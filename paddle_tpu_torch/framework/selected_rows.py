"""SelectedRows: sparse row-set gradients (counterpart of
``paddle_tpu/framework/selected_rows.py``).

An ``is_sparse`` embedding's W grad is ``SelectedRows(rows, values)``:
int64 row ids ``[N]`` (duplicates allowed) and their values ``[N,
...]``, so a ``[vocab, dim]`` grad is not made until an op needs it. It
flows through the env in the slot a dense tensor would take; sparsity
is a property of the value, and the IR var stays a dense
``LOD_TENSOR`` of the param's shape, as in the JAX package.

Every function here keeps its shapes static and makes no host sync, so
a step that uses them can be captured in a CUDA graph: ``N`` is fixed,
no op reads a count, a mask's size or a value back to the host.
Duplicate rows are summed with ``index_put_(accumulate=True)``, which on
CUDA sorts the indices and adds each row's duplicates in that order
(``index_add_`` takes atomics in any order): the same bits from run to
run.
"""
from typing import NamedTuple

import torch


class SelectedRows(NamedTuple):
    rows: torch.Tensor        # int64 [N] row ids (duplicates allowed)
    values: torch.Tensor      # [N, ...] per-row values

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return self.values.shape


def is_selected_rows(v):
    return isinstance(v, SelectedRows)


def merge(grads):
    """Partial sparse grads accumulated: rows and values concatenated
    (duplicates are summed where the grad is applied)."""
    return SelectedRows(torch.cat([g.rows for g in grads]),
                        torch.cat([g.values for g in grads]))


def to_dense(sr, dense_shape, dtype=None):
    """The dense tensor: each row's values summed into a zero table."""
    dtype = dtype or sr.values.dtype
    out = torch.zeros(tuple(dense_shape), dtype=dtype,
                      device=sr.values.device)
    return out.index_put_((sr.rows,), sr.values.to(dtype), accumulate=True)


def run_heads(rows):
    """For sorted ``rows``: the index of the first slot of each slot's
    run of equal ids."""
    head = torch.ones_like(rows, dtype=torch.bool)
    head[1:] = rows[1:] != rows[:-1]
    pos = torch.arange(rows.shape[0], device=rows.device)
    return torch.cummax(torch.where(head, pos, 0), 0).values


def coalesce(sr):
    """Duplicate row ids merged, at a fixed ``N`` (the reference's
    ``scatter::MergeAdd`` before a sparse optimizer update).

    Static-shape design: the rows are sorted (stably), each run of equal
    ids is summed into its first slot, and every other slot of the run
    keeps its row id with a zero value. The result's rows come sorted, so
    a consumer finds each run's first slot with :func:`run_heads`. Every
    row id stays in range: the JAX package marks a duplicate slot with
    an out-of-range id that its scatters drop, and torch's indexing has
    no drop mode (an out-of-range index is a device assert). Summing a
    zero slot adds nothing, and a write that sets rows (lazy Adam) gives
    each slot its run head's value, so every write to a row agrees."""
    rows, order = torch.sort(sr.rows, stable=True)
    merged = torch.zeros_like(sr.values).index_put_(
        (run_heads(rows),), sr.values[order], accumulate=True)
    return SelectedRows(rows, merged)


__all__ = ["SelectedRows", "coalesce", "is_selected_rows", "merge",
           "run_heads", "to_dense"]
