"""Tensor creation, layout and indexing ops in torch (counterpart of
``paddle_tpu/ops/tensor_ops.py``: ``fill_constant :46``,
``fill_any_like :79``, ``uniform_random :86``, ``gaussian_random :96``,
``truncated_gaussian_random :105``, ``assign :123``, ``cast :137``,
``reshape2 :143``, ``transpose2 :165``, ``concat :180``,
``stack :200``, ``squeeze2 :214``, ``unsqueeze2 :226``, ``flatten2
:235``, ``slice :255`` (squeezing its ``decrease_axis``), ``expand
:284``, ``gather :329``, ``increment :402``, ``where :424``,
``arg_max :430``, ``top_k :476``, ``assign_value :128``,
``recompute_barrier :572``). ``cast`` takes the
generic vjp, so ``cast_grad`` casts the
cotangent back to the input's type, as the JAX vjp does. ``slice`` and
``transpose2`` return views and ``reshape2`` one where the strides
allow, so the attention kernels take q/k/v as strided views of the qkv
projection. ``gather`` has a bespoke grad that sums duplicate indices
in a fixed order."""
import math

import numpy as np
import torch

from ..framework.dtype import torch_dtype
from ..framework.registry import register_grad_lower, register_op
from ..framework.selected_rows import coalesce, is_selected_rows
from .common import x_of


def _xshape(x):
    """The ``XShape`` output: an empty ``[0, *x.shape]`` carrier of the
    input's shape (no data)."""
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)


@register_op("fill_constant", grad=False)
def fill_constant(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    return {"Out": torch.full(shape, attrs.get("value", 0.0),
                              dtype=torch_dtype(attrs.get("dtype",
                                                          "float32")),
                              device=ctx.device)}


@register_op("uniform_random", grad=False, needs_rng=True)
def uniform_random(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(shape, generator=ctx.generator(attrs),
                     dtype=torch_dtype(attrs.get("dtype", "float32")),
                     device=ctx.device)
    return {"Out": out * (hi - lo) + lo}


@register_op("gaussian_random", grad=False, needs_rng=True)
def gaussian_random(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    out = torch.randn(shape, generator=ctx.generator(attrs),
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    return {"Out": out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)}


@register_op("fill_any_like", grad=False)
def fill_any_like(ctx, ins, attrs):
    x = x_of(ins)
    dt = torch_dtype(attrs["dtype"]) if attrs.get("dtype") else x.dtype
    return {"Out": torch.full_like(x, attrs.get("value", 0.0), dtype=dt)}


@register_op("truncated_gaussian_random", grad=False, needs_rng=True)
def truncated_gaussian_random(ctx, ins, attrs):
    """A standard normal truncated to [-2, 2], then ``* std + mean``, as
    ``jax.random.truncated_normal(key, -2, 2)`` draws it, from the op's
    own generator (``LowerCtx.generator``)."""
    shape = tuple(int(s) for s in attrs["shape"])
    dt = torch_dtype(attrs.get("dtype", "float32"))
    out = torch.nn.init.trunc_normal_(
        torch.empty(shape, dtype=dt, device=ctx.device), 0.0, 1.0, -2.0,
        2.0, generator=ctx.generator(attrs))
    return {"Out": out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)}


@register_op("assign")
def assign(ctx, ins, attrs):
    return {"Out": x_of(ins)}


@register_op("recompute_barrier", grad=False, infer_shape=False)
def recompute_barrier(ctx, ins, attrs):
    """The identity. In the JAX package it is an optimization barrier
    that keeps XLA from folding a recomputed segment into the forward;
    here the barrier's only job is the new names it gives a recomputed
    segment's reads, so the ``cse`` pass cannot merge the segment's ops
    with the forward's."""
    return {"Out": list(ins["X"])}


@register_op("cast")
def cast(ctx, ins, attrs):
    return {"Out": x_of(ins).to(torch_dtype(attrs["out_dtype"]))}


@register_op("concat")
def concat(ctx, ins, attrs):
    return {"Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))}


@register_op("merge_selected_rows", grad=False, infer_shape=False)
def merge_selected_rows(ctx, ins, attrs):
    """A ``SelectedRows`` with its duplicate rows merged (``coalesce``); a
    dense input passes through."""
    x = x_of(ins)
    return {"Out": coalesce(x) if is_selected_rows(x) else x}


@register_op("get_tensor_from_selected_rows", grad=False,
             infer_shape=False)
def get_tensor_from_selected_rows(ctx, ins, attrs):
    """A ``SelectedRows``' value tensor; a dense input passes through."""
    x = x_of(ins)
    return {"Out": x.values if is_selected_rows(x) else x}


@register_op("where")
def where(ctx, ins, attrs):
    return {"Out": torch.where(x_of(ins, "Condition"), x_of(ins),
                               x_of(ins, "Y"))}


@register_op("reshape2")
def reshape2(ctx, ins, attrs):
    """Fluid semantics: a 0 copies the input's dim, one -1 is inferred."""
    x = x_of(ins)
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("transpose2")
def transpose2(ctx, ins, attrs):
    x = x_of(ins)
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


@register_op("unsqueeze2")
def unsqueeze2(ctx, ins, attrs):
    x = x_of(ins)
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": out, "XShape": _xshape(x)}


@register_op("flatten2")
def flatten2(ctx, ins, attrs):
    """Dims before ``axis`` fold into the first, the rest into the
    second."""
    x = x_of(ins)
    axis = attrs.get("axis", 1)
    lead = math.prod(x.shape[:axis]) if axis > 0 else 1
    return {"Out": x.reshape(lead, -1), "XShape": _xshape(x)}


@register_op("slice")
def slice_op(ctx, ins, attrs):
    x = x_of(ins, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    decrease = attrs.get("decrease_axis", [])
    if decrease:
        out = out.squeeze(tuple(decrease))
    return {"Out": out}


def _gather_index(ins):
    """The flat index of a ``gather`` (an ``[N, 1]`` index is squeezed,
    as in the JAX op) and the index's shape."""
    index = x_of(ins, "Index")
    if index.dim() == 2 and index.shape[1] == 1:
        index = index[:, 0]
    return index.reshape(-1).long(), tuple(index.shape)


@register_op("gather")
def gather(ctx, ins, attrs):
    """``jnp.take(x, index, axis)``: the index's shape replaces dim
    ``axis``."""
    x = x_of(ins)
    axis = attrs.get("axis", 0) % x.dim()
    idx, ishape = _gather_index(ins)
    out = x.index_select(axis, idx)
    return {"Out": out.reshape(tuple(x.shape[:axis]) + ishape
                               + tuple(x.shape[axis + 1:]))}


@register_grad_lower("gather")
def gather_grad(ctx, ins, attrs):
    """X's grad: the upstream rows summed into a zero tensor at their
    indices. Duplicate indices (BERT's ``mask_pos`` draws with
    replacement) are the normal case: ``index_put_`` with accumulate
    sums them in a fixed order (sorted indices) on CUDA, where
    ``index_add_`` takes atomics in any order, so the grad is the same
    bits from run to run."""
    x, g = x_of(ins), x_of(ins, "Out@GRAD")
    axis = attrs["__fwd_op__"]["attrs"].get("axis", 0) % x.dim()
    idx, _ = _gather_index(ins)
    rest = tuple(x.shape[:axis]) + tuple(x.shape[axis + 1:])
    g = g.to(x.dtype).reshape(tuple(x.shape[:axis]) + (idx.shape[0],)
                              + tuple(x.shape[axis + 1:])).movedim(axis, 0)
    dx = x.new_zeros((x.shape[axis],) + rest).index_put_(
        (idx,), g, accumulate=True)
    return {"X@GRAD": [dx.movedim(0, axis)]}


@register_op("increment")
def increment(ctx, ins, attrs):
    """``x + step`` in x's type; the LR schedulers' step counter writes
    its persistable input in place (the same name in and out)."""
    x = x_of(ins)
    return {"Out": (x + attrs.get("step", 1.0)).to(x.dtype)}


@register_op("top_k", grad=False)
def top_k(ctx, ins, attrs):
    """The k largest along the last dim and their indices, int32 as the
    JAX package stores fluid int64 indices."""
    vals, idx = torch.topk(x_of(ins), attrs["k"], dim=-1)
    return {"Out": vals, "Indices": idx.to(torch.int32)}


_CONSTANTS = {}


@register_op("assign_value", grad=False)
def assign_value(ctx, ins, attrs):
    """A constant tensor from the ``values`` attr (``layers.assign`` of a
    numpy array). The device copy is made once per value and device and
    kept for the process: a host-to-device copy cannot be captured in a
    CUDA graph, so a captured program reads the kept tensor (no op
    writes a tensor in place)."""
    shape = [int(s) for s in attrs.get("shape") or ()]
    vals = np.asarray(attrs["values"], dtype=attrs["dtype"])
    if shape:
        vals = vals.reshape(shape)
    key = (str(ctx.device), vals.dtype.str, vals.shape, vals.tobytes())
    out = _CONSTANTS.get(key)
    if out is None:
        out = torch.from_numpy(vals.copy()).to(ctx.device)
        if not ctx.abstract:
            _CONSTANTS[key] = out
    return {"Out": out}


@register_op("stack")
def stack(ctx, ins, attrs):
    return {"Y": torch.stack(ins["X"], dim=attrs.get("axis", 0))}


@register_op("squeeze2")
def squeeze2(ctx, ins, attrs):
    """Drop the listed size-1 dims (every size-1 dim when none are
    listed); a listed dim that is not size 1 stays."""
    x = x_of(ins)
    axes = attrs.get("axes", [])
    if axes:
        axes = [a % x.dim() for a in axes if x.shape[a % x.dim()] == 1]
        out = x.squeeze(tuple(axes)) if axes else x
    else:
        out = x.squeeze()
    return {"Out": out, "XShape": _xshape(x)}


@register_op("expand")
def expand(ctx, ins, attrs):
    """``jnp.tile(x, expand_times)``."""
    return {"Out": x_of(ins).repeat(*[int(t)
                                      for t in attrs["expand_times"]])}


@register_op("arg_max", grad=False)
def arg_max(ctx, ins, attrs):
    """The index of the first largest element along ``axis`` (int64, as
    the IR declares it)."""
    x = x_of(ins)
    axis = attrs.get("axis", -1)
    out = torch.argmax(x, dim=axis, keepdim=bool(attrs.get("keepdims",
                                                           False)))
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "int64")))}
