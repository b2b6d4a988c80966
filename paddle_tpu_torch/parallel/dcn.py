"""The multi-slice grad sync's pre-run gate (``FLAGS_dcn_assert_hier``).

The JAX package parses the compiled executable's collectives into a
comms ledger and holds it to three conditions before the first slab of a
hierarchical program (``paddle_tpu/observability/comms.py``
``assert_hier_decomposition``). The port has no HLO: its collectives
are the program's ops, so :func:`hier_sync_report` reads the program as
it runs (after the pass pipeline) and the mesh, and prices each
``hier_allreduce`` and each bucketed all-reduce of a data-parallel ring
as the ring algorithm moves it, per rank and step:

- reduce-scatter and all-gather ``(n - 1) / n`` of the whole payload,
  all-reduce ``2 (n - 1) / n`` (JAX's ``_WIRE_FACTOR``);
- a hierarchical ``hier_allreduce`` of a grad of ``|g|`` bytes is a
  reduce-scatter of ``|g|`` (padded to a multiple of dp) over ``dp``, an
  all-reduce of ``|g| / dp`` over ``dcn_dp``, an all-gather back to
  ``|g|`` over ``dp``; a flat one one all-reduce of ``|g|`` over
  ``dcn_dp+dp``.

A group that spans more than one ``dcn_dp`` coordinate (``dcn_dp``,
``dcn_dp+dp``, ``dcn_dp+dp_sp``) crosses slices. :func:`check_hier_sync`
raises ``resilience.HierarchicalCommsError`` (with ``violations`` and
the byte table as ``ledger``) when

1. a grad an optimizer op reads is not synced by a ``hier_allreduce``,
   or is synced twice (a ``hier_allreduce`` and an all-reduce of
   ``dp_grad_allreduce`` on one path);
2. a collective across slices carries more than its 1/dp shard (the
   flat path's one all-reduce of ``|g|`` does);
3. there is no collective across slices, or their bytes a step are not
   below :func:`flat_allreduce_wire_bytes`, the flat all-reduce's
   ``2 (S - 1) / S`` x the grads' bytes over ``S = dcn_dp x dp``.
"""
import math

from ..framework.core import OP_ROLE_KEY, OpRole
from ..framework.dtype import itemsize
from .mesh import AXES

#: the ops that sum grads over a data-parallel ring
SYNC_OPS = ("hier_allreduce", "c_coalesced_allreduce_sum", "c_allreduce_sum",
            "allreduce")
#: the groups that span more than one slice
CROSS_SLICE = ("dcn_dp", "dcn_dp+dp", "dcn_dp+dp_sp")


def _wire(kind, n):
    return 2.0 * (n - 1) / n if kind == "all-reduce" else (n - 1) / n


def _nbytes(var):
    shape = [max(int(d), 1) for d in (getattr(var, "shape", None) or ())]
    return int(math.prod(shape)) * itemsize(var.dtype)


def _optimized_grads(block):
    """The grad names the optimizer ops read, in program order."""
    out = []
    for op in block.ops:
        if op.attrs.get(OP_ROLE_KEY) == OpRole.Optimize:
            out.extend(g for g in op.input("Grad") if g not in out)
    return out


def _sync_counts(block):
    """{grad an optimizer op reads: how many sync ops are on its path}:
    each name's last writer before its reader, traced back through its
    inputs (a sync op's output ``i`` through its input ``i``)."""
    ops = block.ops
    writers = {}
    for i, op in enumerate(ops):
        for n in op.output_arg_names:
            writers.setdefault(n, []).append(i)
    memo = {}

    def count(name, before):
        idx = [i for i in writers.get(name, ()) if i < before]
        if not idx:
            return 0
        i = idx[-1]
        key = (name, i)
        if key in memo:
            return memo[key]
        memo[key] = 0                  # a cycle counts nothing
        op = ops[i]
        if op.type in SYNC_OPS:
            outs = op.output("Out")
            ins = op.input("X")
            src = [ins[outs.index(name)]] if name in outs and \
                len(ins) == len(outs) else ins
            got = 1 + max((count(n, i) for n in src), default=0)
        else:
            got = max((count(n, i) for n in op.input_arg_names), default=0)
        memo[key] = got
        return got

    first_reader = {}
    for i, op in enumerate(ops):
        if op.attrs.get(OP_ROLE_KEY) == OpRole.Optimize:
            for g in op.input("Grad"):
                first_reader.setdefault(g, i)
    return {g: count(g, first_reader[g]) for g in _optimized_grads(block)}


def flat_allreduce_wire_bytes(grad_bytes, mesh):
    """What one flat all-reduce of ``grad_bytes`` over every data replica
    (``S = dcn_dp x dp``) moves a rank a step: ``2 (S - 1) / S`` x
    ``grad_bytes`` (JAX ``comms.py``'s yardstick)."""
    S = mesh.dcn_dp * mesh.dp
    return _wire("all-reduce", S) * grad_bytes if S > 1 else 0.0


def hier_sync_report(program, mesh, hierarchical=None):
    """The grad sync of ``program`` on ``mesh`` (``hierarchical``: how
    the ``hier_allreduce`` ops run, default as
    ``ops.collective_ops.hierarchical`` says): a dict of ``rows``
    ({"<kind>@<group>": count, payload and wire bytes a rank a step,
    group size}), ``grad_bytes`` (of the grads the hier ops sync),
    ``cross_slice_wire_bytes``, ``flat_estimate_wire_bytes`` and
    ``violations`` (empty when the gate passes)."""
    from ..ops.collective_ops import hierarchical as _hier
    if hierarchical is None:
        hierarchical = _hier(mesh)
    block = program.global_block()
    rows = {}

    def add(kind, group, n, payload):
        if n <= 1:
            return
        row = rows.setdefault(f"{kind}@{group}", {
            "kind": kind, "group": group, "group_size": n, "count": 0,
            "payload_bytes": 0, "wire_bytes": 0.0})
        row["count"] += 1
        row["payload_bytes"] += int(payload)
        row["wire_bytes"] += _wire(kind, n) * payload

    violations = []
    grad_bytes = 0
    for op in block.ops:
        if op.type == "hier_allreduce":
            inner = op.attrs.get("inner_axis", "dp")
            outer = op.attrs.get("outer_axis", "dcn_dp")
            var = block.var(op.input("X")[0])
            g = _nbytes(var)
            grad_bytes += g
            n, m = mesh.axis_size(inner), mesh.axis_size(outer)
            per = itemsize(var.dtype)
            # the 1/n shard of the grad padded to a multiple of n
            limit = -(-g // (n * per)) * per
            if hierarchical and inner == "dp" and outer == "dcn_dp":
                add("reduce-scatter", inner, n, limit * n)
                add("all-reduce", outer, m, limit)
                add("all-gather", inner, n, limit * n)
                shard = limit
            else:
                add("all-reduce", f"{outer}+{inner}", n * m, g)
                shard = g
            if m > 1 and shard > limit:
                violations.append(
                    f"{op.input('X')[0]}: {shard} bytes cross slices "
                    f"where its 1/{n} shard is {limit} (the flat "
                    f"all-reduce over {outer}+{inner})")
        elif op.type in SYNC_OPS:
            axis = op.attrs.get("axis_name") or "dp"
            n = mesh.axis_size(axis) if axis in AXES else 1
            payload = sum(_nbytes(block.var(x)) for x in op.input("X"))
            add("all-reduce", axis, n, payload)
            if axis in CROSS_SLICE and n > 1:
                violations.append(
                    f"{op.type} over {axis} carries {payload} bytes "
                    f"across slices outside hier_allreduce")
    for g, c in _sync_counts(block).items():
        if c == 0:
            violations.append(
                f"{g}: the optimizer reads it unsynced: no hier_allreduce "
                f"on its path (pass hier_grad_sync did not run: compile "
                f"through CompiledProgram.with_data_parallel over the "
                f"dcn_dp mesh)")
        elif c > 1:
            violations.append(f"{g}: synced {c} times on its path (a "
                              f"hier_allreduce and another all-reduce)")
    cross = sum(r["wire_bytes"] for r in rows.values()
                if r["group"] in CROSS_SLICE)
    flat = flat_allreduce_wire_bytes(grad_bytes, mesh)
    if not any(r["group"] in CROSS_SLICE for r in rows.values()):
        violations.append("no collective across slices: the grads of the "
                          "slices are never summed")
    elif flat and cross >= flat:
        violations.append(f"the bytes across slices, {cross:.0f} a step, "
                          f"do not beat the flat all-reduce's {flat:.0f}")
    return {"mesh": repr(mesh), "hierarchical": bool(hierarchical),
            "rows": rows, "grad_bytes": grad_bytes,
            "cross_slice_wire_bytes": cross,
            "flat_estimate_wire_bytes": flat, "violations": violations}


def check_hier_sync(program, mesh, where="train"):
    """:func:`hier_sync_report` of ``program`` on ``mesh``, raising
    ``HierarchicalCommsError`` when it has violations; returns the
    report."""
    from ..resilience import HierarchicalCommsError
    rep = hier_sync_report(program, mesh)
    if rep["violations"]:
        raise HierarchicalCommsError(
            f"hierarchical grad-sync gate failed for {where!r} on "
            f"{mesh}:\n  - " + "\n  - ".join(rep["violations"]),
            violations=rep["violations"], ledger=rep)
    return rep


__all__ = ["CROSS_SLICE", "check_hier_sync", "flat_allreduce_wire_bytes",
           "hier_sync_report"]
