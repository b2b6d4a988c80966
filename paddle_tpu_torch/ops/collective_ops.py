"""Collective ops in the program IR, over the process world.

Counterpart of the data-parallel half of
``paddle_tpu/ops/collective_ops.py`` (reference:
operators/collective/c_allreduce_op.h:58, c_allgather_op.cc,
c_reducescatter_op.cc, c_broadcast_op.cc). The JAX ops lower to XLA
collectives over a mesh axis inside a mapped region and are identities
outside one. Here a ring is the ``dp`` axis of the process world
(``parallel.mesh``): in a launched world each op calls
``torch.distributed`` (NCCL on the card, inside a captured CUDA graph
too; gloo on the CPU) and reduces across the ranks, as the reference's
NCCL ops do; in a world of 1 without a process group each op is the
identity. Ring 0 is the dp axis; a ring above 0 must be bound by
``c_comm_init`` (an ``axis_name`` attr) or :func:`register_ring`, and an
axis other than ``dp`` raises (ROADMAP.md Queue 1 item 7b), as do
``hier_allreduce``, ``alltoall`` and ``sharding_constraint``.

Grads: an all-reduce sum's is an all-reduce sum, an all-gather's a
reduce-scatter, a reduce-scatter's an all-gather and a broadcast's the
all-reduced grad at the root (zeros elsewhere). ``c_allreduce_max``,
``_min`` and ``_prod`` have none, as in the reference.

``c_coalesced_allreduce_sum`` is the port's own: the data-parallel
rewrite (``framework.passes``, pass ``dp_grad_allreduce``) puts one after
each bucket of parameter grads; it packs them into one flat buffer,
all-reduces it once and scales it by ``scale`` (1/N).

The functions :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter` and :func:`broadcast_` are the same collectives
on tensors, for the sync batch norm and dygraph ``DataParallel``.
"""
import warnings

import torch

from ..framework.registry import register_grad_lower, register_op
from ..parallel import mesh as _mesh
from .common import x_of

# the tensor collectives keep their long-standing names across the
# torch versions the port runs on
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|"
                        r"reduce_scatter_tensor).* is deprecated")

# Explicit ring_id -> axis-name registry (the reference's NCCLCommContext
# ring registry, platform/collective_helper.h:62); ring 0 is dp.
_RING_AXES = {}

_REDUCE_OPS = ("sum", "max", "min", "prod")


def register_ring(ring_id, axis_name, program=None):
    """Bind a reference-style ring_id to a mesh axis name. With
    ``program``, the binding is scoped to that Program (what
    ``c_comm_init`` does); without, it is a process-wide default. Only
    the ``dp`` axis is ported: another raises when the ring is used."""
    if program is not None:
        if not hasattr(program, "_ring_axes"):
            program._ring_axes = {}
        program._ring_axes[int(ring_id)] = axis_name
    else:
        _RING_AXES[int(ring_id)] = axis_name


def _ring_axis(ctx, attrs):
    """The axis of the op's ring: an explicit ``axis_name`` attr, the
    program's ``c_comm_init`` bindings, the process-wide registry, then
    ``dp`` for ring 0. An unbound ring above 0 is an error."""
    name = attrs.get("axis_name")
    if not name:
        ring = attrs.get("ring_id", 0)
        prog_rings = getattr(getattr(ctx, "program", None), "_ring_axes",
                             None)
        if prog_rings and ring in prog_rings:
            name = prog_rings[ring]
        elif ring in _RING_AXES:
            name = _RING_AXES[ring]
        elif ring == 0:
            name = "dp"
        else:
            raise ValueError(
                f"ring_id {ring} has no mesh axis bound — pass axis_name "
                f"on the collective op or call paddle_tpu_torch.ops."
                f"collective_ops.register_ring({ring}, '<axis>') (the "
                f"reference bound rings via c_comm_init, "
                f"operators/collective/c_comm_init_op.cc)")
    if name != "dp":
        raise _mesh.not_ported_7b(f"a collective over the {name!r} axis")
    return name


def _in_world(ctx, attrs):
    """Whether the op communicates: its ring resolves (raising as
    :func:`_ring_axis` does) and this process is in a launched world;
    never while inferring shapes."""
    _ring_axis(ctx, attrs)
    return not getattr(ctx, "abstract", False) and _mesh.is_initialized()


def _dist():
    import torch.distributed as dist
    return dist


def all_reduce(t, op="sum"):
    """``t`` reduced in place across the world's ranks (``op``: sum,
    max, min, prod); returns ``t``. The identity outside a world."""
    if _mesh.is_initialized():
        dist = _dist()
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN,
               "prod": dist.ReduceOp.PRODUCT}[op]
        dist.all_reduce(t, op=rop, group=_mesh.dp_group())
    return t


def all_gather(t):
    """The ranks' ``t`` concatenated on dim 0, in rank order."""
    if not _mesh.is_initialized():
        return t
    n = _mesh.world_size()
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _dist().all_gather_into_tensor(out, t, group=_mesh.dp_group())
    return out


def reduce_scatter(t):
    """The sum over ranks of ``t``, this rank's 1/N slice of dim 0."""
    if not _mesh.is_initialized():
        return t
    n = _mesh.world_size()
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(t.shape)} does "
                         f"not divide by the {n} ranks")
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    _dist().reduce_scatter_tensor(out, t, group=_mesh.dp_group())
    return out


def broadcast_(t, root=0):
    """``t`` overwritten in place with rank ``root``'s; returns ``t``."""
    if _mesh.is_initialized():
        _dist().broadcast(t, src=int(root), group=_mesh.dp_group())
    return t


def _c_reduce(name, kind):
    @register_op(name, grad=None if kind == "sum" else False)
    def _impl(ctx, ins, attrs):
        x = x_of(ins)
        if not _in_world(ctx, attrs):
            return {"Out": x}
        return {"Out": all_reduce(x.clone(), kind)}

    if kind == "sum":
        @register_grad_lower(name)
        def _grad(ctx, ins, attrs):
            g = x_of(ins, "Out@GRAD")
            if not _in_world(ctx, attrs["__fwd_op__"]["attrs"]):
                return {"X@GRAD": [g]}
            return {"X@GRAD": [all_reduce(g.clone(), "sum")]}
    return _impl


for _kind in _REDUCE_OPS:
    _c_reduce(f"c_allreduce_{_kind}", _kind)
_c_reduce("allreduce", "sum")


@register_op("c_allgather")
def c_allgather(ctx, ins, attrs):
    x = x_of(ins)
    if getattr(ctx, "abstract", False) and _mesh.is_initialized():
        return {"Out": x.new_empty((_mesh.world_size() * x.shape[0],)
                                   + tuple(x.shape[1:]))}
    if not _in_world(ctx, attrs):
        return {"Out": x}
    return {"Out": all_gather(x)}


@register_grad_lower("c_allgather")
def c_allgather_grad(ctx, ins, attrs):
    g = x_of(ins, "Out@GRAD")
    if not _in_world(ctx, attrs["__fwd_op__"]["attrs"]):
        return {"X@GRAD": [g]}
    return {"X@GRAD": [reduce_scatter(g)]}


@register_op("c_reducescatter")
def c_reducescatter(ctx, ins, attrs):
    x = x_of(ins)
    if getattr(ctx, "abstract", False) and _mesh.is_initialized():
        return {"Out": x.new_empty((x.shape[0] // _mesh.world_size(),)
                                   + tuple(x.shape[1:]))}
    if not _in_world(ctx, attrs):
        return {"Out": x}
    return {"Out": reduce_scatter(x)}


@register_grad_lower("c_reducescatter")
def c_reducescatter_grad(ctx, ins, attrs):
    g = x_of(ins, "Out@GRAD")
    if not _in_world(ctx, attrs["__fwd_op__"]["attrs"]):
        return {"X@GRAD": [g]}
    return {"X@GRAD": [all_gather(g)]}


@register_op("c_broadcast")
def c_broadcast(ctx, ins, attrs):
    x = x_of(ins)
    if not _in_world(ctx, attrs):
        return {"Out": x}
    return {"Out": broadcast_(x.clone(), attrs.get("root", 0))}


@register_grad_lower("c_broadcast")
def c_broadcast_grad(ctx, ins, attrs):
    fattrs = attrs["__fwd_op__"]["attrs"]
    g = x_of(ins, "Out@GRAD")
    if not _in_world(ctx, fattrs):
        return {"X@GRAD": [g]}
    g = all_reduce(g.clone(), "sum")
    if _mesh.rank() != int(fattrs.get("root", 0)):
        g = torch.zeros_like(g)
    return {"X@GRAD": [g]}


@register_op("broadcast")
def broadcast(ctx, ins, attrs):
    return c_broadcast(ctx, ins, attrs)


@register_grad_lower("broadcast")
def broadcast_grad(ctx, ins, attrs):
    return c_broadcast_grad(ctx, ins, attrs)


@register_op("c_coalesced_allreduce_sum", grad=False, infer_shape=False)
def c_coalesced_allreduce_sum(ctx, ins, attrs):
    """The parameter grads ``X`` packed into one flat buffer per dtype
    (the pass buckets one declared dtype), all-reduced (sum) once and
    scaled by ``scale``; ``Out`` rebinds each to its slice. In a world of
    1 without a group only the scale applies."""
    xs = ins["X"]
    scale = float(attrs.get("scale", 1.0))
    if not _in_world(ctx, attrs):
        return {"Out": [x * scale if scale != 1.0 else x for x in xs]}
    outs = [None] * len(xs)
    for dt in dict.fromkeys(x.dtype for x in xs):
        idx = [i for i, x in enumerate(xs) if x.dtype == dt]
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        all_reduce(flat, "sum")
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for i in idx:
            outs[i] = flat[off:off + xs[i].numel()].view(xs[i].shape)
            off += xs[i].numel()
    return {"Out": outs}


def _not_ported(name):
    @register_op(name, grad=False, infer_shape=False)
    def _impl(ctx, ins, attrs):
        raise _mesh.not_ported_7b(f"the {name!r} op")
    return _impl


for _name in ("hier_allreduce", "alltoall", "sharding_constraint"):
    _not_ported(_name)


@register_op("c_sync_calc_stream")
def c_sync_calc_stream(ctx, ins, attrs):
    # torch.distributed orders a collective against the current stream
    return {"Out": x_of(ins)}


@register_op("c_sync_comm_stream")
def c_sync_comm_stream(ctx, ins, attrs):
    return {"Out": x_of(ins)}


@register_op("c_gen_nccl_id", grad=False, infer_shape=False)
def c_gen_nccl_id(ctx, ins, attrs):
    """The NCCL-id RPC bootstrap (reference c_gen_nccl_id_op.cc) is the
    process group's rendezvous at trainer 0's endpoint here
    (``parallel.mesh.init_parallel_env``)."""
    return None


@register_op("c_comm_init", grad=False, infer_shape=False)
def c_comm_init(ctx, ins, attrs):
    # ring bootstrap collapses to a registry entry: bind ring_id -> axis,
    # program-scoped and process-wide (init ops live in the STARTUP
    # program while the collectives run in the main program)
    if "axis_name" in attrs:
        register_ring(attrs.get("ring_id", 0), attrs["axis_name"],
                      program=ctx.program)
        register_ring(attrs.get("ring_id", 0), attrs["axis_name"])
    return None


@register_op("c_comm_init_all", grad=False, infer_shape=False)
def c_comm_init_all(ctx, ins, attrs):
    return None


__all__ = ["all_gather", "all_reduce", "broadcast_", "reduce_scatter",
           "register_ring"]
