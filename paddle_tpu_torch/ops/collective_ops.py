"""Collective ops in the program IR, over the process world.

Counterpart of ``paddle_tpu/ops/collective_ops.py`` (reference:
operators/collective/c_allreduce_op.h:58, c_allgather_op.cc,
c_reducescatter_op.cc, c_broadcast_op.cc). The JAX ops lower to XLA
collectives over a mesh axis inside a mapped region and are identities
outside one. Here a ring is an axis of the world's layout
(``parallel.mesh.world_mesh``): ``dp`` or ``tp``. In a launched world
each op calls ``torch.distributed`` over the rank's process group on
that axis (NCCL on the card, inside a captured CUDA graph too; gloo on
the CPU), as the reference's NCCL ops do; on an axis of one rank, and in
a world of 1 without a process group, each op is the identity. Ring 0
is the dp axis; a ring above 0 must be bound by ``c_comm_init`` (an
``axis_name`` attr) or :func:`register_ring` (``register_ring(1,
"tp")``). The other axes (``pp``, ``sp``, ``ep``, ``dcn_dp``) raise
(ROADMAP.md Queue 1 item 7b), as do ``hier_allreduce`` and
``alltoall``. ``sharding_constraint`` is a value identity: a layout hint
under GSPMD, while every rank of the port holds whole activations.

Grads: an all-reduce sum's is an all-reduce sum, an all-gather's a
reduce-scatter, a reduce-scatter's an all-gather and a broadcast's the
all-reduced grad at the root (zeros elsewhere). ``c_allreduce_max``,
``_min`` and ``_prod`` have none, as in the reference.

The port's own ops:

- ``c_coalesced_allreduce_sum``: the data-parallel rewrite
  (``framework.passes``, pass ``dp_grad_allreduce``) puts one after
  each bucket of parameter grads; it packs them into one flat buffer,
  all-reduces it once and scales it by ``scale`` (1/N);
- Megatron's conjugate pair, which pass ``tp_shard`` puts around the
  split matmuls: ``c_identity`` (the identity forward, its grad summed
  over the axis) before a column-split weight, ``mp_allreduce_sum`` (a
  sum over the axis forward, the identity grad) after a row-split one;
- ``c_concat``: the ranks' ``X`` concatenated on ``axis`` in axis order
  (the vocab-split logits), its grad the rank's slice;
- ``c_embedding``: the lookup of a vocab-split table, rows
  ``[start_index, start_index + rows)``; an id outside them looks up
  zeros (the ``mp_allreduce_sum`` after it sums the ranks' rows).

The functions :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter` and :func:`broadcast_` are the same collectives
on tensors, for the sync batch norm, dygraph ``DataParallel`` and the
tensor-parallel GPT module.
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
    ``c_comm_init`` does); without, it is a process-wide default. The
    ``dp`` and ``tp`` axes are ported: another raises when the ring is
    used."""
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
    if name not in ("dp", "tp"):
        raise _mesh.not_ported_7b(f"a collective over the {name!r} axis")
    return name


def _in_world(ctx, attrs):
    """The axis the op communicates over, or None when it does not: its
    ring resolves (raising as :func:`_ring_axis` does), this process is
    in a launched world and the axis has more than one rank; never while
    inferring shapes."""
    axis = _ring_axis(ctx, attrs)
    if getattr(ctx, "abstract", False) or not _mesh.is_initialized() \
            or _mesh.axis_world_size(axis) == 1:
        return None
    return axis


def _dist():
    import torch.distributed as dist
    return dist


def _live(axis, mesh=None):
    """Whether a collective over ``axis`` of ``mesh`` (default: the
    active layout; axis None: the whole world) communicates."""
    if not _mesh.is_initialized():
        return False
    return axis is None or _mesh.axis_world_size(axis, mesh) > 1


def _group(axis, mesh=None):
    return None if axis is None else _mesh.axis_group(axis, mesh)


def _size(axis, mesh=None):
    return _mesh.world_size() if axis is None \
        else _mesh.axis_world_size(axis, mesh)


def all_reduce(t, op="sum", axis="dp", mesh=None):
    """``t`` reduced in place across the ranks of ``axis`` of ``mesh``
    (default: the active layout; axis None: the whole world; ``op``:
    sum, max, min, prod); returns ``t``. The identity outside a
    world."""
    if _live(axis, mesh):
        dist = _dist()
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN,
               "prod": dist.ReduceOp.PRODUCT}[op]
        dist.all_reduce(t, op=rop, group=_group(axis, mesh))
    return t


def all_gather(t, axis="dp", dim=0, mesh=None):
    """The ranks' ``t`` concatenated on ``dim``, in axis order."""
    if not _live(axis, mesh):
        return t
    n = _size(axis, mesh)
    t = t.movedim(dim, 0).contiguous() if dim else t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _dist().all_gather_into_tensor(out, t, group=_group(axis, mesh))
    return out.movedim(0, dim) if dim else out


def reduce_scatter(t, axis="dp"):
    """The sum over the ranks of ``axis`` of ``t``, this rank's 1/N
    slice of dim 0."""
    if not _live(axis):
        return t
    n = _size(axis)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(t.shape)} does "
                         f"not divide by the {n} ranks")
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    _dist().reduce_scatter_tensor(out, t, group=_group(axis))
    return out


def broadcast_(t, root=0, axis="dp"):
    """``t`` overwritten in place with that of index ``root`` of this
    rank's ``axis`` group (None: world rank ``root``); returns ``t``."""
    if _live(axis):
        src = int(root) if axis is None or _group(axis) is None \
            else _mesh.axis_global_rank(axis, root)
        _dist().broadcast(t, src=src, group=_group(axis))
    return t


def _c_reduce(name, kind):
    @register_op(name, grad=None if kind == "sum" else False)
    def _impl(ctx, ins, attrs):
        x = x_of(ins)
        axis = _in_world(ctx, attrs)
        if not axis:
            return {"Out": x}
        return {"Out": all_reduce(x.clone(), kind, axis)}

    if kind == "sum":
        @register_grad_lower(name)
        def _grad(ctx, ins, attrs):
            g = x_of(ins, "Out@GRAD")
            axis = _in_world(ctx, attrs["__fwd_op__"]["attrs"])
            if not axis:
                return {"X@GRAD": [g]}
            return {"X@GRAD": [all_reduce(g.clone(), "sum", axis)]}
    return _impl


for _kind in _REDUCE_OPS:
    _c_reduce(f"c_allreduce_{_kind}", _kind)
_c_reduce("allreduce", "sum")


def _abstract_axis(ctx, attrs):
    """The axis size a shape inference in a launched world sees (the
    op's output shape depends on it), else None."""
    if getattr(ctx, "abstract", False) and _mesh.is_initialized():
        return _mesh.axis_world_size(_ring_axis(ctx, attrs))
    return None


@register_op("c_allgather")
def c_allgather(ctx, ins, attrs):
    x = x_of(ins)
    n = _abstract_axis(ctx, attrs)
    if n is not None:
        return {"Out": x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))}
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": x}
    return {"Out": all_gather(x, axis)}


@register_grad_lower("c_allgather")
def c_allgather_grad(ctx, ins, attrs):
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, attrs["__fwd_op__"]["attrs"])
    if not axis:
        return {"X@GRAD": [g]}
    return {"X@GRAD": [reduce_scatter(g, axis)]}


@register_op("c_reducescatter")
def c_reducescatter(ctx, ins, attrs):
    x = x_of(ins)
    n = _abstract_axis(ctx, attrs)
    if n is not None:
        return {"Out": x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))}
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": x}
    return {"Out": reduce_scatter(x, axis)}


@register_grad_lower("c_reducescatter")
def c_reducescatter_grad(ctx, ins, attrs):
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, attrs["__fwd_op__"]["attrs"])
    if not axis:
        return {"X@GRAD": [g]}
    return {"X@GRAD": [all_gather(g, axis)]}


@register_op("c_broadcast")
def c_broadcast(ctx, ins, attrs):
    x = x_of(ins)
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": x}
    return {"Out": broadcast_(x.clone(), attrs.get("root", 0), axis)}


@register_grad_lower("c_broadcast")
def c_broadcast_grad(ctx, ins, attrs):
    fattrs = attrs["__fwd_op__"]["attrs"]
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, fattrs)
    if not axis:
        return {"X@GRAD": [g]}
    g = all_reduce(g.clone(), "sum", axis)
    if _mesh.axis_rank(axis) != int(fattrs.get("root", 0)):
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
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": [x * scale if scale != 1.0 else x for x in xs]}
    outs = [None] * len(xs)
    for dt in dict.fromkeys(x.dtype for x in xs):
        idx = [i for i, x in enumerate(xs) if x.dtype == dt]
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        all_reduce(flat, "sum", axis)
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


for _name in ("hier_allreduce", "alltoall"):
    _not_ported(_name)


@register_op("sharding_constraint")
def sharding_constraint(ctx, ins, attrs):
    """A layout hint (the ``spec`` attr, sanitised by
    ``layers.collective.shard``): the value itself, since every rank of
    the port holds whole activations."""
    return {"Out": x_of(ins)}


# ------------------------------------------- tensor parallelism (tp_shard)

@register_op("c_identity")
def c_identity(ctx, ins, attrs):
    """The identity forward before a column-split weight; its grad, the
    sum of the ranks' partial grads over the axis."""
    _ring_axis(ctx, attrs)
    return {"Out": x_of(ins)}


@register_grad_lower("c_identity")
def c_identity_grad(ctx, ins, attrs):
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, attrs["__fwd_op__"]["attrs"])
    if not axis:
        return {"X@GRAD": [g]}
    return {"X@GRAD": [all_reduce(g.clone(), "sum", axis)]}


@register_op("mp_allreduce_sum")
def mp_allreduce_sum(ctx, ins, attrs):
    """The sum over the axis of the ranks' partial products after a
    row-split weight; its grad, the identity."""
    x = x_of(ins)
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": x}
    return {"Out": all_reduce(x.clone(), "sum", axis)}


@register_grad_lower("mp_allreduce_sum")
def mp_allreduce_sum_grad(ctx, ins, attrs):
    return {"X@GRAD": [x_of(ins, "Out@GRAD")]}


@register_op("c_concat")
def c_concat(ctx, ins, attrs):
    """The ranks' ``X`` concatenated on ``axis`` (attr, default -1) in
    axis order; ``nranks`` (the axis size) sizes it in shape
    inference."""
    x = x_of(ins)
    dim = int(attrs.get("axis", -1)) % x.dim()
    if getattr(ctx, "abstract", False):
        n = int(attrs.get("nranks") or
                _mesh.axis_world_size(_ring_axis(ctx, attrs)))
        shape = list(x.shape)
        shape[dim] *= n
        return {"Out": x.new_empty(shape)}
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": x}
    return {"Out": all_gather(x, axis, dim)}


@register_grad_lower("c_concat")
def c_concat_grad(ctx, ins, attrs):
    fattrs = attrs["__fwd_op__"]["attrs"]
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, fattrs)
    if not axis:
        return {"X@GRAD": [g]}
    dim = int(fattrs.get("axis", -1)) % g.dim()
    n = _mesh.axis_world_size(axis)
    size = g.shape[dim] // n
    return {"X@GRAD": [g.narrow(dim, _mesh.axis_rank(axis) * size,
                                size).contiguous()]}


def _local_ids(ids, rows, start=0, padding_idx=None):
    """(``ids`` made local to the rows ``[start, start + rows)`` of a
    vocab-split table and clamped into them, the mask of the ids that
    are in them and are not ``padding_idx``, a global id)."""
    local = ids.long() - int(start)
    keep = (local >= 0) & (local < rows)
    if padding_idx is not None and int(padding_idx) >= 0:
        keep = keep & (ids.long() != int(padding_idx))
    return local.clamp(0, rows - 1), keep


def vocab_lookup(ids, w, start=0, padding_idx=None):
    """The lookup of ``ids`` in ``w``, rows ``[start, start + len(w))``
    of a vocab-split table: an id in them looks up its row, any other
    (and ``padding_idx``) zeros. Summed over the tp ranks it is the
    whole table's lookup."""
    local, keep = _local_ids(ids, w.shape[0], start, padding_idx)
    out = torch.nn.functional.embedding(local, w)
    return torch.where(keep.unsqueeze(-1), out, 0.0).to(w.dtype)


def _ids(ins):
    ids = x_of(ins, "Ids")
    return ids.squeeze(-1) if ids.dim() > 1 and ids.shape[-1] == 1 else ids


@register_op("c_embedding")
def c_embedding(ctx, ins, attrs):
    """``W`` holds rows ``[start_index, start_index + len(W))`` of a
    vocab-split table (:func:`vocab_lookup`)."""
    return {"Out": vocab_lookup(_ids(ins), x_of(ins, "W"),
                                attrs.get("start_index", 0),
                                attrs.get("padding_idx"))}


@register_grad_lower("c_embedding")
def c_embedding_grad(ctx, ins, attrs):
    """W's grad: the upstream rows of the rank's ids summed into a zero
    table with ``index_put_`` (sorted, the same bits run to run, as
    ``lookup_table``'s)."""
    fattrs = attrs["__fwd_op__"]["attrs"]
    w, g = x_of(ins, "W"), x_of(ins, "Out@GRAD")
    local, keep = _local_ids(_ids(ins), w.shape[0],
                             fattrs.get("start_index", 0),
                             fattrs.get("padding_idx"))
    flat_g = torch.where(keep.reshape(-1, 1),
                         g.reshape(-1, w.shape[-1]), 0.0)
    return {"W@GRAD": [torch.zeros_like(w).index_put_(
        (local.reshape(-1),), flat_g.to(w.dtype), accumulate=True)]}


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
           "register_ring", "vocab_lookup"]
