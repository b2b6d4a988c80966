"""Collective ops in the program IR, over the process world.

Counterpart of ``paddle_tpu/ops/collective_ops.py`` (reference:
operators/collective/c_allreduce_op.h:58, c_allgather_op.cc,
c_reducescatter_op.cc, c_broadcast_op.cc). The JAX ops lower to XLA
collectives over a mesh axis inside a mapped region and are identities
outside one. Here a ring is an axis of the world's layout
(``parallel.mesh.world_mesh``): ``dp``, ``sp``, ``tp``, ``pp``, ``ep``,
``dcn_dp``, or a joint one (``dp_sp``, the grads of a sequence-parallel
program; ``dp_ep``, the tokens of ``switch_moe``'s global batch;
``dcn_dp+dp`` and ``dcn_dp+dp_sp``, the flat grad sync of a multi-slice
program). In a launched world each op calls ``torch.distributed`` over
the rank's process group on that axis (NCCL on the card, inside a
captured CUDA graph too; gloo on the CPU), as the reference's NCCL ops
do; on an axis of one rank, and in a world of 1 without a process
group, each op is the identity. Ring 0 is the dp axis; a ring above 0
must be bound by ``c_comm_init`` (an ``axis_name`` attr) or
:func:`register_ring` (``register_ring(1, "ep")``). ``alltoall`` is the
tiled all-to-all of dim 0 over the ring's axis (its grad the same
all-to-all). ``sharding_constraint`` is a value identity: a layout hint
under GSPMD; where it names ``sp``, pass ``sp_shard`` (``parallel.sp``)
starts the split of the sequence there. ``hier_allreduce`` is the
multi-slice grad sync (:func:`hier_allreduce`): reduce-scatter over
``dp``, all-reduce of the shard over ``dcn_dp``, all-gather over ``dp``,
or one all-reduce over ``dcn_dp+dp`` (the flat path).

Grads: an all-reduce sum's is an all-reduce sum, an all-gather's a
reduce-scatter, a reduce-scatter's an all-gather and a broadcast's the
all-reduced grad at the root (zeros elsewhere). ``c_allreduce_max``,
``_min`` and ``_prod`` have none, as in the reference.

The port's own ops:

- ``c_coalesced_allreduce_sum``: the data-parallel rewrite
  (``framework.passes``, pass ``dp_grad_allreduce``) puts one after
  each bucket of parameter grads; it packs them into one flat buffer,
  all-reduces it once and scales it by ``scale`` (1/N);
- ``c_allgather_selected_rows``: the same rewrite puts one after each
  grad that may hold ``SelectedRows`` (an ``is_sparse`` embedding's):
  every rank's rows, values and validity flags all-gathered in rank
  order and the values scaled by ``scale`` (1/N), so the sparse update
  sums the global batch's mean grad;
- Megatron's conjugate pair, which pass ``tp_shard`` puts around the
  split matmuls: ``c_identity`` (the identity forward, its grad summed
  over the axis) before a column-split weight, ``mp_allreduce_sum`` (a
  sum over the axis forward, the identity grad) after a row-split one;
- ``c_concat``: the ranks' ``X`` concatenated on ``axis`` in axis order
  (the vocab-split logits), its grad the rank's slice;
- ``c_embedding``: the lookup of a vocab-split table, rows
  ``[start_index, start_index + rows)``; an id outside them looks up
  zeros (the ``mp_allreduce_sum`` after it sums the ranks' rows); with
  ``is_sparse`` its grad is a ``SelectedRows`` over the shard's rows
  whose out-of-shard slots are invalid (dropped by every consumer);
- the sequence split's three, which pass ``sp_shard`` puts in
  (``parallel.sp`` says why their grads are scaled so): ``sp_split``
  (a whole tensor's ``sp`` chunk of dim ``dim``; its grad, the chunks'
  grads all-gathered and divided by the axis size), ``sp_gather`` (the
  chunks all-gathered on ``dim``; its grad, the reduce-scatter sum)
  and ``sp_replicate`` (a whole tensor read by a split op: the identity,
  its grad the ranks' partial grads summed and divided by the axis
  size).

The functions :func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`broadcast_`, :func:`ring_shift` and
:func:`all_to_all` are the same collectives on tensors, for the sync
batch norm, dygraph ``DataParallel``, the tensor-parallel GPT module,
the sequence-parallel attention ops and the pipeline schedule
(``ops.pipeline_ops``: the neighbour shifts on ``pp``, both ways, and
the broadcasts from one stage).
"""
import warnings

import torch

from ..framework.registry import register_grad_lower, register_op
from ..framework.selected_rows import SelectedRows
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
    if name not in _mesh.AXES:
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
    active layout; axis None: the mesh's ranks, the whole world by
    default) communicates."""
    if not _mesh.is_initialized():
        return False
    return _mesh.axis_world_size(axis, mesh) > 1


def _group(axis, mesh=None):
    return _mesh.axis_group(axis, mesh)


def _size(axis, mesh=None):
    return _mesh.axis_world_size(axis, mesh)


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


def reduce_scatter(t, axis="dp", dim=0, mesh=None):
    """The sum over the ranks of ``axis`` of ``mesh`` (default: the
    active layout) of ``t``, this rank's 1/N slice of dim ``dim``."""
    if not _live(axis, mesh):
        return t
    n = _size(axis, mesh)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide by the {n} ranks")
    t = t.movedim(dim, 0).contiguous() if dim else t.contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    _dist().reduce_scatter_tensor(out, t, group=_group(axis, mesh))
    return out.movedim(0, dim) if dim else out


def ring_shift(t, axis="sp", mesh=None, reverse=False):
    """``t`` sent to the next rank of ``axis`` (index ``s + 1``) and the
    previous rank's (``s - 1``) received, around the ring (``reverse``:
    sent to ``s - 1``, received from ``s + 1``): one
    ``all_to_all_single`` whose only non-zero splits are the two
    neighbours, which NCCL runs as one grouped send and receive on the
    axis group's own communicator (so a CUDA graph captures it once the
    warm-up has issued it, as it does the other collectives). A new
    tensor; ``t`` itself outside a world or on an axis of one rank."""
    if not _live(axis, mesh):
        return t
    n = _size(axis, mesh)
    s = _mesh.axis_rank(axis, mesh)
    t = t.contiguous()
    rows = t.numel()
    send = [0] * n
    recv = [0] * n
    step = -1 if reverse else 1
    send[(s + step) % n] = rows
    recv[(s - step) % n] = rows
    out = torch.empty_like(t)
    _dist().all_to_all_single(out.view(-1), t.view(-1),
                              output_split_sizes=recv,
                              input_split_sizes=send,
                              group=_group(axis, mesh))
    return out


def all_to_all(t, split_dim, concat_dim, axis="sp", mesh=None):
    """The tiled all-to-all of ``axis``: ``t``'s dim ``split_dim`` cut
    into N pieces, piece ``j`` sent to index ``j``, and the pieces
    received concatenated on ``concat_dim`` in index order (JAX's
    ``lax.all_to_all(..., tiled=True)``). ``t`` itself outside a world
    or on an axis of one rank."""
    if not _live(axis, mesh):
        return t
    n = _size(axis, mesh)
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of "
                         f"{tuple(t.shape)} does not divide by the {n} "
                         f"ranks")
    shape = list(t.shape)
    piece = shape[split_dim] // n
    # [..., n, piece, ...] with the n pieces leading: piece j to index j
    v = t.reshape(shape[:split_dim] + [n, piece] + shape[split_dim + 1:])
    v = v.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(v)
    _dist().all_to_all_single(out, v, group=_group(axis, mesh))
    # out[j] is index j's piece (t's dim i at i + 1): n goes just
    # before concat_dim and merges with it, index-major
    out = out.movedim(0, concat_dim)
    got = list(out.shape)
    merged = got[:concat_dim] + [got[concat_dim] * got[concat_dim + 1]] \
        + got[concat_dim + 2:]
    return out.reshape(merged)


def broadcast_(t, root=0, axis="dp", mesh=None):
    """``t`` overwritten in place with that of index ``root`` of this
    rank's ``axis`` group of ``mesh`` (default: the active layout; axis
    None: of the mesh's ranks, the whole world by default); returns
    ``t``."""
    if _live(axis, mesh):
        _dist().broadcast(t, src=_mesh.axis_global_rank(axis, root, mesh),
                          group=_group(axis, mesh))
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


def all_gather_selected_rows(sr, axis, scale=1.0, mesh=None):
    """The ranks' ``SelectedRows`` over ``axis`` concatenated in axis order
    (rows, values and ``valid`` flags, each one all-gather of a static
    shape), the values times ``scale``: the union a sparse update sums.
    ``sr`` itself (scaled) outside a world."""
    values = sr.values * scale if scale != 1.0 else sr.values
    if not _live(axis, mesh):
        return SelectedRows(sr.rows, values, sr.valid)
    valid = None
    if sr.valid is not None:
        valid = all_gather(sr.valid.to(torch.uint8), axis, 0, mesh).bool()
    return SelectedRows(all_gather(sr.rows, axis, 0, mesh),
                        all_gather(values, axis, 0, mesh), valid)


@register_op("c_allgather_selected_rows", grad=False, infer_shape=False)
def c_allgather_selected_rows(ctx, ins, attrs):
    """The data-parallel sync of a sparse grad (pass ``dp_grad_allreduce``
    puts one after each grad that may hold ``SelectedRows``): every
    rank's (rows, values) over the op's ring gathered in rank order,
    which is the global batch's, the values scaled by ``scale``
    (``1/nranks``), so the update sums the global batch's mean grad. A
    grad that is dense at run time (a table read densely too) is
    all-reduced and scaled as the buckets do. In a world of 1 only the
    scale applies."""
    axis = _in_world(ctx, attrs)
    scale = float(attrs.get("scale", 1.0))
    outs = []
    for x in ins["X"]:
        if isinstance(x, SelectedRows):
            outs.append(all_gather_selected_rows(x, axis, scale) if axis
                        else x._replace(values=x.values * scale))
        elif axis:
            outs.append(all_reduce(x.clone(), "sum", axis) * scale)
        else:
            outs.append(x * scale if scale != 1.0 else x)
    return {"Out": outs}


def hierarchical(mesh):
    """Whether ``hier_allreduce`` decomposes its sum on ``mesh`` (the
    executor's hierarchical path in the JAX package): ``dcn_dp`` above 1,
    no axis but ``dcn_dp`` and ``dp``, and ``FLAGS_dcn_hierarchical``
    on. Elsewhere the op is one all-reduce over the joint group."""
    from ..flags import flag
    return mesh is not None and mesh.dcn_dp > 1 and \
        set(mesh.axis_names) <= {"dcn_dp", "dp"} and \
        bool(flag("dcn_hierarchical"))


@register_op("hier_allreduce", grad=False)
def hier_allreduce(ctx, ins, attrs):
    """The multi-slice gradient sync of one grad (the JAX op's numbers;
    pass ``hier_grad_sync`` puts one after each parameter grad's last
    producer). On a mesh where :func:`hierarchical` holds: ``X``
    flattened and padded to a multiple of the ``inner_axis`` size (dp),
    reduce-scattered over ``inner_axis``, this rank's 1/dp shard
    all-reduced over ``outer_axis`` (dcn_dp: the hop across slices
    carries ``|g| / dp``), all-gathered over ``inner_axis`` and
    un-padded. Elsewhere (``FLAGS_dcn_hierarchical`` off, the flat A/B
    baseline of the same program, or ``tp``, ``sp``, ``pp`` or ``ep``
    beside ``dcn_dp``) one all-reduce over the joint group
    ``<outer_axis>+<inner_axis>``. ``mean`` (default) divides by the
    group's size. The identity in a world of 1 and on a group of one
    rank."""
    x = x_of(ins)
    inner = attrs.get("inner_axis", "dp")
    outer = attrs.get("outer_axis", "dcn_dp")
    if getattr(ctx, "abstract", False) or not _mesh.is_initialized():
        return {"Out": x}
    mesh = _mesh.world_mesh()
    n, m = mesh.axis_size(inner), mesh.axis_size(outer)
    group = n * m
    if group == 1:
        return {"Out": x}
    if hierarchical(mesh) and inner == "dp" and outer == "dcn_dp":
        flat = x.reshape(-1)
        pad = (-flat.numel()) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        shard = reduce_scatter(flat, inner, 0, mesh)
        all_reduce(shard, "sum", outer, mesh)      # the hop: |g| / dp
        out = all_gather(shard, inner, 0, mesh)
        if pad:
            out = out[:x.numel()]
        out = out.view(x.shape)
    else:
        out = all_reduce(x.clone(), "sum", f"{outer}+{inner}", mesh)
    if attrs.get("mean", True) and out.is_floating_point():
        out = out / group
    return {"Out": out}


@register_op("alltoall")
def alltoall(ctx, ins, attrs):
    """``X``'s dim 0 cut into N blocks, block ``j`` sent to index ``j``
    of the op's ring axis and the blocks received stacked in index order
    (JAX's ``lax.all_to_all(..., split_axis=0, concat_axis=0)``): the
    input's shape. The identity outside a world."""
    x = x_of(ins)
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": x}
    return {"Out": all_to_all(x, 0, 0, axis)}


@register_grad_lower("alltoall")
def alltoall_grad(ctx, ins, attrs):
    """The same all-to-all: block ``j`` of the grad goes back to the
    index it came from."""
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, attrs["__fwd_op__"]["attrs"])
    if not axis:
        return {"X@GRAD": [g]}
    return {"X@GRAD": [all_to_all(g, 0, 0, axis)]}


@register_op("sharding_constraint")
def sharding_constraint(ctx, ins, attrs):
    """A layout hint (the ``spec`` attr, sanitised by
    ``layers.collective.shard``): the value itself (pass ``sp_shard``
    replaces the first one that names ``sp`` by ``sp_split``)."""
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


# ------------------------------------------ sequence parallelism (sp_shard)

def _sp_dim(x, attrs):
    return int(attrs.get("dim", 1)) % x.dim()


@register_op("sp_split")
def sp_split(ctx, ins, attrs):
    """This rank's chunk of dim ``dim`` of the whole ``X`` on the axis
    (``axis_name``, ``sp``); ``nranks`` sizes it in shape inference."""
    x = x_of(ins)
    dim = _sp_dim(x, attrs)
    if getattr(ctx, "abstract", False):
        shape = list(x.shape)
        shape[dim] //= int(attrs.get("nranks") or 1)
        return {"Out": x.new_empty(shape)}
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": x}
    n = _mesh.axis_world_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"sp_split: dim {dim} of {tuple(x.shape)} is not "
                         f"divisible by the {n} ranks of {axis!r}")
    piece = x.shape[dim] // n
    return {"Out": x.narrow(dim, _mesh.axis_rank(axis) * piece,
                            piece).contiguous()}


@register_grad_lower("sp_split")
def sp_split_grad(ctx, ins, attrs):
    fattrs = attrs["__fwd_op__"]["attrs"]
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, fattrs)
    if not axis:
        return {"X@GRAD": [g]}
    n = _mesh.axis_world_size(axis)
    return {"X@GRAD": [all_gather(g, axis, _sp_dim(g, fattrs)) / n]}


@register_op("sp_gather")
def sp_gather(ctx, ins, attrs):
    """The axis's chunks of ``X`` all-gathered on dim ``dim`` in index
    order (the whole tensor on every rank)."""
    x = x_of(ins)
    dim = _sp_dim(x, attrs)
    if getattr(ctx, "abstract", False):
        shape = list(x.shape)
        shape[dim] *= int(attrs.get("nranks") or 1)
        return {"Out": x.new_empty(shape)}
    axis = _in_world(ctx, attrs)
    if not axis:
        return {"Out": x}
    return {"Out": all_gather(x, axis, dim)}


@register_grad_lower("sp_gather")
def sp_gather_grad(ctx, ins, attrs):
    fattrs = attrs["__fwd_op__"]["attrs"]
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, fattrs)
    if not axis:
        return {"X@GRAD": [g]}
    return {"X@GRAD": [reduce_scatter(g, axis, _sp_dim(g, fattrs))]}


@register_op("sp_replicate")
def sp_replicate(ctx, ins, attrs):
    """A whole tensor as a split op reads it: the identity; its grad,
    the ranks' partial grads summed over the axis and divided by its
    size."""
    _ring_axis(ctx, attrs)
    return {"Out": x_of(ins)}


@register_grad_lower("sp_replicate")
def sp_replicate_grad(ctx, ins, attrs):
    g = x_of(ins, "Out@GRAD")
    axis = _in_world(ctx, attrs["__fwd_op__"]["attrs"])
    if not axis:
        return {"X@GRAD": [g]}
    g = all_reduce(g.clone(), "sum", axis)
    return {"X@GRAD": [g / _mesh.axis_world_size(axis)]}


def _local_ids(ids, rows, start=0, padding_idx=None):
    """(``ids`` made local to the rows ``[start, start + rows)`` of a
    vocab-split table, the mask of the ids that are in them and are not
    ``padding_idx``, a global id). An id outside the rows wraps into
    them (modulo ``rows``): the ranks' other ids spread over the rows
    as their own do, where a clamp would pile them onto one row, whose
    run of duplicates CUDA's sorted ``index_put_`` accumulate walks one
    by one."""
    local = ids.long() - int(start)
    keep = (local >= 0) & (local < rows)
    if padding_idx is not None and int(padding_idx) >= 0:
        keep = keep & (ids.long() != int(padding_idx))
    return torch.remainder(local, rows), keep


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
    ``lookup_table``'s). With ``is_sparse`` it is the ``SelectedRows`` of
    every id over the shard's local rows, in the ids' order: an id
    outside the shard is an invalid slot (``valid`` False, its row
    wrapped into the shard), which every sparse consumer drops, so a
    lazy update touches exactly the shard's rows the batch names."""
    fattrs = attrs["__fwd_op__"]["attrs"]
    w, g = x_of(ins, "W"), x_of(ins, "Out@GRAD")
    ids = _ids(ins)
    local, keep = _local_ids(ids, w.shape[0], fattrs.get("start_index", 0),
                             fattrs.get("padding_idx"))
    flat_g = torch.where(keep.reshape(-1, 1),
                         g.reshape(-1, w.shape[-1]), 0.0).to(w.dtype)
    if fattrs.get("is_sparse", False):
        _, inside = _local_ids(ids, w.shape[0], fattrs.get("start_index", 0))
        return {"W@GRAD": [SelectedRows(local.reshape(-1), flat_g,
                                        inside.reshape(-1))]}
    return {"W@GRAD": [torch.zeros_like(w).index_put_(
        (local.reshape(-1),), flat_g, accumulate=True)]}


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


__all__ = ["all_gather", "all_gather_selected_rows", "all_reduce",
           "all_to_all", "broadcast_",
           "reduce_scatter", "register_ring", "ring_shift", "vocab_lookup"]
