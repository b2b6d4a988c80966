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
in a fixed order.

The file also ports the JAX module's other ops: the
v1 names that saved programs use (``reshape``, ``transpose``, ``split``,
``squeeze``, ``unsqueeze``, ``flatten``, ``flatten_contiguous_range``,
``feed``, ``fetch``), the shape and fill ops (``shape``,
``fill_constant_batch_size_like :62``, ``fill_zeros_like``, ``range
:393``, ``one_hot``/``one_hot_v2 :371``, ``randint``, ``meshgrid``,
``diag_v2``, ``tril_triu``), indexing and sorting (``gather_nd``,
``scatter``, ``index_select``, ``argsort``, ``arg_min``, ``top_k_v2``,
``cumsum``, ``unstack``, ``unique``, which raises as the JAX op does)
and layout (``flip``/``reverse``, ``roll``, ``tile``, ``expand_v2``,
``expand_as``/``expand_as_v2``, ``pad``, ``pad2d``, ``strided_slice``).
Every size they take (a ``range``'s bounds, a ``one_hot``'s depth, a
``strided_slice``'s starts) is a static attribute, as in the JAX
package, so none reads a tensor on the host. Index outputs keep the
dtype the IR declares (int64 for ``argsort``, ``arg_min``, ``range``
and ``randint``), where the JAX package, with x64 off, stores int32;
``top_k_v2`` gives int32 as ``top_k`` does. The random
``uniform_random_batch_size_like`` and ``gaussian_random_batch_size_like``
(``paddle_tpu/ops/longtail_ops.py:202-222``) come with them, for their
layers."""
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.dtype import torch_dtype
from ..framework.registry import register_grad_lower, register_op
from ..framework.selected_rows import (coalesce, is_selected_rows,
                                       masked_values)
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
    return {"Out": masked_values(x) if is_selected_rows(x) else x}


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


def _constant(ctx, vals):
    """``vals`` (numpy) as a device tensor, made once per value and
    device and kept for the process: a host-to-device copy cannot be
    captured in a CUDA graph, so a captured program reads the kept
    tensor (no op writes a tensor in place)."""
    key = (str(ctx.device), vals.dtype.str, vals.shape, vals.tobytes())
    out = _CONSTANTS.get(key)
    if out is None:
        out = torch.from_numpy(vals.copy()).to(ctx.device)
        if not ctx.abstract:
            _CONSTANTS[key] = out
    return out


@register_op("assign_value", grad=False)
def assign_value(ctx, ins, attrs):
    """A constant tensor from the ``values`` attr (``layers.assign`` of a
    numpy array; ``_constant``)."""
    shape = [int(s) for s in attrs.get("shape") or ()]
    vals = np.asarray(attrs["values"], dtype=attrs["dtype"])
    if shape:
        vals = vals.reshape(shape)
    return {"Out": _constant(ctx, vals)}


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


# ---- v1 names of saved programs -------------------------------------------

@register_op("reshape")
def reshape(ctx, ins, attrs):
    """v1 ``reshape2`` (no ``XShape``)."""
    return {"Out": reshape2(ctx, ins, attrs)["Out"]}


@register_op("transpose")
def transpose(ctx, ins, attrs):
    x = x_of(ins)
    return {"Out": x.permute(*attrs.get("axis", attrs.get("perm")))}


for _v1, _v2 in (("squeeze", squeeze2), ("unsqueeze", unsqueeze2),
                 ("flatten", flatten2)):
    register_op(_v1)(_v2)


@register_op("flatten_contiguous_range")
def flatten_contiguous_range(ctx, ins, attrs):
    """Dims ``start_axis..stop_axis`` folded into one."""
    x = x_of(ins)
    nd = max(x.dim(), 1)
    start = attrs.get("start_axis", 1) % nd
    stop = attrs.get("stop_axis", -1) % nd
    shape = tuple(x.shape[:start]) + (math.prod(x.shape[start:stop + 1]),) \
        + tuple(x.shape[stop + 1:])
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("split")
def split(ctx, ins, attrs):
    """``num`` equal parts, or the listed ``sections``, along ``axis``
    (views of the input)."""
    x = x_of(ins)
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections") or []
    if sections:
        return {"Out": list(x.split([int(s) for s in sections], dim=axis))}
    num = int(attrs.get("num", 0))
    if x.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of size {x.shape[axis]} is "
                         f"not divisible into {num} parts")
    return {"Out": list(x.split(x.shape[axis] // num, dim=axis))}


@register_op("feed", grad=False, infer_shape=False)
def feed(ctx, ins, attrs):
    return None             # the executor binds feeds into the env


@register_op("fetch", grad=False, infer_shape=False)
def fetch(ctx, ins, attrs):
    return {"Out": x_of(ins)}


# ---- shape and fill ops ---------------------------------------------------

@register_op("shape", grad=False)
def shape_op(ctx, ins, attrs):
    """The input's shape, int32 ``[ndim]``: static metadata, kept as a
    constant tensor (``_constant``)."""
    return {"Out": _constant(ctx, np.asarray(x_of(ins, "Input").shape,
                                             dtype=np.int32))}


@register_op("fill_constant_batch_size_like", grad=False)
def fill_constant_batch_size_like(ctx, ins, attrs):
    """``fill_constant`` whose dim ``output_dim_idx`` copies the input's
    dim ``input_dim_idx``."""
    ref = x_of(ins, "Input")
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=torch_dtype(attrs.get("dtype",
                                                          "float32")),
                              device=ctx.device)}


@register_op("fill_zeros_like", grad=False)
def fill_zeros_like(ctx, ins, attrs):
    return {"Out": torch.zeros_like(x_of(ins))}


@register_op("range", grad=False)
def range_op(ctx, ins, attrs):
    """``arange(start, end, step)`` from the static attrs."""
    return {"Out": torch.arange(attrs.get("start", 0), attrs["end"],
                                attrs.get("step", 1),
                                dtype=torch_dtype(attrs.get("dtype",
                                                            "int64")),
                                device=ctx.device)}


def _one_hot(x, depth, attrs):
    """One-hot rows of ``x`` (an index outside ``[0, depth)`` gives a
    zero row, as ``jax.nn.one_hot``), by comparison with an arange, so
    no host check of the indices runs."""
    hot = x.long()[..., None] == torch.arange(int(depth), device=x.device)
    return hot.to(torch_dtype(attrs.get("dtype", "float32")))


@register_op("one_hot_v2", grad=False)
def one_hot_v2(ctx, ins, attrs):
    """v2: the depth axis is appended ([N, 1] -> [N, 1, depth])."""
    return {"Out": _one_hot(x_of(ins), attrs["depth"], attrs)}


@register_op("one_hot", grad=False)
def one_hot(ctx, ins, attrs):
    """v1: a trailing size-1 dim is replaced by the depth axis ([N, 1]
    -> [N, depth])."""
    x = x_of(ins)
    if x.dim() >= 1 and x.shape[-1] == 1:
        x = x[..., 0]
    return {"Out": _one_hot(x, attrs["depth"], attrs)}


@register_op("randint", grad=False, needs_rng=True)
def randint(ctx, ins, attrs):
    """Integers uniform in ``[low, high)`` from the op's generator."""
    shape = tuple(int(s) for s in attrs["shape"])
    return {"Out": torch.randint(
        attrs.get("low", 0), attrs.get("high", 100), shape,
        generator=ctx.generator(attrs), device=ctx.device,
        dtype=torch_dtype(attrs.get("dtype", "int64")))}


@register_op("meshgrid")
def meshgrid(ctx, ins, attrs):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@register_op("diag_v2", grad=False)
def diag_v2(ctx, ins, attrs):
    """A 1-D input's diagonal matrix, or a 2-D input's diagonal, at
    ``offset`` (``jnp.diag``)."""
    return {"Out": torch.diag(x_of(ins), attrs.get("offset", 0))}


@register_op("tril_triu")
def tril_triu(ctx, ins, attrs):
    x, k = x_of(ins), attrs.get("diagonal", 0)
    return {"Out": torch.tril(x, k) if attrs.get("lower", True)
            else torch.triu(x, k)}


# ---- indexing and sorting -------------------------------------------------

@register_op("gather_nd")
def gather_nd(ctx, ins, attrs):
    """``x[index[..., 0], index[..., 1], ...]``: the index's last dim
    addresses X's leading dims."""
    index = x_of(ins, "Index").long()
    return {"Out": x_of(ins)[tuple(index.movedim(-1, 0))]}


@register_op("scatter")
def scatter(ctx, ins, attrs):
    """X with rows ``Ids`` set to (``overwrite``) or increased by
    ``Updates``."""
    x, ids = x_of(ins), x_of(ins, "Ids")
    if ids.dim() == 2 and ids.shape[1] == 1:
        ids = ids[:, 0]
    return {"Out": x.index_put((ids.long(),), x_of(ins, "Updates"),
                               accumulate=not attrs.get("overwrite",
                                                        True))}


@register_op("index_select")
def index_select(ctx, ins, attrs):
    """``jnp.take(x, index, axis=dim)``."""
    x, index = x_of(ins), x_of(ins, "Index")
    dim = attrs.get("dim", 0) % x.dim()
    out = x.index_select(dim, index.reshape(-1).long())
    return {"Out": out.reshape(tuple(x.shape[:dim]) + tuple(index.shape)
                               + tuple(x.shape[dim + 1:]))}


@register_op("argsort", grad=False)
def argsort(ctx, ins, attrs):
    """Stable sort along ``axis`` (descending sorts ``-x``, so ties keep
    their order, as in the JAX op): the sorted values and their
    indices."""
    x = x_of(ins)
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    idx = torch.argsort(key, dim=axis, stable=True)
    return {"Out": torch.take_along_dim(x, idx, dim=axis),
            "Indices": idx}


@register_op("arg_min", grad=False)
def arg_min(ctx, ins, attrs):
    """The index of the first smallest element along ``axis``."""
    out = torch.argmin(x_of(ins), dim=attrs.get("axis", -1),
                       keepdim=bool(attrs.get("keepdims", False)))
    return {"Out": out.to(torch_dtype(attrs.get("dtype", "int64")))}


@register_op("top_k_v2", grad=False)
def top_k_v2(ctx, ins, attrs):
    """The k largest (``largest``) or smallest along ``axis``; int32
    indices as ``top_k``."""
    x = x_of(ins)
    vals, idx = torch.topk(x, attrs["k"], dim=attrs.get("axis", -1) % x.dim(),
                           largest=attrs.get("largest", True))
    return {"Out": vals, "Indices": idx.to(torch.int32)}


@register_op("cumsum")
def cumsum(ctx, ins, attrs):
    """Running sum along ``axis`` in x's type (``flatten`` first,
    ``reverse``, ``exclusive`` as the JAX op)."""
    x = x_of(ins)
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    if attrs.get("reverse", False):
        out = x.flip(axis).cumsum(axis, dtype=x.dtype).flip(axis)
    else:
        out = x.cumsum(axis, dtype=x.dtype)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": out}


@register_op("unstack")
def unstack(ctx, ins, attrs):
    return {"Y": list(x_of(ins).unbind(attrs.get("axis", 0)))}


@register_op("unique", grad=False, infer_shape=False)
def unique(ctx, ins, attrs):
    raise NotImplementedError(
        "unique has data-dependent output shape; the JAX package "
        "refuses it too (use the static-shape unique_with_counts, Queue 1 "
        "item 10)")


# ---- layout ---------------------------------------------------------------

@register_op("flip")
def flip(ctx, ins, attrs):
    return {"Out": torch.flip(x_of(ins), list(attrs["axis"]))}


register_op("reverse")(flip)


@register_op("roll")
def roll(ctx, ins, attrs):
    """``jnp.roll``: no ``axis`` rolls the flattened tensor."""
    axis = attrs.get("axis")
    shifts = attrs["shifts"]
    if not axis:
        return {"Out": torch.roll(x_of(ins), shifts)}
    return {"Out": torch.roll(x_of(ins), shifts, list(axis))}


@register_op("tile")
def tile(ctx, ins, attrs):
    return {"Out": torch.tile(x_of(ins),
                              tuple(int(t) for t in attrs["repeat_times"]))}


@register_op("expand_v2")
def expand_v2(ctx, ins, attrs):
    """Broadcast to ``shape`` (a -1 keeps the input's dim)."""
    x = x_of(ins)
    shape = list(attrs["shape"])
    xshape = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    tgt = tuple(xs if s == -1 else int(s) for s, xs in zip(shape, xshape))
    return {"Out": x.reshape(xshape).expand(tgt)}


@register_op("expand_as_v2")
def expand_as_v2(ctx, ins, attrs):
    """X tiled so each dim becomes the target's (an integer multiple of
    X's dim); the target is ``target_shape``, or the ``Y`` (v2) or
    ``target_tensor`` (v1) input's shape."""
    x = x_of(ins)
    shape = attrs.get("target_shape")
    if shape is None:
        shape = (ins.get("Y") or ins["target_tensor"])[0].shape
    shape = tuple(int(s) for s in shape)
    xshape = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    if any(t % xs for t, xs in zip(shape, xshape)):
        raise ValueError(
            f"expand_as: target {shape} must be integer multiples of "
            f"input {tuple(x.shape)} per dim")
    return {"Out": x.reshape(xshape).repeat(
        *[t // xs for t, xs in zip(shape, xshape)])}


register_op("expand_as")(expand_as_v2)


@register_op("pad")
def pad(ctx, ins, attrs):
    """Constant padding; ``paddings`` is ``[lo0, hi0, lo1, hi1, ...]``."""
    x = x_of(ins)
    p = [int(v) for v in attrs["paddings"]]
    widths = []
    for i in reversed(range(x.dim())):
        widths += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, widths, value=attrs.get("pad_value", 0.0))}


@register_op("pad2d")
def pad2d(ctx, ins, attrs):
    """NCHW padding by ``[top, bottom, left, right]``: ``constant``,
    ``reflect`` or ``edge`` (replicate)."""
    t, b, lft, r = (int(v) for v in attrs["paddings"])
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": F.pad(x_of(ins), [lft, r, t, b],
                             value=attrs.get("pad_value", 0.0))}
    return {"Out": F.pad(x_of(ins), [lft, r, t, b],
                         mode={"reflect": "reflect",
                               "edge": "replicate"}[mode])}


@register_op("strided_slice")
def strided_slice(ctx, ins, attrs):
    """``x[s:e:st]`` on each listed axis, python slice semantics; a
    negative stride takes the flipped input's forward slice (torch views
    take positive steps only)."""
    x = x_of(ins, "Input")
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        n = x.shape[a]
        start, stop, step = slice(s, e, st).indices(n)
        idx = [slice(None)] * x.dim()
        if step > 0:
            idx[a] = slice(start, stop, step)
            x = x[tuple(idx)]
        else:
            idx[a] = slice(n - 1 - start, n - 1 - stop, -step)
            x = x.flip(a)[tuple(idx)]
    return {"Out": x}


def _batch_size_like_shape(ins, attrs):
    shape = [int(v) for v in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        x_of(ins, "Input").shape[int(attrs.get("input_dim_idx", 0))]
    return tuple(shape)


@register_op("uniform_random_batch_size_like", grad=False,
             infer_shape=False, needs_rng=True)
def uniform_random_batch_size_like(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(_batch_size_like_shape(ins, attrs),
                     generator=ctx.generator(attrs),
                     dtype=torch_dtype(attrs.get("dtype", "float32")),
                     device=ctx.device)
    return {"Out": out * (hi - lo) + lo}


@register_op("gaussian_random_batch_size_like", grad=False,
             infer_shape=False, needs_rng=True)
def gaussian_random_batch_size_like(ctx, ins, attrs):
    out = torch.randn(_batch_size_like_shape(ins, attrs),
                      generator=ctx.generator(attrs),
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    return {"Out": out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)}
