"""NN ops in torch (counterpart of ``paddle_tpu/ops/nn_ops.py``:
``conv2d :24-98``, ``pool2d :206``, ``batch_norm :352``,
``sync_batch_norm :397`` (all-reducing its statistics), ``layer_norm
:406``, ``dropout :479``, ``lookup_table :513`` and ``lookup_table_v2
:501`` with the dense scatter-add grad of ``:850-860``, ``cross_entropy
:537``, ``softmax_with_cross_entropy :555``, the fused recurrent cells
``lstm_cell_fused :793`` and ``gru_cell_fused :811``, ``bicubic_interp
:726``, ``trilinear_interp :734`` and ``grid_sampler :742``) and
``gelu`` (``activation_ops.py``, exact erf form).

Convolutions go to cuDNN through ``F.conv2d``, as the JAX package leaves
them to XLA (no Pallas kernel computes one). ``conv2d`` and
``batch_norm`` have bespoke grads (``aten.convolution_backward``;
``aten.native_batch_norm_backward`` on the forward's saved statistics):
the generic vjp would run every forward conv again in the backward.
Under ``FLAGS_cudnn_deterministic`` both take cuDNN's deterministic
algorithms only. ``pool2d`` takes the generic vjp. ``conv2d_transpose``,
``depthwise_conv2d`` and ``conv3d`` are not ported (unregistered: an op
of theirs raises ``NotImplementedError``).

Also what the core layers reach: ``embedding`` (v1,
``:528``), the losses ``smooth_l1_loss :599``, ``huber_loss``,
``log_loss``, ``bce_loss``, ``kldiv_loss``, ``mse_loss``,
``margin_rank_loss`` and ``nll_loss :673``, ``label_smooth :693``,
``pixel_shuffle :765`` and the resizes ``interp_nearest``/
``nearest_interp`` and ``bilinear_interp :705-724`` (the sampling of
``jax.image.resize``: half-pixel centres, antialiased bilinear when
shrinking). The other image ops of the JAX module stay with Queue 1
item 10: ``conv2d_transpose``, ``depthwise_conv2d(_transpose)``,
``conv3d(_transpose)``, ``deformable_conv(_v1)``,
``max_pool2d_with_index``, ``max_pool3d_with_index``, ``unpool``,
``group_norm``, ``instance_norm``, ``spectral_norm``, ``prelu``,
``affine_grid`` and ``temporal_shift``. ``unfold`` and ``space_to_depth``
(``paddle_tpu/ops/extra_ops.py:140-174``) are here too, for the layers
of the same names."""
import math

import torch
import torch.nn.functional as F

from ..flags import flag
from ..framework.registry import register_grad_lower, register_op
from ..framework.selected_rows import SelectedRows
from .common import normalize_padding, x_of


# --------------------------------------------------------------------------
# Convolution and pooling
# --------------------------------------------------------------------------

def _window_pads(attrs, hw, ksize, strides, dilations):
    """((top, bottom), (left, right)) of a conv or pool window: the
    ``paddings`` attr (EXPLICIT), none (VALID), or XLA's SAME split (the
    output is ceil(in / stride), the odd pixel goes after)."""
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "VALID":
        return ((0, 0), (0, 0))
    if algo == "SAME":
        pads = []
        for n, k, s, d in zip(hw, ksize, strides, dilations):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    return normalize_padding(attrs.get("paddings", [0, 0]), 2)


def _pad_input(x, pads, value=0.0, native_max=None):
    """(input, padding argument) for a torch conv/pool call: symmetric
    pads go to the call (up to ``native_max`` per dim, a pooling call's
    limit); others are applied here with ``value``."""
    (t, b), (l, r) = pads
    if t == b and l == r and (native_max is None or
                              (t <= native_max[0] and l <= native_max[1])):
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _conv_args(x, w, attrs):
    if attrs.get("data_format", "NCHW") not in ("NCHW", "AnyLayout"):
        raise NotImplementedError(
            f"paddle_tpu_torch: conv2d data_format "
            f"{attrs['data_format']!r} is not ported (NCHW only)")
    strides = tuple(attrs.get("strides", [1, 1]))
    dilations = tuple(attrs.get("dilations", [1, 1]))
    pads = _window_pads(attrs, x.shape[2:], w.shape[2:], strides,
                        dilations)
    return strides, dilations, int(attrs.get("groups", 1)), pads


def _cudnn(fn):
    """``fn()`` with cuDNN held to deterministic algorithms while
    ``FLAGS_cudnn_deterministic`` is on (its wgrad and dgrad otherwise
    may sum in another order from call to call)."""
    if not flag("cudnn_deterministic") or torch.backends.cudnn.deterministic:
        return fn()
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = False


@register_op("conv2d")
def conv2d(ctx, ins, attrs):
    """NCHW input, OIHW filter; EXPLICIT (2 or 4 paddings), SAME or VALID
    padding, strides, dilations and groups."""
    x, w = x_of(ins, "Input"), x_of(ins, "Filter")
    strides, dilations, groups, pads = _conv_args(x, w, attrs)
    xp, pad = _pad_input(x, pads)
    return {"Output": _cudnn(lambda: F.conv2d(xp, w, None, strides, pad,
                                              dilations, groups))}


@register_grad_lower("conv2d")
def conv2d_grad(ctx, ins, attrs):
    """dInput and dFilter, each only where asked for, from one
    ``aten.convolution_backward`` (cuDNN's dgrad and wgrad); no forward
    recompute."""
    req = attrs["__grad_inputs__"]
    x, w = x_of(ins, "Input"), x_of(ins, "Filter")
    strides, dilations, groups, pads = _conv_args(
        x, w, attrs["__fwd_op__"]["attrs"])
    xp, pad = _pad_input(x, pads)
    need_x, need_w = any(req.get("Input", ())), any(req.get("Filter", ()))
    dx, dw, _ = _cudnn(lambda: torch.ops.aten.convolution_backward(
        x_of(ins, "Output@GRAD").to(x.dtype), xp, w, None, strides, pad,
        dilations, False, [0, 0], groups, [need_x, need_w, False]))
    out = {}
    if need_x:
        if xp is not x:         # the grad of the padding is dropped
            (t, _), (l, _) = pads
            dx = dx[:, :, t:t + x.shape[2], l:l + x.shape[3]]
        out["Input@GRAD"] = [dx]
    if need_w:
        out["Filter@GRAD"] = [dw]
    return out


@register_op("pool2d")
def pool2d(ctx, ins, attrs):
    """Max pooling pads with -inf; average pooling divides a window by
    its real (unpadded) elements when ``exclusive``, by the window's size
    otherwise. ``global_pooling`` reduces H and W; ``adaptive`` takes
    divisible sizes only. The JAX op reads no ``ceil_mode``: the port
    computes the floor shape and raises on ``ceil_mode=True``."""
    x = x_of(ins)
    if attrs.get("ceil_mode", False):
        raise NotImplementedError("paddle_tpu_torch: pool2d ceil_mode is "
                                  "not ported (the floor shape only)")
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", ksize))
    adaptive = attrs.get("adaptive", False)
    if attrs.get("global_pooling", False) or (adaptive and ksize == [1, 1]):
        if ptype == "max":
            return {"Out": x.amax(dim=(2, 3), keepdim=True)}
        return {"Out": x.mean(dim=(2, 3), keepdim=True)}
    if adaptive:
        n, c, h, w = x.shape
        oh, ow = ksize
        if h % oh or w % ow:
            raise NotImplementedError(
                "adaptive pool needs divisible spatial dims")
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        return {"Out": xr.amax(dim=(3, 5)) if ptype == "max"
                else xr.mean(dim=(3, 5))}
    pads = _window_pads(attrs, x.shape[2:], ksize, strides, (1, 1))
    half = (ksize[0] // 2, ksize[1] // 2)     # torch's padding limit
    if ptype == "max":
        xp, pad = _pad_input(x, pads, -math.inf, half)
        return {"Out": F.max_pool2d(xp, ksize, strides, pad)}
    exclusive = attrs.get("exclusive", True)
    xp, pad = _pad_input(x, pads, 0.0, half)
    if xp is x or not exclusive:
        return {"Out": F.avg_pool2d(xp, ksize, strides, pad,
                                    count_include_pad=not exclusive)}
    # padded here: sums over the counts of real elements
    area = ksize[0] * ksize[1]
    ssum = F.avg_pool2d(xp, ksize, strides) * area
    ones = F.pad(torch.ones_like(x[:1, :1]), (pads[1][0], pads[1][1],
                                                pads[0][0], pads[0][1]))
    return {"Out": ssum / (F.avg_pool2d(ones, ksize, strides) * area)}


# --------------------------------------------------------------------------
# Batch normalization
# --------------------------------------------------------------------------

def _bn_layout(x, attrs):
    """(channel axis, reduced axes, broadcast shape of a channel
    vector)."""
    caxis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" \
        else x.dim() - 1
    bshape = [1] * x.dim()
    bshape[caxis] = x.shape[caxis]
    return caxis, tuple(i for i in range(x.dim()) if i != caxis), bshape


def _bn_train(attrs):
    return not (attrs.get("is_test", False)
                or attrs.get("use_global_stats", False))


@register_op("batch_norm")
def batch_norm(ctx, ins, attrs):
    """Statistics always in float32; the normalize runs in ``x.dtype``
    with the float32 ``rsqrt`` cast down after it is taken (so bf16 AMP
    can white-list batch_norm). Train mode: the batch's mean and
    population variance; ``MeanOut``/``VarianceOut`` (which rebind the
    persistable ``Mean``/``Variance``) are ``running * momentum + batch *
    (1 - momentum)``, Paddle's momentum (0.9 = torch's 0.1), computed
    here rather than by torch, whose running update takes the unbiased
    variance. ``SavedVariance`` is ``rsqrt(var + eps)``. Test mode
    (``is_test`` / ``use_global_stats``) normalizes with the running
    statistics."""
    x = x_of(ins)
    scale, bias = x_of(ins, "Scale"), x_of(ins, "Bias")
    mean, var = x_of(ins, "Mean"), x_of(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    _, axes, bshape = _bn_layout(x, attrs)
    if _bn_train(attrs):
        v, m = torch.var_mean(x.float(), dim=axes, correction=0)
        mean_out = mean * momentum + m.to(mean.dtype) * (1 - momentum)
        var_out = var * momentum + v.to(var.dtype) * (1 - momentum)
        saved_m, saved_v = m, torch.rsqrt(v + eps)
        if ctx.op is not None and ctx.op.type == "batch_norm":
            ctx.save_for_grad(ctx.op.output("Y")[0], (saved_m, saved_v))
    else:
        m = mean
        mean_out, var_out = mean, var
        saved_m, saved_v = mean, torch.rsqrt(var + eps)
    dt = x.dtype
    y = (x - m.reshape(bshape).to(dt)) * saved_v.reshape(bshape).to(dt)
    y = y * scale.reshape(bshape).to(dt) + bias.reshape(bshape).to(dt)
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": saved_m, "SavedVariance": saved_v}


@register_grad_lower("batch_norm")
def batch_norm_grad(ctx, ins, attrs):
    """dX, dScale and dBias, each only where asked for, from
    ``aten.native_batch_norm_backward`` on the forward's saved float32
    mean and ``rsqrt(var + eps)`` (train mode; taken again from X when
    the forward ran in another run) or on the running statistics (test
    mode)."""
    fwd = attrs["__fwd_op__"]
    fattrs = fwd["attrs"]
    req = attrs["__grad_inputs__"]
    x, scale = x_of(ins), x_of(ins, "Scale")
    mean, var = x_of(ins, "Mean"), x_of(ins, "Variance")
    eps = fattrs.get("epsilon", 1e-5)
    caxis, axes, _ = _bn_layout(x, fattrs)
    train = _bn_train(fattrs)
    saved = ctx.take_saved(fwd["outputs"]["Y"][0]) if train else None
    if train and saved is None:
        v, m = torch.var_mean(x.float(), dim=axes, correction=0)
        saved = (m, torch.rsqrt(v + eps))
    sm, sv = saved if train else (None, None)
    mask = [any(req.get(s, ())) for s in ("X", "Scale", "Bias")]
    g = x_of(ins, "Y@GRAD").to(x.dtype)
    dx, dscale, dbias = torch.ops.aten.native_batch_norm_backward(
        g.movedim(caxis, 1), x.movedim(caxis, 1), scale, mean, var, sm, sv,
        train, eps, mask)
    out = {}
    for slot, need, val in (("X", mask[0], dx), ("Scale", mask[1], dscale),
                            ("Bias", mask[2], dbias)):
        if need:
            out[slot + "@GRAD"] = [val.movedim(1, caxis) if slot == "X"
                                   else val]
    return out


def _global_stats(x, running_mean, attrs):
    """(mean, population variance, count) of ``x`` over every rank's
    rows, float32, from one all-reduce of the shifted per-rank sums."""
    from .collective_ops import all_reduce
    caxis, axes, _ = _bn_layout(x, attrs)
    C = x.shape[caxis]
    n = x.numel() // C
    v, m = torch.var_mean(x.float(), dim=axes, correction=0)
    k = running_mean.float()
    d = m - k
    stats = torch.cat([n * d, n * (v + d * d),
                       torch.full((1,), float(n), device=x.device)])
    all_reduce(stats, "sum", _DATA)
    count = stats[2 * C]
    md = stats[:C] / count
    return k + md, (stats[C:2 * C] / count - md * md).clamp_min(0.0), count


#: the ranks a sync batch norm's statistics span: every data replica
#: (dcn_dp x dp; dp alone without a dcn_dp axis)
_DATA = "dcn_dp+dp"


def _sync_bn_world(ctx, attrs):
    """Whether a sync_batch_norm reduces across ranks: train mode, real
    tensors, a launched world."""
    from ..parallel import mesh
    return (_bn_train(attrs) and not getattr(ctx, "abstract", False)
            and mesh.is_initialized())


def _card_path(x, attrs):
    """Whether a sync batch norm takes torch's fused CUDA kernels: a
    CUDA tensor with the channels on dim 1."""
    return x.is_cuda and _bn_layout(x, attrs)[0] == 1


def _card_stats(x, eps):
    """(mean, population variance, rsqrt(var + eps), per-rank counts)
    over every rank's rows on the card: torch's ``batch_norm_stats`` per
    rank (float32), one all-gather of (mean, invstd, count), and their
    exact combination:
    ``mean = sum n_r m_r / N``, ``var = sum n_r (v_r + (m_r - mean)^2) /
    N``."""
    from .collective_ops import all_gather
    C = x.shape[1]
    m, inv = torch.batch_norm_stats(x, eps)
    n = torch.full((1,), float(x.numel() // C), device=x.device,
                   dtype=m.dtype)
    allst = all_gather(torch.cat([m, inv, n])[None], _DATA)
    ms, invs, counts = allst[:, :C], allst[:, C:2 * C], allst[:, 2 * C:]
    total = counts.sum()
    gm = (counts * ms).sum(0) / total
    vs = invs.reciprocal().square() - eps
    gv = ((counts * (vs + (ms - gm).square())).sum(0) / total).clamp_min(0.0)
    return gm, gv, torch.rsqrt(gv + eps), counts.view(-1)


@register_op("sync_batch_norm")
def sync_batch_norm(ctx, ins, attrs):
    """Batch norm over the global batch of a data-parallel world
    (reference operators/sync_batch_norm_op.cu). Under GSPMD the JAX
    package's ``batch_norm`` already takes the cross-replica mean
    (``paddle_tpu/ops/nn_ops.py:397-403``). The statistics are float32.
    On the CPU each rank's statistics, shifted by the running mean (the
    same on every rank), are all-reduced in one call: ``n (m - K)``, ``n
    (v + (m - K)^2)`` and ``n`` per channel, from which the global mean
    and population variance follow. On the card torch's fused sync
    batch-norm kernels do the arithmetic (:func:`_card_stats`, then
    ``batch_norm_elemt``), with one all-gather of (mean, invstd, count)
    per rank. The Paddle-momentum running update and the saved
    ``rsqrt(var + eps)`` are :func:`batch_norm`'s. Test mode
    (``is_test``, ``use_global_stats``) and a world of 1 without a
    process group are :func:`batch_norm` itself."""
    if not _sync_bn_world(ctx, attrs):
        return batch_norm(ctx, ins, attrs)
    x = x_of(ins)
    scale, bias = x_of(ins, "Scale"), x_of(ins, "Bias")
    mean, var = x_of(ins, "Mean"), x_of(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    _, _, bshape = _bn_layout(x, attrs)
    if _card_path(x, attrs):
        gm, gv, inv, counts = _card_stats(x, eps)
        y = torch.batch_norm_elemt(x, scale, bias, gm, inv, eps)
        saved = (gm, inv, counts.to(torch.int32))
    else:
        gm, gv, count = _global_stats(x, mean, attrs)
        inv = torch.rsqrt(gv + eps)
        dt = x.dtype
        y = (x - gm.reshape(bshape).to(dt)) * inv.reshape(bshape).to(dt)
        y = y * scale.reshape(bshape).to(dt) + bias.reshape(bshape).to(dt)
        saved = (gm, inv, count)
    mean_out = mean * momentum + gm.to(mean.dtype) * (1 - momentum)
    var_out = var * momentum + gv.to(var.dtype) * (1 - momentum)
    if ctx.op is not None and ctx.op.type == "sync_batch_norm":
        ctx.save_for_grad(ctx.op.output("Y")[0], saved)
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": gm, "SavedVariance": inv}


@register_grad_lower("sync_batch_norm")
def sync_batch_norm_grad(ctx, ins, attrs):
    """dX over the global batch, dScale and dBias of this rank's rows
    (the data-parallel grad all-reduce sums them). Per channel, this
    rank's ``sum dy`` and ``sum dy (x - mean)`` in float32 are
    all-reduced in one call; then ``dx = scale * rsqrt(var + eps) * (dy -
    sum dy / N - (x - mean) rsqrt(var + eps)^2 sum dy (x - mean) / N)``
    with the global sums and count N: plain PyTorch on the CPU, torch's
    ``batch_norm_backward_reduce`` and ``batch_norm_backward_elemt`` on
    the card. Test mode and a world of 1 without a process group take
    :func:`batch_norm_grad`."""
    fattrs = attrs["__fwd_op__"]["attrs"]
    if not _sync_bn_world(ctx, fattrs):
        return batch_norm_grad(ctx, ins, attrs)
    from .collective_ops import all_reduce
    fwd = attrs["__fwd_op__"]
    req = attrs["__grad_inputs__"]
    x, scale = x_of(ins), x_of(ins, "Scale")
    eps = fattrs.get("epsilon", 1e-5)
    caxis, axes, bshape = _bn_layout(x, fattrs)
    C = x.shape[caxis]
    card = _card_path(x, fattrs)
    saved = ctx.take_saved(fwd["outputs"]["Y"][0])
    if saved is None:
        # the forward ran in another run: its statistics again
        if card:
            gm, _, inv, counts = _card_stats(x, eps)
            saved = (gm, inv, counts.to(torch.int32))
        else:
            gm, gv, count = _global_stats(x, x_of(ins, "Mean"), fattrs)
            saved = (gm, torch.rsqrt(gv + eps), count)
    need = [any(req.get(s, ())) for s in ("X", "Scale", "Bias")]
    out = {}
    if card:
        gm, inv, counts = saved
        g = x_of(ins, "Y@GRAD").to(x.dtype)
        sum_dy, sum_dy_xmu, dscale, dbias = torch.batch_norm_backward_reduce(
            g, x, gm, inv, scale, True, True, True)
        if need[0]:
            red = all_reduce(torch.cat([sum_dy, sum_dy_xmu]), "sum", _DATA)
            out["X@GRAD"] = [torch.batch_norm_backward_elemt(
                g, x, gm, inv, scale, red[:C], red[C:], counts)]
    else:
        gm, inv, count = saved
        g = x_of(ins, "Y@GRAD").float()
        xmu = x.float() - gm.reshape(bshape)
        sums = torch.cat([g.sum(dim=axes), (g * xmu).sum(dim=axes)])
        dbias, dscale = sums[:C].clone(), sums[C:] * inv
        all_reduce(sums, "sum", _DATA)
        if need[0]:
            mdy = (sums[:C] / count).reshape(bshape)
            k = (inv * inv * sums[C:] / count).reshape(bshape)
            dx = (g - mdy - xmu * k) * (scale.float() * inv).reshape(bshape)
            out["X@GRAD"] = [dx.to(x.dtype)]
    if need[1]:
        out["Scale@GRAD"] = [dscale.to(scale.dtype)]
    if need[2]:
        out["Bias@GRAD"] = [dbias.to(scale.dtype)]
    return out


@register_op("layer_norm")
def layer_norm(ctx, ins, attrs):
    """Stats in float32, output in the input's type; ``Mean`` and
    ``Variance`` (population) over the normalized dims."""
    x = x_of(ins)
    scale, bias = x_of(ins, "Scale"), x_of(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    xf = x.float()
    m = xf.mean(dim=axes, keepdim=True)
    v = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.float().reshape(norm_shape)
    if bias is not None:
        y = y + bias.float().reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {"Y": y.to(x.dtype), "Mean": m.reshape(lead),
            "Variance": v.reshape(lead)}


@register_op("dropout", needs_rng=True)
def dropout(ctx, ins, attrs):
    """The keep mask is drawn from the op's own generator
    (``LowerCtx.generator``), so the grad op's recompute draws the same
    mask as the forward. With ``sp_chunk`` ``[dim, n, r]`` (pass
    ``sp_shard``) ``X`` is chunk ``r`` of ``n`` of dim ``dim``: the
    whole tensor's mask is drawn and the chunk's part kept."""
    x = x_of(ins)
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if p == 0.0:
        return {"Out": x, "Mask": torch.ones_like(x)}
    if attrs.get("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(x)}
    chunk = attrs.get("sp_chunk")
    if chunk:
        # the rank's chunk of the whole tensor's mask (pass sp_shard)
        dim, n, r = (int(c) for c in chunk)
        shape = list(x.shape)
        shape[dim] *= n
        u = torch.rand(shape, generator=ctx.generator(attrs),
                       dtype=torch.float32, device=x.device).narrow(
            dim, r * x.shape[dim], x.shape[dim])
    else:
        u = torch.rand(x.shape, generator=ctx.generator(attrs),
                       dtype=torch.float32, device=x.device)
    keep = u < (1.0 - p)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    else:
        out = x * keep.to(x.dtype)
    return {"Out": out, "Mask": keep.to(x.dtype)}


@register_op("lookup_table_v2")
def lookup_table_v2(ctx, ins, attrs):
    """Rows of ``W`` at ``Ids`` (any shape); int32 ids index directly;
    ``padding_idx`` rows are zeros."""
    w, ids = x_of(ins, "W"), x_of(ins, "Ids")
    out = F.embedding(ids, w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids != padding_idx)[..., None], out, 0.0)
    return {"Out": out}


@register_op("lookup_table")
def lookup_table(ctx, ins, attrs):
    """``lookup_table_v2`` with the v1 layout: ids with a trailing
    ``[..., 1]`` dim are squeezed."""
    ids = x_of(ins, "Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ins = {**ins, "Ids": [ids[..., 0]]}
    return lookup_table_v2(ctx, ins, attrs)


@register_grad_lower("lookup_table")
def lookup_table_grad(ctx, ins, attrs):
    """W's grad: with ``is_sparse`` the ``SelectedRows`` of the looked-up
    ids and their upstream rows (no ``[vocab, dim]`` table is made);
    else the upstream rows scatter-added into a zero table,
    deterministically. ``padding_idx`` rows get zeros either way."""
    fattrs = attrs["__fwd_op__"]["attrs"]
    w, ids, g = x_of(ins, "W"), x_of(ins, "Ids"), x_of(ins, "Out@GRAD")
    if ids.dim() >= 2 and ids.shape[-1] == 1 and g.dim() == ids.dim():
        ids = ids[..., 0]
    flat_ids = ids.reshape(-1).long()
    flat_g = g.reshape(-1, w.shape[-1])
    padding_idx = fattrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        flat_g = torch.where((flat_ids != padding_idx)[:, None], flat_g,
                             0.0)
    if fattrs.get("is_sparse", False):
        return {"W@GRAD": [SelectedRows(flat_ids, flat_g)]}
    # index_put_ with accumulate sums a row's duplicates in a fixed
    # order (sorted ids) on CUDA, where index_add_ takes atomics in any
    # order: the grad is the same bits from run to run
    return {"W@GRAD": [torch.zeros_like(w).index_put_(
        (flat_ids,), flat_g.to(w.dtype), accumulate=True)]}


register_grad_lower("lookup_table_v2")(lookup_table_grad)


@register_op("cross_entropy")
def cross_entropy(ctx, ins, attrs):
    """``-log(max(X[label], 1e-20))`` over probabilities ``X``; a label
    equal to ``ignore_index`` gives 0 (its index is clamped into range
    for the gather first)."""
    x, label = x_of(ins), x_of(ins, "Label")
    if attrs.get("soft_label", False):
        return {"Y": -torch.sum(label * torch.log(x.clamp_min(1e-20)),
                                dim=-1, keepdim=True)}
    if label.dim() == x.dim():
        label = label[..., 0]
    lbl = label.long().unsqueeze(-1)
    picked = torch.take_along_dim(x, lbl.clamp(0, x.shape[-1] - 1), dim=-1)
    loss = -torch.log(picked.clamp_min(1e-20))
    return {"Y": torch.where(lbl == attrs.get("ignore_index", -100), 0.0,
                             loss)}


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = x_of(ins, "Logits"), x_of(ins, "Label")
    axis = attrs.get("axis", -1)
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim():
            lbl = lbl.squeeze(axis)
        idx = lbl.long().unsqueeze(axis)
        loss = -torch.take_along_dim(logp, idx, dim=axis)
        ignore = attrs.get("ignore_index", -100)
        if ignore >= 0:
            loss = torch.where(idx == ignore, 0.0, loss)
    return {"Softmax": softmax, "Loss": loss}


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """The stable sigmoid binary cross-entropy of logits X against
    ``Label``: ``max(x, 0) - x label + log1p(exp(-|x|))``; 0 where the
    label is ``ignore_index``; ``normalize`` divides by the count of
    other labels (at least 1)."""
    x, label = x_of(ins), x_of(ins, "Label")
    loss = (torch.maximum(x, x.new_zeros(())) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label == ignore, 0.0, loss)
    if attrs.get("normalize", False):
        norm = torch.clamp_min(torch.sum((label != ignore).to(x.dtype)),
                               1.0)
        loss = loss / norm
    return {"Out": loss}


@register_op("square_error_cost")
def square_error_cost(ctx, ins, attrs):
    return {"Out": torch.square(x_of(ins) - x_of(ins, "Y"))}


@register_op("gelu")
def gelu(ctx, ins, attrs):
    return {"Out": F.gelu(x_of(ins), approximate="tanh"
                          if attrs.get("approximate", False) else "none")}


@register_op("lstm_cell_fused")
def lstm_cell_fused(ctx, ins, attrs):
    """One LSTM step, the x/h projections fused: Gates = [X, HPrev] @ W +
    B, split (i, f, c_hat, o) as the JAX package packs them."""
    x, h_prev, c_prev = x_of(ins), x_of(ins, "HPrev"), x_of(ins, "CPrev")
    gates = torch.cat([x, h_prev], dim=-1) @ x_of(ins, "W") + x_of(ins, "B")
    i, f, c_hat, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + float(attrs.get("forget_bias", 0.0))) * c_prev \
        + torch.sigmoid(i) * torch.tanh(c_hat)
    return {"H": torch.sigmoid(o) * torch.tanh(c), "C": c}


@register_op("gru_cell_fused")
def gru_cell_fused(ctx, ins, attrs):
    """One GRU step, fused: update and reset (u, r) from [X, HPrev] @
    WGate; the candidate from [X, r * HPrev] @ WCand. u gates the
    candidate (``origin_mode`` False) or the previous state (True)."""
    x, h_prev = x_of(ins), x_of(ins, "HPrev")
    gates = torch.sigmoid(torch.cat([x, h_prev], dim=-1) @ x_of(ins, "WGate")
                          + x_of(ins, "BGate"))
    u, r = gates.chunk(2, dim=-1)
    cand = torch.tanh(torch.cat([x, r * h_prev], dim=-1)
                      @ x_of(ins, "WCand") + x_of(ins, "BCand"))
    if attrs.get("origin_mode", False):
        return {"H": u * h_prev + (1.0 - u) * cand}
    return {"H": u * cand + (1.0 - u) * h_prev}


@register_op("grid_sampler")
def grid_sampler(ctx, ins, attrs):
    """Bilinear sampling of x [B, C, H, W] at grid [B, Hg, Wg, 2]
    locations in [-1, 1], corners aligned; taps outside the image read
    zero (``F.grid_sample``'s ``align_corners=True``, zero padding)."""
    return {"Out": F.grid_sample(x_of(ins), x_of(ins, "Grid"),
                                 mode="bilinear", padding_mode="zeros",
                                 align_corners=True)}


def _triangle(d):
    return torch.clamp(1.0 - d, min=0.0)


def _keys_cubic(d):
    """Keys' cubic convolution kernel with a = -0.5."""
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0,
                      (1.5 * d - 2.5) * d * d + 1.0)
    return torch.where(d >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, kernel, dtype, device):
    """[n_in, n_out] resampling weights of ``jax.image.resize`` (half-pixel
    centres; antialiased when shrinking, the kernel widened by the
    scale; each output's weights normalised; an output whose centre
    lies outside the input gets none)."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    f = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) \
        * inv - 0.5
    d = (f[None, :] - torch.arange(n_in, dtype=torch.float64,
                                   device=device)[:, None]).abs() / width
    w = kernel(d)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(
        torch.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (f >= -0.5) & (f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(dtype)


def _resize(x, sizes, kernel):
    """x resized on its trailing len(sizes) dims, each dim whose size
    changes by one weight-matrix product (``jax.image.resize``)."""
    first = x.dim() - len(sizes)
    for k, n_out in enumerate(sizes):
        dim = first + k
        if x.shape[dim] == n_out:
            continue
        w = _resize_weights(x.shape[dim], n_out, kernel, x.dtype, x.device)
        x = torch.tensordot(x.movedim(dim, -1), w, dims=1).movedim(-1, dim)
    return x


@register_op("bicubic_interp")
def bicubic_interp(ctx, ins, attrs):
    """x [B, C, H, W] resized to (out_h, out_w) with Keys' cubic kernel,
    as ``jax.image.resize(method="bicubic")``."""
    return {"Out": _resize(x_of(ins), (attrs["out_h"], attrs["out_w"]),
                           _keys_cubic)}


@register_op("trilinear_interp")
def trilinear_interp(ctx, ins, attrs):
    """x [B, C, D, H, W] resized to (out_d, out_h, out_w) with the
    triangle kernel, as ``jax.image.resize(method="trilinear")``."""
    return {"Out": _resize(x_of(ins), (attrs["out_d"], attrs["out_h"],
                                       attrs["out_w"]), _triangle)}


register_op("embedding")(lookup_table_v2)
register_grad_lower("embedding")(lookup_table_grad)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

@register_op("smooth_l1_loss")
def smooth_l1_loss(ctx, ins, attrs):
    """Per-row sum of the smooth L1 of ``X - Y`` (quadratic below
    ``1 / sigma^2``); ``Diff`` is ``X - Y``."""
    x, y = x_of(ins), x_of(ins, "Y")
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = torch.abs(x - y)
    loss = torch.where(diff < 1.0 / s2, 0.5 * s2 * torch.square(diff),
                       diff - 0.5 / s2)
    return {"Out": loss.sum(-1, keepdim=True), "Diff": x - y}


@register_op("huber_loss")
def huber_loss(ctx, ins, attrs):
    x, y = x_of(ins), x_of(ins, "Y")
    d = attrs.get("delta", 1.0)
    r = y - x
    return {"Out": torch.where(torch.abs(r) <= d, 0.5 * torch.square(r),
                               d * (torch.abs(r) - 0.5 * d)),
            "Residual": r}


@register_op("log_loss")
def log_loss(ctx, ins, attrs):
    p, label = x_of(ins, "Predicted"), x_of(ins, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": -label * torch.log(p + eps)
            - (1 - label) * torch.log(1 - p + eps)}


@register_op("bce_loss")
def bce_loss(ctx, ins, attrs):
    x, label = x_of(ins), x_of(ins, "Label")
    return {"Out": -(label * torch.log(x.clamp_min(1e-12))
                     + (1 - label) * torch.log((1 - x).clamp_min(1e-12)))}


@register_op("kldiv_loss")
def kldiv_loss(ctx, ins, attrs):
    """``target * (log(target) - x)`` reduced by ``reduction`` (mean,
    sum, batchmean or none)."""
    x, target = x_of(ins), x_of(ins, "Target")
    loss = target * (torch.log(target.clamp_min(1e-12)) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / x.shape[0]
    return {"Loss": loss}


@register_op("mse_loss")
def mse_loss(ctx, ins, attrs):
    return {"Out": torch.square(x_of(ins, "Input") - x_of(ins, "Label"))}


@register_op("margin_rank_loss")
def margin_rank_loss(ctx, ins, attrs):
    x1, x2, label = x_of(ins, "X1"), x_of(ins, "X2"), x_of(ins, "Label")
    out = torch.clamp(-label * (x1 - x2) + attrs.get("margin", 0.0),
                      min=0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("nll_loss")
def nll_loss(ctx, ins, attrs):
    """``-X[i, label[i]]`` over log-probabilities, reduced by
    ``reduction``; ``Total_weight`` is the row count."""
    x, label = x_of(ins), x_of(ins, "Label")
    loss = -torch.gather(x, 1, label.long()[:, None])[:, 0]
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    return {"Out": loss, "Total_weight": torch.full(
        (), float(x.shape[0]), dtype=x.dtype, device=x.device)}


# --------------------------------------------------------------------------
# Label smoothing, pixel shuffle, resizes
# --------------------------------------------------------------------------

@register_op("label_smooth")
def label_smooth(ctx, ins, attrs):
    """``(1 - eps) * X + eps * PriorDist`` (uniform over the last dim
    without one)."""
    x = x_of(ins)
    eps = attrs.get("epsilon", 0.1)
    dist = x_of(ins, "PriorDist")
    return {"Out": (1 - eps) * x + (eps * dist if dist is not None
                                    else eps / x.shape[-1])}


@register_op("pixel_shuffle")
def pixel_shuffle(ctx, ins, attrs):
    """[N, C r^2, H, W] -> [N, C, H r, W r] (``F.pixel_shuffle``'s
    channel order, the JAX op's)."""
    return {"Out": F.pixel_shuffle(x_of(ins),
                                   int(attrs.get("upscale_factor", 1)))}


def _nearest(x, sizes):
    """``jax.image.resize(method="nearest")`` on the trailing dims:
    output i reads input ``floor((i + 0.5) * n_in / n_out)``."""
    first = x.dim() - len(sizes)
    for k, n_out in enumerate(sizes):
        dim = first + k
        n_in = x.shape[dim]
        idx = ((torch.arange(n_out, dtype=torch.float32, device=x.device)
                + 0.5) * n_in / n_out).floor().long()
        x = x.index_select(dim, idx)
    return x


@register_op("interp_nearest")
def interp_nearest(ctx, ins, attrs):
    return {"Out": _nearest(x_of(ins), (attrs["out_h"], attrs["out_w"]))}


register_op("nearest_interp")(interp_nearest)


@register_op("bilinear_interp")
def bilinear_interp(ctx, ins, attrs):
    """x [B, C, H, W] resized to (out_h, out_w) with the triangle
    kernel, as ``jax.image.resize(method="bilinear")``."""
    return {"Out": _resize(x_of(ins), (attrs["out_h"], attrs["out_w"]),
                           _triangle)}


@register_op("unfold")
def unfold(ctx, ins, attrs):
    """im2col: [N, C, H, W] -> [N, C kh kw, L] sliding-window columns;
    ``paddings`` is [ph, pw] or [top, left, bottom, right]."""
    x = x_of(ins)
    pads = list(attrs.get("paddings", [0, 0]))
    if len(pads) == 2:
        pads = [pads[0], pads[1], pads[0], pads[1]]
    pt, pl, pb, pr = pads
    if (pt, pl) == (pb, pr):
        return {"Y": F.unfold(x, attrs["kernel_sizes"],
                              dilation=attrs.get("dilations", [1, 1]),
                              padding=(pt, pl),
                              stride=attrs.get("strides", [1, 1]))}
    return {"Y": F.unfold(F.pad(x, [pl, pr, pt, pb]),
                          attrs["kernel_sizes"],
                          dilation=attrs.get("dilations", [1, 1]),
                          stride=attrs.get("strides", [1, 1]))}


@register_op("space_to_depth")
def space_to_depth(ctx, ins, attrs):
    """[N, C, H, W] -> [N, C b^2, H/b, W/b], the channel order of the JAX
    op (block offsets outermost)."""
    x = x_of(ins)
    b = int(attrs["blocksize"])
    N, C, H, W = x.shape
    out = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": out.reshape(N, C * b * b, H // b, W // b)}
