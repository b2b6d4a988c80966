"""NN ops in torch (counterpart of ``paddle_tpu/ops/nn_ops.py``:
``conv2d :24-98``, ``pool2d :206``, ``batch_norm :352``, ``layer_norm
:406``, ``dropout :479``, ``lookup_table :513`` and ``lookup_table_v2
:501`` with the dense scatter-add grad of ``:850-860``, ``cross_entropy
:537``, ``softmax_with_cross_entropy :555``) and ``gelu``
(``activation_ops.py``, exact erf form).

Convolutions go to cuDNN through ``F.conv2d``, as the JAX package leaves
them to XLA (no Pallas kernel computes one). ``conv2d`` and
``batch_norm`` have bespoke grads (``aten.convolution_backward``;
``aten.native_batch_norm_backward`` on the forward's saved statistics):
the generic vjp would run every forward conv again in the backward.
Under ``FLAGS_cudnn_deterministic`` both take cuDNN's deterministic
algorithms only. ``pool2d`` takes the generic vjp. ``conv2d_transpose``,
``depthwise_conv2d`` and ``conv3d`` are not ported (unregistered: an op
of theirs raises ``NotImplementedError``)."""
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
    mask as the forward."""
    x = x_of(ins)
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if p == 0.0:
        return {"Out": x, "Mask": torch.ones_like(x)}
    if attrs.get("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(x)}
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
