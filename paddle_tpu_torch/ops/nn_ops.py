"""NN ops in torch (counterpart of ``paddle_tpu/ops/nn_ops.py``:
``layer_norm :406``, ``dropout :479``, ``lookup_table :513`` with the
dense scatter-add grad of ``:850-860``, ``softmax_with_cross_entropy
:555``) and ``gelu`` (``activation_ops.py``, exact erf form)."""
import torch
import torch.nn.functional as F

from ..framework.registry import register_grad_lower, register_op
from .common import x_of


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


@register_op("lookup_table")
def lookup_table(ctx, ins, attrs):
    """ids with a trailing ``[..., 1]`` dim are squeezed (v1 layout);
    int32 ids index directly."""
    w, ids = x_of(ins, "W"), x_of(ins, "Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    out = F.embedding(ids, w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids != padding_idx)[..., None], out, 0.0)
    return {"Out": out}


@register_grad_lower("lookup_table")
def lookup_table_grad(ctx, ins, attrs):
    """Dense W grad: the upstream rows scatter-added into a zero table,
    deterministically (``is_sparse`` row sets are not in this port
    yet)."""
    fattrs = attrs["__fwd_op__"]["attrs"]
    if fattrs.get("is_sparse", False):
        raise NotImplementedError("paddle_tpu_torch: is_sparse embedding "
                                  "grads are not ported")
    w, ids, g = x_of(ins, "W"), x_of(ins, "Ids"), x_of(ins, "Out@GRAD")
    if ids.dim() >= 2 and ids.shape[-1] == 1 and g.dim() == ids.dim():
        ids = ids[..., 0]
    flat_ids = ids.reshape(-1).long()
    flat_g = g.reshape(-1, w.shape[-1]).to(w.dtype)
    padding_idx = fattrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        flat_g = torch.where((flat_ids != padding_idx)[:, None], flat_g,
                             0.0)
    # index_put_ with accumulate sums a row's duplicates in a fixed
    # order (sorted ids) on CUDA, where index_add_ takes atomics in any
    # order: the grad is the same bits from run to run
    return {"W@GRAD": [torch.zeros_like(w).index_put_(
        (flat_ids,), flat_g, accumulate=True)]}


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


@register_op("gelu")
def gelu(ctx, ins, attrs):
    return {"Out": F.gelu(x_of(ins), approximate="tanh"
                          if attrs.get("approximate", False) else "none")}
