"""The ``flash_attention`` op (counterpart of
``paddle_tpu/ops/ring_attention_ops.py:160``).

``impl`` keeps its meaning: ``""`` is the kernel path (K1 forward, K2 or
K3 + K4 backward through ``kernels.FlashAttention``; the plain versions
on CPU tensors), ``"xla"`` the plain composite with materialized scores,
chosen explicitly and never as a fallback. The bias is a constant mask on
both paths: it gets no gradient.
"""
from ..framework.registry import register_op
from ..kernels.flash_attention import flash_attention_ref, \
    flash_attention_train
from .common import x_of


@register_op("flash_attention", infer_shape=False)
def flash_attention_op(ctx, ins, attrs):
    q, k, v = x_of(ins, "Q"), x_of(ins, "K"), x_of(ins, "V")
    bias = x_of(ins, "Bias")
    scale = float(attrs.get("scale", 0.0)) or q.shape[-1] ** -0.5
    causal = bool(attrs.get("causal", False))
    impl = attrs.get("impl") or ""
    if impl == "xla":
        bias = None if bias is None else bias.detach()
        return {"Out": flash_attention_ref(q, k, v, bias, scale,
                                           causal)[0]}
    if impl != "":
        raise ValueError(f"flash_attention: impl {impl!r} is not in "
                         f"paddle_tpu_torch (\"\" = kernels, \"xla\" = "
                         f"plain composite)")
    return {"Out": flash_attention_train(q, k, v, bias, scale, causal)}
