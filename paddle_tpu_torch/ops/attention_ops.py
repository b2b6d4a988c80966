"""The ``flash_attention`` op (counterpart of
``paddle_tpu/ops/ring_attention_ops.py:160``).

``impl`` keeps its meaning: ``""`` is the kernel path (K1 forward, K2 or
K3 + K4 backward through ``kernels.FlashAttention``; the plain versions
on CPU tensors), ``"pallas"`` an explicit request for the kernels,
``"xla"`` the plain composite with materialized scores. With ``impl``
``""`` a bias that is not a ``[B, 1, 1, Sk]`` key bias takes the
composite, as the JAX op routes it
(``paddle_tpu/kernels/flash_attention.py:604-611``): the op's defined
route by input shape, not a fallback from a kernel error; an explicit
kernel request raises for it. The bias is a constant mask on every
path: it gets no gradient.
"""
from ..framework.registry import register_op
from ..kernels.flash_attention import flash_attention_ref, \
    flash_attention_train
from .common import x_of


def _key_bias(bias):
    return bias is None or (bias.dim() == 4 and bias.shape[1] == 1
                            and bias.shape[2] == 1)


@register_op("flash_attention", infer_shape=False)
def flash_attention_op(ctx, ins, attrs):
    q, k, v = x_of(ins, "Q"), x_of(ins, "K"), x_of(ins, "V")
    bias = x_of(ins, "Bias")
    scale = float(attrs.get("scale", 0.0)) or q.shape[-1] ** -0.5
    causal = bool(attrs.get("causal", False))
    impl = attrs.get("impl") or ""
    if impl not in ("", "pallas", "xla"):
        raise ValueError(f"flash_attention: impl {impl!r} is not in "
                         f"paddle_tpu_torch (\"\" = kernels, \"pallas\" = "
                         f"kernels only, \"xla\" = plain composite)")
    if not _key_bias(bias):
        if impl == "pallas":
            raise ValueError(
                f"flash_attention impl={impl!r} supports only a "
                f"[B, 1, 1, Sk] key bias, got {tuple(bias.shape)}; use a "
                f"key mask (+ causal=True for causality) or impl='xla'")
        impl = "xla"       # a general [B,H,Sq,Sk] bias: the composite
    if impl == "xla":
        bias = None if bias is None else bias.detach()
        return {"Out": flash_attention_ref(q, k, v, bias, scale,
                                           causal)[0]}
    return {"Out": flash_attention_train(q, k, v, bias, scale, causal)}
