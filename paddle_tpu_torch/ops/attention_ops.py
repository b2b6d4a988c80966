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

The kernel route's grad is bespoke: the forward keeps its ``out`` and
``lse2`` for the grad op (``LowerCtx.save_for_grad``), which launches
the backward kernels on them, so a training step runs K1 once per layer
(the generic vjp would recompute the forward). ``impl="xla"`` takes the
generic vjp of the composite.
"""
import torch

from ..framework.registry import (OPS, generic_grad_lower,
                                  register_grad_lower, register_op)
from ..kernels.flash_attention import (flash_attention_bwd,
                                       flash_attention_fwd,
                                       flash_attention_ref,
                                       flash_attention_train)
from .common import x_of


def _key_bias(bias):
    return bias is None or (bias.dim() == 4 and bias.shape[1] == 1
                            and bias.shape[2] == 1)


def _route(ins, attrs):
    """(q, k, v, bias, scale, causal, impl) of one op: ``impl`` "xla"
    (the composite) or "" (the kernels)."""
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
    return q, k, v, bias, scale, causal, "" if impl == "pallas" else impl


@register_op("flash_attention", infer_shape=False)
def flash_attention_op(ctx, ins, attrs):
    q, k, v, bias, scale, causal, impl = _route(ins, attrs)
    if impl == "xla":
        bias = None if bias is None else bias.detach()
        return {"Out": flash_attention_ref(q, k, v, bias, scale,
                                           causal)[0]}
    out, lse2 = flash_attention_train(q, k, v, bias, scale, causal,
                                      return_lse2=True)
    if ctx.op is not None:
        ctx.save_for_grad(ctx.op.output("Out")[0], (out, lse2))
    return {"Out": out}


@register_grad_lower("flash_attention")
def flash_attention_grad(ctx, ins, attrs):
    """dq, dk, dv from the backward kernels (K2, or K3 then K4) on the
    forward's saved ``out`` and ``lse2``; where nothing was saved (the
    forward ran in another run) K1 runs again for them. The bias gets
    zeros."""
    fwd = attrs["__fwd_op__"]
    q, k, v, bias, scale, causal, impl = _route(ins, fwd["attrs"])
    if impl == "xla":
        return generic_grad_lower(ctx, ins, attrs, OPS["flash_attention"])
    saved = ctx.take_saved(fwd["outputs"]["Out"][0])
    out, lse2 = saved if saved is not None \
        else flash_attention_fwd(q, k, v, bias, scale, causal)
    dO = x_of(ins, "Out@GRAD").to(q.dtype)
    grads = dict(zip("QKV", flash_attention_bwd(q, k, v, bias, scale,
                                                causal, out, lse2, dO)))
    if bias is not None:
        grads["Bias"] = torch.zeros_like(bias)
    return {slot + "@GRAD": [grads[slot]]
            for slot, need in attrs["__grad_inputs__"].items() if any(need)}
