"""Optimizer update ops in torch (counterpart of
``paddle_tpu/ops/optimizer_ops.py``: ``adam :76``, dense path, and
``fused_adam :373``). Each op returns new param/moment tensors that
rebind the same names in the env, as the JAX lowering does; no input is
written in place (a rollback's ``assign`` snapshot aliases it)."""
import torch

from ..framework.registry import register_op
from .common import x_of


def _hyper(attrs):
    if attrs.get("lazy_mode", False):
        raise NotImplementedError("paddle_tpu_torch: lazy (sparse) adam "
                                  "is not ported")
    return (attrs.get("beta1", 0.9), attrs.get("beta2", 0.999),
            attrs.get("epsilon", 1e-8))


@register_op("adam", grad=False)
def adam(ctx, ins, attrs):
    p, g, lr = x_of(ins, "Param"), x_of(ins, "Grad"), \
        x_of(ins, "LearningRate")
    m1, m2 = x_of(ins, "Moment1"), x_of(ins, "Moment2")
    b1p, b2p = x_of(ins, "Beta1Pow"), x_of(ins, "Beta2Pow")
    b1, b2, eps = _hyper(attrs)
    g = g.to(p.dtype)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr.to(p.dtype) * torch.sqrt(1 - b2p.to(p.dtype)) / \
        (1 - b1p.to(p.dtype))
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": p_new, "Moment1Out": m1n, "Moment2Out": m2n,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


@register_op("fused_adam", grad=False, infer_shape=False)
def fused_adam(ctx, ins, attrs):
    """A bucket of ``adam`` updates (``passes.FuseOptimizerPass``) over
    lists of tensors with ``torch._foreach_*``: each element takes the
    operations of :func:`adam` in the same order, so every output equals
    the per-param op's bit for bit, while a bucket is a few multi-tensor
    launches instead of ~19 per param. Where the JAX op concatenates the
    bucket (which XLA fuses away), eager torch would copy every tensor
    twice. Beta-pows come param-shaped (elementwise, as the moments) or
    scalar (a per-param step size broadcast over its param)."""
    ps = ins["Param"]
    dt = ps[0].dtype
    gs = [g.to(dt) for g in ins["Grad"]]
    # a scheduler's LR is a [1] var; the multi-tensor ops take a 0-d one
    lr = ins["LearningRate"][0].to(dt).reshape(())
    b1ps = [b.to(dt) for b in ins["Beta1Pow"]]
    b2ps = [b.to(dt) for b in ins["Beta2Pow"]]
    b1, b2, eps = _hyper(attrs)
    # m1 = b1 m1 + (1 - b1) g;  m2 = b2 m2 + (1 - b2) g^2
    m1n = torch._foreach_mul(ins["Moment1"], b1)
    torch._foreach_add_(m1n, torch._foreach_mul(gs, 1 - b1))
    m2n = torch._foreach_mul(ins["Moment2"], b2)
    gsq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(gsq, 1 - b2)
    torch._foreach_add_(m2n, gsq)
    del gsq
    # lr_t = lr sqrt(1 - b2p) / (1 - b1p); 1 - x as -x + 1 (the same
    # rounding)
    lr_t = torch._foreach_neg(b2ps)
    torch._foreach_add_(lr_t, 1)
    torch._foreach_sqrt_(lr_t)
    torch._foreach_mul_(lr_t, lr)
    den = torch._foreach_neg(b1ps)
    torch._foreach_add_(den, 1)
    torch._foreach_div_(lr_t, den)
    del den
    # p - lr_t m1 / (sqrt(m2) + eps)
    if tuple(b1ps[0].shape) == tuple(ps[0].shape):
        upd = torch._foreach_mul(lr_t, m1n)
    else:       # scalar beta-pows: broadcast each step size
        upd = [t * m for t, m in zip(lr_t, m1n)]
    den = torch._foreach_sqrt(m2n)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(upd, den)
    del den
    return {"ParamOut": torch._foreach_sub(ps, upd), "Moment1Out": m1n,
            "Moment2Out": m2n,
            "Beta1PowOut": torch._foreach_mul(ins["Beta1Pow"], b1),
            "Beta2PowOut": torch._foreach_mul(ins["Beta2Pow"], b2)}
