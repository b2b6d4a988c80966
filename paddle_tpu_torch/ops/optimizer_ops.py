"""Optimizer update ops in torch (counterpart of
``paddle_tpu/ops/optimizer_ops.py``: ``adam :76``, dense path). Each op
returns new param/moment tensors that rebind the same names in the env,
as the JAX lowering does."""
import torch

from ..framework.registry import register_op
from .common import x_of


@register_op("adam", grad=False)
def adam(ctx, ins, attrs):
    p, g, lr = x_of(ins, "Param"), x_of(ins, "Grad"), \
        x_of(ins, "LearningRate")
    m1, m2 = x_of(ins, "Moment1"), x_of(ins, "Moment2")
    b1p, b2p = x_of(ins, "Beta1Pow"), x_of(ins, "Beta2Pow")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    if attrs.get("lazy_mode", False):
        raise NotImplementedError("paddle_tpu_torch: lazy (sparse) adam "
                                  "is not ported")
    g = g.to(p.dtype)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr.to(p.dtype) * torch.sqrt(1 - b2p.to(p.dtype)) / \
        (1 - b1p.to(p.dtype))
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": p_new, "Moment1Out": m1n, "Moment2Out": m2n,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}
