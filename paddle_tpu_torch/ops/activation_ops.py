"""Activation ops in torch (counterpart of
``paddle_tpu/ops/activation_ops.py``: ``tanh :25``, ``rsqrt :32``,
``softmax :89``). Each takes the generic vjp grad, as in the JAX
package."""
import torch

from ..framework.registry import register_op
from .common import x_of


@register_op("tanh")
def tanh(ctx, ins, attrs):
    return {"Out": torch.tanh(x_of(ins))}


@register_op("rsqrt")
def rsqrt(ctx, ins, attrs):
    return {"Out": torch.rsqrt(x_of(ins))}


@register_op("softmax")
def softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(x_of(ins), dim=attrs.get("axis", -1))}
