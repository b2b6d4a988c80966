"""Activation ops in torch (counterpart of
``paddle_tpu/ops/activation_ops.py``: ``relu :23``, ``sigmoid :24``,
``tanh :25``,
``exp :26``, ``rsqrt :32``, ``floor :36``, ``ceil :37``, ``cos :41``,
``square :33``, ``log :27``, ``pow :81``, ``softmax :89``,
``log_softmax :95``). Each takes the generic vjp grad, as in the
JAX package; ``floor`` and ``ceil`` have none."""
import torch

from ..framework.registry import register_op
from .common import x_of


@register_op("relu")
def relu(ctx, ins, attrs):
    return {"Out": torch.relu(x_of(ins))}


@register_op("sigmoid")
def sigmoid(ctx, ins, attrs):
    return {"Out": torch.sigmoid(x_of(ins))}


@register_op("exp")
def exp(ctx, ins, attrs):
    return {"Out": torch.exp(x_of(ins))}


@register_op("log")
def log(ctx, ins, attrs):
    return {"Out": torch.log(x_of(ins))}


@register_op("square")
def square(ctx, ins, attrs):
    return {"Out": torch.square(x_of(ins))}


@register_op("floor", grad=False)
def floor(ctx, ins, attrs):
    return {"Out": torch.floor(x_of(ins))}


@register_op("ceil", grad=False)
def ceil(ctx, ins, attrs):
    return {"Out": torch.ceil(x_of(ins))}


@register_op("cos")
def cos(ctx, ins, attrs):
    return {"Out": torch.cos(x_of(ins))}


@register_op("pow")
def pow_op(ctx, ins, attrs):
    """``x ** factor``; the factor may come as a ``FactorTensor``."""
    f = x_of(ins, "FactorTensor")
    return {"Out": torch.pow(x_of(ins), attrs.get("factor", 1.0)
                             if f is None else f)}


@register_op("tanh")
def tanh(ctx, ins, attrs):
    return {"Out": torch.tanh(x_of(ins))}


@register_op("rsqrt")
def rsqrt(ctx, ins, attrs):
    return {"Out": torch.rsqrt(x_of(ins))}


@register_op("softmax")
def softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(x_of(ins), dim=attrs.get("axis", -1))}


@register_op("log_softmax")
def log_softmax(ctx, ins, attrs):
    return {"Out": torch.log_softmax(x_of(ins), dim=attrs.get("axis", -1))}
