"""Activation ops in torch (counterpart of
``paddle_tpu/ops/activation_ops.py``: ``relu :23``, ``sigmoid :24``,
``tanh :25``,
``exp :26``, ``rsqrt :32``, ``floor :36``, ``ceil :37``, ``cos :41``,
``square :33``, ``log :27``, ``pow :81``, ``softmax :89``,
``log_softmax :95``, ``sqrt :31``, ``abs :34``, ``sign :39``). Each
takes the generic vjp grad, as in the JAX package; ``floor``, ``ceil``,
``round`` and ``sign`` have none.

The other activations of the JAX module (``:28-71``, ``maxout :101``)
follow, each with its JAX op's attributes and defaults, which are not
always ``torch.nn.functional``'s: ``leaky_relu``'s alpha is 0.02,
``brelu`` clips to [0, 24], ``stanh`` is ``1.7159 tanh(0.67 x)``,
``hard_swish`` is ``x clip(x + 3, 0, 6) / 6``, and ``selu`` takes the
fixed constants of ``jax.nn.selu`` (the JAX op reads no attribute).
``softplus`` is ``logaddexp(x, 0)`` as ``jax.nn.softplus``, with no
linear cut-off."""
import torch
import torch.nn.functional as F

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


@register_op("sqrt")
def sqrt(ctx, ins, attrs):
    return {"Out": torch.sqrt(x_of(ins))}


@register_op("abs")
def abs_op(ctx, ins, attrs):
    return {"Out": torch.abs(x_of(ins))}


@register_op("sign", grad=False)
def sign(ctx, ins, attrs):
    return {"Out": torch.sign(x_of(ins))}


@register_op("softmax")
def softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(x_of(ins), dim=attrs.get("axis", -1))}


@register_op("log_softmax")
def log_softmax(ctx, ins, attrs):
    return {"Out": torch.log_softmax(x_of(ins), dim=attrs.get("axis", -1))}


def _act(name, fn, grad=None):
    @register_op(name, grad=grad)
    def _op(ctx, ins, attrs, _fn=fn):
        return {"Out": _fn(x_of(ins), attrs)}
    return _op


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


_act("log2", lambda x, a: torch.log2(x))
_act("log10", lambda x, a: torch.log10(x))
_act("log1p", lambda x, a: torch.log1p(x))
_act("expm1", lambda x, a: torch.expm1(x))
_act("reciprocal", lambda x, a: 1.0 / x)
_act("round", lambda x, a: torch.round(x), grad=False)
_act("sin", lambda x, a: torch.sin(x))
_act("tan", lambda x, a: torch.tan(x))
_act("asin", lambda x, a: torch.asin(x))
_act("acos", lambda x, a: torch.acos(x))
_act("atan", lambda x, a: torch.atan(x))
_act("sinh", lambda x, a: torch.sinh(x))
_act("cosh", lambda x, a: torch.cosh(x))
_act("erf", lambda x, a: torch.erf(x))
_act("softplus", lambda x, a: _softplus(x))
_act("softsign", lambda x, a: x / (torch.abs(x) + 1.0))
_act("logsigmoid", lambda x, a: -_softplus(-x))
_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_act("softshrink", lambda x, a: torch.where(
    x > a.get("lambda", 0.5), x - a.get("lambda", 0.5),
    torch.where(x < -a.get("lambda", 0.5), x + a.get("lambda", 0.5),
                torch.zeros_like(x))))
_act("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)))
_act("relu6", lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)))
_act("leaky_relu", lambda x, a: F.leaky_relu(x, a.get("alpha", 0.02)))
_act("elu", lambda x, a: F.elu(x, a.get("alpha", 1.0)))
_act("selu", lambda x, a: F.selu(x))
_act("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_act("silu", lambda x, a: F.silu(x))
_act("mish", lambda x, a: x * torch.tanh(_softplus(x)))
_act("hard_sigmoid", lambda x, a: torch.clamp(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_act("hard_swish", lambda x, a: x * torch.clamp(
    x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0))
_act("brelu", lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                       a.get("t_max", 24.0)))
_act("stanh", lambda x, a: a.get("scale_b", 1.7159)
     * torch.tanh(a.get("scale_a", 0.67) * x))
_act("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, torch.zeros_like(x)))


@register_op("maxout")
def maxout(ctx, ins, attrs):
    """The max over each group of ``groups`` channels along ``axis``
    (1 = NCHW, -1/3 = NHWC)."""
    x = x_of(ins)
    groups = attrs["groups"]
    axis = int(attrs.get("axis", 1)) % x.dim()
    c = x.shape[axis]
    shape = tuple(x.shape[:axis]) + (c // groups, groups) \
        + tuple(x.shape[axis + 1:])
    return {"Out": x.reshape(shape).amax(dim=axis + 1)}
