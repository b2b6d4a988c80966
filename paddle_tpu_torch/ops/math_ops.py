"""Elementwise, matmul and reduction ops in torch (counterpart of
``paddle_tpu/ops/math_ops.py``: ``elementwise_*``, ``sum :52`` (over
``SelectedRows`` too), ``scale :74``, ``matmul :92``, ``mul :116``,
``reduce_sum``, ``reduce_mean``/``reduce_max``/``reduce_min :151``,
``mean :174``, the comparisons (``less_than :240``), the logical ops,
``isfinite :268`` and ``einsum :328``). Large products go to
``torch.matmul``, as the JAX package leaves them to XLA. ``mul`` (every
``fc``) has a bespoke grad: the generic vjp would recompute its forward
product, which eager torch cannot deduplicate as XLA does."""
import math

import torch

from ..framework.registry import register_grad_lower, register_op
from ..framework.selected_rows import is_selected_rows, merge, to_dense
from .common import bcast_y, reduce_axes, x_of


def _ew(name, fn):
    @register_op(name)
    def _op(ctx, ins, attrs, _fn=fn):
        x = x_of(ins)
        y = bcast_y(x, x_of(ins, "Y"), attrs.get("axis", -1))
        return {"Out": _fn(x, y)}
    return _op


_ew("elementwise_add", torch.add)
_ew("elementwise_sub", torch.sub)
_ew("elementwise_mul", torch.mul)
_ew("elementwise_div", torch.div)
_ew("elementwise_min", torch.minimum)
_ew("elementwise_max", torch.maximum)
_ew("elementwise_pow", torch.pow)


def _cmp(name, fn):
    @register_op(name, grad=False)
    def _op(ctx, ins, attrs, _fn=fn):
        x = x_of(ins)
        return {"Out": _fn(x, bcast_y(x, x_of(ins, "Y"),
                                      attrs.get("axis", -1)))}
    return _op


_cmp("greater_equal", torch.greater_equal)
_cmp("greater_than", torch.greater)
_cmp("less_than", torch.less)
_cmp("less_equal", torch.less_equal)
_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)


@register_op("logical_and", grad=False)
def logical_and(ctx, ins, attrs):
    return {"Out": torch.logical_and(x_of(ins), x_of(ins, "Y"))}


@register_op("logical_or", grad=False)
def logical_or(ctx, ins, attrs):
    return {"Out": torch.logical_or(x_of(ins), x_of(ins, "Y"))}


@register_op("logical_not", grad=False)
def logical_not(ctx, ins, attrs):
    return {"Out": torch.logical_not(x_of(ins))}


@register_op("isfinite", grad=False)
def isfinite(ctx, ins, attrs):
    """One flag: whether every element of X is finite."""
    return {"Out": torch.isfinite(x_of(ins)).all().reshape(1)}


@register_op("sum")
def sum_op(ctx, ins, attrs):
    """The sum of the ``X`` list. ``SelectedRows`` inputs stay sparse when
    every input is one (``merge``); mixed with dense ones, each is
    densified into the dense inputs' shape first."""
    xs = ins["X"]
    if any(is_selected_rows(x) for x in xs):
        if all(is_selected_rows(x) for x in xs):
            return {"Out": merge(xs)}
        shape = next(x.shape for x in xs if not is_selected_rows(x))
        xs = [to_dense(x, shape) if is_selected_rows(x) else x for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("scale")
def scale(ctx, ins, attrs):
    """``x * scale + bias`` (or ``(x + bias) * scale``) in x's type; the
    scale may come as a ``ScaleTensor`` input."""
    x = x_of(ins)
    s = x_of(ins, "ScaleTensor")
    s = attrs.get("scale", 1.0) if s is None else s
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        out = x * s
        if b:
            out = out + b
    else:
        out = (x + b) * s
    return {"Out": out.to(x.dtype)}


@register_op("matmul")
def matmul(ctx, ins, attrs):
    x, y = x_of(ins), x_of(ins, "Y")
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("mul")
def mul(ctx, ins, attrs):
    """Flattening matmul: X flattened to 2-D at ``x_num_col_dims``, Y at
    ``y_num_col_dims``."""
    x, y = x_of(ins), x_of(ins, "Y")
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xn]), -1)
    y2 = y.reshape(math.prod(y.shape[:yn]), -1)
    out = torch.matmul(x2, y2)
    return {"Out": out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))}


@register_grad_lower("mul")
def mul_grad(ctx, ins, attrs):
    """dX = dOut Y^T and dY = X^T dOut on the flattened 2-D forms, each
    only where asked for; no forward recompute."""
    fattrs = attrs["__fwd_op__"]["attrs"]
    req = attrs["__grad_inputs__"]
    x, y, g = x_of(ins), x_of(ins, "Y"), x_of(ins, "Out@GRAD")
    xn = fattrs.get("x_num_col_dims", 1)
    yn = fattrs.get("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xn]), -1)
    y2 = y.reshape(math.prod(y.shape[:yn]), -1)
    g2 = g.to(x.dtype).reshape(x2.shape[0], y2.shape[1])
    out = {}
    if any(req.get("X", ())):
        out["X@GRAD"] = [torch.matmul(g2, y2.t()).reshape(x.shape)]
    if any(req.get("Y", ())):
        out["Y@GRAD"] = [torch.matmul(x2.t(), g2).reshape(y.shape)]
    return out


@register_op("reduce_sum")
def reduce_sum(ctx, ins, attrs):
    x = x_of(ins)
    axes, keep = reduce_axes(attrs, x.dim())
    return {"Out": torch.sum(x, dim=axes, keepdim=keep)}


def _reduce(name, fn):
    @register_op(name)
    def _op(ctx, ins, attrs, _fn=fn):
        x = x_of(ins)
        axes, keep = reduce_axes(attrs, x.dim())
        return {"Out": _fn(x, axes, keep)}
    return _op


_reduce("reduce_mean", lambda x, d, k: torch.mean(x, dim=d, keepdim=k))
_reduce("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
_reduce("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k))


@register_op("mean")
def mean(ctx, ins, attrs):
    """Mean of every element: a 0-d tensor, as ``jnp.mean``."""
    return {"Out": torch.mean(x_of(ins))}


@register_op("einsum")
def einsum(ctx, ins, attrs):
    """Einstein summation over the ``Operands`` list. Its grad is the
    generic vjp (which recomputes the product), as in the JAX package."""
    return {"Out": torch.einsum(attrs["equation"], *ins["Operands"])}
