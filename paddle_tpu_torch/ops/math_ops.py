"""Elementwise, matmul and reduction ops in torch (counterpart of
``paddle_tpu/ops/math_ops.py``: ``elementwise_*``, ``sum :52`` (over
``SelectedRows`` too), ``scale :74``, ``matmul :92``, ``mul :116``,
``reduce_sum``, ``reduce_mean``/``reduce_max``/``reduce_min :151``,
``mean :174``, the comparisons (``less_than :240``), the logical ops,
``isfinite :268``, ``einsum :328``, and the gradient clips'
``clip :180``, ``clip_by_norm :186`` and ``squared_l2_norm :196``).
Large products go to ``torch.matmul``, as the JAX package leaves them to XLA. ``mul`` (every
``fc``) has a bespoke grad: the generic vjp would recompute its forward
product, which eager torch cannot deduplicate as XLA does.

The rest of the JAX module follows: ``elementwise_mod`` and
``elementwise_floordiv`` (python's floor semantics, no grad),
``matmul_v2``, ``bmm``, ``dot``, ``reduce_prod``/``reduce_all``/
``reduce_any``, ``logsumexp``, ``p_norm``, ``norm`` (l2_normalize),
``maximum``/``minimum``, ``logical_xor``, ``isfinite_v2``/``isinf_v2``/
``isnan_v2``, ``kron``, ``trace``, ``addmm`` and the linear algebra
``cholesky``, ``inverse`` and ``matrix_power`` (``torch.linalg``:
cuSOLVER and cuBLAS on the card, as the JAX package leaves them to
XLA). Each takes the generic vjp grad."""
import math

import torch

from ..framework.registry import register_grad_lower, register_op
from ..framework.selected_rows import is_selected_rows, merge, to_dense
from .common import bcast_y, reduce_axes, x_of


def _ew(name, fn, grad=None):
    @register_op(name, grad=grad)
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
_ew("elementwise_mod", torch.remainder, grad=False)
_ew("elementwise_floordiv", lambda x, y: torch.div(x, y,
                                                   rounding_mode="floor"),
    grad=False)


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


@register_op("clip")
def clip(ctx, ins, attrs):
    return {"Out": torch.clamp(x_of(ins), attrs.get("min"),
                               attrs.get("max"))}


@register_op("clip_by_norm")
def clip_by_norm(ctx, ins, attrs):
    """``x * max_norm / ||x||`` where the L2 norm exceeds ``max_norm``,
    else ``x``; the scale stays a device tensor."""
    x = x_of(ins)
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12), 1.0)
    return {"Out": x * scale.to(x.dtype)}


@register_op("squared_l2_norm")
def squared_l2_norm(ctx, ins, attrs):
    """The sum of squares of X, a 0-d tensor."""
    return {"Out": torch.sum(torch.square(x_of(ins)))}


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


@register_op("matmul_v2")
def matmul_v2(ctx, ins, attrs):
    x, y = x_of(ins), x_of(ins, "Y")
    if attrs.get("trans_x", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    return {"Out": torch.matmul(x, y)}


@register_op("bmm")
def bmm(ctx, ins, attrs):
    return {"Out": torch.matmul(x_of(ins), x_of(ins, "Y"))}


@register_op("dot")
def dot(ctx, ins, attrs):
    """Row-wise dot product over the last dim (a 1-D pair keeps a [1])."""
    x, y = x_of(ins), x_of(ins, "Y")
    return {"Out": torch.sum(x * y, dim=-1, keepdim=x.dim() == 1)}


def _prod(x, axes, keep):
    """``jnp.prod`` over several axes: torch's ``prod`` takes one, so the
    reduced axes are moved last and flattened into it."""
    rest = [d for d in range(x.dim()) if d not in axes]
    out = x.permute(*rest, *axes).reshape(
        *[x.shape[d] for d in rest], -1).prod(-1)
    if keep:
        out = out.reshape([1 if d in axes else x.shape[d]
                           for d in range(x.dim())])
    return out


_reduce("reduce_prod", _prod)


def _bool_reduce(name, fn):
    @register_op(name, grad=False)
    def _op(ctx, ins, attrs, _fn=fn):
        x = x_of(ins)
        axes, keep = reduce_axes(attrs, x.dim())
        return {"Out": _fn(x.bool(), dim=axes, keepdim=keep)}
    return _op


_bool_reduce("reduce_all", torch.all)
_bool_reduce("reduce_any", torch.any)


@register_op("logsumexp")
def logsumexp(ctx, ins, attrs):
    """Over ``dim``/``keep_dim`` (the reduce spelling) or
    ``axis``/``keepdim`` (Paddle 2.x's)."""
    x = x_of(ins)
    attrs = dict(attrs)
    if "axis" in attrs:
        attrs.setdefault("dim", attrs["axis"])
    if "keepdim" in attrs:
        attrs.setdefault("keep_dim", attrs["keepdim"])
    axes, keep = reduce_axes(attrs, x.dim())
    return {"Out": torch.logsumexp(x, dim=axes, keepdim=keep)}


@register_op("p_norm")
def p_norm(ctx, ins, attrs):
    """``sum(|x|^p) ^ (1/p)`` along ``axis``."""
    x = x_of(ins)
    p = attrs.get("porder", 2.0)
    return {"Out": torch.sum(torch.abs(x) ** p, dim=attrs.get("axis", -1),
                             keepdim=attrs.get("keepdim", False))
            ** (1.0 / p)}


@register_op("norm")
def norm(ctx, ins, attrs):
    """l2_normalize: ``x / sqrt(sum(x^2, axis) + epsilon)`` and the
    norm."""
    x = x_of(ins)
    n = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                             keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


@register_op("maximum")
def maximum(ctx, ins, attrs):
    return {"Out": torch.maximum(x_of(ins), x_of(ins, "Y"))}


@register_op("minimum")
def minimum(ctx, ins, attrs):
    return {"Out": torch.minimum(x_of(ins), x_of(ins, "Y"))}


@register_op("logical_xor", grad=False)
def logical_xor(ctx, ins, attrs):
    return {"Out": torch.logical_xor(x_of(ins), x_of(ins, "Y"))}


@register_op("isfinite_v2", grad=False)
def isfinite_v2(ctx, ins, attrs):
    return {"Out": torch.isfinite(x_of(ins))}


@register_op("isinf_v2", grad=False)
def isinf_v2(ctx, ins, attrs):
    return {"Out": torch.isinf(x_of(ins))}


@register_op("isnan_v2", grad=False)
def isnan_v2(ctx, ins, attrs):
    return {"Out": torch.isnan(x_of(ins))}


@register_op("kron")
def kron(ctx, ins, attrs):
    return {"Out": torch.kron(x_of(ins), x_of(ins, "Y"))}


@register_op("trace")
def trace(ctx, ins, attrs):
    """The sum of the ``offset`` diagonal over ``axis1``/``axis2``."""
    return {"Out": torch.diagonal(
        x_of(ins, "Input"), attrs.get("offset", 0), attrs.get("axis1", 0),
        attrs.get("axis2", 1)).sum(-1)}


@register_op("addmm")
def addmm(ctx, ins, attrs):
    """``Beta * Input + Alpha * (X @ Y)``."""
    return {"Out": attrs.get("Beta", 1.0) * x_of(ins, "Input")
            + attrs.get("Alpha", 1.0) * torch.matmul(x_of(ins),
                                                      x_of(ins, "Y"))}


@register_op("cholesky")
def cholesky(ctx, ins, attrs):
    """The lower Cholesky factor of the input symmetrised, as
    ``jnp.linalg.cholesky`` symmetrises it (its grad is then symmetric
    too); its transpose with ``upper``."""
    x = x_of(ins)
    lo = torch.linalg.cholesky((x + x.transpose(-1, -2).conj()) / 2)
    return {"Out": lo.transpose(-1, -2) if attrs.get("upper", False)
            else lo}


@register_op("inverse")
def inverse(ctx, ins, attrs):
    return {"Output": torch.linalg.inv(x_of(ins, "Input"))}


@register_op("matrix_power")
def matrix_power(ctx, ins, attrs):
    return {"Out": torch.linalg.matrix_power(x_of(ins), attrs["n"])}
