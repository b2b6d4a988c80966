"""Elementwise, comparison, logical and reduction layers, ``sums``
(``:118``), ``scale`` (``:128``), ``mean`` (``:102``), ``einsum``
(``:245``), and the
operators ``+ - * / ** - < >=`` of ``Variable`` and the eager
``VarBase`` (``:197-242``; trimmed copy of
``paddle_tpu/layers/math.py``); also
``elementwise_floordiv``, ``elementwise_mod``, ``logical_xor``,
``reduce_prod``/``reduce_all``/``reduce_any`` and ``sum``."""
import numpy as np

from ..dygraph.base import VarBase
from ..framework.core import Variable
from . import tensor as tensor_layers
from .layer_helper import LayerHelper


def _binary(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    if np.isscalar(y):
        y = tensor_layers.fill_constant([1], x.dtype, float(y))
    if np.isscalar(x):
        x = tensor_layers.fill_constant([1], y.dtype, float(x))
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_div", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_pow", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_min", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_max", x, y, axis, act, name)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=input[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def einsum(equation, *operands, name=None):
    helper = LayerHelper("einsum", name=name)
    out = helper.create_variable_for_type_inference(operands[0].dtype)
    helper.append_op(type="einsum", inputs={"Operands": list(operands)},
                     outputs={"Out": [out]}, attrs={"equation": equation})
    return out


def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if np.isscalar(y):
        y = tensor_layers.fill_constant([1], x.dtype, float(y))
    if cond is None:
        cond = helper.create_variable_for_type_inference(
            dtype="bool", stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, cond=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp("greater_than", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp("not_equal", x, y, cond)


def logical_or(x, y, out=None, name=None):
    return _cmp("logical_or", x, y, out)


def greater_equal(x, y, cond=None):
    return _cmp("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)


def logical_and(x, y, out=None, name=None):
    return _cmp("logical_and", x, y, out)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype="bool", stop_gradient=True)
    helper.append_op(type="logical_not", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": [dim] if isinstance(dim, int) else list(dim),
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_mod", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_floordiv", x, y, axis, act, name)


def logical_xor(x, y, out=None, name=None):
    return _cmp("logical_xor", x, y, out)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", input, dim, keep_dim, name)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", input, dim, keep_dim, name)


def sum(x):
    """The ``sum`` op over one var or a list of them."""
    helper = LayerHelper("sum")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(dtype=xs[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(xs)},
                     outputs={"Out": [out]})
    return out


def _install_op_overloads(cls):
    """The operators of the reference's ``math_op_patch``, one
    implementation for static Variables and eager VarBases (the layer
    functions dispatch through the dygraph-aware LayerHelper)."""
    def binop(op_type, reverse=False):
        def impl(self, other):
            return _binary(op_type, other, self) if reverse \
                else _binary(op_type, self, other)
        return impl

    cls.__add__ = binop("elementwise_add")
    cls.__radd__ = binop("elementwise_add", reverse=True)
    cls.__sub__ = binop("elementwise_sub")
    cls.__rsub__ = binop("elementwise_sub", reverse=True)
    cls.__mul__ = binop("elementwise_mul")
    cls.__rmul__ = binop("elementwise_mul", reverse=True)
    cls.__truediv__ = binop("elementwise_div")
    cls.__rtruediv__ = binop("elementwise_div", reverse=True)
    cls.__pow__ = binop("elementwise_pow")
    cls.__neg__ = lambda self: scale(self, scale=-1.0)
    cls.__lt__ = lambda self, other: _cmp("less_than", self, other)
    cls.__ge__ = lambda self, other: _cmp("greater_equal", self, other)


_install_op_overloads(Variable)
_install_op_overloads(VarBase)
