"""Elementwise and reduction layers (trimmed copy of
``paddle_tpu/layers/math.py``)."""
import numpy as np

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


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_div", x, y, axis, act, name)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": [dim] if isinstance(dim, int) else list(dim),
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type="reduce_sum", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out
