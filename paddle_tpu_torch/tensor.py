"""The ``paddle.tensor`` 2.0-preview namespace: aliases over the fluid
tensor and math layers (a copy of ``paddle_tpu/tensor.py``). ``eye``
and ``size`` come with ``layers.more``'s long tail, Queue 1 item 10."""
from .layers.math import (  # noqa: F401
    elementwise_add as add, elementwise_div as divide,
    elementwise_mul as multiply, elementwise_sub as subtract, equal,
    logical_and, logical_not, logical_or, reduce_max as max,
    reduce_mean as mean, reduce_min as min, reduce_prod as prod,
    reduce_sum as sum, scale)
from .layers.nn import flatten, squeeze  # noqa: F401
from .layers.tensor import (  # noqa: F401
    argmax, argmin, argsort, assign, cast, concat, diag, expand,
    fill_constant, gather, gather_nd, linspace, one_hot, ones, ones_like,
    range, reshape, shape, slice, split, stack, transpose, unstack, where,
    zeros, zeros_like)
