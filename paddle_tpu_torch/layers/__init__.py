"""fluid.layers namespace of the port: the layer functions the GPT
training program uses (importing it registers the op lowerings)."""
from .. import ops  # noqa: F401  (registers op lowerings)
from . import loss, math, nn, tensor  # noqa: F401
from .loss import softmax_with_cross_entropy
from .math import (elementwise_add, elementwise_div, elementwise_max,
                   elementwise_mul, elementwise_sub, greater_equal,
                   logical_and, logical_not, reduce_sum)
from .nn import dropout, embedding, fc, flash_attention, layer_norm, matmul
from .tensor import (assign, cast, create_global_var, data, fill_constant,
                     reshape, slice, transpose)

__all__ = ["assign", "cast", "create_global_var", "data", "dropout",
           "elementwise_add", "elementwise_div", "elementwise_max",
           "elementwise_mul", "elementwise_sub", "embedding", "fc",
           "fill_constant", "flash_attention", "greater_equal", "layer_norm",
           "logical_and", "logical_not", "matmul", "reduce_sum", "reshape",
           "slice", "softmax_with_cross_entropy", "transpose"]
