"""fluid.layers namespace of the port: the layer functions the GPT
training program uses (importing it registers the op lowerings)."""
from .. import ops  # noqa: F401  (registers op lowerings)
from . import loss, math, nn, tensor  # noqa: F401
from .loss import softmax_with_cross_entropy
from .math import (elementwise_add, elementwise_div, elementwise_mul,
                   reduce_sum)
from .nn import dropout, embedding, fc, flash_attention, layer_norm, matmul
from .tensor import (create_global_var, data, fill_constant, reshape, slice,
                     transpose)

__all__ = ["create_global_var", "data", "dropout", "elementwise_add",
           "elementwise_div", "elementwise_mul", "embedding", "fc",
           "fill_constant", "flash_attention", "layer_norm", "matmul",
           "reduce_sum", "reshape", "slice", "softmax_with_cross_entropy",
           "transpose"]
