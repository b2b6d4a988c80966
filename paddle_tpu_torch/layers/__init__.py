"""fluid.layers namespace of the port: the layer functions the GPT and
BERT training programs use (importing it registers the op lowerings)."""
from .. import ops  # noqa: F401  (registers op lowerings)
from . import learning_rate_scheduler, loss, math, nn, tensor  # noqa: F401
from .learning_rate_scheduler import (autoincreased_step_counter,
                                      noam_decay)
from .loss import softmax_with_cross_entropy
from .math import (einsum, elementwise_add, elementwise_div,
                   elementwise_max, elementwise_min, elementwise_mul,
                   elementwise_sub, greater_equal, logical_and, logical_not,
                   mean, reduce_sum, scale)
from .nn import (accuracy, dropout, embedding, fc, flash_attention,
                 layer_norm, matmul, rsqrt, softmax, tanh, topk, unsqueeze)
from .tensor import (assign, cast, create_global_var, data, fill_constant,
                     gather, ones_like, reshape, slice, transpose)

__all__ = ["accuracy", "assign", "autoincreased_step_counter", "cast",
           "create_global_var", "data", "dropout", "einsum",
           "elementwise_add", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_mul", "elementwise_sub",
           "embedding", "fc", "fill_constant", "flash_attention", "gather",
           "greater_equal", "layer_norm", "logical_and", "logical_not",
           "matmul", "mean", "noam_decay", "ones_like", "reduce_sum",
           "reshape", "rsqrt", "scale", "slice", "softmax",
           "softmax_with_cross_entropy", "tanh", "topk", "transpose",
           "unsqueeze"]
