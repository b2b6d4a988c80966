"""fluid.layers namespace of the port: the layer functions the GPT,
BERT, ResNet, LeNet and Wide&Deep training programs use (importing it
registers the op lowerings)."""
from .. import ops  # noqa: F401  (registers op lowerings)
from . import learning_rate_scheduler, loss, math, nn, tensor  # noqa: F401
from .learning_rate_scheduler import (autoincreased_step_counter,
                                      cosine_decay, exponential_decay,
                                      inverse_time_decay, linear_lr_warmup,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from .loss import (cross_entropy, sigmoid_cross_entropy_with_logits,
                   softmax_with_cross_entropy, square_error_cost)
from .math import (einsum, elementwise_add, elementwise_div,
                   elementwise_max, elementwise_min, elementwise_mul,
                   elementwise_pow, elementwise_sub, equal, greater_equal,
                   less_than, logical_and, logical_not, mean, reduce_sum,
                   scale, sums)
from .nn import (accuracy, batch_norm, ceil, conv2d, cos, dropout,
                 embedding, exp, fc, flash_attention, flatten, floor,
                 layer_norm, matmul, pool2d, pow, relu, rsqrt, sigmoid,
                 softmax, square, tanh, topk, unsqueeze)
from .tensor import (assign, cast, concat, create_global_var, data,
                     fill_constant, gather, get_tensor_from_selected_rows,
                     merge_selected_rows, ones_like, reshape, slice,
                     transpose)

__all__ = ["accuracy", "assign", "autoincreased_step_counter", "batch_norm",
           "cast", "ceil", "concat", "conv2d", "cos", "cosine_decay",
           "create_global_var", "cross_entropy", "data", "dropout", "einsum",
           "elementwise_add", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_mul", "elementwise_pow",
           "elementwise_sub", "embedding", "equal", "exp", "exponential_decay",
           "fc", "fill_constant", "flash_attention", "flatten", "floor",
           "gather", "get_tensor_from_selected_rows", "greater_equal",
           "inverse_time_decay", "layer_norm", "less_than", "linear_lr_warmup",
           "logical_and", "logical_not", "matmul", "mean",
           "merge_selected_rows", "natural_exp_decay", "noam_decay",
           "ones_like", "piecewise_decay", "polynomial_decay", "pool2d", "pow",
           "reduce_sum", "relu", "reshape", "rsqrt", "scale", "sigmoid",
           "sigmoid_cross_entropy_with_logits", "slice", "softmax",
           "softmax_with_cross_entropy", "square", "square_error_cost", "sums",
           "tanh", "topk", "transpose", "unsqueeze"]
