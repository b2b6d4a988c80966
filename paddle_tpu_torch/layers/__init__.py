"""fluid.layers namespace of the port: the layer functions the GPT,
BERT, ResNet, LeNet, Wide&Deep and seq2seq programs use, control flow,
the sequence layers and the RNN cell/decoder API (importing it
registers the op lowerings)."""
from .. import ops  # noqa: F401  (registers op lowerings)
from . import (control_flow, learning_rate_scheduler, loss,  # noqa: F401
               math, more, nn, rnn_api, sequence_lod, tensor)
from .control_flow import (DynamicRNN, IfElse, Print, StaticRNN, Switch,
                           While, array_length, array_read, array_write,
                           case, cond, create_array, switch_case)
from .more import dynamic_gru, dynamic_lstm, dynamic_lstmp, lstm
from .rnn_api import (BasicDecoder, BeamSearchDecoder, Decoder,
                      DecodeHelper, GRUCell, GreedyEmbeddingHelper,
                      LSTMCell, RNNCell, SampleEmbeddingHelper,
                      TrainingHelper, dynamic_decode, rnn)
from .sequence_lod import (lod_append, lod_reset, sequence_concat,
                           sequence_conv, sequence_enumerate,
                           sequence_erase, sequence_expand,
                           sequence_expand_as, sequence_first_step,
                           sequence_last_step, sequence_mask, sequence_pad,
                           sequence_pool, sequence_reshape,
                           sequence_reverse, sequence_scatter,
                           sequence_slice, sequence_softmax,
                           sequence_unpad)
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
                   greater_than, less_equal, less_than, logical_and,
                   logical_not, logical_or, mean, not_equal, reduce_max,
                   reduce_mean, reduce_min, reduce_sum, scale, sums)
from .nn import (abs, accuracy, batch_norm, beam_search, ceil, clip,
                 clip_by_norm, conv2d, cos, dropout, embedding, exp, fc,
                 flash_attention, flatten, floor, gather_tree, gru_unit,
                 layer_norm, log, log_softmax, lstm_unit, matmul, pool2d,
                 pow, relu, rsqrt, sigmoid, sign, softmax, sqrt, square,
                 squeeze, tanh, topk, unsqueeze)
from .tensor import (argmax, assign, beam_search_decode, cast, concat,
                     create_global_var, create_parameter, data, expand,
                     fill_constant, gather, get_tensor_from_selected_rows,
                     increment, merge_selected_rows, ones_like, reshape,
                     slice, stack, transpose, where)

__all__ = ["BasicDecoder", "BeamSearchDecoder", "DecodeHelper", "Decoder",
           "DynamicRNN", "GRUCell", "GreedyEmbeddingHelper", "IfElse",
           "LSTMCell", "Print", "RNNCell", "SampleEmbeddingHelper",
           "StaticRNN", "Switch", "TrainingHelper", "While", "abs", "accuracy",
           "argmax", "array_length", "array_read", "array_write", "assign",
           "autoincreased_step_counter", "batch_norm", "beam_search",
           "beam_search_decode", "case", "cast", "ceil", "clip",
           "clip_by_norm", "concat", "cond",
           "conv2d", "cos", "cosine_decay", "create_array",
           "create_global_var", "create_parameter", "cross_entropy", "data",
           "dropout", "dynamic_decode", "dynamic_gru", "dynamic_lstm",
           "dynamic_lstmp", "einsum", "elementwise_add", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_mul",
           "elementwise_pow", "elementwise_sub", "embedding", "equal", "exp",
           "expand", "exponential_decay", "fc", "fill_constant",
           "flash_attention", "flatten", "floor", "gather", "gather_tree",
           "get_tensor_from_selected_rows", "greater_equal", "greater_than",
           "gru_unit", "increment", "inverse_time_decay", "layer_norm",
           "less_equal", "less_than", "linear_lr_warmup", "lod_append",
           "lod_reset", "log", "log_softmax", "logical_and", "logical_not",
           "logical_or", "lstm", "lstm_unit", "matmul", "mean",
           "merge_selected_rows", "natural_exp_decay", "noam_decay",
           "not_equal", "ones_like", "piecewise_decay", "polynomial_decay",
           "pool2d", "pow", "reduce_max", "reduce_mean", "reduce_min",
           "reduce_sum", "relu", "reshape", "rnn", "rsqrt", "scale",
           "sequence_concat", "sequence_conv", "sequence_enumerate",
           "sequence_erase", "sequence_expand", "sequence_expand_as",
           "sequence_first_step", "sequence_last_step", "sequence_mask",
           "sequence_pad", "sequence_pool", "sequence_reshape",
           "sequence_reverse", "sequence_scatter", "sequence_slice",
           "sequence_softmax", "sequence_unpad", "sigmoid",
           "sigmoid_cross_entropy_with_logits", "sign", "slice", "softmax",
           "softmax_with_cross_entropy", "sqrt", "square", "square_error_cost",
           "squeeze", "stack", "sums", "switch_case", "tanh", "topk",
           "transpose", "unsqueeze", "where"]
