"""Op classification for mixed precision (a copy of
``paddle_tpu/contrib/mixed_precision/fp16_lists.py``).

White ops run in the low-precision compute dtype (bf16: the matmuls,
where the FLOPs are), black ops stay float32 (loss, softmax and norm
numerics), every other ("gray") op follows its inputs: low precision
when a low-precision producer feeds it, float32 otherwise.
"""

white_list = {
    "mul", "matmul", "matmul_v2", "bmm",
    "conv2d", "conv3d", "conv2d_transpose", "depthwise_conv2d",
}

black_list = {
    "exp", "log", "mean", "reduce_mean", "reduce_sum", "sum",
    "softmax", "log_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "sigmoid_cross_entropy_with_logits", "bce_loss",
    "square_error_cost", "mse_loss", "huber_loss", "nll_loss",
    "layer_norm", "batch_norm", "sync_batch_norm", "group_norm",
    "instance_norm", "squared_l2_norm", "p_norm", "norm",
}

# ops that are never touched (state, IO, bookkeeping)
_untouched = {
    "feed", "fetch", "fill_constant", "assign", "cast", "print",
    "increment", "while", "cond", "recurrent", "write_to_array",
    "read_from_array", "lod_array_length",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.black_varnames = set(custom_black_varnames or ())
        for w in (custom_white_list or ()):
            self.white_list.add(w)
            self.black_list.discard(w)
        for b in (custom_black_list or ()):
            self.black_list.add(b)
            self.white_list.discard(b)
        overlap = self.white_list & self.black_list
        if overlap:
            raise ValueError(f"ops in both white and black lists: {overlap}")

    def classify(self, op_type):
        if op_type in _untouched:
            return "skip"
        if op_type in self.white_list:
            return "white"
        if op_type in self.black_list:
            return "black"
        return "gray"
