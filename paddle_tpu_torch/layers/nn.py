"""NN layers (trimmed copy of ``paddle_tpu/layers/nn.py``): ``fc``,
``embedding``, ``layer_norm``, ``dropout``, ``softmax`` (``:270``),
``tanh`` (``:294``), ``rsqrt`` (``:339``), ``topk`` (``:440``),
``accuracy`` (``:451``), ``unsqueeze`` (``:538``), ``matmul``,
``flash_attention`` (``:741``)."""
import numpy as np

from ..framework import initializer as init_mod
from .layer_helper import LayerHelper


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected: ``mul`` + ``elementwise_add`` (+ activation)."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    in_features = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(helper.param_attr,
                                shape=[in_features, size],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="mul", inputs={"X": [input], "Y": [w]},
        outputs={"Out": [out]},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    out = helper.append_bias_op(out, dim_start=num_flatten_dims)
    return helper.append_activation(out, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """``lookup_table``; a negative padding_idx counts from the end,
    None is no padding (-1)."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    if padding_idx is None:
        padding_idx = -1
    elif padding_idx < 0:
        padding_idx = int(size[0]) + int(padding_idx)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"padding_idx": padding_idx, "is_sparse": is_sparse,
               "is_distributed": is_distributed})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            helper.param_attr, shape=norm_shape, dtype=input.dtype,
            default_initializer=init_mod.ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr, shape=norm_shape, dtype=input.dtype,
            is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    mean = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    stop_gradient=True)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(out, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, axis=-1, use_cudnn=False, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def _unary(op_type, x, name=None, attrs=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs or {})
    return out


def tanh(x, name=None):
    return _unary("tanh", x, name)


def rsqrt(x, name=None):
    return _unary("rsqrt", x, name)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    idx = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [idx]},
                     attrs={"k": k})
    return out, idx


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    _, idx = topk(input, k)
    acc = helper.create_variable_for_type_inference(dtype="float32",
                                                    stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [input], "Indices": [idx], "Label": [label]},
        outputs={"Accuracy": [acc], "Correct": [correct], "Total": [total]})
    return acc


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out


def flash_attention(q, k, v, attn_bias=None, scale=0.0, causal=False,
                    impl=None, block_q=None, block_k=None, name=None):
    """Fused attention. q/k/v ``[B, n_head, S, d_head]``; attn_bias an
    optional additive key mask ``[B, 1, 1, S]`` (no gradient flows to
    it). ``impl``: None/"" = the kernels, "xla" = the plain composite.
    ``block_q``/``block_k`` are kept in the op for the JAX package's
    program form; the CUDA kernels pick their own tiles."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    ins = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        ins["Bias"] = [attn_bias]
    helper.append_op(
        type="flash_attention", inputs=ins, outputs={"Out": [out]},
        attrs={"scale": float(scale), "causal": bool(causal),
               "impl": impl or "",
               "block_q": int(block_q or 0), "block_k": int(block_k or 0)},
        infer_shape=False)
    out.shape = tuple(q.shape or ())
    out.dtype = q.dtype
    return out
