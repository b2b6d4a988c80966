"""NN layers (trimmed copy of ``paddle_tpu/layers/nn.py``): ``fc``,
``embedding``, ``conv2d`` (``:84``), ``pool2d`` (``:139``),
``batch_norm`` (``:164``), ``layer_norm``, ``dropout``, ``softmax``
(``:270``), ``relu`` (``:286``), ``sigmoid`` (``:290``), ``tanh``
(``:294``), ``exp``,
``rsqrt`` (``:339``), ``floor``, ``ceil``, ``cos``, ``pow`` (``:391``),
``topk`` (``:440``), ``accuracy`` (``:451``), ``unsqueeze`` (``:538``),
``flatten`` (``:560``), ``matmul``, ``flash_attention`` (``:741``),
``log_softmax`` (``:278``), ``log`` (``:331``), ``squeeze`` (``:549``),
the fused recurrent steps ``lstm_unit`` and ``gru_unit`` (``:649-711``)
and the beam-search steps ``beam_search`` and ``gather_tree``
(``:919-960``)."""
import copy

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


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _conv_padding(padding):
    if isinstance(padding, str):
        return [0, 0], padding.upper()
    return list(_pair(padding)), "EXPLICIT"


def _append_channel_bias(helper, out):
    if helper.bias_attr is False:
        return out
    bias = helper.create_parameter(helper.bias_attr, shape=[out.shape[1]],
                                   dtype=out.dtype, is_bias=True)
    tmp = helper.create_variable_for_type_inference(dtype=out.dtype)
    helper.append_op(type="elementwise_add",
                     inputs={"X": [out], "Y": [bias]},
                     outputs={"Out": [tmp]}, attrs={"axis": 1})
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None, data_format="NCHW"):
    """``conv2d`` (+ a per-channel bias, + activation). The filter
    defaults to a normal of std sqrt(2 / (k_h k_w C_in))."""
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    filter_size = _pair(filter_size)
    padding, algo = _conv_padding(padding)
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": list(_pair(stride)), "paddings": list(padding),
               "dilations": list(_pair(dilation)), "groups": groups,
               "padding_algorithm": algo, "data_format": data_format})
    out = _append_channel_bias(helper, out)
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": list(_pair(pool_size)),
               "strides": list(_pair(pool_stride)),
               "paddings": list(_pair(pool_padding)),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False, sync=False):
    """``batch_norm`` with a scale (ones), an offset (zeros) and the
    persistable moving mean (zeros) and variance (ones), which the op's
    ``MeanOut``/``VarianceOut`` rebind. ``sync`` (``sync_batch_norm``)
    is not ported."""
    if sync:
        raise NotImplementedError("paddle_tpu_torch: sync_batch_norm is "
                                  "not ported")
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    caxis = 1 if data_layout == "NCHW" else len(input.shape) - 1
    c = input.shape[caxis]
    dtype = input.dtype if input.dtype != "float16" else "float32"
    scale = helper.create_parameter(
        helper.param_attr, shape=[c], dtype=dtype,
        default_initializer=init_mod.ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    mean = helper.create_global_variable(
        shape=[c], dtype=dtype, name=moving_mean_name,
        initializer=init_mod.ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        shape=[c], dtype=dtype, name=moving_variance_name,
        initializer=init_mod.ConstantInitializer(1.0))
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    saved_m = helper.create_variable_for_type_inference(dtype=dtype,
                                                        stop_gradient=True)
    saved_v = helper.create_variable_for_type_inference(dtype=dtype,
                                                        stop_gradient=True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_m], "SavedVariance": [saved_v]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


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


def relu(x, name=None):
    return _unary("relu", x, name)


def sigmoid(x, name=None):
    return _unary("sigmoid", x, name)


def tanh(x, name=None):
    return _unary("tanh", x, name)


def exp(x, name=None):
    return _unary("exp", x, name)


def square(x, name=None):
    return _unary("square", x, name)


def rsqrt(x, name=None):
    return _unary("rsqrt", x, name)


def sqrt(x, name=None):
    return _unary("sqrt", x, name)


def abs(x, name=None):
    return _unary("abs", x, name)


def sign(x, name=None):
    return _unary("sign", x, name)


def clip(x, min, max, name=None):
    return _unary("clip", x, name, {"min": min, "max": max})


def clip_by_norm(x, max_norm, name=None):
    return _unary("clip_by_norm", x, name, {"max_norm": max_norm})


def floor(x, name=None):
    return _unary("floor", x, name)


def ceil(x, name=None):
    return _unary("ceil", x, name)


def cos(x, name=None):
    return _unary("cos", x, name)


def pow(x, factor=1.0, name=None):
    return _unary("pow", x, name, {"factor": factor})


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


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
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


def log(x, name=None):
    return _unary("log", x, name)


def log_softmax(input, axis=-1, name=None):
    return _unary("log_softmax", input, name, {"axis": axis})


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes or [])})
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step for use inside StaticRNN: the x/h projections and
    the gate math as one ``lstm_cell_fused`` op. Returns (hidden_t,
    cell_t)."""
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    D = int(x_t.shape[-1])
    H = int(hidden_t_prev.shape[-1])
    w = helper.create_parameter(helper.param_attr, shape=[D + H, 4 * H],
                                dtype=x_t.dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[4 * H],
                                dtype=x_t.dtype, is_bias=True)
    h = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    c = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    helper.append_op(
        type="lstm_cell_fused",
        inputs={"X": [x_t], "HPrev": [hidden_t_prev],
                "CPrev": [cell_t_prev], "W": [w], "B": [b]},
        outputs={"H": [h], "C": [c]},
        attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size=None, param_attr=None, bias_attr=None,
             name=None):
    """One GRU step for use inside StaticRNN (one ``gru_cell_fused``
    op). A named param or bias attr names its two parts ``<name>.gate``
    and ``<name>.cand``. Returns hidden_t."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    D = int(input.shape[-1])
    H = int(hidden.shape[-1])

    def _suffixed(attr, suffix):
        from ..param_attr import ParamAttr
        attr = ParamAttr._to_attr(attr)
        if attr and attr.name:
            attr = copy.copy(attr)
            attr.name = attr.name + suffix
        return attr

    wg = helper.create_parameter(_suffixed(helper.param_attr, ".gate"),
                                 shape=[D + H, 2 * H], dtype=input.dtype)
    bg = helper.create_parameter(_suffixed(helper.bias_attr, ".gate"),
                                 shape=[2 * H], dtype=input.dtype,
                                 is_bias=True)
    wc = helper.create_parameter(_suffixed(helper.param_attr, ".cand"),
                                 shape=[D + H, H], dtype=input.dtype)
    bc = helper.create_parameter(_suffixed(helper.bias_attr, ".cand"),
                                 shape=[H], dtype=input.dtype,
                                 is_bias=True)
    h = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="gru_cell_fused",
        inputs={"X": [input], "HPrev": [hidden], "WGate": [wg],
                "BGate": [bg], "WCand": [wc], "BCand": [bc]},
        outputs={"H": [h]}, attrs={})
    return h


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id=0,
                name=None):
    """One beam expansion step. Returns (selected_ids [B, beam] int32,
    selected_scores [B, beam], parent_idx [B, beam] int32)."""
    helper = LayerHelper("beam_search", name=name)
    B = pre_ids.shape[0] if pre_ids.shape else -1
    outs = [helper.block.create_var(name=f"{helper.name}.{suffix}",
                                    dtype=dtype, shape=(B, beam_size))
            for suffix, dtype in (("ids", "int32"), ("scores", "float32"),
                                  ("parents", "int32"))]
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "scores": [scores]},
        outputs={"selected_ids": [outs[0]], "selected_scores": [outs[1]],
                 "parent_idx": [outs[2]]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id)},
        infer_shape=False)
    return tuple(outs)


def gather_tree(ids, parents, name=None):
    """Back-trace beam parents into sequences; ids/parents [T, B,
    beam]."""
    helper = LayerHelper("gather_tree", name=name)
    out = helper.block.create_var(name=f"{helper.name}.out", dtype="int32",
                                  shape=tuple(ids.shape or ()))
    helper.append_op(type="gather_tree",
                     inputs={"Ids": [ids], "Parents": [parents]},
                     outputs={"Out": [out]}, attrs={}, infer_shape=False)
    return out
