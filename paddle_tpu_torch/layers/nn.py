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
(``:919-960``).

Also the activation layers (``gelu :298`` ... ``logsigmoid
:387``, ``brelu``, ``selu``, ``stanh :1174-1189``, ``maxout :1111``),
``mul``, ``bmm``, ``auc :467``, ``l2_normalize``, ``label_smooth``,
``image_resize :518`` and ``resize_bilinear``/``resize_nearest``/
``resize_trilinear``/``image_resize_short :1443-1487``, ``pad``,
``pad2d``, ``strided_slice :1002``, ``unfold``, ``pixel_shuffle``,
``expand_as``, ``space_to_depth``, ``reverse``, the random layers
``uniform_random(_batch_size_like)`` and
``gaussian_random(_batch_size_like)``, ``unique`` (raises, as in the
JAX package) and the decode layers ``kv_cache_write`` ...
``spec_accept`` (``:764-918``), whose ops ``models.gpt``'s generation
programs are made of."""
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
    return _emit_embedding("lookup_table", input, size, is_sparse,
                           is_distributed, padding_idx, param_attr, dtype,
                           name)


def _emit_embedding(op_type, input, size, is_sparse, is_distributed,
                    padding_idx, param_attr, dtype, name=None):
    """The body of ``embedding`` (v1 ``lookup_table``) and of
    ``fluid.embedding`` (``lookup_table_v2``)."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    if padding_idx is None:
        padding_idx = -1
    elif padding_idx < 0:
        padding_idx = int(size[0]) + int(padding_idx)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type=op_type, inputs={"W": [w], "Ids": [input]},
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


def ring_attention(q, k, v, attn_bias=None, scale=0.0, mechanism="ring",
                   causal=False, name=None):
    """Sequence-parallel attention for long sequences. q/k/v ``[B,
    n_head, S, d_head]``, the sequence split over the ``sp`` axis by
    pass ``sp_shard``. ``mechanism`` "ring" passes K/V blocks around the
    sp ring into an online softmax (blocks above the diagonal skipped
    under ``causal``); "ulysses" all-to-alls the split from the
    sequence to the heads. ``attn_bias``: ``[B, 1, 1, S]``, ``[B, H, S,
    S]`` or ``[B, 1, S, S]``. Exact attention either way; one pass
    without an sp axis."""
    assert mechanism in ("ring", "ulysses")
    helper = LayerHelper(f"{mechanism}_attention", name=name)
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    ins = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        ins["Bias"] = [attn_bias]
    helper.append_op(
        type=f"{mechanism}_attention", inputs=ins,
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "causal": bool(causal)},
        infer_shape=False)
    out.shape = tuple(q.shape or ())
    out.dtype = q.dtype
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


def switch_moe(input, num_experts, d_hidden, capacity_factor=1.25,
               param_attr=None, name=None):
    """Switch-style Mixture-of-Experts FFN block (``ops/moe_ops.py``).
    Expert weights are stacked ``[E, ...]`` and annotated ``("ep",)``
    (pass ``ep_shard`` cuts each ``ep`` rank's ``[E / ep, ...]``
    slice); returns (out, aux_loss), aux_loss the load-balance term to
    add to the training loss."""
    helper = LayerHelper("switch_moe", param_attr=param_attr, name=name)
    d = int(input.shape[-1])
    E, H = int(num_experts), int(d_hidden)
    gate_w = helper.create_parameter(helper.param_attr, shape=[d, E],
                                     dtype=input.dtype)
    std1 = (2.0 / (d + H)) ** 0.5
    w1 = helper.create_parameter(
        helper.param_attr, shape=[E, d, H], dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(0.0, std1),
        dist_attr=("ep",))
    b1 = helper.create_parameter(helper.param_attr, shape=[E, H],
                                 dtype=input.dtype, is_bias=True,
                                 dist_attr=("ep",))
    w2 = helper.create_parameter(
        helper.param_attr, shape=[E, H, d], dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(0.0, std1),
        dist_attr=("ep",))
    b2 = helper.create_parameter(helper.param_attr, shape=[E, d],
                                 dtype=input.dtype, is_bias=True,
                                 dist_attr=("ep",))
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    aux = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="switch_moe",
        inputs={"X": [input], "GateW": [gate_w], "W1": [w1], "B1": [b1],
                "W2": [w2], "B2": [b2]},
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"capacity_factor": float(capacity_factor)},
        infer_shape=False)
    out.shape = tuple(input.shape or ())
    out.dtype = input.dtype
    aux.shape = ()
    aux.dtype = input.dtype
    return out, aux


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


# ---- activations, shape and resize layers --------------------------------

def gelu(x, approximate=False, name=None):
    return _unary("gelu", x, name, {"approximate": approximate})


def leaky_relu(x, alpha=0.02, name=None):
    return _unary("leaky_relu", x, name, {"alpha": alpha})


def relu6(x, threshold=6.0, name=None):
    return _unary("relu6", x, name, {"threshold": threshold})


def elu(x, alpha=1.0, name=None):
    return _unary("elu", x, name, {"alpha": alpha})


def swish(x, beta=1.0, name=None):
    return _unary("swish", x, name, {"beta": beta})


def hard_swish(x, name=None):
    return _unary("hard_swish", x, name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _unary("hard_sigmoid", x, name, {"slope": slope,
                                            "offset": offset})


def round(x, name=None):
    return _unary("round", x, name)


def sin(x, name=None):
    return _unary("sin", x, name)


def erf(x, name=None):
    return _unary("erf", x, name)


def softplus(x, name=None):
    return _unary("softplus", x, name)


def softsign(x, name=None):
    return _unary("softsign", x, name)


def logsigmoid(x, name=None):
    return _unary("logsigmoid", x, name)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _unary("brelu", x, name, {"t_min": float(t_min),
                                     "t_max": float(t_max)})


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772,
         name=None):
    return _unary("selu", x, name, {"scale": float(scale),
                                    "alpha": float(alpha)})


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _unary("stanh", x, name, {"scale_a": float(scale_a),
                                     "scale_b": float(scale_b)})


def maxout(x, groups, name=None, axis=1):
    return _unary("maxout", x, name, {"groups": int(groups),
                                      "axis": int(axis)})


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="mul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})
    return out


def bmm(x, y, name=None):
    helper = LayerHelper("bmm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="bmm", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC; the histogram state lives in two int64 global
    vars. Returns ``(auc, auc, [stat_pos, stat_neg])``."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        shape=[num_thresholds + 1], dtype="int64",
        initializer=init_mod.ConstantInitializer(0))
    stat_neg = helper.create_global_variable(
        shape=[num_thresholds + 1], dtype="int64",
        initializer=init_mod.ConstantInitializer(0))
    auc_out = helper.create_variable_for_type_inference(dtype="float32",
                                                        stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"num_thresholds": num_thresholds, "curve": curve})
    return auc_out, auc_out, [stat_pos, stat_neg]


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    norm = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype=label.dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]}, attrs={"epsilon": epsilon})
    return out


def image_resize(input, out_shape, resample="BILINEAR", name=None):
    helper = LayerHelper("image_resize", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = "bilinear_interp" if resample.upper() == "BILINEAR" \
        else "nearest_interp"
    helper.append_op(type=op, inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"out_h": out_shape[0], "out_w": out_shape[1]})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1,
                    data_format="NCHW"):
    if out_shape is None and scale is not None:
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    return image_resize(input, out_shape, resample="BILINEAR", name=name)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True,
                   data_format="NCHW"):
    if out_shape is None and scale is not None:
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    return image_resize(input, out_shape, resample="NEAREST", name=name)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1,
                     data_format="NCDHW"):
    if out_shape is None and scale is not None:
        out_shape = [int(s * scale) for s in input.shape[2:]]
    d, h, w = [int(v) for v in out_shape]
    helper = LayerHelper("trilinear_interp", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="trilinear_interp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"out_d": d, "out_h": h, "out_w": w,
                            "align_corners": bool(align_corners),
                            "align_mode": int(align_mode)},
                     infer_shape=False)
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the short side is ``out_short_len``, keeping the
    aspect ratio."""
    h, w = int(input.shape[2]), int(input.shape[3])
    ratio = out_short_len / float(min(h, w))
    out_shape = ([out_short_len, int(w * ratio)] if h < w
                 else [int(h * ratio), out_short_len])
    return image_resize(input, out_shape, resample=resample)


def pad(x, paddings, pad_value=0.0, name=None):
    return _unary("pad", x, name, {"paddings": list(paddings),
                                   "pad_value": pad_value})


def pad2d(x, paddings, mode="constant", pad_value=0.0, name=None):
    return _unary("pad2d", x, name, {"paddings": list(paddings),
                                     "mode": mode, "pad_value": pad_value})


def strided_slice(input, axes, starts, ends, strides, name=None):
    helper = LayerHelper("strided_slice", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="strided_slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "strides": list(strides)},
                     infer_shape=False)
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    helper = LayerHelper("unfold", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)

    def _pair2(v):
        return [v, v] if isinstance(v, int) else list(v)
    helper.append_op(type="unfold", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"kernel_sizes": _pair2(kernel_sizes),
                            "strides": _pair2(strides),
                            "paddings": (list(paddings)
                                         if isinstance(paddings,
                                                       (list, tuple))
                                         else [paddings] * 4),
                            "dilations": _pair2(dilations)},
                     infer_shape=False)
    return out


def pixel_shuffle(x, upscale_factor, name=None):
    return _unary("pixel_shuffle", x, name,
                  {"upscale_factor": int(upscale_factor)})


def space_to_depth(x, blocksize, name=None):
    return _unary("space_to_depth", x, name, {"blocksize": int(blocksize)})


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="expand_as",
                     inputs={"X": [x], "target_tensor": [target_tensor]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def reverse(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return _unary("reverse", x, name, {"axis": list(axis)})


def unique(x, dtype="int32"):
    """Refused, as in the JAX package: the output shape depends on the
    data."""
    raise NotImplementedError(
        "unique has a data-dependent output shape; use "
        "layers.unique_with_counts (first-occurrence order, padded with a "
        "Count output; Queue 1 item 10) instead")


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    helper = LayerHelper("uniform_random", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="uniform_random", inputs={},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "min": float(min),
                            "max": float(max), "seed": int(seed),
                            "dtype": dtype},
                     infer_shape=False)
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    helper = LayerHelper("gaussian_random", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="gaussian_random", inputs={},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": float(mean),
                            "std": float(std), "seed": int(seed),
                            "dtype": dtype},
                     infer_shape=False)
    return out


def _random_batch_size_like(op_type, input, shape, input_dim_idx,
                            output_dim_idx, dtype, extra):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type=op_type, inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs=dict(extra, shape=list(shape),
                                input_dim_idx=int(input_dim_idx),
                                output_dim_idx=int(output_dim_idx),
                                dtype=dtype),
                     infer_shape=False)
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _random_batch_size_like(
        "uniform_random_batch_size_like", input, shape, input_dim_idx,
        output_dim_idx, dtype,
        {"min": float(min), "max": float(max), "seed": int(seed)})


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _random_batch_size_like(
        "gaussian_random_batch_size_like", input, shape, input_dim_idx,
        output_dim_idx, dtype,
        {"mean": float(mean), "std": float(std), "seed": int(seed)})


# ---- the decode layers ----------------------------------------------------

def _decode_out(helper, like, dtype=None):
    out = helper.create_variable_for_type_inference(
        dtype=dtype or like.dtype)
    out.shape = tuple(like.shape or ())
    out.dtype = dtype or like.dtype
    return out


def kv_cache_write(cache, kv, pos, name=None):
    """``kv`` [B, H, S, D] written into the dense ``cache`` [B, H, L, D]
    at each row's ``pos`` [B] int32; returns the updated cache."""
    helper = LayerHelper("kv_cache_write", name=name)
    out = _decode_out(helper, cache)
    helper.append_op(
        type="kv_cache_write",
        inputs={"Cache": [cache], "KV": [kv], "Pos": [pos]},
        outputs={"Out": [out]}, attrs={}, infer_shape=False)
    return out


def kv_cached_attention(q, k_cache, v_cache, pos, scale=0.0, name=None):
    """``q`` [B, H, S, D] over the caches [B, H, L, D], key j visible to
    query i iff ``j <= pos[b] + i``."""
    helper = LayerHelper("kv_cached_attention", name=name)
    out = _decode_out(helper, q)
    helper.append_op(
        type="kv_cached_attention",
        inputs={"Q": [q], "K": [k_cache], "V": [v_cache], "Pos": [pos]},
        outputs={"Out": [out]}, attrs={"scale": float(scale)},
        infer_shape=False)
    return out


def paged_kv_cache_write(cache, kv, tables, pos, scale=None, limit=None,
                         name=None):
    """``kv`` [B, H, S, D] written into the block pool ``cache``
    [N, H, bs, D] through ``tables`` [B, nblk] at ``pos`` [B] (``limit``
    [B]: the real vectors a row, the rest to the trash block). An int8
    pool takes its ``scale`` [N, H, bs] and returns ``(pool, scale)``;
    else the updated pool."""
    helper = LayerHelper("paged_kv_cache_write", name=name)
    out = _decode_out(helper, cache)
    ins = {"Cache": [cache], "KV": [kv], "Tables": [tables], "Pos": [pos]}
    if limit is not None:
        ins["Limit"] = [limit]
    outs = {"Out": [out]}
    out_scale = None
    if scale is not None:
        ins["Scale"] = [scale]
        out_scale = _decode_out(helper, scale)
        outs["OutScale"] = [out_scale]
    helper.append_op(type="paged_kv_cache_write", inputs=ins,
                     outputs=outs, attrs={}, infer_shape=False)
    return (out, out_scale) if out_scale is not None else out


def paged_attention(q, k_cache, v_cache, tables, pos, k_scale=None,
                    v_scale=None, scale=0.0, impl=None, name=None):
    """``q`` [B, H, S, D] over the block pools through ``tables`` at
    ``pos``: the decode kernel for S = 1, the gather route for S > 1 or
    ``impl="xla"``."""
    helper = LayerHelper("paged_attention", name=name)
    out = _decode_out(helper, q)
    ins = {"Q": [q], "K": [k_cache], "V": [v_cache], "Tables": [tables],
           "Pos": [pos]}
    if k_scale is not None:
        ins["KScale"] = [k_scale]
        ins["VScale"] = [v_scale]
    helper.append_op(type="paged_attention", inputs=ins,
                     outputs={"Out": [out]},
                     attrs={"scale": float(scale), "impl": impl or ""},
                     infer_shape=False)
    return out


def row_gather(x, index, name=None):
    """``out[b] = x[b, index[b]]``."""
    helper = LayerHelper("row_gather", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="row_gather", inputs={"X": [x], "Index": [index]},
                     outputs={"Out": [out]}, attrs={}, infer_shape=False)
    out.shape = tuple(x.shape[:1] or ()) + tuple(x.shape[2:] or ())
    out.dtype = x.dtype
    return out


def sample_tokens(logits, temperature, top_k=None, seed=0, name=None):
    """Next token per row of ``logits`` [B, V]: greedy where
    ``temperature`` <= 0, else sampled (within ``top_k`` where > 0).
    Returns int32 [B]."""
    helper = LayerHelper("sample_tokens", name=name)
    out = helper.create_variable_for_type_inference(dtype="int32")
    ins = {"X": [logits], "Temperature": [temperature]}
    if top_k is not None:
        ins["TopK"] = [top_k]
    helper.append_op(type="sample_tokens", inputs=ins,
                     outputs={"Out": [out]}, attrs={"seed": int(seed)},
                     infer_shape=False)
    out.shape = tuple(logits.shape[:1] or ())
    out.dtype = "int32"
    return out


def spec_accept(logits, draft, temperature, num_draft, top_k=None,
                seed=0, name=None):
    """Speculative acceptance over a verified span: returns ``(tokens
    [B, S] int32, accepted [B] int32)``; row b emits ``tokens[b,
    :accepted[b] + 1]``."""
    helper = LayerHelper("spec_accept", name=name)
    out = helper.create_variable_for_type_inference(dtype="int32")
    acc = helper.create_variable_for_type_inference(dtype="int32")
    ins = {"X": [logits], "Draft": [draft], "Temperature": [temperature],
           "NumDraft": [num_draft]}
    if top_k is not None:
        ins["TopK"] = [top_k]
    helper.append_op(type="spec_accept", inputs=ins,
                     outputs={"Out": [out], "Accepted": [acc]},
                     attrs={"seed": int(seed)}, infer_shape=False)
    out.shape = tuple(logits.shape[:2] or ())
    out.dtype = "int32"
    acc.shape = tuple(logits.shape[:1] or ())
    acc.dtype = "int32"
    return out, acc
