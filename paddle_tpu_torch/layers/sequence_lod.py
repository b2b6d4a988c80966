"""fluid.layers sequence surface (a copy of
``paddle_tpu/layers/sequence_lod.py``).

The API follows the reference's, with the masked-dense difference of
the JAX package: sequence boundaries come as an explicit ``length``
Variable ([B] ints) instead of the input's LoD (see
``ops/sequence_ops.py``). Layers that change lengths return (out,
out_length).
"""
from .layer_helper import LayerHelper


def _seq_op(op_type, inputs, attrs, dtype, helper=None, n_outs=1,
            out_dtypes=None, name=None):
    helper = helper or LayerHelper(op_type, name=name)
    out_dtypes = out_dtypes or [dtype] * n_outs
    outs = [helper.create_variable_for_type_inference(dtype=dt)
            for dt in out_dtypes]
    out_slots = {"Out": [outs[0]]}
    if n_outs > 1:
        out_slots["OutLength"] = [outs[1]]
    helper.append_op(type=op_type, inputs=inputs, outputs=out_slots,
                     attrs=attrs or {})
    return outs[0] if n_outs == 1 else tuple(outs)


def sequence_pool(input, pool_type, length=None, is_test=False, pad_value=0.0):
    """reference sequence_lod.py sequence_pool; pad_value fills the result
    rows of zero-length sequences."""
    return _seq_op("sequence_pool",
                   {"X": [input], "Length": [length]},
                   {"pooltype": pool_type.upper(),
                    "pad_value": float(pad_value)}, input.dtype)


def sequence_first_step(input, length=None):
    return sequence_pool(input, "FIRST", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "LAST", length=length)


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    return _seq_op("sequence_softmax",
                   {"X": [input], "Length": [length]}, {}, input.dtype,
                   name=name)


def sequence_reverse(x, length=None, name=None):
    return _seq_op("sequence_reverse",
                   {"X": [x], "Length": [length]}, {}, x.dtype, name=name)


def sequence_expand_as(x, y=None, length=None, maxlen=None, name=None):
    """x row i broadcast over the i-th target length. `length`+`maxlen`
    replace the reference's `y` LoD donor; passing a padded `y` Variable
    infers maxlen from its shape."""
    if maxlen is None:
        if y is None or y.shape is None or len(y.shape) < 2:
            raise ValueError("sequence_expand_as needs maxlen= or a padded "
                             "y with a static time dim")
        maxlen = int(y.shape[1])
    return _seq_op("sequence_expand_as",
                   {"X": [x], "Length": [length]},
                   {"maxlen": int(maxlen)}, x.dtype, name=name)


def sequence_pad(x, pad_value=0.0, maxlen=None, length=None, name=None):
    """Packed [total, ...] -> padded [B, maxlen, ...]
    (reference sequence_pad; pad_value here is a float, not a Variable)."""
    if maxlen is None:
        raise ValueError(
            "sequence_pad needs a static maxlen= (the reference derives "
            "the padded length from LoD — a dynamic output shape)")
    out = _seq_op("sequence_pad",
                  {"X": [x], "Length": [length]},
                  {"padded_length": int(maxlen),
                   "pad_value": float(pad_value)}, x.dtype, name=name)
    return out, length


def sequence_unpad(x, length=None, name=None):
    return _seq_op("sequence_unpad",
                   {"X": [x], "Length": [length]}, {}, x.dtype, name=name)


def sequence_concat(input, length=None, name=None):
    """input: list of padded [B, Ti, ...]; length: parallel list of [B]
    length Variables. Returns (out, out_length)."""
    if length is None or len(length) != len(input):
        raise ValueError(
            "sequence_concat needs length=[len1, len2, ...] (one [B] int "
            "Variable per input); the reference reads LoD off the inputs, "
            "the masked-dense design passes lengths explicitly")
    return _seq_op("sequence_concat",
                   {"X": list(input), "Length": list(length)}, {},
                   input[0].dtype, n_outs=2,
                   out_dtypes=[input[0].dtype, "int32"], name=name)


def sequence_slice(input, offset, length, name=None, seq_length=None):
    """Per-row [offset, offset+length) slice; `seq_length` (the input's
    valid-length vector) is optional — the kernel slices by Offset and
    SliceLength alone."""
    ins = {"X": [input], "Offset": [offset], "SliceLength": [length]}
    if seq_length is not None:
        ins["Length"] = [seq_length]
    return _seq_op("sequence_slice", ins, {}, input.dtype, n_outs=2,
                   out_dtypes=[input.dtype, "int32"], name=name)


def sequence_erase(input, tokens, length=None, name=None):
    return _seq_op("sequence_erase",
                   {"X": [input], "Length": [length]},
                   {"tokens": [int(t) for t in tokens]}, input.dtype,
                   n_outs=2, out_dtypes=[input.dtype, "int32"], name=name)


def sequence_enumerate(input, win_size, pad_value=0, length=None, name=None):
    return _seq_op("sequence_enumerate",
                   {"X": [input], "Length": [length]},
                   {"win_size": int(win_size), "pad_value": pad_value},
                   input.dtype, name=name)


def sequence_reshape(input, new_dim, length=None, name=None):
    return _seq_op("sequence_reshape",
                   {"X": [input], "Length": [length]},
                   {"new_dim": int(new_dim)}, input.dtype, n_outs=2,
                   out_dtypes=[input.dtype, "int32"], name=name)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        raise ValueError(
            "sequence_mask needs a static maxlen= (the reference's "
            "default derives it from max(x) — a dynamic output shape)")
    return _seq_op("sequence_mask", {"X": [x]},
                   {"maxlen": int(maxlen), "out_dtype": dtype}, dtype,
                   name=name)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, length=None, name=None):
    """reference sequence_lod.py sequence_conv: context window (im2col over
    time) + one projection matmul."""
    assert filter_stride == 1, "sequence_conv supports stride 1"
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    D = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                shape=[filter_size * D, num_filters],
                                dtype=input.dtype)
    if padding_start is None:
        padding_start = -(filter_size // 2)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [w], "Length": [length]},
        outputs={"Out": [out]},
        attrs={"contextStart": int(padding_start),
               "contextLength": int(filter_size), "contextStride": 1})
    out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out, act)


def sequence_expand(x, y=None, ref_level=-1, length=None,
                    repeat_times=None, out_rows=None, name=None):
    """Masked-dense sequence_expand (reference sequence_expand_op.h):
    row i of x repeats repeat_times[i] times into a static out_rows
    buffer (padded; OutLength carries per-row lengths)."""
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out_len = helper.create_variable_for_type_inference(dtype="int32")
    if repeat_times is None or out_rows is None or length is None:
        raise ValueError(
            "masked-dense sequence_expand needs length= ([B] int row "
            "lengths), repeat_times= ([B] int), and out_rows= (static "
            "output capacity); the reference derives these from LoD")
    ins = {"X": [x], "RepeatTimes": [repeat_times]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(type="sequence_expand", inputs=ins,
                     outputs={"Out": [out], "OutLength": [out_len]},
                     attrs={"out_rows": int(out_rows)},
                     infer_shape=False)
    return out


def sequence_scatter(input, index, updates, upd_length=None, name=None):
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    ins = {"X": [input], "Ids": [index], "Updates": [updates]}
    if upd_length is not None:
        ins["UpdLength"] = [upd_length]
    helper.append_op(type="sequence_scatter", inputs=ins,
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def lod_reset(x, y=None, target_lod=None):
    """Masked-dense lod_reset (reference lod_reset_op.h): re-mask x by
    new lengths (y: [B] lengths tensor, or target_lod: static list)."""
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out_len = helper.create_variable_for_type_inference(dtype="int32")
    if y is None:
        if target_lod is None:
            raise ValueError("lod_reset needs y= or target_lod=")
        import numpy as np
        from . import tensor as T
        y = T.assign(np.asarray(target_lod, np.int32))
    helper.append_op(type="lod_reset", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "OutLength": [out_len]},
                     infer_shape=False)
    return out


def lod_append(x, level):
    """reference lod_append (layers/nn.py): append a lod level. The
    masked-dense design carries ONE explicit length vector, so
    appending a level == re-masking by it (lod_reset)."""
    return lod_reset(x, y=level if not isinstance(level, (list, tuple))
                     else None,
                     target_lod=level if isinstance(level, (list, tuple))
                     else None)
