"""The full-sequence RNN layers (a copy of ``paddle_tpu/layers/more.py``
``:38-177``): ``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru`` and
``lstm``, thin wrappers over the ``lstm`` / ``lstmp`` / ``gru`` ops of
``ops/rnn_ops.py`` (input pre-projected, masked-dense ``length``)."""
from . import tensor as T
from .layer_helper import LayerHelper


def _single(op_type, ins, attrs, dtype, out_slot="Out", name=None,
            infer_shape=False, shape=None, stop_gradient=False):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=stop_gradient)
    helper.append_op(type=op_type, inputs=ins, attrs=attrs or {},
                     outputs={out_slot: [out]}, infer_shape=infer_shape)
    if shape is not None and getattr(out, "shape", None) in (None, ()):
        out.shape = tuple(shape)
    return out


def _multi(op_type, ins, attrs, outs_spec, name=None, infer_shape=False):
    """outs_spec: [(slot, dtype)] -> tuple of vars in that order."""
    helper = LayerHelper(op_type, name=name)
    outs = {s: [helper.create_variable_for_type_inference(d)]
            for s, d in outs_spec}
    helper.append_op(type=op_type, inputs=ins, attrs=attrs or {},
                     outputs=outs, infer_shape=infer_shape)
    vals = tuple(outs[s][0] for s, _ in outs_spec)
    return vals if len(vals) > 1 else vals[0]


# --------------------------------------------------------------- RNN API

def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", length=None, name=None):
    """reference layers/nn.py dynamic_lstm -> lstm op. input [B, T, 4H]
    (pre-projected); size = 4H. Returns (hidden, cell) [B, T, H]."""
    H = size // 4
    helper = LayerHelper("dynamic_lstm", name=name,
                         param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(param_attr, [H, 4 * H], input.dtype)
    bias_w = 7 * H if use_peepholes else 4 * H
    bias = helper.create_parameter(bias_attr, [1, bias_w], input.dtype,
                                   is_bias=True)
    ins = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    if length is not None:
        ins["Length"] = [length]
    hidden, cell = _multi(
        "lstm", ins,
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation},
        [("Hidden", input.dtype), ("Cell", input.dtype)], name=name)
    B, Tm = input.shape[0], input.shape[1]
    for v in (hidden, cell):
        v.shape = (B, Tm, H)
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", length=None, name=None):
    """reference dynamic_lstmp -> lstmp op. Returns (projection, cell).
    use_peepholes=True (the reference default) sizes Bias [1, 7H] with the
    peephole diagonals in columns 4H:7H."""
    H = size // 4
    helper = LayerHelper("dynamic_lstmp", name=name,
                         param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(param_attr, [proj_size, 4 * H],
                                     input.dtype)
    proj_w = helper.create_parameter(param_attr, [H, proj_size],
                                     input.dtype)
    bias_w = 7 * H if use_peepholes else 4 * H
    bias = helper.create_parameter(bias_attr, [1, bias_w], input.dtype,
                                   is_bias=True)
    ins = {"Input": [input], "Weight": [weight], "ProjWeight": [proj_w],
           "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    if length is not None:
        ins["Length"] = [length]
    proj, cell = _multi(
        "lstmp", ins,
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation,
         "proj_activation": proj_activation},
        [("Projection", input.dtype), ("Cell", input.dtype)], name=name)
    B, Tm = input.shape[0], input.shape[1]
    proj.shape = (B, Tm, proj_size)
    cell.shape = (B, Tm, H)
    return proj, cell


def dynamic_gru(input, size, h_0=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", origin_mode=False,
                length=None, name=None):
    """reference dynamic_gru -> gru op. input [B, T, 3H]; size = H."""
    helper = LayerHelper("dynamic_gru", name=name,
                         param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(param_attr, [size, 3 * size],
                                     input.dtype)
    bias = helper.create_parameter(bias_attr, [1, 3 * size], input.dtype,
                                   is_bias=True)
    ins = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if length is not None:
        ins["Length"] = [length]
    out = _single("gru", ins,
                  {"is_reverse": is_reverse, "origin_mode": origin_mode,
                   "gate_activation": gate_activation,
                   "activation": candidate_activation},
                  input.dtype, out_slot="Hidden", name=name)
    out.shape = (input.shape[0], input.shape[1], size)
    return out


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers=1,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """reference layers/nn.py lstm (the cudnn_lstm front), mapped onto
    stacked `lstm` ops with an in-graph input projection per
    layer/direction, as the JAX package maps it (the reference's packed
    cuDNN weight blob is not reproduced). Returns (out [B,T,H*dirs],
    last_h, last_c) where the last states are the FINAL layer's last
    valid step, shaped [1, B, H*dirs] (the reference stacks all layers —
    documented divergence)."""
    from . import nn as nn_mod
    x = input
    dirs = 2 if is_bidirec else 1
    Tm = input.shape[1]

    def _at(v, t):
        sl = T.slice(v, axes=[1], starts=[t], ends=[t + 1])
        return T.transpose(sl, [1, 0, 2])          # [1, B, H]

    last_h = last_c = None
    for layer in range(num_layers):
        per_dir, last_hs, last_cs = [], [], []
        for d in range(dirs):
            proj = nn_mod.fc(x, 4 * hidden_size, num_flatten_dims=2,
                             bias_attr=False)
            hidden, cell = dynamic_lstm(
                proj, 4 * hidden_size, use_peepholes=False,
                is_reverse=(d == 1))
            per_dir.append(hidden)
            # the reverse direction processes t=Tm-1 FIRST; its final
            # state lives at t=0
            t_last = 0 if d == 1 else Tm - 1
            last_hs.append(_at(hidden, t_last))
            last_cs.append(_at(cell, t_last))
        x = per_dir[0] if dirs == 1 else T.concat(per_dir, axis=2)
        last_h = last_hs[0] if dirs == 1 else T.concat(last_hs, axis=2)
        last_c = last_cs[0] if dirs == 1 else T.concat(last_cs, axis=2)
        if dropout_prob and not is_test and layer < num_layers - 1:
            # cudnn semantics: dropout BETWEEN layers, never after the top
            x = nn_mod.dropout(x, dropout_prob)
    return x, last_h, last_c
