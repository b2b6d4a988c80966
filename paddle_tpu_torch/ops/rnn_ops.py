"""Full-sequence RNN ops and recurrence-adjacent convolutions in torch
(counterpart of ``paddle_tpu/ops/rnn_ops.py``): ``lstm``, ``lstmp``,
``lstm_unit``, ``gru``, ``gru_unit``, ``row_conv``, ``conv_shift`` and
``im2sequence``.

Each full-sequence op is masked-dense, as there: a [B, T, ...] batch plus
an optional ``Length`` [B]; a Python loop over the time dim runs one gate
matmul per step, and a padding step carries the previous state through
unchanged and outputs zeros. Gates are packed as the JAX package packs
them (LSTM i, f, c_hat, o; GRU u, r + candidate), so its weights load
unchanged. Grads take the generic vjp (the loop recomputed).
"""
import torch
import torch.nn.functional as F

from ..framework.registry import register_op
from .common import x_of

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _act(attrs, key, default):
    return _ACTS[attrs.get(key, default)]


def _lengths(ins, x):
    ln = x_of(ins, "Length")
    if ln is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                          device=x.device)
    return ln.reshape(-1).long()


def _maybe_reverse(x, lengths, flag):
    """Reverse each row's valid prefix (padding stays in place)."""
    if not flag:
        return x
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.take_along_dim(x, idx, dim=1)


def _live(t, lengths):
    return (t < lengths)[:, None]


def _peepholes(bias, H):
    return bias[:, 4 * H:5 * H], bias[:, 5 * H:6 * H], bias[:, 6 * H:7 * H]


@register_op("lstm", infer_shape=False)
def lstm(ctx, ins, attrs):
    """Full-sequence LSTM. Input [B, T, 4H] (pre-projected x @ Wx);
    Weight [H, 4H]; Bias [1, 4H], or [1, 7H] with use_peepholes (the
    W_ic, W_fc, W_oc diagonals); optional H0/C0 [B, H] and Length [B].
    Hidden/Cell [B, T, H]."""
    x, w, bias = x_of(ins, "Input"), x_of(ins, "Weight"), x_of(ins, "Bias")
    B, T = x.shape[0], x.shape[1]
    H = w.shape[0]
    peep = bool(attrs.get("use_peepholes", False))
    rev = bool(attrs.get("is_reverse", False))
    act_g = _act(attrs, "gate_activation", "sigmoid")
    act_c = _act(attrs, "cell_activation", "tanh")
    act_h = _act(attrs, "candidate_activation", "tanh")
    lengths = _lengths(ins, x)
    b_gate = bias[:, :4 * H] if bias is not None else 0.0
    if peep:
        w_ic, w_fc, w_oc = _peepholes(bias, H)
    h0, c0 = x_of(ins, "H0"), x_of(ins, "C0")
    h = h0 if h0 is not None else x.new_zeros((B, H))
    c = c0 if c0 is not None else x.new_zeros((B, H))
    xs = _maybe_reverse(x, lengths, rev)
    hs, cs = [], []
    for t in range(T):
        gi, gf, gc, go = (xs[:, t] + h @ w + b_gate).chunk(4, dim=-1)
        if peep:
            gi = gi + c * w_ic
            gf = gf + c * w_fc
        c_new = act_g(gf) * c + act_g(gi) * act_h(gc)
        o = act_g(go + c_new * w_oc) if peep else act_g(go)
        h_new = o * act_c(c_new)
        live = _live(t, lengths)
        h = torch.where(live, h_new, h)
        c = torch.where(live, c_new, c)
        hs.append(torch.where(live, h, 0.0))
        cs.append(torch.where(live, c, 0.0))
    return {"Hidden": _maybe_reverse(torch.stack(hs, 1), lengths, rev),
            "Cell": _maybe_reverse(torch.stack(cs, 1), lengths, rev)}


@register_op("lstmp", infer_shape=False)
def lstmp(ctx, ins, attrs):
    """LSTM with a recurrent projection: the carried state is r =
    proj_act(h @ ProjWeight) [B, P]; Weight [P, 4H]; Bias [1, 4H] or
    [1, 7H] with use_peepholes. Projection [B, T, P], Cell [B, T, H]."""
    x, w = x_of(ins, "Input"), x_of(ins, "Weight")
    w_proj, bias = x_of(ins, "ProjWeight"), x_of(ins, "Bias")
    B, T = x.shape[0], x.shape[1]
    H, P = w_proj.shape
    peep = bool(attrs.get("use_peepholes", False))
    rev = bool(attrs.get("is_reverse", False))
    act_g = _act(attrs, "gate_activation", "sigmoid")
    act_c = _act(attrs, "cell_activation", "tanh")
    act_h = _act(attrs, "candidate_activation", "tanh")
    act_p = _act(attrs, "proj_activation", "identity")
    lengths = _lengths(ins, x)
    b_gate = bias[:, :4 * H] if bias is not None else 0.0
    if peep:
        w_ic, w_fc, w_oc = _peepholes(bias, H)
    h0, c0 = x_of(ins, "H0"), x_of(ins, "C0")
    r = h0 if h0 is not None else x.new_zeros((B, P))
    c = c0 if c0 is not None else x.new_zeros((B, H))
    xs = _maybe_reverse(x, lengths, rev)
    rs, cs = [], []
    for t in range(T):
        gi, gf, gc, go = (xs[:, t] + r @ w + b_gate).chunk(4, dim=-1)
        if peep:
            gi = gi + c * w_ic
            gf = gf + c * w_fc
        c_new = act_g(gf) * c + act_g(gi) * act_h(gc)
        o = act_g(go + c_new * w_oc) if peep else act_g(go)
        r_new = act_p((o * act_c(c_new)) @ w_proj)
        live = _live(t, lengths)
        r = torch.where(live, r_new, r)
        c = torch.where(live, c_new, c)
        rs.append(torch.where(live, r, 0.0))
        cs.append(torch.where(live, c, 0.0))
    return {"Projection": _maybe_reverse(torch.stack(rs, 1), lengths, rev),
            "Cell": _maybe_reverse(torch.stack(cs, 1), lengths, rev)}


@register_op("lstm_unit")
def lstm_unit(ctx, ins, attrs):
    """One LSTM step on gate pre-activations: X [B, 4H] split (i, f,
    c_hat, o), C_prev [B, H]."""
    i, f, c_hat, o = x_of(ins).chunk(4, dim=-1)
    c = torch.sigmoid(f + float(attrs.get("forget_bias", 0.0))) * \
        x_of(ins, "C_prev") + torch.sigmoid(i) * torch.tanh(c_hat)
    return {"C": c, "H": torch.sigmoid(o) * torch.tanh(c)}


def _gru_step(xt, h, w_g, w_c, bias, act_g, act_c, origin_mode, H):
    xg = xt[:, :2 * H] + h @ w_g
    if bias is not None:
        xg = xg + bias[:, :2 * H]
    u, r = act_g(xg).chunk(2, dim=-1)
    xc = xt[:, 2 * H:] + (r * h) @ w_c
    if bias is not None:
        xc = xc + bias[:, 2 * H:]
    cand = act_c(xc)
    if origin_mode:
        return u * h + (1.0 - u) * cand
    return u * cand + (1.0 - u) * h


@register_op("gru", infer_shape=False)
def gru(ctx, ins, attrs):
    """Full-sequence GRU. Input [B, T, 3H] (pre-projected, packed u, r,
    c_hat); Weight [H, 3H] (u/r gates, then the candidate); Bias [1, 3H];
    optional H0 [B, H] and Length [B]. Hidden [B, T, H]."""
    x, w, bias = x_of(ins, "Input"), x_of(ins, "Weight"), x_of(ins, "Bias")
    B, T = x.shape[0], x.shape[1]
    H = w.shape[0]
    rev = bool(attrs.get("is_reverse", False))
    origin = bool(attrs.get("origin_mode", False))
    act_g = _act(attrs, "gate_activation", "sigmoid")
    act_c = _act(attrs, "activation", "tanh")
    lengths = _lengths(ins, x)
    w_g, w_c = w[:, :2 * H], w[:, 2 * H:]
    h0 = x_of(ins, "H0")
    h = h0 if h0 is not None else x.new_zeros((B, H))
    xs = _maybe_reverse(x, lengths, rev)
    hs = []
    for t in range(T):
        h_new = _gru_step(xs[:, t], h, w_g, w_c, bias, act_g, act_c, origin,
                          H)
        live = _live(t, lengths)
        h = torch.where(live, h_new, h)
        hs.append(torch.where(live, h, 0.0))
    return {"Hidden": _maybe_reverse(torch.stack(hs, 1), lengths, rev)}


@register_op("gru_unit")
def gru_unit(ctx, ins, attrs):
    """One GRU step: Input [B, 3H] pre-projected, HiddenPrev [B, H],
    Weight [H, 3H], optional Bias [1, 3H]."""
    h, w = x_of(ins, "HiddenPrev"), x_of(ins, "Weight")
    H = h.shape[-1]
    out = _gru_step(x_of(ins, "Input"), h, w[:, :2 * H], w[:, 2 * H:],
                    x_of(ins, "Bias"), _act(attrs, "gate_activation",
                                            "sigmoid"),
                    _act(attrs, "activation", "tanh"),
                    bool(attrs.get("origin_mode", False)), H)
    return {"Hidden": out}


@register_op("row_conv")
def row_conv(ctx, ins, attrs):
    """Lookahead row convolution: out[b, t] = sum_k x[b, t+k] *
    filter[k] for k < future context; steps past a row's length count
    zero."""
    x, filt = x_of(ins), x_of(ins, "Filter")       # [B, T, D], [K, D]
    T = x.shape[1]
    lengths = _lengths(ins, x)
    t = torch.arange(T, device=x.device)
    out = torch.zeros_like(x)
    for k in range(filt.shape[0]):
        src = t + k
        ok = (src[None, :] < lengths[:, None])[..., None]
        g = x.index_select(1, src.clamp(0, T - 1))
        out = out + torch.where(ok, g, 0.0) * filt[k]
    mask = (t[None, :] < lengths[:, None])[..., None]
    return {"Out": torch.where(mask, out, 0.0)}


@register_op("conv_shift")
def conv_shift(ctx, ins, attrs):
    """Circular correlation: out[b, i] = sum_j x[b, (i + j - M//2) mod N]
    * y[b, j], M odd."""
    x, y = x_of(ins), x_of(ins, "Y")               # [B, N], [B, M]
    N, M = x.shape[1], y.shape[1]
    i = torch.arange(N, device=x.device)[:, None]
    j = torch.arange(M, device=x.device)[None, :]
    g = x[:, (i + j - M // 2) % N]                 # [B, N, M]
    return {"Out": torch.einsum("bnm,bm->bn", g, y)}


@register_op("im2sequence", infer_shape=False)
def im2sequence(ctx, ins, attrs):
    """Image -> patch sequence: x [B, C, H, W] unfolds to [B, oh*ow,
    C*kh*kw] (features ordered C, kh, kw); every row has length
    oh*ow."""
    x = x_of(ins)
    kh, kw = attrs["kernels"]
    sh, sw = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0, 0, 0])
    pu, pl, pd, pr = (pads if len(pads) == 4 else
                      [pads[0], pads[1], pads[0], pads[1]])
    xp = F.pad(x, (pl, pr, pu, pd))
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    cols = F.unfold(xp, (kh, kw), stride=(sh, sw))  # [B, C*kh*kw, L]
    return {"Out": cols.transpose(1, 2),
            "OutLength": torch.full((x.shape[0],), oh * ow,
                                    dtype=torch.int32, device=x.device)}
