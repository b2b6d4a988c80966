"""Sequence (ragged) ops in torch, masked-dense (counterpart of
``paddle_tpu/ops/sequence_ops.py``).

A batch of sequences is a padded dense tensor [B, T, ...] plus an
explicit ``Length`` [B] int vector, as in the JAX package: every op
masks by Length, padding positions carry zeros and take zero grads, and
the packed <-> padded converters (``sequence_pad`` / ``sequence_unpad``)
keep a static packed buffer whose valid prefix is sum(Length). Grads
take the generic vjp.
"""
import torch

from ..framework.dtype import torch_dtype
from ..framework.registry import register_op
from .common import x_of


def _len_of(ins):
    ln = x_of(ins, "Length")
    if ln is None:
        raise ValueError(
            "sequence op needs a Length input ([B] int lengths); the "
            "masked-dense design passes lengths explicitly instead of LoD "
            "offsets")
    return ln.reshape(-1).long()


def _time_mask(lengths, T):
    """[B, T] bool validity mask."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _expand(mask, ndim):
    """A [B, T] mask broadcast-shaped to rank ``ndim``."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - 2))


def _take_time(x, idx):
    """x[b, idx[b, t], ...] for an index [B, T'] over x's dim 1."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.take_along_dim(
        x, idx.expand(tuple(idx.shape[:2]) + tuple(x.shape[2:])), dim=1)


@register_op("sequence_mask", grad=False)
def sequence_mask(ctx, ins, attrs):
    """out[.., j] = j < x[..] for j < maxlen (static)."""
    x = x_of(ins).long()
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen > 0 (a "
                         "derived maxlen is a data-dependent shape)")
    out = torch.arange(maxlen, device=x.device) < x[..., None]
    return {"Out": out.to(torch_dtype(attrs.get("out_dtype", "int64")))}


@register_op("sequence_pool")
def sequence_pool(ctx, ins, attrs):
    """SUM / MEAN / SQRT / MAX / MIN / FIRST / LAST over each row's
    valid prefix; an empty row gives ``pad_value``."""
    x = x_of(ins)
    lengths = _len_of(ins)
    ptype = attrs.get("pooltype", "SUM").upper()
    mask = _expand(_time_mask(lengths, x.shape[1]), x.dim())
    n = lengths.clamp(min=1).to(x.dtype).reshape(
        (-1,) + (1,) * (x.dim() - 2))
    if ptype in ("SUM", "MEAN", "SQRT"):
        out = torch.where(mask, x, 0.0).sum(1)
        if ptype == "MEAN":
            out = out / n
        elif ptype == "SQRT":
            out = out / torch.sqrt(n)
    elif ptype == "MAX":
        out = torch.where(mask, x, float("-inf")).amax(1)
    elif ptype == "MIN":
        out = torch.where(mask, x, float("inf")).amin(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    elif ptype == "LAST":
        idx = (lengths - 1).clamp(min=0).reshape(-1, 1)
        out = _take_time(x, idx)[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype!r}")
    empty = (lengths == 0).reshape((-1,) + (1,) * (out.dim() - 1))
    return {"Out": torch.where(empty, float(attrs.get("pad_value", 0.0)),
                               out)}


@register_op("sequence_softmax")
def sequence_softmax(ctx, ins, attrs):
    """Softmax over each row's valid prefix (zeros on padding)."""
    x = x_of(ins)
    mask = _expand(_time_mask(_len_of(ins), x.shape[1]), x.dim())
    out = torch.softmax(torch.where(mask, x, float("-inf")), dim=1)
    return {"Out": torch.where(mask, out, 0.0)}


def _reverse_index(lengths, T):
    t = torch.arange(T, device=lengths.device)[None, :]
    return torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)


@register_op("sequence_reverse")
def sequence_reverse(ctx, ins, attrs):
    """Reverse each valid prefix; padding stays in place."""
    x = x_of(ins)
    return {"Out": _take_time(x, _reverse_index(_len_of(ins), x.shape[1]))}


@register_op("sequence_expand_as")
def sequence_expand_as(ctx, ins, attrs):
    """Row i of x broadcast over the first lengths[i] of maxlen steps."""
    x = x_of(ins)
    if "maxlen" not in attrs:
        raise ValueError("sequence_expand_as needs static attr maxlen")
    T = int(attrs["maxlen"])
    out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
    mask = _expand(_time_mask(_len_of(ins), T), out.dim())
    return {"Out": torch.where(mask, out, 0.0)}


def _offsets(lengths):
    return torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)[:-1]])


@register_op("sequence_pad")
def sequence_pad(ctx, ins, attrs):
    """Packed [total, ...] + lengths -> padded [B, padded_length, ...]."""
    x = x_of(ins)
    lengths = _len_of(ins)
    P = int(attrs["padded_length"])
    t = torch.arange(P, device=x.device)[None, :]
    idx = _offsets(lengths)[:, None] + t
    g = x.index_select(0, idx.clamp(0, x.shape[0] - 1).reshape(-1))
    g = g.reshape(tuple(idx.shape) + tuple(x.shape[1:]))
    mask = _expand(t < lengths[:, None], g.dim())
    return {"Out": torch.where(mask, g, float(attrs.get("pad_value", 0.0)))}


@register_op("sequence_unpad")
def sequence_unpad(ctx, ins, attrs):
    """Padded [B, P, ...] + lengths -> a packed [B*P, ...] buffer whose
    valid prefix holds the tokens back to back (zeros after)."""
    x = x_of(ins)
    lengths = _len_of(ins)
    B, P = x.shape[0], x.shape[1]
    t = torch.arange(P, device=x.device)[None, :]
    valid = (t < lengths[:, None]).reshape(-1)
    pos = (_offsets(lengths)[:, None] + t).reshape(-1)
    flat = x.reshape((B * P,) + tuple(x.shape[2:]))
    # every padding slot lands on a scratch row past the buffer
    pos = torch.where(valid, pos, B * P)
    out = flat.new_zeros((B * P + 1,) + tuple(x.shape[2:]))
    out = out.index_put((pos,), flat)
    return {"Out": out[:B * P]}


@register_op("sequence_concat")
def sequence_concat(ctx, ins, attrs):
    """Per row, x1[b, :l1] ++ x2[b, :l2] ++ ..., padded to sum(Ti)."""
    xs = list(ins["X"])
    lens = [v.reshape(-1).long() for v in ins["Length"]]
    B = xs[0].shape[0]
    T_out = sum(int(v.shape[1]) for v in xs)
    t = torch.arange(T_out, device=xs[0].device)[None, :]
    out = xs[0].new_zeros((B, T_out) + tuple(xs[0].shape[2:]))
    start = lens[0].new_zeros((B, 1))
    for x, ln in zip(xs, lens):
        rel = t - start
        within = (rel >= 0) & (rel < ln[:, None])
        g = _take_time(x, rel.clamp(0, x.shape[1] - 1))
        out = torch.where(_expand(within, out.dim()), g, out)
        start = start + ln[:, None]
    return {"Out": out, "OutLength": sum(lens).to(torch.int32)}


@register_op("sequence_slice")
def sequence_slice(ctx, ins, attrs):
    """Per row, the slice [offset, offset + length) of the sequence."""
    x = x_of(ins)
    offset = x_of(ins, "Offset").reshape(-1).long()
    length = x_of(ins, "SliceLength").reshape(-1)
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    g = _take_time(x, (offset[:, None] + t).clamp(0, T - 1))
    mask = _expand(t < length.long()[:, None], g.dim())
    return {"Out": torch.where(mask, g, 0.0), "OutLength": length}


@register_op("sequence_erase", grad=False)
def sequence_erase(ctx, ins, attrs):
    """Drop the listed token ids and compact each row left."""
    x = x_of(ins)
    lengths = _len_of(ins)
    B, T = x.shape[0], x.shape[1]
    keep = _time_mask(lengths, T)
    for tok in attrs.get("tokens", []):
        keep = keep & (x != int(tok))
    new_pos = torch.cumsum(keep.long(), 1) - 1
    cols = torch.where(keep, new_pos, T)       # dropped: a scratch column
    rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
    out = x.new_zeros((B, T + 1)).index_put((rows, cols), x)
    return {"Out": out[:, :T],
            "OutLength": keep.sum(1, dtype=torch.int32)}


@register_op("sequence_enumerate", grad=False)
def sequence_enumerate(ctx, ins, attrs):
    """Sliding windows of win_size ids; pad_value past the valid
    prefix."""
    x = x_of(ins)
    lengths = _len_of(ins)
    win = int(attrs["win_size"])
    T = x.shape[1]
    idx = torch.arange(T, device=x.device)[:, None] + \
        torch.arange(win, device=x.device)[None, :]          # [T, win]
    g = x[:, idx.clamp(0, T - 1)]                             # [B, T, win]
    ok = idx[None] < lengths[:, None, None]
    return {"Out": torch.where(ok, g, int(attrs.get("pad_value", 0)))}


@register_op("sequence_expand", infer_shape=False)
def sequence_expand(ctx, ins, attrs):
    """Row i of X repeated RepeatTimes[i] times into a static
    ``out_rows`` batch; rows past sum(RepeatTimes) are zero with
    OutLength 0."""
    x = x_of(ins)
    lengths = _len_of(ins)
    rep = x_of(ins, "RepeatTimes").reshape(-1).long()
    ends = torch.cumsum(rep, 0)
    j = torch.arange(int(attrs["out_rows"]), device=x.device)
    src = torch.searchsorted(ends, j, right=True).clamp(0, x.shape[0] - 1)
    valid = j < ends[-1]
    out = x.index_select(0, src)
    mask = valid.reshape((-1,) + (1,) * (x.dim() - 1))
    out_len = torch.where(valid, lengths.index_select(0, src), 0)
    return {"Out": torch.where(mask, out, 0.0),
            "OutLength": out_len.to(torch.int32)}


@register_op("sequence_scatter")
def sequence_scatter(ctx, ins, attrs):
    """Per row, out[b, ids[b, u]] += updates[b, u] for u < UpdLength[b]
    (every update when UpdLength is absent)."""
    x = x_of(ins)
    ids = x_of(ins, "Ids").long()
    upd = x_of(ins, "Updates")
    B, U = ids.shape
    ln = x_of(ins, "UpdLength")
    ln = ln.reshape(-1).long() if ln is not None else \
        torch.full((B,), U, device=x.device)
    valid = torch.arange(U, device=x.device)[None, :] < ln[:, None]
    rows = torch.arange(B, device=x.device)[:, None].expand(B, U)
    cols = torch.where(valid, ids, x.shape[1])    # dropped: scratch col
    wide = torch.cat([x, x.new_zeros((B, 1))], 1)
    wide = wide.index_put((rows, cols), torch.where(valid, upd, 0.0),
                          accumulate=True)
    return {"Out": wide[:, :x.shape[1]]}


@register_op("lod_reset")
def lod_reset(ctx, ins, attrs):
    """Keep the data, swap the lengths (input Y or attr target_lengths);
    steps past a new length are zeroed."""
    x = x_of(ins)
    y = x_of(ins, "Y")
    new_len = (y.reshape(-1) if y is not None else torch.tensor(
        attrs["target_lengths"], dtype=torch.int32, device=x.device))
    mask = _expand(_time_mask(new_len.long(), x.shape[1]), x.dim())
    return {"Out": torch.where(mask, x, 0.0),
            "OutLength": new_len.to(torch.int32)}


@register_op("shrink_rnn_memory")
def shrink_rnn_memory(ctx, ins, attrs):
    """Zero the rows whose sequence ended before RNN step ``step`` (the
    static-batch form of dropping them)."""
    x = x_of(ins)
    alive = (_len_of(ins) > int(attrs.get("step", 0))).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    return {"Out": torch.where(alive, x, 0.0)}


@register_op("sequence_conv")
def sequence_conv(ctx, ins, attrs):
    """Context-window projection: the [B, T, ctx*D] unfold over time
    (zeros outside the sequence) times Filter [ctx*D, M]."""
    x, filt = x_of(ins), x_of(ins, "Filter")
    mask = _time_mask(_len_of(ins), x.shape[1])
    xm = torch.where(mask[..., None], x, 0.0)
    start = int(attrs.get("contextStart", 0))
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    cols = []
    for k in range(int(attrs.get("contextLength", 3))):
        src = t + start + k
        ok = ((src >= 0) & (src < T))[None, :, None]
        cols.append(torch.where(ok, xm.index_select(1, src.clamp(0, T - 1)),
                                0.0))
    out = torch.cat(cols, -1) @ filt
    return {"Out": torch.where(mask[..., None], out, 0.0)}


@register_op("sequence_reshape")
def sequence_reshape(ctx, ins, attrs):
    """Token width D -> new_dim; lengths rescale by D / new_dim."""
    x = x_of(ins)
    lengths = x_of(ins, "Length").reshape(-1)
    new_dim = int(attrs["new_dim"])
    B, T, D = x.shape
    if (T * D) % new_dim:
        raise ValueError(f"T*D={T * D} not divisible by new_dim={new_dim}")
    return {"Out": x.reshape(B, (T * D) // new_dim, new_dim),
            "OutLength": (lengths * D) // new_dim}


@register_op("sequence_topk_avg_pooling", infer_shape=False)
def sequence_topk_avg_pooling(ctx, ins, attrs):
    """Per (row, channel), the running average of the top-k valid column
    values at each k of ``topks``. X [B, C, R, Cmax] with ROW [B] /
    COLUMN [B] valid sizes; Out [B, R, C * len(topks)], pos [B, R, C,
    max_k] (-1 where fewer than k columns are valid). Ties take the
    lower column first, as ``lax.top_k``."""
    x = x_of(ins)
    rows = x_of(ins, "ROW").reshape(-1).long()
    ncol = x_of(ins, "COLUMN").reshape(-1).long()
    topks = [int(k) for k in attrs["topks"]]
    max_k = topks[-1]
    B, C, R, Cm = x.shape
    kk = min(max_k, Cm)
    valid_c = torch.arange(Cm, device=x.device)[None, :] < ncol[:, None]
    masked = torch.where(valid_c[:, None, None, :], x, float("-inf"))
    top_v, top_i = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[..., :kk], top_i[..., :kk]
    k_live = (torch.arange(kk, device=x.device)[None, :]
              < ncol[:, None])[:, None, None, :]
    pos = torch.where(k_live, top_i, -1)
    csum = torch.cumsum(torch.where(k_live, top_v, 0.0), -1)
    outs = [csum[..., min(k, kk) - 1] / k for k in topks]  # [B, C, R]
    out = torch.stack(outs, -1).permute(0, 2, 1, 3).reshape(B, R, -1)
    row_live = (torch.arange(R, device=x.device)[None, :]
                < rows[:, None])[..., None]
    if kk < max_k:
        pos = torch.cat([pos, pos.new_full((B, C, R, max_k - kk), -1)], -1)
    return {"Out": torch.where(row_live, out, 0.0),
            "pos": pos.permute(0, 2, 1, 3).to(torch.int32)}


# ---- DynamicRNN's LoD machinery, masked-dense: the rank table is a
# stable descending sort of the lengths, reordering is a row gather,
# the memory helper is the identity ----

@register_op("lod_rank_table", grad=False, infer_shape=False)
def lod_rank_table(ctx, ins, attrs):
    """Index (original row of each rank) and Length, sorted by length
    descending, ties in their original order."""
    lengths = _len_of(ins)
    order = torch.sort(-lengths, stable=True).indices
    return {"Index": order, "Length": lengths[order]}


@register_op("max_sequence_len", grad=False, infer_shape=False)
def max_sequence_len(ctx, ins, attrs):
    return {"Out": _len_of(ins).max().reshape(1)}


@register_op("reorder_lod_tensor_by_rank", infer_shape=False)
def reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """X's rows permuted by the rank table's Index."""
    idx = x_of(ins, "RankTable").reshape(-1).long()
    return {"Out": x_of(ins).index_select(0, idx)}


@register_op("rnn_memory_helper", infer_shape=False)
def rnn_memory_helper(ctx, ins, attrs):
    """The identity that threads an RNN memory through blocks."""
    return {"Out": x_of(ins)}
