"""Incremental-decoding ops: the KV-cache write and read of the dense
bank, the paged-pool write, the paged read, the per-row gather, the
sampler and the speculative acceptance, as plain functions on tensors
(what ``models.GPT`` calls) and as the registered ops of the Fluid
programs that ``models.gpt``'s builders make.

Counterpart of ``paddle_tpu/ops/decode_ops.py``. JAX arrays are
immutable, so the JAX ops return updated caches and the executor donates
the inputs so that XLA appends in place; here the cache and pool writes
update their tensors in place (``index_put_``) and return them. The
registered write ops keep the JAX ops' values: they write a clone of
their ``Cache`` (and ``Scale``) input, so no input (a fed or fetched
pool, scope state, a cached constant, a view) changes behind the
program's back.

The registered ``paged_attention`` op routes as the JAX op does: one
query a row (S = 1) takes the decode kernel (K5 on CUDA tensors, its
plain version on CPU tensors); S > 1, or ``impl="xla"``, takes the
gather route ``paged_attention_gather``; ``"pallas"`` and
``"interpret"`` take the kernel. ``sample_tokens`` and ``spec_accept``
draw from the op's seeded generator (``needs_rng``); their greedy rows
are the argmax, bit for bit, and their sampled rows follow the JAX op's
distribution, not its threefry draws.
"""
import numpy as np
import torch

from ..framework.registry import register_op
from ..kernels.paged_attention import (paged_attention,
                                      paged_attention_gather, quantize_kv)
from .common import x_of

_NEG_INF = -1e30


def kv_cache_write(cache, kv, pos):
    """Write S new vectors into a dense cache at each row's position, in
    place. cache ``[B, H, L, D]``, kv ``[B, H, S, D]``, pos ``[B]``:
    ``cache[b, :, pos[b]:pos[b]+S] = kv[b]``. The start clamps to
    ``[0, L - S]`` as ``lax.dynamic_update_slice`` does. Returns cache."""
    B, _, L, _ = cache.shape
    S = kv.shape[2]
    start = pos.long().clamp(0, L - S)
    rows = torch.arange(B, device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(S, device=cache.device)[None, :]
    # advanced indices at dims 0 and 2 around a slice: the indexed dims
    # come first, so the value is [B, S, H, D]
    cache[rows, :, cols] = kv.permute(0, 2, 1, 3).to(cache.dtype)
    return cache


def kv_cached_attention(q, k, v, pos, scale=None):
    """Causal attention of S fresh queries over a dense cache, masked by
    per-row positions: key j is visible to query i iff
    ``j <= pos[b] + i``. q ``[B, H, S, D]``, k/v ``[B, H, L, D]``.
    Scores and softmax in float32; output in q's dtype."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    L, S = k.shape[2], q.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    key_idx = torch.arange(L, device=q.device)[None, None, :]
    qry_pos = pos.long()[:, None, None] \
        + torch.arange(S, device=q.device)[None, :, None]
    scores = scores.masked_fill(~(key_idx <= qry_pos)[:, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def paged_kv_cache_write(pool, kv, tables, pos, scale=None, limit=None):
    """Write S new vectors per row into a block-paged pool, in place:
    row b's vector i lands at ``(tables[b, (pos[b]+i)//bs], :,
    (pos[b]+i) % bs)``. ``limit [B]`` marks how many of the S vectors
    are real; the others go to the trash block 0. With an int8 pool the
    vectors are quantized and ``scale [N, H, bs]`` is written too.
    Returns ``pool`` or ``(pool, scale)``. Rows whose table entry is the
    trash block write garbage nobody reads (duplicate trash writes may
    land in any order)."""
    bs = pool.shape[2]
    B, H, S, D = kv.shape
    tables = tables.long()
    steps = torch.arange(S, device=kv.device)
    qpos = pos.long()[:, None] + steps[None, :]                  # [B, S]
    safe = qpos.clamp(0, tables.shape[1] * bs - 1)
    blk = torch.gather(tables, 1, safe // bs)
    if limit is not None:
        blk = torch.where(steps[None, :] < limit.long()[:, None], blk,
                          torch.zeros_like(blk))
    blk, offs = blk.reshape(-1), (safe % bs).reshape(-1)         # [B*S]
    vals = kv.permute(0, 2, 1, 3).reshape(B * S, H, D)
    # advanced indices at dims 0 and 2: the value is [B*S, H, D]
    if pool.dtype == torch.int8:
        qv, sc = quantize_kv(vals)
        pool[blk, :, offs] = qv
        scale[blk, :, offs] = sc
        return pool, scale
    pool[blk, :, offs] = vals.to(pool.dtype)
    return pool


def row_gather(x, index):
    """``out[b] = x[b, index[b]]`` (index clipped into range)."""
    idx = index.long().clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _top_k_mask(logits, scaled, top_k):
    """``scaled`` with every entry below its row's ``top_k``-th highest
    logit set to -1e30 (rows with ``top_k <= 0`` keep the whole
    vocabulary; ties at the threshold stay eligible). ``logits`` and
    ``scaled`` are ``[..., V]``, ``top_k`` ``[B]`` (broadcast over the
    middle dims)."""
    V = logits.shape[-1]
    top_k = top_k.to(logits.device).long()
    k = top_k.clamp(1, V).view(-1, *([1] * (logits.dim() - 1)))
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = torch.gather(
        sorted_desc, -1, (k - 1).expand(*logits.shape[:-1], 1))
    keep_all = (top_k <= 0).view(-1, *([1] * (logits.dim() - 1)))
    return scaled.masked_fill(~(keep_all | (logits >= thresh)), _NEG_INF)


def draw_tokens(probs, generator=None):
    """One index per row of ``probs [B, V]`` by inverse CDF: one uniform
    ``u`` per row from ``generator``, the first index whose cumulative
    probability exceeds ``u`` times the row's total (so a zero-probability
    entry is never drawn). Unlike ``torch.multinomial``, whose argument
    check reads the device, it can be captured into a CUDA graph.
    Returns int64 ``[B]``."""
    cdf = probs.cumsum(-1)
    u = torch.rand((probs.shape[0], 1), generator=generator,
                   device=probs.device, dtype=probs.dtype)
    idx = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    return idx.clamp_(max=probs.shape[-1] - 1)[:, 0]


def all_greedy(temperature):
    """True when every row of the host array ``temperature`` is greedy
    (<= 0): the sampling mode a caller decides on the host."""
    return bool((np.asarray(temperature) <= 0).all())


def sample_tokens(logits, temperature, top_k=None, generator=None,
                  greedy=None):
    """Next token per row from logits ``[B, V]`` with per-row sampling
    config: rows with ``temperature <= 0`` take the argmax (first maximum
    wins); the others sample from ``softmax(logits / t)``, restricted to
    the ``top_k`` highest logits where ``top_k > 0`` (ties at the
    threshold stay eligible). Draws come from ``generator``
    (:func:`draw_tokens`). ``greedy`` is the sampling mode, decided by
    the caller on the host: True takes the argmax of every row and draws
    nothing; False runs the sampler over every row with no host
    branch, so a CUDA graph can hold it; None decides it from
    ``temperature``, which must then lie on the host. Returns int32
    ``[B]``."""
    logits = logits.float()
    if greedy is None:
        if temperature.device.type != "cpu":
            raise ValueError("sample_tokens: pass greedy= when the "
                             "temperatures lie on the device")
        greedy = all_greedy(temperature.numpy())
    argmax = torch.argmax(logits, dim=-1)
    if greedy:
        return argmax.to(torch.int32)
    temperature = temperature.to(logits.device).float()
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    if top_k is not None:
        scaled = _top_k_mask(logits, scaled, top_k)
    sampled = draw_tokens(torch.softmax(scaled, dim=-1), generator)
    return torch.where(temperature <= 0, argmax, sampled).to(torch.int32)


def spec_accept(logits, draft, temperature, num_draft, top_k=None,
                generator=None, greedy=None):
    """Speculative-decoding acceptance over a verified span: rejection
    sampling specialised to a point-mass draft (the drafters propose
    tokens, not distributions), so the draft ``d_i`` is accepted with
    probability ``p_i(d_i)`` and the residual on rejection is ``p`` with
    ``d_i`` removed.

    logits ``[B, S, V]`` (position i: the model's next-token scores after
    the current token and drafts ``d_1..d_i``), draft ``[B, K]`` (K =
    S - 1), temperature ``[B]``, num_draft ``[B]`` (each row's real draft
    count), optional top_k ``[B]``: the same per-row sampling as
    :func:`sample_tokens`. Greedy rows accept ``d_i`` while it equals the
    argmax and emit argmax tokens throughout, so speculative greedy
    output is the sequential greedy output. ``greedy`` as in
    :func:`sample_tokens` (True draws nothing).

    Returns ``(out [B, S] int32, accepted [B] int32)``: row b emits
    ``out[b, :accepted[b] + 1]`` (accepted drafts, then the correction
    or bonus token). Counterpart of the JAX ``spec_accept`` op."""
    logits = logits.float()
    B, S, V = logits.shape
    K = S - 1
    dev = logits.device
    draft = draft.to(dev).long()
    num_draft = num_draft.to(dev).long()
    if greedy is None:
        if temperature.device.type != "cpu":
            raise ValueError("spec_accept: pass greedy= when the "
                             "temperatures lie on the device")
        greedy = all_greedy(temperature.numpy())
    temperature = temperature.to(dev).float()
    rows = torch.arange(B, device=dev)
    greedy_tok = torch.argmax(logits, dim=-1)                    # [B, S]
    steps = torch.arange(K, device=dev)[None, :]
    if greedy:
        accept = draft == greedy_tok[:, :K]
    else:
        scaled = logits / temperature.clamp_min(1e-6)[:, None, None]
        if top_k is not None:
            scaled = _top_k_mask(logits, scaled, top_k)
        p = torch.softmax(scaled[:, :K], dim=-1)                 # [B, K, V]
        p_draft = torch.gather(p, 2, draft[:, :, None])[:, :, 0]
        u = torch.rand((B, K), generator=generator, device=dev)
        is_greedy = (temperature <= 0)[:, None]
        accept = torch.where(is_greedy, draft == greedy_tok[:, :K],
                             u < p_draft)
    accept = accept & (steps < num_draft[:, None])
    # the leading run of accepts: a rejection stops everything after it
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)           # [B]
    corr = greedy_tok[rows, a]
    if not greedy:
        row_scaled = scaled[rows, a]                             # [B, V]
        d_at_a = draft[rows, a.clamp(0, max(K - 1, 0))] if K > 0 \
            else torch.zeros_like(a)
        excl = (torch.arange(V, device=dev)[None, :] == d_at_a[:, None]) \
            & (a < num_draft)[:, None]
        resample = draw_tokens(torch.softmax(
            row_scaled.masked_fill(excl, _NEG_INF), dim=-1), generator)
        corr = torch.where(temperature <= 0, corr, resample)
    padded = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
    out = torch.where(torch.arange(S, device=dev)[None, :] < a[:, None],
                      padded, corr[:, None])
    return out.to(torch.int32), a.to(torch.int32)


# ---- the registered ops ---------------------------------------------------

@register_op("kv_cache_write", grad=False, infer_shape=False)
def kv_cache_write_op(ctx, ins, attrs):
    """Cache [B, H, L, D], KV [B, H, S, D], Pos [B] -> Out: the cache with
    ``Out[b, :, pos[b]:pos[b]+S] = KV[b]``."""
    return {"Out": kv_cache_write(x_of(ins, "Cache").clone(),
                                  x_of(ins, "KV"), x_of(ins, "Pos"))}


@register_op("kv_cached_attention", grad=False, infer_shape=False)
def kv_cached_attention_op(ctx, ins, attrs):
    """Q [B, H, S, D] over the K/V caches [B, H, L, D], key j visible to
    query i iff ``j <= Pos[b] + i``."""
    return {"Out": kv_cached_attention(
        x_of(ins, "Q"), x_of(ins, "K"), x_of(ins, "V"), x_of(ins, "Pos"),
        scale=float(attrs.get("scale", 0.0)) or None)}


@register_op("paged_kv_cache_write", grad=False, infer_shape=False)
def paged_kv_cache_write_op(ctx, ins, attrs):
    """Cache [N, H, bs, D], KV [B, H, S, D], Tables [B, nblk], Pos [B]
    (+ Limit [B]; + Scale [N, H, bs] for an int8 pool) -> Out (+
    OutScale): the pool with row b's vector i at ``(Tables[b,
    (Pos[b]+i)//bs], :, (Pos[b]+i) % bs)``, past-limit vectors in the
    trash block 0."""
    pool = x_of(ins, "Cache").clone()
    scale = x_of(ins, "Scale").clone() if ins.get("Scale") else None
    out = paged_kv_cache_write(pool, x_of(ins, "KV"), x_of(ins, "Tables"),
                               x_of(ins, "Pos"), scale=scale,
                               limit=x_of(ins, "Limit"))
    if pool.dtype == torch.int8:
        return {"Out": out[0], "OutScale": out[1]}
    return {"Out": out}


@register_op("paged_attention", grad=False, infer_shape=False)
def paged_attention_op(ctx, ins, attrs):
    """Q [B, H, S, D] over the block pools K/V [N, H, bs, D] (+ KScale/
    VScale for int8) through Tables [B, nblk] int32 at Pos [B] int32 ->
    Out [B, H, S, D], routed as the module docstring says."""
    q, k, v = x_of(ins, "Q"), x_of(ins, "K"), x_of(ins, "V")
    tables, pos = x_of(ins, "Tables"), x_of(ins, "Pos")
    ks, vs = x_of(ins, "KScale"), x_of(ins, "VScale")
    scale = float(attrs.get("scale", 0.0)) or None
    impl = attrs.get("impl") or None
    if impl is None and q.shape[2] != 1:
        impl = "xla"
    if impl == "xla":
        return {"Out": paged_attention_gather(q, k, v, tables, pos,
                                              k_scale=ks, v_scale=vs,
                                              scale=scale)}
    return {"Out": paged_attention(q.contiguous(), k, v, tables, pos,
                                   k_scale=ks, v_scale=vs, scale=scale)}


@register_op("row_gather", grad=False, infer_shape=False)
def row_gather_op(ctx, ins, attrs):
    """X [B, S, ...], Index [B] -> Out [B, ...] = X[b, Index[b]]."""
    return {"Out": row_gather(x_of(ins), x_of(ins, "Index"))}


@register_op("sample_tokens", grad=False, needs_rng=True,
             infer_shape=False)
def sample_tokens_op(ctx, ins, attrs):
    """X [B, V] logits, Temperature [B] (+ TopK [B]) -> Out [B] int32:
    argmax where the temperature is <= 0, else a draw from the op's
    generator. The sampler runs over every row with no host branch
    (``greedy=False``), as the JAX op does."""
    return {"Out": sample_tokens(x_of(ins), x_of(ins, "Temperature"),
                                 top_k=x_of(ins, "TopK"),
                                 generator=ctx.generator(attrs),
                                 greedy=False)}


@register_op("spec_accept", grad=False, needs_rng=True,
             infer_shape=False)
def spec_accept_op(ctx, ins, attrs):
    """X [B, S, V] span logits, Draft [B, S-1], Temperature [B],
    NumDraft [B] (+ TopK [B]) -> Out [B, S] int32, Accepted [B] int32
    (:func:`spec_accept`, every row through the sampler)."""
    out, acc = spec_accept(x_of(ins), x_of(ins, "Draft"),
                           x_of(ins, "Temperature"),
                           x_of(ins, "NumDraft"), top_k=x_of(ins, "TopK"),
                           generator=ctx.generator(attrs), greedy=False)
    return {"Out": out, "Accepted": acc}
