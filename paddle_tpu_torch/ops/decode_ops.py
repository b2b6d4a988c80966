"""Incremental-decoding ops as plain functions on tensors: the KV-cache
write and read of the dense bank, the paged-pool write, the per-row
gather and the sampler.

Counterpart of ``paddle_tpu/ops/decode_ops.py``. JAX arrays are
immutable, so the JAX ops return updated caches and the executor donates
the inputs so that XLA appends in place; here the cache and pool writes
update their tensors in place (``index_put_``) and return them.
"""
import torch

from ..kernels.paged_attention import quantize_kv

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


def sample_tokens(logits, temperature, top_k=None, generator=None):
    """Next token per row from logits ``[B, V]`` with per-row sampling
    config: rows with ``temperature <= 0`` take the argmax (first maximum
    wins); the others sample from ``softmax(logits / t)``, restricted to
    the ``top_k`` highest logits where ``top_k > 0`` (ties at the
    threshold stay eligible). Draws come from ``generator``. Returns
    int32 ``[B]``."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if bool((temperature <= 0).all()):     # host tensor: no device sync
        return greedy.to(torch.int32)
    temperature = temperature.to(logits.device).float()
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    if top_k is not None:
        top_k = top_k.to(logits.device).long()
        V = logits.shape[-1]
        k = top_k.clamp(1, V)
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        thresh = torch.gather(sorted_desc, 1, (k - 1)[:, None])
        allowed = (top_k <= 0)[:, None] | (logits >= thresh)
        scaled = scaled.masked_fill(~allowed, _NEG_INF)
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)
