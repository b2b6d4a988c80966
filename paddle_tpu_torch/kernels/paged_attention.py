"""Paged decode attention: the CUDA kernel ``csrc/paged_attention.cu``,
its plain PyTorch version, and the int8 KV codec.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``. Layout as
there: q ``[B, H, 1, D]`` (one decode query per row), k/v pools
``[num_blocks, H, block_size, D]`` (float32, bfloat16, or int8 with
float32 ``k_scale``/``v_scale`` ``[num_blocks, H, block_size]``), block
tables ``[B, blocks_per_row]`` int32 (entries past a row's allocation
name the trash block 0 and are masked by ``pos``), pos ``[B]`` int32
(key slot j is visible iff ``j <= pos[b]``).

:func:`paged_attention` takes the plain version for tensors on the CPU
only; for CUDA tensors it launches the kernel or raises. The kernel
decodes one query per row: S > 1 reads (chunked prefill, speculative
verify) go through :func:`paged_attention_ref`, as the JAX entry routes
them to its gather composite. It splits each row's table into runs of
blocks (:func:`split_plan`), folds each run in its own CUDA block and
merges a row's runs in a second small kernel; the host never reads
``pos``.
"""
import ctypes

import torch

from . import _build

_NEG_INF = -1e30
_QMAX = 127.0
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (16, 32, 64, 128)
# slots per split of a row's table in the kernel (see split_plan)
SPLIT_TOKENS = 256


def split_plan(block_size, nblk):
    """How the kernel cuts each row's block table: ``(blocks per split,
    splits)``. A split is a fixed run of ``max(1, SPLIT_TOKENS //
    block_size)`` table entries, so its boundaries depend on the block
    index alone (never on the batch, the table width or other rows) and
    a row's result is bitwise the same in any batch; ``splits`` covers
    ``nblk`` entries and sizes the kernel's grid."""
    bps = max(1, SPLIT_TOKENS // block_size)
    return bps, -(-nblk // bps)


def quantize_kv(kv):
    """Symmetric per-vector int8 quantization of ``kv [..., D]``:
    returns ``(int8 values, float32 scale [...])`` with
    ``scale = absmax / 127`` (0 -> 1.0, so an all-zero vector round-trips
    exactly). Rounding is half-to-even, as in the JAX codec."""
    kv = kv.float()
    scale = kv.abs().amax(dim=-1) / _QMAX
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(kv / scale.unsqueeze(-1)).clamp(-_QMAX, _QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale):
    """Inverse of :func:`quantize_kv`: int8 ``[..., D]`` times
    ``scale [...]`` -> float32."""
    return q.float() * scale.unsqueeze(-1).float()


def paged_attention_ref(q, k_pool, v_pool, tables, pos, k_scale=None,
                        v_scale=None, scale=None):
    """Gather-then-attend plain version (the JAX ``_xla_paged_attention``):
    each row's blocks gathered through its table, dequantized, per-row
    position mask, float32 softmax. Handles S >= 1 queries per row (query
    i of row b sees keys ``<= pos[b] + i``)."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    B, H, S, D = q.shape
    bs = k_pool.shape[2]
    L = tables.shape[1] * bs
    tables = tables.long()

    def gather(pool, sc):
        g = pool[tables]                              # [B, nblk, H, bs, D]
        g = dequantize_kv(g, sc[tables]) if sc is not None else g.float()
        return g.permute(0, 2, 1, 3, 4).reshape(B, H, L, D)

    k = gather(k_pool, k_scale)
    v = gather(v_pool, v_scale)
    scores = torch.matmul(q.float(), k.transpose(-1, -2)) * scale
    key_idx = torch.arange(L, device=q.device)[None, None, :]
    qry_pos = pos.long()[:, None, None] \
        + torch.arange(S, device=q.device)[None, :, None]
    mask = key_idx <= qry_pos                                 # [B, S, L]
    scores = scores.masked_fill(~mask[:, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v).to(q.dtype)


def _check(q, k_pool, v_pool, tables, pos, k_scale, v_scale):
    B, H, S, D = q.shape
    if S != 1:
        raise ValueError(
            f"the paged_attention kernel decodes ONE query per row (S=1), "
            f"got S={S}; S>1 reads go through paged_attention_ref")
    if q.dtype not in _Q_DTYPES or k_pool.dtype not in _KV_DTYPES \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: unsupported dtypes q {q.dtype}, "
                        f"pools {k_pool.dtype}/{v_pool.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head dim in "
                         f"{_HEAD_DIMS}, got {D}")
    N, Hp, bs, Dp = k_pool.shape
    if (Hp, Dp) != (H, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != B:
        raise ValueError("paged_attention: tables must be int32 [B, nblk]")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError("paged_attention: pos must be int32 [B]")
    if k_scale is not None:
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (N, H, bs):
                raise ValueError("paged_attention: scales must be float32 "
                                 "[num_blocks, H, block_size]")
    for t in (q, k_pool, v_pool, tables, pos, k_scale, v_scale):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError("paged_attention: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("paged_attention: inputs must be contiguous")
    # the kernel moves each block's K and V slice with bulk copies of
    # whole 16-byte vectors: a row (D * elem >= 16 bytes) always
    # qualifies, so any block size does, from a pool that starts on 16
    # bytes (the int8 scales move 4 bytes at a time)
    for t in (k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("paged_attention: pools must start on a "
                             "16-byte boundary")


def paged_attention(q, k_pool, v_pool, block_tables, pos, k_scale=None,
                    v_scale=None, scale=None):
    """Decode attention of one query per row over a block-paged pool ->
    ``[B, H, 1, D]`` in q's dtype. CPU tensors take
    :func:`paged_attention_ref`; CUDA tensors launch the kernel."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention needs BOTH k_scale and v_scale "
                         "for a quantized pool (or neither)")
    if k_pool.dtype == torch.int8 and k_scale is None:
        raise ValueError("int8 KV pool needs k_scale/v_scale arrays")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, pos,
                                   k_scale, v_scale, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, k_pool, v_pool, block_tables, pos, k_scale, v_scale)
    B, H, _, D = q.shape
    bs, nblk = k_pool.shape[2], block_tables.shape[1]
    bps, nsplit = split_plan(bs, nblk)
    out = torch.empty_like(q)
    # per-split (acc[D], m, l) of rows with several live splits; every
    # cell the merge reads is written first, so no clearing
    part = torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                       device=q.device) if nsplit > 1 else None
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.pt_paged_attention(
            _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
            _build.ptr(k_scale), _build.ptr(v_scale),
            _build.ptr(block_tables), _build.ptr(pos), _build.ptr(out),
            _build.ptr(part), _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype],
            B, H, D, bs, nblk, bps, nsplit, float(scale),
            _build.stream_of(q))
    _build.check(lib, err, "paged_attention launch")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.pt_paged_attention
    if not fn.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 9 + [i] * 9 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


__all__ = ["paged_attention", "paged_attention_ref", "quantize_kv",
           "dequantize_kv", "split_plan"]
