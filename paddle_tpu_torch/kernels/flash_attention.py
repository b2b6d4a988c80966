"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention_fwd.cu``
and its plain PyTorch version.

Counterpart of ``paddle_tpu/kernels/flash_attention.py`` (the Pallas
``_fwd_pallas``). Layout as there: q ``[B, H, Sq, D]``, k/v
``[B, H, Sk, D]``, optional additive key bias ``[B, 1, 1, Sk]``,
optional causal mask (key j visible to query i iff j <= i). Returns the
output and the base-2 log-sum-exp ``lse2 = m2 + log2(l)`` of shape
``[B, H, 1, Sq]`` that the backward (a later port) reads.

:func:`flash_attention_fwd` takes the plain version for tensors on the
CPU only; for CUDA tensors it launches the kernel or raises.
"""
import ctypes

import torch

from . import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_ref(q, k, v, bias=None, scale=None, causal=False):
    """Plain PyTorch forward with materialized scores: the CPU path and
    the kernel's yardstick. Scores and softmax in float32; the
    probabilities are cast to v's type before the product with v, as the
    JAX composite does. Returns ``(out, lse2)``."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    lse2 = (torch.logsumexp(s, dim=-1) * _LOG2E).unsqueeze(2)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v).to(q.dtype), lse2


def _check(q, k, v, bias):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention needs q [B,H,Sq,D] and k/v "
                         f"[B,H,Sk,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError("flash_attention: q and k/v disagree on B, H or D")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim in "
                         f"{_HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             f"contiguous (stride 1)")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
    if bias is not None and (tuple(bias.shape) != (B, 1, 1, k.shape[2])
                             or bias.device != q.device):
        raise ValueError(f"flash_attention kernel takes only a "
                         f"[B, 1, 1, Sk] key bias on q's device, got "
                         f"{tuple(bias.shape)} on {bias.device}")


def flash_attention_fwd(q, k, v, bias=None, scale=None, causal=False):
    """Fused attention forward -> ``(out [B,H,Sq,D], lse2 [B,H,1,Sq])``.
    CPU tensors take :func:`flash_attention_ref`; CUDA tensors launch the
    kernel (any Sq/Sk; head dim 16/32/64/128; q/k/v may be strided views
    with a contiguous head dim)."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, bias)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, 1, Sq), dtype=torch.float32, device=q.device)
    b32 = None
    if bias is not None:
        b32 = bias.reshape(B, Sk).to(torch.float32).contiguous()
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.pt_flash_attention_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(b32),
            _build.ptr(out), _build.ptr(lse), _DTYPES[q.dtype], B, H, Sq,
            Sk, D, strides, float(scale), int(bool(causal)),
            _build.stream_of(q))
    _build.check(lib, err, "flash_attention_fwd launch")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, bias=None, scale=None, causal=False):
    """Attention output only (the op the models call)."""
    return flash_attention_fwd(q, k, v, bias, scale, causal)[0]


def _lib():
    lib = _build.load("flash_attention_fwd")
    fn = lib.pt_flash_attention_fwd
    if not fn.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i,
                       vp]
        fn.restype = ctypes.c_int
    return lib


__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref"]
