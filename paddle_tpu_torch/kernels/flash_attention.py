"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` (K1)
and ``csrc/flash_attention_bwd.cu`` (K2-K4), their plain PyTorch
versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/kernels/flash_attention.py`` (the Pallas
``_fwd_pallas`` and ``_bwd_pallas``). Layout as there: q ``[B, H, Sq, D]``,
k/v ``[B, H, Sk, D]``, optional additive key bias ``[B, 1, 1, Sk]`` (a
constant mask: zero gradient), optional causal mask (key j visible to
query i iff j <= i). The forward returns the output and the base-2
log-sum-exp ``lse2 = m2 + log2(l)`` of shape ``[B, H, 1, Sq]`` that the
backward reads.

Each wrapper takes its plain version for tensors on the CPU only; for
CUDA tensors it launches its kernel or raises, and counts the launch.
"""
import ctypes
from typing import Optional

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


def _plain(t):
    """True for a CPU tensor (take the plain version), False for a CUDA
    tensor (launch the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {t.device}")
    return False


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
        # the kernels copy 16-byte chunks of each row (cp.async)
        elem = t.element_size()
        if t.data_ptr() % 16 or any(t.stride(i) * elem % 16
                                    for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"flash_attention: {name}'s base address and "
                             f"batch/head/row strides must be multiples of "
                             f"16 bytes, got address {t.data_ptr()} and "
                             f"strides {t.stride()[:3]} of {elem}-byte "
                             f"elements")
    if bias is not None and (tuple(bias.shape) != (B, 1, 1, k.shape[2])
                             or bias.device != q.device):
        raise ValueError(f"flash_attention kernel takes only a "
                         f"[B, 1, 1, Sk] key bias on q's device, got "
                         f"{tuple(bias.shape)} on {bias.device}")


def flash_attention_fwd(q, k, v, bias=None, scale=None, causal=False):
    """Fused attention forward -> ``(out [B,H,Sq,D], lse2 [B,H,1,Sq])``.
    CPU tensors take :func:`flash_attention_ref`; CUDA tensors launch the
    kernel (any Sq/Sk; head dim 16/32/64/128; q/k/v may be strided views
    with a contiguous head dim whose base addresses and strides are
    multiples of 16 bytes)."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    if _plain(q):
        return flash_attention_ref(q, k, v, bias, scale, causal)
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




# --------------------------------------------------------------- backward

def single_pass_backward(sk, causal):
    """Whether the backward runs the combined kernel K2 or K3 then K4:
    the JAX package's ``_block_sizes`` choice of one k block (``nk ==
    1``), ``Sk <= 4096`` and not (causal, ``Sk >= 2048`` and a multiple
    of 1024)."""
    return sk <= 4096 and not (causal and sk >= 2048 and sk % 1024 == 0)


def flash_attention_bwd_ref(q, k, v, bias, scale, causal, out, lse2, dO):
    """Plain PyTorch backward with materialized p, in float32: the CPU
    path and the kernels' yardstick. ``p = exp2(q k^T scale log2e + bias
    log2e - lse2)`` (causal: 0 above the diagonal), ``ds = p (dO v^T -
    rowsum(dO O)) scale`` rounded to k's type, ``dq = ds k``, ``dk = ds^T
    q``, ``dv = p^T dO`` with p rounded to dO's type. Returns
    ``(dq, dk, dv)`` in q's, k's and v's types; the bias gets none."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dO))
    s2 = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * _LOG2E)
    if bias is not None:
        s2 = s2 + bias.float() * _LOG2E
    p = torch.exp2(s2 - lse2.float().transpose(-1, -2))
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~keep, 0.0)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(k.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.to(dO.dtype).float().transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_K2, _K3, _K4 = 0, 1, 2


def _launch_bwd(kind, q, k, v, bias, scale, causal, out, lse2, dO):
    """Check the inputs and launch one backward kernel; returns
    (dq, dk, dv) with None for what the kernel does not compute."""
    _check(q, k, v, bias)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if tuple(dO.shape) != (B, H, Sq, D) or dO.dtype != q.dtype \
            or tuple(out.shape) != (B, H, Sq, D):
        raise ValueError(f"flash_attention_bwd: dO and out must be "
                         f"{(B, H, Sq, D)} of q's type, got "
                         f"{tuple(dO.shape)} {dO.dtype}, "
                         f"{tuple(out.shape)}")
    if tuple(lse2.shape) != (B, H, 1, Sq) or lse2.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse2 must be float32 "
                         f"{(B, H, 1, Sq)}, got {tuple(lse2.shape)} "
                         f"{lse2.dtype}")
    for name, t in (("dO", dO), ("out", out), ("lse2", lse2)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is on "
                             f"{t.device}, q on {q.device}")
    dO = dO.contiguous()
    lse = lse2.contiguous()
    # delta = rowsum(dO * O) is plain torch, as in the JAX package (:461)
    delta = (dO.float() * out.float()).sum(-1).contiguous()
    b32 = None if bias is None \
        else bias.reshape(B, Sk).to(torch.float32).contiguous()
    dq = dk = dv = acc = None
    if kind in (_K2, _K4):
        dk = torch.empty((B, H, Sk, D), dtype=k.dtype, device=q.device)
        dv = torch.empty((B, H, Sk, D), dtype=v.dtype, device=q.device)
    if kind == _K2:
        acc = torch.zeros((B, H, Sq, D), dtype=torch.float32,
                          device=q.device)
        dq = acc if q.dtype == torch.float32 else torch.empty_like(
            acc, dtype=q.dtype)
    elif kind == _K3:
        dq = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    lib = _lib_bwd()
    with torch.cuda.device(q.device):
        err = lib.pt_flash_attention_bwd(
            kind, _build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(b32), _build.ptr(dO), _build.ptr(lse),
            _build.ptr(delta), _build.ptr(dq), _build.ptr(dk),
            _build.ptr(dv), _build.ptr(acc), _DTYPES[q.dtype], B, H, Sq, Sk,
            D, strides, float(scale), int(bool(causal)),
            _build.stream_of(q))
    _build.check(lib, err, "flash_attention_bwd launch")
    return dq, dk, dv


def flash_attention_bwd_single(q, k, v, bias, scale, causal, out, lse2, dO):
    """K2, the combined pass -> ``(dq, dk, dv)``."""
    if _plain(q):
        return flash_attention_bwd_ref(q, k, v, bias, scale, causal, out,
                                       lse2, dO)
    res = _launch_bwd(_K2, q, k, v, bias, scale, causal, out, lse2, dO)
    flash_attention_bwd_single.launches += 1
    return res


def flash_attention_bwd_dq(q, k, v, bias, scale, causal, out, lse2, dO):
    """K3 -> ``dq``."""
    if _plain(q):
        return flash_attention_bwd_ref(q, k, v, bias, scale, causal, out,
                                       lse2, dO)[0]
    dq = _launch_bwd(_K3, q, k, v, bias, scale, causal, out, lse2, dO)[0]
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, bias, scale, causal, out, lse2, dO):
    """K4 -> ``(dk, dv)``."""
    if _plain(q):
        return flash_attention_bwd_ref(q, k, v, bias, scale, causal, out,
                                       lse2, dO)[1:]
    res = _launch_bwd(_K4, q, k, v, bias, scale, causal, out, lse2, dO)[1:]
    flash_attention_bwd_dkv.launches += 1
    return res


flash_attention_bwd_single.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, bias, scale, causal, out, lse2, dO):
    """Attention backward -> ``(dq, dk, dv)``. CPU tensors take
    :func:`flash_attention_bwd_ref`; CUDA tensors launch K2, or K3 then
    K4, by :func:`single_pass_backward`, or raise."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    if _plain(q):
        return flash_attention_bwd_ref(q, k, v, bias, scale, causal, out,
                                       lse2, dO)
    if single_pass_backward(k.shape[2], causal):
        return flash_attention_bwd_single(q, k, v, bias, scale, causal, out,
                                          lse2, dO)
    dq = flash_attention_bwd_dq(q, k, v, bias, scale, causal, out, lse2, dO)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, scale, causal, out,
                                     lse2, dO)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_attention_bwd",
                         mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], scale: float, causal: bool,
            out: torch.Tensor, lse2: torch.Tensor, dO: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_bwd` as a torch op: under ``torch.func``
    transforms a Function's backward sees wrapped tensors without
    storage, and the dispatcher hands an op the plain tensors a kernel
    launch needs."""
    return flash_attention_bwd(q, k, v, bias, scale, causal, out, lse2, dO)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: forward K1 (saves ``out`` and ``lse2``),
    backward K2 or K3 + K4. ``apply(q, k, v, bias, scale, causal) ->
    (out, lse2)``; the bias gets a zero gradient, by contract."""

    @staticmethod
    def forward(q, k, v, bias, scale, causal):
        return flash_attention_fwd(q, k, v, bias, scale, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, scale, causal = inputs
        out, lse2 = output
        ctx.save_for_backward(q, k, v, bias, out, lse2)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse2)

    @staticmethod
    def backward(ctx, d_out, d_lse2):
        q, k, v, bias, out, lse2 = ctx.saved_tensors
        dq, dk, dv = _bwd_op(q, k, v, bias, ctx.scale, ctx.causal, out,
                             lse2, d_out)
        dbias = None if bias is None else torch.zeros_like(bias)
        return dq, dk, dv, dbias, None, None


def flash_attention_train(q, k, v, bias=None, scale=None, causal=False):
    """Attention output through :class:`FlashAttention` (the training
    op's forward)."""
    if scale is None or scale == 0.0:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bias, float(scale),
                                bool(causal))[0]


def _lib_bwd():
    lib = _build.load("flash_attention_bwd")
    fn = lib.pt_flash_attention_bwd
    if not fn.argtypes:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i,
                       i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
                       ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    return lib


__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_bwd_ref", "flash_attention_bwd_single",
           "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_train", "single_pass_backward"]
