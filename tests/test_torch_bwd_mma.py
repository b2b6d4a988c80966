"""The arithmetic of the tensor-core flash-attention backward kernels K3
(dq) and K4 (dk, dv) in ``paddle_tpu_torch/kernels/csrc``, on the CPU.

The kernels run only on the GPU (chip_smoke.py holds them against their
plain versions there). Here: their float32 arithmetic (3xTF32 products,
exp2 of the base-2 scores, ds and p rounded as the kernels round them),
emulated bit for bit per product, against a float64 reference and
against the JAX package's backward kernels in interpret mode at the
K3/K4 route; their tile walks (dead causal tiles skipped, the mask only
on diagonal and ragged-edge tiles) against the untiled arithmetic; and
the port's plain backward against the JAX kernels for bf16 inputs."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mma import mm_3xtf32

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

_LOG2E = 1.4426950408889634


def _inputs(seed, B, H, S, D, causal, with_bias=False):
    """q, k, v, dO, bias (or None) as float32 tensors, and the forward's
    lse2 [B,H,S,1] and delta [B,H,S,1] from a float64 forward, rounded to
    float32 as the kernels receive them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, H, S, D))
                                    .astype(np.float32)) for _ in range(4))
    bias = None
    if with_bias:
        bias = torch.from_numpy(np.where(rng.random((B, 1, 1, S)) < 0.25,
                                         -1e4, 0.0).astype(np.float32))
    s = q.double() @ k.double().transpose(-1, -2) * D ** -0.5
    if bias is not None:
        s = s + bias.double()
    if causal:
        s = s.masked_fill(~_keep(S, S), float("-inf"))
    lse2 = torch.logsumexp(s, -1, keepdim=True) * _LOG2E
    out = torch.softmax(s, -1) @ v.double()
    delta = (do.double() * out).sum(-1, keepdim=True)
    return q, k, v, do, bias, lse2.float(), delta.float()


def _keep(sq, sk):
    return torch.ones(sq, sk, dtype=torch.bool).tril()


def bwd(q, k, v, do, bias, lse2, delta, causal, mm):
    """dq, dk, dv as K3 and K4 compute them, each product through ``mm``:
    s = q k^T, p = exp2(s scale log2e + bias log2e - lse2) (masked: 0),
    dp = dO v^T, ds = p (dp - delta) scale, dq = ds k, dk = ds^T q, dv =
    p^T dO."""
    scale = q.shape[-1] ** -0.5
    x = mm(q, k.transpose(-1, -2)) * (scale * _LOG2E) - lse2
    if bias is not None:
        x = x + bias * _LOG2E
    p = torch.exp2(x)
    if causal:
        p = p.masked_fill(~_keep(q.shape[2], k.shape[2]), 0.0)
    ds = p * (mm(do, v.transpose(-1, -2)) - delta) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _rel_err(got, want):
    return max((g.double() - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True)])
def test_bwd_3xtf32_holds_float32_accuracy(causal, with_bias):
    """At S=256, D=64 the emulated K3/K4 arithmetic is within 2e-6 of max
    |ref| of a float64 reference on the same float32 inputs (measured: at
    most 1.15e-6 over dq, dk, dv, where exact float32 products give
    1.14e-6 and one TF32 product 8e-4): fifty times inside the 1e-4 limit
    the card holds the float32 kernels to."""
    args = _inputs(0, 1, 2, 256, 64, causal, with_bias)
    want = bwd(*(t.double() if t is not None else None for t in args),
               causal, torch.matmul)
    got = bwd(*args, causal, mm_3xtf32)
    err = _rel_err(got, want)
    assert err <= 2e-6, err


@pytest.mark.parametrize("causal,with_bias", [(True, True), (False, False)])
def test_bwd_3xtf32_matches_the_jax_kernels(causal, with_bias):
    """The same float32 inputs through the JAX package's backward (its
    Pallas `_dq_kernel` and `_dkv_kernel` in interpret mode: bk = 32, so
    nk = 4, the K3/K4 route) and through the emulated kernel arithmetic."""
    B, H, S, D = 1, 2, 128, 32
    q, k, v, do, bias, _, _ = _inputs(5, B, H, S, D, causal, with_bias)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    jb = None if bias is None else jnp.asarray(bias.numpy())
    scale = D ** -0.5
    out, lse = jfa._fwd_pallas(jq, jk, jv, jb, scale, causal, None, 32,
                               True)
    want = jfa._bwd_pallas(jq, jk, jv, jb, scale, causal, None, 32, True,
                           out, lse, jdo)
    lse2 = torch.from_numpy(np.array(lse)).transpose(-1, -2)
    delta = (do * torch.from_numpy(np.array(out))).sum(-1, keepdim=True)
    got = bwd(q, k, v, do, bias, lse2, delta, causal, mm_3xtf32)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


def _pad_rows(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))


def k3_tiles(q, k, v, do, lse2, delta, causal, BQ=128, BK=64):
    """dq by K3's walk: per 128-row q tile, warps of 16 rows, key tiles up
    to the tile's causal limit; a warp skips a tile no row of it sees,
    and the mask is applied only where a tile touches the diagonal or the
    ragged Sk edge. Rows past Sq are zero (as the kernel loads them)."""
    S, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    scale = D ** -0.5
    n = -(-S // BQ) * BQ
    q, do, lse2, delta = (_pad_rows(t, n) for t in (q, do, lse2, delta))
    kp, vp = (_pad_rows(t, -(-Sk // BK) * BK) for t in (k, v))
    dq = torch.zeros_like(q)
    for q0 in range(0, n, BQ):
        kend = min(Sk, q0 + BQ) if causal else Sk
        for k0 in range(0, kend, BK):
            for qw in range(q0, q0 + BQ, 16):
                if qw >= S or (causal and k0 > qw + 15):
                    continue
                r, c = slice(qw, qw + 16), slice(k0, k0 + BK)
                x = q[:, :, r] @ kp[:, :, c].transpose(-1, -2) \
                    * (scale * _LOG2E) - lse2[:, :, r]
                p = torch.exp2(x)
                if (causal and k0 + BK - 1 > qw) or k0 + BK > Sk:
                    cols = torch.arange(k0, k0 + BK)
                    rows = torch.arange(qw, qw + 16)[:, None]
                    p = p.masked_fill((cols >= Sk) | (causal & (cols > rows)),
                                      0.0)
                ds = p * (do[:, :, r] @ vp[:, :, c].transpose(-1, -2)
                          - delta[:, :, r]) * scale
                dq[:, :, r] += ds @ kp[:, :, c]
    return dq[:, :, :S]


def k4_tiles(q, k, v, do, lse2, delta, causal, BQ=32, BK=64):
    """dk, dv by K4's walk: per 64-key tile, warps of 16 keys, q tiles
    from the first one the causal tile can see; a warp skips a q tile
    that sees none of its keys (or whose keys are all past Sk), and the
    mask is applied only on diagonal and ragged-edge pairs."""
    S, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    scale = D ** -0.5
    n = -(-S // BQ) * BQ
    q, do, lse2, delta = (_pad_rows(t, n) for t in (q, do, lse2, delta))
    nk = -(-Sk // BK) * BK
    k, v = (_pad_rows(t, nk) for t in (k, v))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, nk, BK):
        qstart = (k0 // BQ) * BQ if causal else 0
        for q0 in range(qstart, S, BQ):
            for kw in range(k0, k0 + BK, 16):
                if kw >= Sk or (causal and kw > q0 + BQ - 1):
                    continue
                r, c = slice(q0, q0 + BQ), slice(kw, kw + 16)
                x = k[:, :, c] @ q[:, :, r].transpose(-1, -2) \
                    * (scale * _LOG2E) - lse2[:, :, r].transpose(-1, -2)
                p = torch.exp2(x)                          # [keys, rows]
                if (causal and kw + 15 > q0) or q0 + BQ > S or kw + 16 > Sk:
                    rows = torch.arange(q0, q0 + BQ)
                    keys = torch.arange(kw, kw + 16)[:, None]
                    p = p.masked_fill((rows >= S) | (keys >= Sk)
                                      | (causal & (keys > rows)), 0.0)
                dpt = v[:, :, c] @ do[:, :, r].transpose(-1, -2)
                dst = p * (dpt - delta[:, :, r].transpose(-1, -2)) * scale
                dv[:, :, c] += p @ do[:, :, r]
                dk[:, :, c] += dst @ q[:, :, r]
    return dk[:, :, :Sk], dv[:, :, :Sk]


@pytest.mark.parametrize("S,causal", [(200, True), (200, False), (256, True)])
def test_tile_walks_match_the_untiled_arithmetic(S, causal):
    """K3's and K4's walks over tiles (which tiles they visit, where they
    mask) give the untiled result, in float64, at a ragged and an even S."""
    args = [t.double() for t in _inputs(S, 1, 2, S, 32, causal)
            if t is not None]
    q, k, v, do, lse2, delta = args
    want = bwd(q, k, v, do, None, lse2, delta, causal, torch.matmul)
    got = (k3_tiles(*args, causal), *k4_tiles(*args, causal))
    assert _rel_err(got, want) <= 1e-12


@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True)])
def test_bf16_bwd_matches_the_jax_kernels(causal, with_bias):
    """bf16 inputs through the port's backward (its plain version on the
    CPU) and through the JAX package's `_bwd_pallas` in interpret mode at
    the K3/K4 route (bk = 32): within 2e-2 of max |ref| (the JAX kernels
    round q scale log2e to bf16 before the product, the port scales
    after it)."""
    B, H, S, D = 1, 2, 128, 32
    rng = np.random.default_rng(11 + causal)
    arrs = [rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrs)
    jb = tb = None
    if with_bias:
        b = np.where(rng.random((B, 1, 1, S)) < 0.25, -1e4, 0.0)
        jb, tb = jnp.asarray(b, jnp.float32), torch.from_numpy(b).float()
    scale = D ** -0.5
    out, lse = jfa._fwd_pallas(jq, jk, jv, jb, scale, causal, None, 32,
                               True)
    want = jfa._bwd_pallas(jq, jk, jv, jb, scale, causal, None, 32, True,
                           out, lse, jdo)
    tout = torch.from_numpy(np.asarray(out, np.float32)).bfloat16()
    tlse = torch.from_numpy(np.array(lse))
    got = tfa.flash_attention_bwd(tq, tk, tv, tb, scale, causal, tout, tlse,
                                  tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= 2e-2, (name, err)
