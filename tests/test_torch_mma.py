"""The numerics and checks around the tensor-core flash-attention kernels
(K1 and K2 in ``paddle_tpu_torch/kernels/csrc``), on the CPU.

The kernels run only on the GPU (chip_smoke.py holds them against their
plain versions there). Here: the 3xTF32 product they use for float32
inputs, emulated bit for bit in plain PyTorch, against a float64
reference at the K1 shapes the CPU tests use; the wrapper's 16-byte
alignment check; the build's staleness rule for shared headers; and the
parser of the compiler's register report."""
import importlib
import os
import time

import numpy as np
import pytest
import torch

tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
from paddle_tpu_torch.kernels import _build  # noqa: E402

_LOG2E = 1.4426950408889634


def tf32_rna(x):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` does: round the magnitude to
    10 mantissa bits, ties away from zero, on the int32 view."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernels' mma.sync does it for float32: hi/lo TF32
    parts, three products (lo*hi, hi*lo, hi*hi), float32 sums. Each
    product of two TF32 values is exact in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a, b):
    """a @ b with a single TF32 product."""
    return tf32_rna(a) @ tf32_rna(b)


def attention(q, k, v, mm, causal=True):
    """K1's arithmetic: base-2 scores scaled in float32 after the product,
    exp2 softmax, P V through ``mm``."""
    s2 = mm(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5 * _LOG2E)
    if causal:
        keep = torch.ones(s2.shape[-2:], dtype=torch.bool).tril()
        s2 = s2.masked_fill(~keep, float("-inf"))
    m = s2.amax(-1, keepdim=True)
    p = torch.exp2(s2 - m)
    return mm(p, v) / p.sum(-1, keepdim=True)


def _inputs(seed=0, B=1, H=2, S=256, D=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(3)]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0e-30], dtype=torch.float32)
    r = tf32_rna(x)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    # a tie rounds away from zero, like cvt.rna
    assert r[1] == 1.0 + 2.0 ** -10 and r[3] == -(1.0 + 2.0 ** -10)
    assert r[2] == 1.0 + 2.0 ** -10
    hi, lo = split(torch.randn(1000, generator=torch.Generator()
                                .manual_seed(0)))
    assert (lo.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_attention_holds_float32_accuracy(causal):
    """At the K1 CPU shapes (S=256, D=64) the 3xTF32 forward is within
    1e-6 of max |ref| of a float64 reference: a hundredfold inside the
    1e-4 limit the card holds the float32 kernels to."""
    q, k, v = (torch.from_numpy(a) for a in _inputs())
    ref = attention(q.double(), k.double(), v.double(), torch.matmul,
                    causal)
    got = attention(q, k, v, mm_3xtf32, causal)
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    assert err <= 1e-6, err
    s_ref = q.double() @ k.double().transpose(-1, -2)
    s_err = (mm_3xtf32(q, k.transpose(-1, -2)).double() - s_ref).abs().max()
    assert s_err.item() <= 1e-6 * s_ref.abs().max().item()


def test_single_tf32_product_misses_the_float32_limit():
    """One TF32 product (2^-11 per operand) is off by more than 1e-4 of
    max |ref|: why the kernels use three."""
    q, k, v = (torch.from_numpy(a) for a in _inputs())
    ref = attention(q.double(), k.double(), v.double(), torch.matmul)
    got = attention(q, k, v, mm_tf32)
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    assert err > 1e-4, err


def test_3xtf32_matches_the_plain_version():
    """The emulated kernel arithmetic and flash_attention_ref (the CPU
    path and the card's yardstick) agree within the card's limit."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(seed=1))
    want, _ = tfa.flash_attention_ref(q, k, v, causal=True)
    got = attention(q, k, v, mm_3xtf32)
    assert (got - want).abs().max().item() <= 1e-5


def test_3xtf32_matches_the_jax_kernel():
    """The same inputs through the JAX package's flash attention (its
    Pallas kernel in interpret mode, 128-key blocks) and through the
    emulated kernel arithmetic."""
    import jax.numpy as jnp
    jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
    arrs = _inputs(seed=2)
    want = jfa.flash_attention(*(jnp.asarray(a) for a in arrs), causal=True,
                               impl="interpret", block_k=128)
    got = attention(*(torch.from_numpy(a) for a in arrs), mm_3xtf32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_alignment_check_raises_on_misaligned_views():
    """The kernels copy 16-byte chunks of each row: the wrapper refuses a
    base address or a stride that is not a multiple of 16 bytes (and
    takes the model's packed qkv views)."""
    B, S, H, D = 2, 8, 3, 16
    qkv = torch.zeros(B, S, 3 * H * D)
    q, k, v = (t.view(B, S, H, D).transpose(1, 2)
               for t in qkv.split(H * D, dim=-1))
    tfa._check(q, k, v, None)
    flat = torch.zeros(B * H * S * D + 1)
    shifted = flat[1:].view(B, H, S, D)            # base 4 bytes off
    with pytest.raises(ValueError, match="16 bytes"):
        tfa._check(shifted, k.contiguous(), v.contiguous(), None)
    padded = torch.zeros(B, H, S, D + 1)[..., :D]  # row stride 68 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        tfa._check(q.contiguous(), padded, v.contiguous(), None)
    bf = torch.zeros(B, H, S, D + 4, dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="16 bytes"):          # 40 bytes
        tfa._check(bf, bf, bf, None)


def test_header_change_makes_a_built_library_stale(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    src, lib = csrc / "k.cu", build / "libk.so"
    header = csrc / "shared.cuh"
    assert _build._stale("k")                       # not built
    now = time.time()
    for path, t in ((src, now - 30), (header, now - 30), (lib, now - 20)):
        path.write_text("")
        os.utime(path, (t, t))
    assert not _build._stale("k")
    os.utime(header, (now, now))                    # the header is touched
    assert _build._stale("k")
    os.utime(lib, (now + 10, now + 10))             # rebuilt
    assert not _build._stale("k")
    os.utime(src, (now + 20, now + 20))             # the source is touched
    assert _build._stale("k")


def test_build_reports_registers():
    assert ("-Xptxas", "-v") in zip(_build.NVCC_FLAGS, _build.NVCC_FLAGS[1:])


def test_ptxas_report_names_each_kernel():
    import chip_smoke
    out = (
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__8f45d1f5"
        "_22_flash_attention_bwd_cu_3287dd2c19flash_bwd_k2_kernelIfLi64EEEvN"
        "S_4ArgsE' for 'sm_90a'\n"
        "    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__8f45d1f5"
        "_22_flash_attention_fwd_cu_3287dd2c16flash_fwd_kernelI13__nv_bfloat"
        "16Li128EEEvNS_7FwdArgsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    rep = chip_smoke.ptxas_report("flash", out)
    assert rep["kernels"] == [
        {"entry": "flash_bwd_k2_kernel<float,64>", "stack": 16,
         "spill_stores": 12, "spill_loads": 12, "registers": 255},
        {"entry": "flash_fwd_kernel<bf16,128>", "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 168}]
