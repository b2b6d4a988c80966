"""Port kernels' plain versions and decode ops against the JAX package.

The same seeded numpy inputs go through the JAX function (Pallas kernels
in interpret mode, as tests/test_flash_attention.py and
tests/test_kvpool.py run them) and through its counterpart in
paddle_tpu_torch on the CPU, where each kernel wrapper takes its plain
PyTorch version. The CUDA kernels themselves run only on the GPU and are
checked there by chip_smoke.py."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the kernels packages re-export functions named like their modules
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
jpa = importlib.import_module("paddle_tpu.kernels.paged_attention")
jops = importlib.import_module("paddle_tpu.ops.decode_ops")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
tpa = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")
tops = importlib.import_module("paddle_tpu_torch.ops.decode_ops")

# tolerances: f32 differs only by summation order and exp vs exp2 (1e-5);
# bf16 inputs round scores/probabilities at different places in the two
# packages (2e-2, a few bf16 ulps of O(1) outputs)
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _both(a, dtype):
    """One numpy array -> (jax array, torch tensor) of ``dtype``; both
    round float32 -> bfloat16 to nearest-even."""
    j = jnp.asarray(a, dtype=getattr(jnp, dtype))
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 32, 32, 16), (1, 2, 64, 256, 32)])
def test_flash_ref_matches_jax_interpret(dtype, causal, with_bias, shape):
    B, H, Sq, Sk, D = shape
    rng = np.random.default_rng(Sq + Sk + D)
    q, tq = _both(rng.normal(size=(B, H, Sq, D)).astype(np.float32), dtype)
    k, tk = _both(rng.normal(size=(B, H, Sk, D)).astype(np.float32), dtype)
    v, tv = _both(rng.normal(size=(B, H, Sk, D)).astype(np.float32), dtype)
    bias = tbias = None
    if with_bias:
        b = np.where(rng.random((B, 1, 1, Sk)) < 0.25, -1e4, 0.0)
        bias, tbias = _both(b.astype(np.float32), "float32")
    # Sk=256 with 128-key blocks drives the online (multi-block) kernel
    want = jfa.flash_attention(q, k, v, bias=bias, causal=causal,
                               impl="interpret",
                               block_k=128 if Sk > 128 else None)
    got = tfa.flash_attention(tq, tk, tv, bias=tbias, causal=causal)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, H, Sq, D)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True)])
def test_flash_lse2_matches_jax_fwd_pallas(causal, with_bias):
    B, H, S, D = 2, 2, 64, 16
    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(3)]
    (q, tq), (k, tk), (v, tv) = (_both(a, "float32") for a in arrs)
    bias = tbias = None
    if with_bias:
        bias, tbias = _both(rng.normal(size=(B, 1, 1, S)).astype(
            np.float32), "float32")
    scale = D ** -0.5
    out, lse = jfa._fwd_pallas(q, k, v, bias, scale, causal, None, None,
                               True)
    tout, tlse = tfa.flash_attention_fwd(tq, tk, tv, bias=tbias,
                                         scale=scale, causal=causal)
    assert tuple(tlse.shape) == (B, H, 1, S) and tlse.dtype == torch.float32
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-5,
                               rtol=0)


def _paged_inputs(kv_dtype, seed=1):
    """B=3 rows over a 12-block pool: ragged pos (one inside the first
    block, one on a block boundary, one deep) and trash-block (0)
    padding past each row's allocation."""
    rng = np.random.default_rng(seed)
    B, H, D, bs, nblk, N = 3, 2, 32, 8, 4, 12
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    kp = rng.normal(size=(N, H, bs, D)).astype(np.float32)
    vp = rng.normal(size=(N, H, bs, D)).astype(np.float32)
    pos = np.array([3, 15, 30], np.int32)
    tables = np.zeros((B, nblk), np.int32)
    perm = rng.permutation(np.arange(1, N))
    used = 0
    for b, p in enumerate(pos):
        n = p // bs + 1
        tables[b, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_paged_ref_matches_jax_interpret(kv_dtype):
    q, kp, vp, tables, pos = _paged_inputs(kv_dtype)
    jq, tq = _both(q, "float32")
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    if kv_dtype == "int8":
        jk, jks = jpa.quantize_kv(jnp.asarray(kp))
        jv, jvs = jpa.quantize_kv(jnp.asarray(vp))
        tk, tks = tpa.quantize_kv(torch.from_numpy(kp))
        tv, tvs = tpa.quantize_kv(torch.from_numpy(vp))
        want = jpa.paged_attention(jq, jk, jv, jt, jp, k_scale=jks,
                                   v_scale=jvs, impl="interpret")
        got = tpa.paged_attention(tq, tk, tv, tt, tp, k_scale=tks,
                                  v_scale=tvs)
        tol = 1e-5
    else:
        jk, tk = _both(kp, kv_dtype)
        jv, tv = _both(vp, kv_dtype)
        want = jpa.paged_attention(jq, jk, jv, jt, jp, impl="interpret")
        got = tpa.paged_attention(tq, tk, tv, tt, tp)
        # the TPU kernel rounds p to the pool type before p.v, the
        # plain version does not
        tol = _TOL[kv_dtype]
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


def test_paged_ref_multi_query_matches_jax_composite():
    """S > 1 queries (the chunked-prefill read) through the plain
    version match the JAX gather composite."""
    rng = np.random.default_rng(2)
    _, kp, vp, tables, pos = _paged_inputs("float32")
    q = rng.normal(size=(3, 2, 4, 32)).astype(np.float32)
    want = jpa.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tables),
                               jnp.asarray(pos - 3), impl="xla")
    got = tpa.paged_attention_ref(torch.from_numpy(q), torch.from_numpy(kp),
                                  torch.from_numpy(vp),
                                  torch.from_numpy(tables),
                                  torch.from_numpy(pos - 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_quantize_dequantize_match_jax_exactly():
    rng = np.random.default_rng(0)
    kv = rng.normal(size=(3, 2, 8, 16)).astype(np.float32)
    kv[0, 0, 0] = 0.0                       # an all-zero vector
    kv[1, 1, 2] *= 1e-3
    jq, js = jpa.quantize_kv(jnp.asarray(kv))
    tq, ts = tpa.quantize_kv(torch.from_numpy(kv))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0] == 1.0
    np.testing.assert_array_equal(
        tpa.dequantize_kv(tq, ts).numpy(),
        np.asarray(jpa.dequantize_kv(jq, js)))
    assert (tpa.dequantize_kv(tq, ts)[0, 0, 0] == 0).all()


def test_paged_wrapper_validation():
    q = torch.zeros(1, 2, 1, 32)
    kp = torch.zeros(4, 2, 8, 32)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="BOTH"):
        tpa.paged_attention(q, kp, kp, tables, pos,
                            k_scale=torch.ones(4, 2, 8))
    with pytest.raises(ValueError, match="int8"):
        tpa.paged_attention(q, kp.to(torch.int8), kp.to(torch.int8),
                            tables, pos)
    with pytest.raises(ValueError, match="ONE query"):
        tpa._check(torch.zeros(1, 2, 2, 32), kp, kp, tables, pos, None,
                   None)


# -- decode ops (index arithmetic of the cache writes) ---------------------

def _jop(fn, **ins):
    return fn(None, {k: [v] for k, v in ins.items() if v is not None}, {})


@pytest.mark.parametrize("S", [1, 3])
def test_kv_cache_write_and_read_match_jax(S):
    rng = np.random.default_rng(S)
    B, H, L, D = 3, 2, 16, 8
    cache = rng.normal(size=(B, H, L, D)).astype(np.float32)
    kv = rng.normal(size=(B, H, S, D)).astype(np.float32)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    pos = np.array([0, 5, L - 1], np.int32)     # the last one clamps
    want = _jop(jops.kv_cache_write, Cache=jnp.asarray(cache),
                KV=jnp.asarray(kv), Pos=jnp.asarray(pos))["Out"]
    got = tops.kv_cache_write(torch.from_numpy(cache.copy()),
                              torch.from_numpy(kv), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    att = _jop(jops.kv_cached_attention, Q=jnp.asarray(q), K=want, V=want,
               Pos=jnp.asarray(pos))["Out"]
    tatt = tops.kv_cached_attention(torch.from_numpy(q), got, got,
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(tatt.numpy(), np.asarray(att), atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("S,with_limit", [(1, False), (3, True)])
def test_paged_kv_cache_write_matches_jax(kv_dtype, S, with_limit):
    """The pool write's advanced indexing: index dims first, so the value
    is [B*S, H, D]. Past-limit writes land in the trash block 0, which is
    compared only outside block 0 (duplicate trash writes may land in any
    order)."""
    rng = np.random.default_rng(11)
    B, H, D, bs, nblk, N = 3, 2, 8, 4, 4, 10
    pool = rng.normal(size=(N, H, bs, D)).astype(np.float32)
    kv = rng.normal(size=(B, H, S, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[:B * nblk // 2 + 3]
    tables = np.concatenate([tables, np.zeros(B * nblk - tables.size,
                                              np.int64)]).reshape(B, nblk)
    tables = tables.astype(np.int32)
    pos = np.array([0, 3, 5], np.int32)
    limit = np.array([S, 1, 0], np.int32) if with_limit else None
    ins = dict(Cache=None, KV=jnp.asarray(kv), Tables=jnp.asarray(tables),
               Pos=jnp.asarray(pos),
               Limit=None if limit is None else jnp.asarray(limit))
    tpool = torch.from_numpy(pool.copy())
    tscale = None
    if kv_dtype == "int8":
        qp, sc = jpa.quantize_kv(jnp.asarray(pool))
        ins["Cache"], ins["Scale"] = qp, sc
        tpool, tscale = tpa.quantize_kv(tpool)
    else:
        ins["Cache"] = jnp.asarray(pool)
    want = _jop(jops.paged_kv_cache_write, **ins)
    got = tops.paged_kv_cache_write(
        tpool, torch.from_numpy(kv), torch.from_numpy(tables),
        torch.from_numpy(pos), scale=tscale,
        limit=None if limit is None else torch.from_numpy(limit))
    if kv_dtype == "int8":
        got, got_scale = got
        np.testing.assert_array_equal(got_scale.numpy()[1:],
                                      np.asarray(want["OutScale"])[1:])
    np.testing.assert_array_equal(got.numpy()[1:],
                                  np.asarray(want["Out"])[1:])


def test_row_gather_matches_jax():
    x = np.random.default_rng(4).normal(size=(3, 5, 6)).astype(np.float32)
    idx = np.array([0, 4, 9], np.int32)            # 9 clips to 4
    want = _jop(jops.row_gather, X=jnp.asarray(x),
                Index=jnp.asarray(idx))["Out"]
    got = tops.row_gather(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
