"""GPT's generation programs of the port against its ``GPT`` module, the
registered ``paged_attention`` op's routes, and the sampling ops, on the
CPU at ``GPTConfig.tiny()`` (the builders against the JAX package's are
in ``test_torch_decode_programs.py``).

- Each program's logits and caches equal what the ``GPT`` method of the
  same mode computes at the same inputs (1e-5 of max |ref|; bf16 pools
  2e-2), from the JAX startup's parameters.
- ``paged_attention``: S = 1 takes the kernel's wrapper, S > 1 and
  ``impl="xla"`` the gather route, as the JAX op routes them; a row with
  nothing visible is a stated difference.
- ``sample_tokens`` and ``spec_accept``: greedy rows bitwise the JAX
  op's, sampled rows by their distribution.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import decode_ops as tdec

from test_torch_decode_programs import (B, CFG, CPU, D, H, MAX_LEN,
                                        NUM_BLOCKS, S, BS, _build, _feeds,
                                        _fetches, _run, _tables)
from torch_pair import FWD_TOL, assert_close, assert_pair, run_op, run_pair


@functools.lru_cache(maxsize=1)
def _start():
    """The JAX startup's tiny-GPT parameters."""
    return _run("gpt_logits", "fp32", _feeds("gpt_logits"))[1]


def _module(start):
    params = {n: v for n, v in start.items()
              if n in tgpt.param_shapes(CFG["port"])}
    return tgpt.GPT(CFG["port"], params, device="cpu")


def _t(a):
    return a if isinstance(a, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(a))


def _pool_tensors(feed, kv_dtype):
    pools = []
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "int8": torch.int8}[kv_dtype]
    pk, pv = _t(feed["cache_pk_0"]).to(dt), _t(feed["cache_pv_0"]).to(dt)
    ks = _t(feed["cache_pks_0"]) if kv_dtype == "int8" else None
    vs = _t(feed["cache_pvs_0"]) if kv_dtype == "int8" else None
    pools.append((pk, pv, ks, vs))
    return pools


def _port_program(name, kv_dtype, feed, start):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        out = _build("port", name, kv_dtype)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    tfluid.framework.scope_from_arrays(scope, start)
    return exe.run(main, feed=feed, fetch_list=_fetches(out), scope=scope,
                   return_numpy=False)


MODULE_CASES = [("gpt_logits", "fp32"), ("gpt_prefill", "fp32"),
                ("gpt_decode_step", "fp32"),
                ("gpt_decode_step_paged", "fp32"),
                ("gpt_decode_step_paged", "bf16"),
                ("gpt_decode_step_paged", "int8"),
                ("gpt_verify_step_paged", "fp32"),
                ("gpt_verify_step_paged", "int8")]


@pytest.mark.parametrize("name,kv_dtype", MODULE_CASES,
                         ids=[f"{n}-{d}" for n, d in MODULE_CASES])
def test_program_matches_module(name, kv_dtype):
    """Each program's logits and caches equal what ``models.GPT``'s
    method of the same mode computes at the same inputs (1e-5 of max
    |ref|; 2e-2 with a bf16 pool)."""
    start = _start()
    gpt = _module(start)
    feed = _feeds(name, "fp32" if kv_dtype == "bf16" else kv_dtype)
    if kv_dtype == "bf16":
        feed = {n: (_t(v).to(torch.bfloat16) if n.startswith("cache_p")
                    else v) for n, v in feed.items()}
    got = _port_program(name, kv_dtype, feed, start)
    tol = 2e-2 if kv_dtype == "bf16" else FWD_TOL
    f = {n: (v if isinstance(v, torch.Tensor) else _t(v))
         for n, v in feed.items()}
    if name == "gpt_logits":
        want = [gpt.logits(f["tokens"].long(), f["pos_ids"].long(),
                           f["last_pos"].long())]
    elif name == "gpt_prefill":
        logits, ks, vs = gpt.prefill(f["tokens"].long(), f["pos_ids"].long(),
                                     f["last_pos"].long())
        pad = MAX_LEN - S
        want = [logits] + [torch.nn.functional.pad(c, (0, 0, 0, pad))
                           for c in ks + vs]
    elif name == "gpt_decode_step":
        ck, cv = [f["cache_k_0"].clone()], [f["cache_v_0"].clone()]
        want = [gpt.decode_step(f["token"].long(), f["pos"].long(), ck, cv)]
        want += ck + cv
    elif name == "gpt_decode_step_paged":
        pools = _pool_tensors(feed, kv_dtype)
        want = [gpt.decode_step_paged(f["token"].long(), f["pos"],
                                      f["block_tables"], pools)]
        want += [p for p in pools[0] if p is not None]
    else:
        pools = _pool_tensors(feed, kv_dtype)
        want = [gpt.verify_step_paged(
            f["tokens"].long(), f["pos_ids"].long(), f["start_pos"],
            f["limit"], f["block_tables"], pools)]
        want += [p for p in pools[0] if p is not None]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w.dtype == torch.int8:
            assert torch.equal(g, w), f"{name} fetch {i}"
        else:
            assert_close(g.float().numpy(), w.float().numpy(), tol,
                         f"{name} {kv_dtype} fetch {i}")


# ---- the paged_attention op's routes --------------------------------------

def _paged_inputs(S_q, pos):
    rng = np.random.default_rng(4)
    return {"Q": rng.standard_normal((B, H, S_q, D)).astype(np.float32),
            "K": rng.standard_normal((NUM_BLOCKS, H, BS, D)).astype(
                np.float32),
            "V": rng.standard_normal((NUM_BLOCKS, H, BS, D)).astype(
                np.float32),
            "Tables": _tables(), "Pos": np.asarray(pos, np.int32)}


@pytest.mark.parametrize("S_q,impl,route", [
    (1, "", "kernel"), (3, "", "gather"), (1, "xla", "gather"),
    (1, "pallas", "kernel"), (1, "interpret", "kernel")])
def test_paged_attention_routes(monkeypatch, S_q, impl, route):
    """S = 1 takes the kernel's wrapper, S > 1 and ``impl="xla"`` the
    gather route, as the JAX op routes them; the values agree with the
    JAX op's."""
    taken = []
    for fn, tag in (("paged_attention", "kernel"),
                    ("paged_attention_gather", "gather")):
        real = getattr(tdec, fn)
        monkeypatch.setattr(tdec, fn, lambda *a, _r=real, _t=tag, **k:
                            taken.append(_t) or _r(*a, **k))
    ins = _paged_inputs(S_q, [3, 9, 14])
    shape = ins["Q"].shape
    tout, _ = run_op("port", "paged_attention", ins, {"impl": impl},
                     {"Out": (shape, "float32")})
    assert taken == [route]
    jout, _ = run_op("jax", "paged_attention", ins,
                     {"impl": "xla" if impl == "" and S_q > 1 else
                      ("interpret" if impl in ("", "pallas") else impl)},
                     {"Out": (shape, "float32")})
    assert_close(tout["Out"], jout["Out"], FWD_TOL, "paged_attention")


def test_no_visible_key_is_a_stated_difference():
    """A row at pos -1 sees no key: the JAX kernel (interpreted) gives
    0 and the gather composites of both packages the average of the
    values. On the CPU the port's S = 1 route is the plain version,
    which is the composite; on the card K5 gives 0, as the JAX kernel
    does."""
    ins = _paged_inputs(1, [-1, 5, 6])
    shape = ins["Q"].shape
    port, _ = run_op("port", "paged_attention", ins, {"impl": ""},
                     {"Out": (shape, "float32")})
    jk, _ = run_op("jax", "paged_attention", ins, {"impl": "interpret"},
                   {"Out": (shape, "float32")})
    jx, _ = run_op("jax", "paged_attention", ins, {"impl": "xla"},
                   {"Out": (shape, "float32")})
    assert np.abs(jk["Out"][0]).max() == 0.0
    assert np.abs(jx["Out"][0]).max() > 0.0
    assert_close(port["Out"], jx["Out"], FWD_TOL, "composite")
    assert_close(port["Out"][1:], jk["Out"][1:], FWD_TOL, "visible rows")


# ---- sampling ops ---------------------------------------------------------

def test_sample_tokens_greedy_rows_bitwise_and_sampled_distribution():
    rng = np.random.default_rng(5)
    V, n = 8, 4000
    logits = np.tile(rng.standard_normal((1, V)).astype(np.float32) * 2,
                     (n, 1))
    temp = np.where(np.arange(n) % 2 == 0, 0.0, 0.7).astype(np.float32)
    ins = {"X": logits, "Temperature": temp}
    tout, _ = run_op("port", "sample_tokens", ins, {"seed": 3},
                     {"Out": ((n,), "int32")})
    jout, _ = run_op("jax", "sample_tokens", ins, {"seed": 3},
                     {"Out": ((n,), "int32")})
    t, j = tout["Out"], jout["Out"]
    np.testing.assert_array_equal(t[::2], j[::2])
    p = np.exp(logits[0] / 0.7 - (logits[0] / 0.7).max())
    p /= p.sum()
    for got in (t[1::2], j[1::2]):
        freq = np.bincount(got, minlength=V) / got.size
        assert np.abs(freq - p).max() < 0.04, (freq, p)


def test_spec_accept_greedy_bitwise_and_sampled_acceptance_rate():
    rng = np.random.default_rng(6)
    Bn, K, V = 2000, 3, 6
    logits = rng.standard_normal((Bn, K + 1, V)).astype(np.float32)
    argmax = logits.argmax(-1).astype(np.int32)
    draft = np.where(rng.random((Bn, K)) < 0.7, argmax[:, :K],
                     rng.integers(0, V, (Bn, K))).astype(np.int32)
    greedy = np.zeros(Bn, np.float32)
    nd = np.full(Bn, K, np.int32)
    ins = {"X": logits, "Draft": draft, "Temperature": greedy,
           "NumDraft": nd}
    outs = {"Out": ((Bn, K + 1), "int32"), "Accepted": ((Bn,), "int32")}
    t, _ = run_op("port", "spec_accept", ins, {}, outs)
    j, _ = run_op("jax", "spec_accept", ins, {}, outs)
    for s in outs:
        np.testing.assert_array_equal(t[s], j[s], err_msg=s)
    # sampled rows: the first draft is accepted with probability p(d_1)
    ins["Temperature"] = np.ones(Bn, np.float32)
    ins["Draft"] = np.zeros((Bn, K), np.int32)
    ins["X"] = np.tile(logits[:1], (Bn, 1, 1))
    p0 = np.exp(ins["X"][0, 0]) / np.exp(ins["X"][0, 0]).sum()
    for pkg in ("port", "jax"):
        r, _ = run_op(pkg, "spec_accept", ins, {"seed": 2}, outs)
        rate = (r["Accepted"] >= 1).mean()
        assert abs(rate - p0[0]) < 0.04, (pkg, rate, p0[0])


def test_decode_layers_match_jax():
    """The decode layers through ``run_pair``: a cache write and read
    (dense and paged), the row gather, and greedy sampling and
    acceptance (no draw), within 1e-5 of the JAX package's, ints
    exactly."""
    rng = np.random.default_rng(9)
    feed = {"q": rng.standard_normal((2, 2, 3, 4)).astype(np.float32),
            "kv": rng.standard_normal((2, 2, 3, 4)).astype(np.float32),
            "cache": rng.standard_normal((2, 2, 8, 4)).astype(np.float32),
            "pool": rng.standard_normal((7, 2, 4, 4)).astype(np.float32),
            "tables": np.array([[1, 2, 3], [4, 5, 6]], np.int32),
            "pos": np.array([2, 5], np.int32),
            "logits": rng.standard_normal((2, 4, 6)).astype(np.float32),
            "draft": np.array([[1, 2, 3], [0, 4, 5]], np.int32),
            "idx": np.array([3, 1], np.int32)}

    def build(f):
        L = f.layers
        d = {n: L.data(n, list(a.shape), str(a.dtype))
             for n, a in feed.items()}
        cache = L.kv_cache_write(d["cache"], d["kv"], d["pos"])
        att = L.kv_cached_attention(d["q"], cache, cache, d["pos"])
        pool = L.paged_kv_cache_write(d["pool"], d["kv"], d["tables"],
                                      d["pos"])
        patt = L.paged_attention(d["q"], pool, pool, d["tables"], d["pos"])
        rows = L.row_gather(d["logits"], d["idx"])
        zero = L.fill_constant([2], "float32", 0.0)
        tok = L.sample_tokens(rows, zero)
        out, acc = L.spec_accept(d["logits"], d["draft"], zero,
                                 L.fill_constant([2], "int32", 3))
        return [cache, att, pool, patt, rows, tok, out, acc]

    out, _, _ = run_pair(build, feed)
    assert_pair(out, what="decode layers")
