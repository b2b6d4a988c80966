"""GPT's generation programs built from the port's registered decode ops,
against the JAX package's builders and against the port's ``GPT``
module, on the CPU at ``GPTConfig.tiny()``.

- Each dense builder (``gpt_logits``, ``gpt_prefill``,
  ``gpt_decode_step``, ``gpt_verify_step``) from the JAX startup's
  parameters: logits and caches within 1e-5 of max |ref| of the JAX
  program's (``test_torch_decode_paged.py`` holds the paged builders,
  fp32 and int8, whose quantized pools may differ by one step on a
  rounding boundary).
- A write op never changes its ``Cache`` input: a fed pool fetched
  beside the new one, or a cache that ``assign`` made from a constant or
  a feed, is the same after the run, and a second run gives the first's
  values.

``test_torch_decode_module.py`` holds the same programs against the
port's ``GPT`` module, the ``paged_attention`` op's routes and the
sampling ops.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import gpt as tgpt

from torch_pair import FWD_TOL, arrays, assert_close

CPU = tfluid.CPUPlace()
B, S, MAX_LEN, BS, NBLK = 3, 6, 16, 4, 4
NUM_BLOCKS = 1 + B * NBLK
RNG = np.random.default_rng(0)
CFG = dict(jax=jgpt.GPTConfig.tiny(), port=tgpt.GPTConfig.tiny())
H, D = 2, 16
VOCAB = 128


def _tables():
    """Each row its own NBLK blocks (block 0 is the trash block)."""
    return (1 + np.arange(B * NBLK, dtype=np.int32)).reshape(B, NBLK)


def _pools(kv_dtype, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(1):
        for n in (f"cache_pk_{i}", f"cache_pv_{i}"):
            a = rng.standard_normal((NUM_BLOCKS, H, BS, D)).astype(
                np.float32)
            if kv_dtype == "int8":
                out[n] = rng.integers(-127, 128, a.shape).astype(np.int8)
            else:
                out[n] = a
    if kv_dtype == "int8":
        for n in ("cache_pks_0", "cache_pvs_0"):
            out[n] = rng.uniform(0.005, 0.02, (NUM_BLOCKS, H, BS)).astype(
                np.float32)
    return out


def _dense_caches(seed=2):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((B, H, MAX_LEN, D)).astype(np.float32)
            for n in ("cache_k_0", "cache_v_0")}


def _feeds(name, kv_dtype="fp32"):
    toks = RNG.integers(1, VOCAB, (B, S)).astype(np.int32)
    pos = np.array([3, 7, 0], np.int32)
    if name in ("gpt_logits", "gpt_prefill"):
        return {"tokens": toks,
                "pos_ids": np.broadcast_to(np.arange(S, dtype=np.int32),
                                           (B, S)).copy(),
                "last_pos": np.array([S - 1, 2, 4], np.int32)}
    if name == "gpt_decode_step":
        return dict(_dense_caches(), token=toks[:, 0], pos=pos)
    if name == "gpt_verify_step":
        span = 3
        return dict(_dense_caches(), tokens=toks[:, :span], pos=pos,
                    pos_ids=pos[:, None] + np.arange(span, dtype=np.int32))
    if name == "gpt_decode_step_paged":
        return dict(_pools(kv_dtype), token=toks[:, 0], pos=pos,
                    block_tables=_tables())
    span = 4
    feed = dict(_pools(kv_dtype), tokens=toks[:, :span],
                pos_ids=pos[:, None] + np.arange(span, dtype=np.int32),
                start_pos=pos, limit=np.array([4, 2, 3], np.int32),
                block_tables=_tables())
    if name == "gpt_prefill_chunk_paged":
        feed["last_idx"] = np.array([3, 1, 2], np.int32)
    return feed


def _build(pkg, name, kv_dtype):
    g = jgpt if pkg == "jax" else tgpt
    cfg = CFG[pkg]
    if name in ("gpt_logits",):
        return g.gpt_logits(cfg)
    if name in ("gpt_prefill", "gpt_decode_step", "gpt_verify_step"):
        return getattr(g, name)(cfg, MAX_LEN)
    return getattr(g, name)(cfg, kv_dtype)


def _fetches(out):
    return [out["logits"]] + list(out.get("cache_k", [])) \
        + list(out.get("cache_v", [])) + list(out.get("cache_vars", []))


def _run(name, kv_dtype, feed):
    """{"jax": fetched arrays, "port": ...} of one builder's program,
    both from the JAX startup's parameters."""
    res, start = {}, None
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            out = _build(pkg, name, kv_dtype)
        scope = fluid.Scope()
        exe = fluid.Executor() if pkg == "jax" else fluid.Executor(CPU)
        exe.run(startup, scope=scope)
        if pkg == "jax":
            start = arrays(scope)
        else:
            tfluid.framework.scope_from_arrays(scope, start)
        res[pkg] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=_fetches(out), scope=scope)]
    return res, start


CASES = [("gpt_logits", "fp32"), ("gpt_prefill", "fp32"),
         ("gpt_decode_step", "fp32"), ("gpt_verify_step", "fp32")]


@pytest.mark.parametrize("name,kv_dtype", CASES,
                         ids=[f"{n}-{d}" for n, d in CASES])
def test_builder_matches_jax(name, kv_dtype):
    builder_matches_jax(name, kv_dtype)


def builder_matches_jax(name, kv_dtype):
    """The port's program of a builder gives the JAX program's logits
    and caches (feeds, fetches and cache order as in the JAX package)."""
    jout = _build_names("jax", name, kv_dtype)
    tout = _build_names("port", name, kv_dtype)
    assert tout == jout
    res, _ = _run(name, kv_dtype, _feeds(name, kv_dtype))
    for i, (j, t) in enumerate(zip(res["jax"], res["port"])):
        if j.dtype == np.int8:
            # a quantized value may sit on a rounding boundary
            assert np.abs(t.astype(int) - j.astype(int)).max() <= 1, i
        else:
            assert_close(t, j, FWD_TOL, f"{name} fetch {i}")


def _build_names(pkg, name, kv_dtype):
    fluid = jfluid if pkg == "jax" else tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = _build(pkg, name, kv_dtype)
    return out["feed_names"], out.get("cache_names")


# ---- cache inputs the program still reads ---------------------------------

def test_write_leaves_a_read_pool_unchanged():
    """The paged decode program fetches its fed pools beside the
    updated ones: the fed arrays (and the fetched inputs) are unchanged,
    the outputs hold the new vectors."""
    _, start = _run("gpt_logits", "fp32", _feeds("gpt_logits"))
    feed = _feeds("gpt_decode_step_paged")
    before = {n: v.copy() for n, v in feed.items()}
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        out = tgpt.gpt_decode_step_paged(CFG["port"])
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    tfluid.framework.scope_from_arrays(scope, start)
    names = out["cache_names"]
    vals = exe.run(
        main, feed=feed, fetch_list=names + out["cache_vars"], scope=scope)
    old, new = vals[:len(names)], vals[len(names):]
    for n, o, nw in zip(names, old, new):
        np.testing.assert_array_equal(feed[n], before[n], err_msg=n)
        np.testing.assert_array_equal(o, before[n], err_msg=n)
        assert not np.array_equal(nw, before[n]), n


@pytest.mark.parametrize("source", ["assign_value", "assign_feed"])
def test_write_into_an_assigned_cache_runs_alike_twice(source):
    """``kv_cache_write`` into a cache that ``assign`` made and no later
    op reads, of a numpy constant (a cached constant tensor in the port)
    or of a fed array (the caller's tensor itself): two runs at other
    positions each fetch what the JAX program fetches, and the constant
    and the fed tensor stay zero."""
    import torch
    rng = np.random.default_rng(3)
    zeros = np.zeros((B, H, MAX_LEN, D), np.float32)
    kv = rng.standard_normal((B, H, 2, D)).astype(np.float32)
    positions = [np.array([0, 3, 5], np.int32),
                 np.array([8, 10, 12], np.int32)]
    fed = torch.zeros(zeros.shape)
    got = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            if source == "assign_feed":
                src = fluid.layers.assign(
                    fluid.data("c", list(zeros.shape), "float32"))
            else:
                src = fluid.layers.assign(zeros)
            out = fluid.layers.nn.kv_cache_write(
                src, fluid.data("kv", list(kv.shape), "float32"),
                fluid.data("pos", [B], "int32"))
        exe = fluid.Executor() if pkg == "jax" else fluid.Executor(CPU)
        exe.run(startup)
        got[pkg] = []
        for pos in positions:
            feed = {"kv": kv, "pos": pos}
            if source == "assign_feed":
                feed["c"] = zeros if pkg == "jax" else fed
            got[pkg].append(np.asarray(
                exe.run(main, feed=feed, fetch_list=[out])[0]))
    for run, (j, t) in enumerate(zip(got["jax"], got["port"])):
        assert_close(t, j, FWD_TOL, f"{source} run {run}")
    np.testing.assert_array_equal(fed.numpy(), zeros)
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        again = tfluid.layers.assign(zeros)
    np.testing.assert_array_equal(tfluid.Executor(CPU).run(
        again.block.program, fetch_list=[again])[0], zeros)
