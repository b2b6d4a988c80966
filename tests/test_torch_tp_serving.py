"""Tensor-parallel generation behind the batcher and the server
(``serving.tp``: a leader rank that hands every engine call to its
followers) against the JAX package, on the CPU.

One launch of 2 gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=2 --device=cpu
--grace_s=60 tests/torch_tp_serving_runner.py``), the tp group of
``GPTGenerator(GPTConfig.tiny(), tp=2)`` over the JAX startup's
parameters, runs every scenario; the tests read what each rank wrote.
The JAX side runs here, on the conftest's virtual devices, while the
launch runs: ``serving.GenerationEngine(GPTGenerator(tp=2))`` through a
``DecodeBatcher`` (``tests/test_serving_podscale.py``'s ``_run_bank``),
and its ``generate``. Tokens are equal; a KV payload's arrays are within
1e-5 of max |ref|.

1. Paged and dense banks: six prompts of mixed lengths.
2. Chunked prefill (4-token chunks), prefix hits and a copy-on-write
   divergence: tokens, the pool draining to 0 blocks in use, and the
   follower's pool digest equal to the leader's before every call it
   ran (and read once more at the end).
3. n-gram speculation (k 4) at tp 2, and a model drafter at tp 2 (its
   drafts handed out) and at tp 1 beside the tp 2 target: tokens equal
   the non-speculative run's and JAX's ``test_spec_greedy_parity_tp2``.
4. The server over the wire: four clients, one request cancelled
   mid-decode, one deduplicated pair; ``health`` lists both ranks;
   ``drain()`` ends the follower loop.
5. A hot reload from a whole-tensor save with a request in flight (it
   finishes on the old weights; later ones equal JAX's over the new),
   then a corrupt copy refused typed on both ranks, the new weights
   still serving.
6. A prefill-only request exported from tp 2 (``kvblocks1``, every
   head) continues to the same tokens imported into the port's tp 1
   engine, into the JAX package's engine and back into the tp 2 pool.
7. A decode-step fault on the leader: the supervisor restarts the loop,
   the reset runs on both ranks, and the prompts are then served
   exactly.
8. The follower exits (code 17) mid-traffic: the client gets
   ``TPGroupLostError`` within a few watchdog periods, ``health``
   reports the group lost, a later request is refused typed, and the
   launch ends with exit codes ``[0, 17]``.

With no launch: a world larger than the tp group raises naming item 8b.
The model drafter's own drafts at tp 2 and at tp 1 (scenario
``drafters``) equal the JAX ``ModelDrafter``'s.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu import serving as jserving
from paddle_tpu.flags import flag as jflag
from paddle_tpu.flags import set_flags as jset_flags
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models.generation import GPTGenerator as JGenerator
from paddle_tpu.models.generation import ModelDrafter as JModelDrafter
from paddle_tpu.parallel.mesh import get_mesh, set_mesh

import paddle_tpu_torch as T
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import gpt as tgpt

import torch_tp_serving_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 2
SCENARIOS = ["banks", "chunked", "spec", "drafters", "export", "server",
             "reload", "chaos", "lost"]
WATCHDOG_S = 2.0


def _jax_scope():
    cfg = jgpt.GPTConfig.tiny()
    main, startup = J.Program(), J.Program()
    with J.program_guard(main, startup):
        jgpt.gpt_logits(cfg)
    scope = J.Scope()
    with J.scope_guard(scope):
        J.Executor().run(startup)
    return scope


def _weights_b(arrays):
    """Weights B: the last layer's ffn_1 bias steered toward token 7's
    embedding row (greedy output provably changes)."""
    out = dict(arrays)
    name = "decoder_layer_0_ffn_1.b_0"
    out[name] = arrays[name] + 10.0 * arrays["word_embedding"][7]
    return out


def _save_port(arrays, dirname):
    import torch
    main, startup = T.Program(), T.Program()
    with T.program_guard(main, startup):
        tgpt.gpt_logits(tgpt.GPTConfig.tiny())
    scope = T.Scope()
    for n, a in arrays.items():
        scope.set(n, torch.from_numpy(np.ascontiguousarray(a)))
    tio.save_params(T.Executor(T.CPUPlace()), dirname, main_program=main,
                    scope=scope)


def _jrun_bank(engine, prompts, new=R.NEW, spec_k=0, kv=None):
    from paddle_tpu.serving.batching import (DecodeBatcher,
                                             GenerationRequest,
                                             RequestQueue)
    b = DecodeBatcher(RequestQueue(max_depth=64), engine,
                      spec_k=spec_k).start()
    try:
        reqs = [GenerationRequest(p, max_new_tokens=new) if kv is None
                else GenerationRequest(p, max_new_tokens=new, kv=kv,
                                       first_token=kv["first_token"])
                for p in prompts]
        for r in reqs:
            b.queue.put(r)
        return [r.wait(timeout=120)[0].tolist() for r in reqs]
    finally:
        b.stop()


def _jax_refs(scope, scope_b):
    """Every JAX-side reference the tests hold the ranks to."""
    cfg = jgpt.GPTConfig.tiny()
    keys = ("prefill_chunk_tokens", "kv_prefix_cache", "serving_tp")
    saved = {k: jflag(k) for k in keys}
    prev = get_mesh()
    out = {}
    try:
        g2 = JGenerator(cfg, scope, max_len=R.MAX_LEN,
                        bucket_min=R.BUCKET_MIN, tp=2)
        ps = R.prompts(cfg.vocab_size, R.LENS)
        for paged in (True, False):
            eng = jserving.GenerationEngine(g2, slots=4, paged=paged,
                                            pool_name=f"jtp_banks_{paged}")
            out[f"banks/{'paged' if paged else 'dense'}"] = \
                _jrun_bank(eng, ps)
        jset_flags({"FLAGS_prefill_chunk_tokens": 4})
        eng = jserving.GenerationEngine(g2, slots=4, paged=True,
                                        prefix_cache=True,
                                        pool_name="jtp_chunked")
        out["chunked/main"] = _jrun_bank(
            eng, R.prompts(cfg.vocab_size, [11, 7, 13], seed=1))
        pa, pb = R.cow_pair(cfg.vocab_size)
        eng = jserving.GenerationEngine(g2, slots=4, paged=True,
                                        prefix_cache=True, kv_block_size=4,
                                        pool_name="jtp_cow")
        out["chunked/cow"] = _jrun_bank(eng, [pa]) + _jrun_bank(eng, [pb])
        jset_flags({"FLAGS_prefill_chunk_tokens": 0})
        # test_spec_greedy_parity_tp2
        sp = [R.repetitive_prompt(11), R.prompts(cfg.vocab_size, [8])[0]]
        out["spec"] = [t.tolist() for t in g2.generate(
            sp, max_new_tokens=8, seed=0, paged=True, spec_k=4)]
        # the drafter's tp is FLAGS_serving_tp's
        ctxs = [R.repetitive_prompt(12), R.prompts(cfg.vocab_size, [9])[0]]
        for tp in (2, 1):
            jset_flags({"FLAGS_serving_tp": tp})
            d = JModelDrafter.from_generator(g2)
            out[f"drafts/tp{tp}"] = [np.asarray(d.draft(x, 4)).tolist()
                                     for x in ctxs]
        jset_flags({"FLAGS_serving_tp": 0})
        g1 = JGenerator(cfg, scope, max_len=R.MAX_LEN,
                        bucket_min=R.BUCKET_MIN, tp=1)
        gb = JGenerator(cfg, scope_b, max_len=R.MAX_LEN,
                        bucket_min=R.BUCKET_MIN, tp=1)

        def gen(g, p, n):
            return np.asarray(g.generate([p], max_new_tokens=n,
                                         seed=0)[0]).tolist()
        out["server"] = {str(i): gen(g1, p, R.NEW) for i, p in enumerate(
            R.prompts(cfg.vocab_size, [11, 7, 9, 5], seed=8))}
        rp = R.prompts(cfg.vocab_size, [11, 7], seed=12)
        out["reload/inflight"] = gen(g1, rp[0], 30)
        out["reload/after"] = [gen(gb, p, R.NEW) for p in rp]
        out["chaos"] = [gen(g1, p, R.NEW) for p in
                        R.prompts(cfg.vocab_size, [9, 6], seed=14)]
        xp = R.prompts(cfg.vocab_size, [13], seed=5)[0]
        out["export/tokens"] = gen(g1, xp, R.NEW)
        out["export/engine"] = jserving.GenerationEngine(
            g2, slots=4, paged=True, pool_name="jtp_import")
    finally:
        jset_flags({f"FLAGS_{k}": v for k, v in saved.items()})
        set_mesh(prev)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_serving"))
    scope = _jax_scope()
    arrays = {n: np.asarray(scope.find_var(n))
              for n in tgpt.param_shapes(tgpt.GPTConfig.tiny())}
    np.savez(os.path.join(tmp, "params.npz"), **arrays)
    arrays_b = _weights_b(arrays)
    _save_port(arrays_b, os.path.join(tmp, "ckpt_b"))
    R._save_corrupt(os.path.join(tmp, "ckpt_b"), os.path.join(tmp,
                                                               "ckpt_bad"))
    args = os.path.join(tmp, "args.json")
    with open(args, "w") as f:
        json.dump({"out": tmp, "params": os.path.join(tmp, "params.npz"),
                   "ckpt_b": os.path.join(tmp, "ckpt_b"),
                   "ckpt_bad": os.path.join(tmp, "ckpt_bad"),
                   "scenarios": SCENARIOS}, f)
    pp = [REPO, HERE] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pp))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={N}", "--device=cpu", "--grace_s=60",
         os.path.join(HERE, "torch_tp_serving_runner.py"), args],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        scope_b = J.Scope()
        for n, v in scope.items():
            scope_b.set(n, v)
        for n, a in arrays_b.items():
            scope_b.set(n, a)
        refs = _jax_refs(scope, scope_b)
        out, err = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"tmp": tmp, "refs": refs, "arrays": arrays,
            "seconds": time.perf_counter() - t0, "rc": proc.returncode,
            "stderr": err.decode(errors="replace")}


def read(world, name, rank):
    with open(os.path.join(world["tmp"], f"{name}.{rank}.json")) as f:
        return json.load(f)


def _follower_ok(rec):
    assert rec["error"] is None, rec
    assert rec["digest_checks"] > 0, rec


# ------------------------------------------------------------ the launch

def test_launch_ends_with_every_rank_code(world, record_property):
    """The launch ran every scenario and ended by itself: the leader 0,
    the follower 17 (scenario 8). Its wall time is reported."""
    record_property("launch_seconds", world["seconds"])
    print(f"tp serving launch + JAX references: {world['seconds']:.1f} s")
    assert world["rc"] == R.FOLLOWER_EXIT, world["stderr"][-4000:]
    assert "launch: exit codes [0, 17]" in world["stderr"], \
        world["stderr"][-4000:]
    for name in SCENARIOS:
        assert os.path.exists(os.path.join(world["tmp"], f"{name}.0.json"))


# ------------------------------------------------------------ scenarios

@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_banks_tokens_equal_jax(world, kind):
    lead = read(world, "banks", 0)[kind]
    assert lead["tokens"] == world["refs"][f"banks/{kind}"]
    follower = read(world, "banks", 1)[kind]
    assert follower["error"] is None
    assert follower["calls"]["step"] == lead["calls"]["step"]
    if kind == "paged":
        _follower_ok(follower)
        assert lead["digests"][0] == lead["digests"][1]
        assert lead["blocks_in_use"] == 0


def test_chunked_prefill_and_prefix_hits_equal_jax(world):
    lead = read(world, "chunked", 0)["main"]
    want = world["refs"]["chunked/main"]
    assert lead["first"] == want and lead["again"] == want
    assert lead["hits"] >= 3            # every repeat an exact hit
    assert lead["in_use_1"] == 0 and lead["in_use_2"] == 0
    assert lead["cached_1"] > 0
    assert lead["calls"]["prefill_chunk"] > lead["calls"]["start_prefill"]
    follower = read(world, "chunked", 1)["main"]
    _follower_ok(follower)
    assert lead["digests"][0] == lead["digests"][1]


def test_cow_divergence_equals_jax_and_digests_agree(world):
    lead = read(world, "chunked", 0)["cow"]
    want = world["refs"]["chunked/cow"]
    assert lead["a"] + lead["b"] == want
    assert lead["a_again"] == want[:1]      # the shared blocks intact
    assert lead["cow"] >= 1
    assert lead["in_use"] == 0
    _follower_ok(read(world, "chunked", 1)["cow"])
    assert lead["digests"][0] == lead["digests"][1]


@pytest.mark.parametrize("drafter", ["ngram", "model_tp2", "model_tp1"])
def test_spec_greedy_equals_plain_and_jax_tp2(world, drafter):
    rec = read(world, "spec", 0)
    plain = rec["plain"]["tokens"]
    got = rec[drafter]
    assert got["tokens"] == plain == world["refs"]["spec"]
    assert got["spec_steps"] >= 1
    follower = read(world, "spec", 1)[drafter]
    _follower_ok(follower)
    assert follower["calls"]["spec_step"] == got["spec_steps"]
    # a tp-2 model drafter drafts on both ranks, a tp-1 one on the leader
    drafts = follower["calls"].get("draft", 0)
    assert (drafts > 0) == (drafter == "model_tp2")
    assert got["digests"][0] == got["digests"][1]


@pytest.mark.parametrize("tp", [2, 1])
def test_model_drafter_drafts_equal_jax(world, tp):
    for rank in range(N):
        rec = read(world, "drafters", rank)[f"tp{tp}"]
        assert rec["tp"] == tp
        assert rec["drafts"] == world["refs"][f"drafts/tp{tp}"]


def test_server_over_the_wire(world):
    lead = read(world, "server", 0)
    want = world["refs"]["server"]
    toks = lead["tokens"]
    for i in range(4):
        assert toks[str(i)] == want[str(i)], i
    assert toks["dup0"] == toks["dup1"] == want["0"]
    assert lead["dedup_hits"] >= 1
    assert lead["cancelled"] is True
    assert toks["cancelled"].startswith("RequestCancelledError")
    ranks = lead["health"]["tp_ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["alive"] for r in ranks)
    assert lead["health"]["tp_group"] == "ok"
    assert lead["digests"][0] == lead["digests"][1]
    assert lead["drained"]["drained"] and lead["in_use"] == 0
    assert lead["state"] == "stopped"
    follower = read(world, "server", 1)
    assert follower["error"] is None
    _follower_ok(follower["follower"])
    assert follower["follower"]["calls"]["stop"] == 1


def test_hot_reload_whole_tensor_save(world):
    lead = read(world, "reload", 0)
    refs = world["refs"]
    assert lead["inflight"] == refs["reload/inflight"]
    assert lead["after"] == refs["reload/after"]
    assert lead["swap"]["weights_version"] == 2
    follower = read(world, "reload", 1)["follower"]
    assert follower["calls"]["apply_params"] == 1
    assert follower["error"] is None


def test_corrupt_reload_refused_on_both_ranks(world):
    lead = read(world, "reload", 0)
    assert lead["corrupt"] == "CheckpointCorruptReply"
    assert lead["after_corrupt"] == world["refs"]["reload/after"]
    follower = read(world, "reload", 1)["follower"]
    assert [r["etype"] for r in follower["refused"]] == \
        ["CheckpointCorruptError"]
    assert follower["calls"]["unstage"] == 1
    assert follower["calls"]["apply_params"] == 1     # B's only


def _payload(world):
    with np.load(os.path.join(world["tmp"], "export.0.npz")) as z:
        out = {}
        for k in z.files:
            v = z[k]
            out[k] = v.item() if v.ndim == 0 and v.dtype.kind in "iUO" \
                else v
        return out


@pytest.mark.parametrize("into", ["port_tp1", "jax", "tp2"])
def test_export_from_tp2_continues_anywhere(world, into):
    want = world["refs"]["export/tokens"]
    p = R.prompts(128, [13], seed=5)[0]
    if into == "tp2":
        lead = read(world, "export", 0)
        assert lead["continued"] == want
        assert lead["num_heads"] == tgpt.GPTConfig.tiny().num_heads
        _follower_ok(read(world, "export", 1))
        assert lead["digests"][0] == lead["digests"][1]
        return
    payload = _payload(world)
    assert payload["fmt"] == "kvblocks1"
    if into == "jax":
        got = _jrun_bank(world["refs"]["export/engine"], [p], kv=payload)
    else:
        from paddle_tpu_torch.models import GPTConfig, GPTGenerator
        from paddle_tpu_torch.serving import GenerationEngine
        gen = GPTGenerator(GPTConfig.tiny(), world["arrays"],
                           max_len=R.MAX_LEN, bucket_min=R.BUCKET_MIN,
                           device="cpu")
        eng = GenerationEngine(gen, slots=4, paged=True,
                               pool_name="tp1_import")
        # the single-card export of the same prompt: the same layout, the
        # same values within 1e-5 of max |ref|
        from paddle_tpu_torch.serving import GenerationRequest
        from paddle_tpu_torch.serving.batching import (DecodeBatcher,
                                                       RequestQueue)
        req = GenerationRequest(p, max_new_tokens=R.NEW, export_kv=True)
        b = DecodeBatcher(RequestQueue(max_depth=8), eng).start()
        try:
            b.queue.put(req)
            ref = req.wait(timeout=60)[0]
        finally:
            b.stop()
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                top = float(np.abs(ref[k]).max()) or 1.0
                assert payload[k].shape == ref[k].shape, k
                assert float(np.abs(payload[k] - ref[k]).max()) <= 1e-5 * top
        got = R.run_bank(eng, [GenerationRequest(
            p, max_new_tokens=R.NEW, kv=payload,
            first_token=payload["first_token"])])
    assert got == [want]


def test_chaos_decode_fault_restarts_both_ranks(world):
    lead = read(world, "chaos", 0)
    assert lead["fired"] == 1 and lead["restarts"] >= 1
    assert lead["resets"] >= 1
    errors = [v for k, v in lead.items() if k.startswith("faulted")
              and isinstance(v, str)]
    assert errors and all("fault injected" in e for e in errors)
    assert [lead["after"][str(i)] for i in range(2)] == world["refs"]["chaos"]
    assert lead["digests"][0] == lead["digests"][1]
    follower = read(world, "chaos", 1)["follower"]
    _follower_ok(follower)
    assert follower["calls"]["reset"] == lead["resets"]


def test_lost_follower_fails_typed_and_health_reports_it(world):
    lead = read(world, "lost", 0)
    assert lead["inflight"].startswith("TPGroupLostError"), lead["inflight"]
    assert lead["seconds"] < 4 * WATCHDOG_S
    assert lead["later"].startswith("TPGroupLostError"), lead["later"]
    h = lead["health"]
    assert h["tp_group"] == "lost"
    assert [r["alive"] for r in h["tp_ranks"]] == [True, False]
    assert lead["state"] == "stopped"
    assert not os.path.exists(os.path.join(world["tmp"], "lost.1.json"))


# ---------------------------------------------------- cases with no launch

@pytest.mark.parametrize("world_size,tp", [(4, 2), (8, 4)])
def test_world_larger_than_the_tp_group_raises(world_size, tp):
    from paddle_tpu_torch.serving import check_serving_world
    with pytest.raises(NotImplementedError, match="item 8b"):
        check_serving_world(tp, world=world_size)
    check_serving_world(tp, world=tp)


def test_pool_digest_follows_the_bookkeeping():
    from paddle_tpu_torch.serving import KVBlockPool
    a, b = (KVBlockPool(slots=2, num_layers=1, num_heads=2, d_head=4,
                        max_seq_len=16, block_size=4, device="cpu",
                        prefix_cache=True, name=f"digest_{i}")
            for i in range(2))
    assert a.digest() == b.digest()
    for p in (a, b):
        p.alloc(0, 6)
    assert a.digest() == b.digest()
    a.alloc(1, 3)
    assert a.digest() != b.digest()
    b.alloc(1, 3)
    a.prefix_insert(np.arange(6), 0)
    assert a.digest() != b.digest()
    b.prefix_insert(np.arange(6), 0)
    assert a.digest() == b.digest()
