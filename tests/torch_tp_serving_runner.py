"""Worker of the port's tensor-parallel serving CPU tests
(``test_torch_tp_serving.py``): one rank of a gloo world of 2 started by
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2
--device=cpu --grace_s=60``, the tp group of ``GPTGenerator(tp=2)``.

    python torch_tp_serving_runner.py <args.json>

``args``: ``{"out": dir, "params": npz of the JAX startup's tiny-GPT
arrays, "ckpt_b": a save_params directory of weights B, "ckpt_bad": a
copy of it with one byte flipped, "scenarios": [names]}``. Rank 0 (the
leader) drives every scenario through ``serving.tp``; rank 1 runs the
follower loop and reports what it ran. Each scenario writes
``<out>/<scenario>.<rank>.json`` (and arrays into ``.npz`` where it has
any). The last scenario, ``lost``, ends the follower with exit code 17
mid-traffic. This module imports the port only (the ranks never import
JAX).
"""
import json
import os
import sys
import threading
import time

import numpy as np

MAX_LEN, BUCKET_MIN, NEW = 48, 8, 6
LENS = [11, 7, 19, 5, 13, 9]
FOLLOWER_EXIT = 17


def prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def repetitive_prompt(n=12):
    return np.array(([5, 6, 7] * ((n + 2) // 3))[:n], np.int32)


def cow_pair(vocab):
    """Two prompts sharing an 8-token head (2 blocks at block size 4)."""
    rng = np.random.default_rng(2)
    head = rng.integers(1, vocab, 8).astype(np.int32)
    return (np.concatenate([head, rng.integers(1, vocab, 3).astype(np.int32)]),
            np.concatenate([head, rng.integers(1, vocab, 5).astype(np.int32)]))


class Ctx:
    def __init__(self, args):
        import torch
        torch.set_num_threads(1)
        from paddle_tpu_torch.parallel import mesh
        self.args = args
        self.mesh = mesh
        mesh.init_parallel_env()
        self.rank = mesh.rank()
        with np.load(args["params"]) as z:
            self.params = {k: z[k] for k in z.files}

    def gen(self, **kw):
        from paddle_tpu_torch.models import GPTConfig, GPTGenerator
        return GPTGenerator(GPTConfig.tiny(), self.params, max_len=MAX_LEN,
                            bucket_min=BUCKET_MIN, device="cpu", tp=2, **kw)

    @property
    def cfg(self):
        from paddle_tpu_torch.models import GPTConfig
        return GPTConfig.tiny()


def run_bank(engine, reqs, spec_k=0):
    """``reqs`` (GenerationRequests) through a DecodeBatcher over
    ``engine``; the token lists."""
    from paddle_tpu_torch.serving.batching import DecodeBatcher, RequestQueue
    b = DecodeBatcher(RequestQueue(max_depth=64), engine,
                      spec_k=spec_k).start()
    try:
        for r in reqs:
            b.queue.put(r)
        return [r.wait(timeout=120)[0].tolist() for r in reqs]
    finally:
        b.stop()


def with_engine(c, lead, **kw):
    """Every rank builds ``serving.tp_generation_engine`` (per-call
    digest checks on); the leader runs ``lead(engine)`` and then reads
    the pools' digests and ends the group, the follower runs its loop.
    Returns (the leader's record, or the follower's)."""
    from paddle_tpu_torch.serving import tp_generation_engine
    eng = tp_generation_engine(c.gen(), check_digests=True, **kw)
    if not eng.leader:
        eng.run()
        return eng.record()
    try:
        rec = lead(eng)
        rec["digests"] = eng.pool_digests()
        rec["calls"] = dict(eng.calls)
        rec["blocks_in_use"] = (eng.pool.blocks_in_use()
                                if eng.pool is not None else None)
    finally:
        eng.shutdown()
    return rec


def reqs_of(ps, new=NEW, **kw):
    from paddle_tpu_torch.serving import GenerationRequest
    return [GenerationRequest(p, max_new_tokens=new, **kw) for p in ps]


# ------------------------------------------------------------- scenarios

def sc_banks(c):
    """Six prompts of mixed lengths through the batcher, paged and dense."""
    ps = prompts(c.cfg.vocab_size, LENS)
    out = {}
    for paged in (True, False):
        out["paged" if paged else "dense"] = with_engine(
            c, lambda e: {"tokens": run_bank(e, reqs_of(ps))},
            slots=4, paged=paged, pool_name=f"tp_banks_{paged}")
    return out


def sc_chunked(c):
    """Chunked prefill (4-token chunks) with the prefix cache: the
    prompts, then again (every prompt an exact prefix hit); then two
    prompts sharing a block-aligned head (the second adopts it and
    copies on write at its divergence), then the first again."""
    from paddle_tpu_torch.flags import flag, set_flags
    ps = prompts(c.cfg.vocab_size, [11, 7, 13], seed=1)
    pa, pb = cow_pair(c.cfg.vocab_size)
    old = flag("prefill_chunk_tokens")
    set_flags({"FLAGS_prefill_chunk_tokens": 4})
    try:
        def lead(e):
            rec = {"first": run_bank(e, reqs_of(ps)),
                   "in_use_1": e.pool.blocks_in_use(),
                   "cached_1": e.pool.cached_blocks()}
            hits = e.pool.counters["prefix_hits"]
            rec["again"] = run_bank(e, reqs_of(ps))
            rec["hits"] = e.pool.counters["prefix_hits"] - hits
            rec["in_use_2"] = e.pool.blocks_in_use()
            return rec

        def lead_cow(e):
            rec = {"a": run_bank(e, reqs_of([pa])),
                   "b": run_bank(e, reqs_of([pb]))}
            rec["cow"] = e.pool.counters["prefix_cow_copies"]
            rec["a_again"] = run_bank(e, reqs_of([pa]))
            rec["in_use"] = e.pool.blocks_in_use()
            return rec
        out = {"main": with_engine(c, lead, slots=4, paged=True,
                                   prefix_cache=True,
                                   pool_name="tp_chunked"),
               "cow": with_engine(c, lead_cow, slots=4, paged=True,
                                  prefix_cache=True, kv_block_size=4,
                                  pool_name="tp_cow")}
    finally:
        set_flags({"FLAGS_prefill_chunk_tokens": old})
    return out


def sc_spec(c):
    """Speculation at tp 2 through the batcher (spec_k 4): the n-gram
    drafter, a model drafter at tp 2 (its drafts handed out) and one at
    tp 1 beside the tp 2 target (whole layers gathered once, drafting on
    the leader alone); each beside the same prompts with speculation
    off."""
    from paddle_tpu_torch.flags import flag, set_flags
    ps = [repetitive_prompt(11), prompts(c.cfg.vocab_size, [8])[0]]
    saved = {k: flag(k) for k in ("decode_spec_mode", "serving_tp")}
    out = {"plain": with_engine(c, lambda e: {"tokens": run_bank(
        e, reqs_of(ps, new=8))}, slots=4, paged=True, pool_name="tp_plain")}
    try:
        for name, mode, tp in (("ngram", "ngram", 1),
                               ("model_tp2", "model", 2),
                               ("model_tp1", "model", 1)):
            set_flags({"FLAGS_decode_spec_mode": mode,
                       "FLAGS_serving_tp": tp})

            def lead(e):
                rec = {"tokens": run_bank(e, reqs_of(ps, new=8), spec_k=4)}
                rec["spec_steps"] = e.calls.get("spec_step", 0)
                return rec
            out[name] = with_engine(c, lead, slots=4, paged=True,
                                    pool_name=f"tp_spec_{name}")
    finally:
        set_flags({f"FLAGS_{k}": v for k, v in saved.items()})
    return out


def sc_drafters(c):
    """The model drafter's drafts outside the engine: at tp 2 (every rank
    drafts, in lockstep) and at tp 1 beside the tp 2 target."""
    from paddle_tpu_torch.models.generation import ModelDrafter
    gen = c.gen()
    ctxs = [repetitive_prompt(12), prompts(c.cfg.vocab_size, [9])[0]]
    out = {}
    for tp in (2, 1):
        d = ModelDrafter.from_generator(gen, tp=tp)
        out[f"tp{tp}"] = {"tp": d.tp,
                          "drafts": [d.draft(x, 4).tolist() for x in ctxs]}
    return out


def sc_export(c):
    """A prefill-only request exported from the tp 2 pool (written out
    for the test's imports), and the same payload imported back into the
    tp 2 pool and decoded."""
    from paddle_tpu_torch.serving import GenerationRequest
    p = prompts(c.cfg.vocab_size, [13], seed=5)[0]
    arrays = {}

    def lead(e):
        from paddle_tpu_torch.serving.batching import (DecodeBatcher,
                                                       RequestQueue)
        req = GenerationRequest(p, max_new_tokens=NEW, export_kv=True)
        b = DecodeBatcher(RequestQueue(max_depth=8), e).start()
        try:
            b.queue.put(req)
            payload = req.wait(timeout=120)[0]
            back = GenerationRequest(p, max_new_tokens=NEW, kv=payload,
                                     first_token=payload["first_token"])
            b.queue.put(back)
            cont = back.wait(timeout=120)[0].tolist()
        finally:
            b.stop()
        for k, v in payload.items():
            arrays[k] = np.asarray(v)
        return {"continued": cont, "first_token": int(payload["first_token"]),
                "num_heads": int(payload["num_heads"])}
    rec = with_engine(c, lead, slots=4, paged=True, pool_name="tp_export")
    return rec, arrays


def _wire(endpoint, prompt, new, out, key, rid=None):
    from paddle_tpu_torch.serving import Client
    try:
        with Client(endpoint, timeout=120) as cl:
            out[key] = cl.generate(prompt, new, rid=rid).tolist()
    except Exception as e:  # noqa: BLE001 — judged by the test
        out[key] = f"{type(e).__name__}: {e}"


def _server(c, **kw):
    from paddle_tpu_torch.serving import InferenceServer
    kw.setdefault("decode_slots", 4)
    kw.setdefault("paged", True)
    return InferenceServer(generator=c.gen(), **kw)


def _follow(server):
    server.start()
    err = server.join()
    return {"follower": server.tp_follower.record(),
            "error": None if err is None else repr(err)}


def sc_server(c):
    """Over the wire: four clients, one request cancelled mid-decode and
    one pair deduplicated by request id; ``health`` lists both ranks;
    ``drain()`` then ``stop()`` end the follower loop."""
    from paddle_tpu_torch.serving import Client
    srv = _server(c)
    if srv.tp_follower is not None:
        return _follow(srv)
    srv.start()
    srv.gen_engine.check_digests = True
    ps = prompts(c.cfg.vocab_size, [11, 7, 9, 5], seed=8)
    out = {}
    threads = [threading.Thread(target=_wire, args=(srv.endpoint, p, NEW,
                                                    out, str(i)))
               for i, p in enumerate(ps)]
    # the deduplicated pair: one rid, two connections
    threads += [threading.Thread(target=_wire, args=(
        srv.endpoint, ps[0], NEW, out, f"dup{k}", "dup-rid"))
        for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    # cancel: a long request, cancelled once it is decoding
    long_p = prompts(c.cfg.vocab_size, [5], seed=9)[0]
    t = threading.Thread(target=_wire, args=(srv.endpoint, long_p, 40, out,
                                             "cancelled", "cancel-rid"))
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and \
            srv.health().get("decode_active_rows", 0) < 1:
        time.sleep(0.001)
    with Client(srv.endpoint) as cl:
        cancelled = cl.cancel("cancel-rid")
        health = cl.health()
    t.join(60)
    stats = srv.stats()
    digests = srv.tp_pool_digests()
    drained = srv.drain(timeout=30)
    return {"tokens": out, "cancelled": cancelled, "health": health,
            "dedup_hits": stats.get("hedge_dedup_hits", 0),
            "digests": digests, "drained": drained,
            "in_use": srv.gen_engine.pool.blocks_in_use(),
            "state": srv.state}


def _save_corrupt(src, dst):
    import shutil
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    name = sorted(f for f in os.listdir(dst) if f.endswith(".npy"))[0]
    path = os.path.join(dst, name)
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def sc_reload(c):
    """Hot reload to weights B (a whole-tensor save) while a request is in
    flight, then a corrupt copy of B refused on both ranks with B still
    serving."""
    from paddle_tpu_torch.serving import Client
    srv = _server(c)
    if srv.tp_follower is not None:
        return _follow(srv)
    srv.start()
    ps = prompts(c.cfg.vocab_size, [11, 7], seed=12)
    out = {}
    t = threading.Thread(target=_wire, args=(srv.endpoint, ps[0], 30, out,
                                             "inflight"))
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and \
            srv.health().get("decode_active_rows", 0) < 1:
        time.sleep(0.001)
    with Client(srv.endpoint) as cl:
        swap = cl.reload_weights(c.args["ckpt_b"])
        t.join(60)
        out["after"] = [cl.generate(p, NEW).tolist() for p in ps]
        try:
            cl.reload_weights(c.args["ckpt_bad"])
            out["corrupt"] = "accepted"
        except Exception as e:  # noqa: BLE001 — judged by the test
            out["corrupt"] = type(e).__name__
            out["corrupt_msg"] = str(e)
        out["after_corrupt"] = [cl.generate(p, NEW).tolist() for p in ps]
    out["swap"] = swap
    srv.drain(timeout=30)
    return out


def sc_chaos(c):
    """A decode-step fault injected on the leader: the decode loop dies,
    the supervisor restarts it (the engine reset handed to the
    follower), and the same prompts are then served exactly."""
    from paddle_tpu_torch import resilience
    srv = _server(c)
    if srv.tp_follower is not None:
        return _follow(srv)
    srv.start()
    srv.gen_engine.check_digests = True
    ps = prompts(c.cfg.vocab_size, [9, 6], seed=14)
    out = {}
    with resilience.fault_injection("serving.decode_step",
                                    exc=RuntimeError, times=1) as spec:
        for i, p in enumerate(ps):
            _wire(srv.endpoint, p, NEW, out, f"faulted{i}")
        fired = spec["fired"]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and \
            srv.supervisor.restarts() < 1:
        time.sleep(0.01)
    out["restarts"] = srv.supervisor.restarts()
    out["after"] = {}
    for i, p in enumerate(ps):
        _wire(srv.endpoint, p, NEW, out["after"], str(i))
    out["fired"] = fired
    out["resets"] = srv.gen_engine.calls.get("reset", 0)
    out["digests"] = srv.tp_pool_digests()
    srv.drain(timeout=30)
    return out


def sc_lost(c):
    """The follower exits (code 17) at its fifth decode step: the client
    gets the typed error, ``health`` reports the group lost, a later
    request is refused typed, and the leader stops and exits by itself."""
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.serving import Client
    srv = _server(c, loop_watchdog_s=2.0)
    if srv.tp_follower is not None:
        seen = {"steps": 0}

        def die(point, ctx):
            if ctx["op"] == "step":
                seen["steps"] += 1
                if seen["steps"] == 5:
                    sys.stdout.flush()
                    os._exit(FOLLOWER_EXIT)
            return None
        with resilience.fault_injection("serving.tp_follower", exc=die,
                                        times=-1):
            return _follow(srv)
    srv.start()
    p = prompts(c.cfg.vocab_size, [7], seed=16)[0]
    out = {}
    t0 = time.monotonic()
    _wire(srv.endpoint, p, 30, out, "inflight")
    out["seconds"] = time.monotonic() - t0
    with Client(srv.endpoint) as cl:
        health = cl.health()
    _wire(srv.endpoint, p, 4, out, "later")
    srv.stop()
    out["health"] = health
    out["state"] = srv.state
    return out


SCENARIOS = {n[3:]: f for n, f in globals().items() if n.startswith("sc_")}


def _write(c, name, rec):
    arrays = None
    if isinstance(rec, tuple):
        rec, arrays = rec
    base = os.path.join(c.args["out"], f"{name}.{c.rank}")
    with open(base + ".json", "w") as f:
        json.dump(rec, f, default=str)
    if arrays:
        np.savez(base + ".npz", **arrays)


def main(path):
    with open(path) as f:
        args = json.load(f)
    c = Ctx(args)
    for name in args["scenarios"]:
        t0 = time.perf_counter()
        rec = SCENARIOS[name](c)
        if isinstance(rec, dict):
            rec["seconds"] = time.perf_counter() - t0
        _write(c, name, rec)
    sys.stdout.flush()
    # the group may be lost (the last scenario ends the follower): the
    # leader leaves without tearing down a process group with a dead peer
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1])
