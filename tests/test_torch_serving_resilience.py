"""The port's serving resilience layer on the CPU, mirroring
tests/test_serving_resilience.py: lifecycle and ``health``, ``stop``
failing queued requests, typed draining refusal over the wire, drain
(infer and generation), supervised restarts of both loops, degraded then
recovered, the watchdog on an execute and on a decode step, hot weight
reload (infer and generation) and its corrupt checkpoint, concurrent
swaps, hedged infer with dedup, cancel, request-id dedup of generate,
the client's reconnect after a bounce. Held against the JAX package:
drain's greedy tokens and a reload's in-flight / old / new tokens equal
the JAX ``GPTGenerator.generate`` tokens under the same params, and a
reload of the infer engine matches the JAX engine's outputs after the
same reload within 1e-5 of max |ref|."""
import os
import socket
import threading
import time

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.distributed import wire
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (BadRequestError, Client,
                                      InferenceServer, InternalServerError,
                                      RequestCancelledError,
                                      ServerOverloadedError,
                                      ServerShutdownError, ServingError)
from tests import torch_served_models as M
from tests.torch_tiny_gpt import BUCKET_MIN, MAX_LEN, tiny_pair

CPU = T.CPUPlace()
RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _fresh():
    tres.reset_retry_budget()
    tres.clear_faults()
    yield
    tres.clear_faults()
    tres.reset_retry_budget()


def _wait_until(cond, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """A saved MLP (x [-1, 16] -> 32 relu -> 4 softmax) with seeded
    weights, and two params-only checkpoints beside it: ``ckpt_v1`` (the
    same weights) and ``ckpt_v2`` (every weight doubled)."""
    d = str(tmp_path_factory.mktemp("mlp"))
    main, _, feeds, targets = M.build(T, "mlp")
    exe, scope = T.Executor(CPU), T.Scope()
    import torch
    for n, a in M.weights(main, np.random.default_rng(0)).items():
        scope.set(n, torch.from_numpy(a))
    T.save_inference_model(d, feeds, targets, exe, main_program=main,
                           scope=scope)
    tio.save_params(exe, os.path.join(d, "ckpt_v1"), main_program=main,
                    scope=scope)
    for v in main.global_block().vars.values():
        if tio.is_parameter(v):
            scope.set(v.name, scope.find_var(v.name) * 2.0)
    tio.save_params(exe, os.path.join(d, "ckpt_v2"), main_program=main,
                    scope=scope)
    return d


def _x(rows=1):
    return RNG.standard_normal((rows, 16)).astype(np.float32)


def _server(path, **kw):
    kw.setdefault("batch_timeout_ms", 1.0)
    return InferenceServer(path, place=CPU, **kw)


# ------------------------------------------------------ tiny GPT helpers

@pytest.fixture(scope="module")
def gpt_ab(tmp_path_factory):
    """The tiny GPT's params A (the JAX startup's) and B (the last
    layer's ffn_1 bias steered toward token 7's embedding row, so greedy
    output provably changes), a JAX generator for each, and B saved by
    the port's ``io.save_params`` (manifest included)."""
    tgen, jgen_a, jscope = tiny_pair()
    cfg = tgen.cfg
    arrays_a = {n: np.asarray(jscope.find_var(n)) for n in tgpt.param_shapes(cfg)}
    bname = "decoder_layer_%d_ffn_1.b_0" % (cfg.num_layers - 1)
    arrays_b = dict(arrays_a)
    arrays_b[bname] = arrays_a[bname] + 10.0 * arrays_a["word_embedding"][7]
    jscope_b = J.Scope()
    for n, v in jscope.items():
        jscope_b.set(n, v)
    jscope_b.set(bname, arrays_b[bname])
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.models.generation import GPTGenerator as JGenerator
    jgen_b = JGenerator(jgpt.GPTConfig.tiny(), jscope_b, max_len=MAX_LEN,
                        bucket_min=BUCKET_MIN)
    d = str(tmp_path_factory.mktemp("gpt_b"))
    main, startup = T.Program(), T.Program()
    with T.program_guard(main, startup):
        tgpt.gpt_logits(cfg)
    import torch
    scope = T.Scope()
    for n, a in arrays_b.items():
        scope.set(n, torch.from_numpy(np.ascontiguousarray(a)))
    tio.save_params(T.Executor(CPU), d, main_program=main, scope=scope)
    return {"cfg": cfg, "A": arrays_a, "B": arrays_b, "jgen_a": jgen_a,
            "jgen_b": jgen_b, "dir_b": d, "bname": bname}


def _tgen(arrays):
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator
    return GPTGenerator(GPTConfig.tiny(), arrays, max_len=MAX_LEN,
                        bucket_min=BUCKET_MIN, device="cpu")


def _jref(jgen, prompt, n):
    return np.asarray(jgen.generate([prompt], max_new_tokens=n, seed=0)[0])


def _prompt(cfg, n):
    return RNG.integers(1, cfg.vocab_size, n).astype(np.int32)


def _gen_server(arrays, **kw):
    kw.setdefault("decode_slots", 2)
    kw.setdefault("paged", True)
    return InferenceServer(generator=_tgen(arrays), **kw)


# ------------------------------------------------- client reconnect fix

def test_client_reconnects_after_server_bounce(mlp):
    server = _server(mlp).start()
    port = server.port
    c = Client(server.endpoint)
    x = _x()
    want, = c.infer({"x": x})
    server.stop()
    server2 = _server(mlp, port=port).start()
    try:
        got, = c.infer({"x": x})         # reconnects once, transparently
        np.testing.assert_array_equal(got, want)
        assert c.ping()
    finally:
        c.close()
        server2.stop()


def test_client_idempotent_ops_retry(mlp):
    server = _server(mlp).start()
    c = Client(server.endpoint)
    try:
        assert c.ping()
        c._sock.close()                  # a silently dead socket
        assert c.ping()                  # retry_call + reconnect
        assert "state" in c.health()
        assert "requests_completed" in c.stats()
        assert "serving_requests_completed_total" in c.metrics()
    finally:
        c.close()
        server.stop()


# ------------------------------------------------ typed shutdown errors

def test_stop_fails_queued_requests_immediately(mlp):
    server = _server(mlp, max_batch_size=1, queue_depth=64)
    server.start(serve_network=False)

    def slow(point, ctx):
        time.sleep(0.4)

    with tres.fault_injection("serving.execute", exc=slow, times=-1):
        x = _x()
        first = server.submit({"x": x})
        time.sleep(0.05)
        queued = [server.submit({"x": x}) for _ in range(4)]
        t0 = time.monotonic()
        server.stop()
        for req in queued:
            with pytest.raises(ServerShutdownError):
                req.wait(timeout=10)
        assert time.monotonic() - t0 < 8.0       # not the requests' timeouts
    assert server.state == "stopped"
    try:
        first.wait(timeout=10)
    except ServingError:
        pass


def test_draining_admission_refused_typed_over_wire(mlp):
    server = _server(mlp).start()
    try:
        with Client(server.endpoint) as c:
            c.infer({"x": _x()})
            server.queue.quiesce()               # drain's admission gate
            with pytest.raises(ServerShutdownError):
                c.infer({"x": _x()})
            assert c.ping()                      # control ops still served
            assert c.health()["state"] == "serving"
    finally:
        server.stop()


# ----------------------------------------------- lifecycle + health op

def test_lifecycle_states_and_health(mlp):
    server = _server(mlp)
    assert server.state == "created"
    server.start()
    try:
        assert server.state == "serving"
        with Client(server.endpoint) as c:
            h = c.health()
            assert h["state"] == "serving" and h["weights_version"] == 1
            assert h["breaker"] == "closed"
            assert h["loops"]["microbatcher"]["alive"] is True
            assert h["loops"]["microbatcher"]["restarts"] == 0
            assert h["queue_depth"] == 0 and h["brownout_level"] == 0
        st = server.stats()
        assert st["state"] == "serving" and st["loop_restarts"] == 0
        assert st["breaker_state"] == "closed"
    finally:
        server.stop()
    assert server.state == "stopped"


def test_drain_completes_inflight_and_stops(mlp):
    server = _server(mlp, batch_timeout_ms=10.0)
    server.start(serve_network=False)
    x = _x()
    ref, = server.infer({"x": x}, timeout=60)
    reqs = [server.submit({"x": x}) for _ in range(6)]
    report = server.drain(timeout=60)
    assert report == {"drained": True, "remaining": 0}
    assert server.state == "stopped"
    for req in reqs:                     # admitted before the drain
        got, = req.wait(timeout=10)
        # a batch of 6 sums in another order than a batch of 1: within
        # 1e-5 of max |ref| (float32)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    with pytest.raises(ServerShutdownError):
        server.submit({"x": x})


def test_drain_generation_greedy_parity(gpt_ab):
    """drain() returns with no row in flight, and the rows admitted
    before it give the JAX package's greedy tokens (exact)."""
    cfg = gpt_ab["cfg"]
    prompts = [_prompt(cfg, n) for n in (5, 9, 7)]
    server = _gen_server(gpt_ab["A"])
    server.start(serve_network=False)
    reqs = [server.submit_generate(p, max_new_tokens=8) for p in prompts]
    report = server.drain(timeout=120)
    assert report == {"drained": True, "remaining": 0}
    assert server.decode_batcher.inflight() == 0
    for req, p in zip(reqs, prompts):
        got, = req.wait(timeout=10)
        np.testing.assert_array_equal(got, _jref(gpt_ab["jgen_a"], p, 8))


# ------------------------------------------------------ supervised loops

def test_supervisor_restarts_crashed_microbatcher(mlp):
    server = _server(mlp)
    server.supervisor.poll_s = 0.02
    server.start(serve_network=False)
    try:
        x = _x()
        server.infer({"x": x}, timeout=60)
        with tres.fault_injection("serving.queue", exc=RuntimeError,
                                  times=1):
            assert _wait_until(
                lambda: server.stats()["loop_restarts"] >= 1)
        assert _wait_until(server.batcher.alive)
        server.infer({"x": x}, timeout=60)       # serving again
        h = server.health()
        assert h["loops"]["microbatcher"]["restarts"] == 1
        assert server.state == "serving"         # one crash != degraded
    finally:
        server.stop()


def test_supervisor_restarts_crashed_decode_loop(gpt_ab):
    cfg = gpt_ab["cfg"]
    server = _gen_server(gpt_ab["A"])
    server.supervisor.poll_s = 0.02
    server.start(serve_network=False)
    try:
        p = _prompt(cfg, 5)
        server.generate(p, max_new_tokens=2, timeout=120)
        with tres.fault_injection("serving.queue", exc=RuntimeError,
                                  times=1):
            assert _wait_until(
                lambda: server.stats()["loop_restarts"] >= 1)
        assert _wait_until(server.decode_batcher.alive)
        got = server.generate(p, max_new_tokens=4, timeout=120)
        np.testing.assert_array_equal(got, _jref(gpt_ab["jgen_a"], p, 4))
    finally:
        server.stop()


def test_decode_step_crash_restarts_loop_without_leaks(gpt_ab):
    """A fault in a decode step fails the rows in flight typed and ends
    the loop; the supervisor restarts it on a reset engine (every block
    freed) and the next requests give the reference tokens."""
    cfg = gpt_ab["cfg"]
    server = _gen_server(gpt_ab["A"])
    server.supervisor.poll_s = 0.02
    server.start(serve_network=False)
    try:
        prompts = [_prompt(cfg, n) for n in (6, 8)]
        with tres.chaos({"serving.decode_step": {"times": 1}}):
            reqs = [server.submit_generate(p, max_new_tokens=6)
                    for p in prompts]
            for r in reqs:
                with pytest.raises(tres.FaultInjected):
                    r.wait(timeout=60)
            assert _wait_until(
                lambda: server.health()["loops"]["decode"]["restarts"] == 1)
        assert _wait_until(lambda: server.state == "serving")
        for p in prompts:
            np.testing.assert_array_equal(
                server.generate(p, max_new_tokens=6, timeout=120),
                _jref(gpt_ab["jgen_a"], p, 6))
        assert server.gen_engine.reclaim_leaks([]) == 0
        assert server.gen_engine.pool.blocks_in_use() == 0
        assert server.stats()["engine_failures"] == 1
    finally:
        server.stop()


def test_watchdog_fails_hung_execute_typed(mlp):
    """A hung execute is bounded by the loop watchdog: the batch's client
    gets WatchdogTimeout over the wire (an InternalServerError too), and
    the loop serves the next batch."""
    server = _server(mlp, loop_watchdog_s=1.0).start()
    try:
        with Client(server.endpoint) as c:
            x = _x()
            want, = c.infer({"x": x})

            def hang(point, ctx):
                time.sleep(4.0)

            with tres.fault_injection("serving.execute", exc=hang, times=1):
                t0 = time.monotonic()
                with pytest.raises(tres.WatchdogTimeout) as ei:
                    c.infer({"x": x})
                assert time.monotonic() - t0 < 3.9   # not the whole hang
            assert isinstance(ei.value, InternalServerError)
            got, = c.infer({"x": x})
            np.testing.assert_array_equal(got, want)
        assert server.stats()["watchdog_timeouts"] >= 1
        assert server.batcher.alive()
    finally:
        server.stop()


def test_decode_watchdog_drops_the_bank_and_serves_again(gpt_ab):
    """A decode step stalled past the watchdog fails its rows with
    WatchdogTimeout; the engine releases its pool's device arrays and
    decode graphs, and the next requests are served from a fresh bank
    with the reference tokens (the stalled step, once awake, does not
    run)."""
    cfg = gpt_ab["cfg"]
    server = _gen_server(gpt_ab["A"], loop_watchdog_s=1.0)
    server.start(serve_network=False)
    try:
        p = _prompt(cfg, 6)
        server.generate(p, max_new_tokens=2, timeout=120)   # warm
        pool = server.gen_engine.pool
        arrays_before = pool.tensors()[0]
        decoder_before = server.gen_engine.decoder
        with tres.chaos({"serving.decode_step": {"delay": 2.5,
                                                 "times": 1}}):
            req = server.submit_generate(p, max_new_tokens=6)
            with pytest.raises(tres.WatchdogTimeout):
                req.wait(timeout=60)
        assert server.gen_engine.decoder is not decoder_before
        time.sleep(1.7)                  # the abandoned step wakes up
        got = server.generate(p, max_new_tokens=6, timeout=120)
        np.testing.assert_array_equal(got, _jref(gpt_ab["jgen_a"], p, 6))
        assert pool.tensors()[0] is not arrays_before
        st = server.stats()
        assert st["watchdog_timeouts"] == 1 and st["loop_restarts"] == 0
        assert pool.reclaim_leaks([]) == 0
    finally:
        server.stop()


def test_step_stalled_after_its_bank_check_writes_only_the_released_bank(
        gpt_ab):
    """A decode step that passed its bank check and then stalls past the
    watchdog (inside the decoder's run): the trip releases the bank, the
    failed row's slot is admitted anew on a fresh bank, and only then
    does the stalled step go on. It writes the arrays it was handed, so
    the live pool stays bitwise what the admission left, and the new
    request decodes the JAX generator's tokens."""
    import torch

    from paddle_tpu_torch.serving.batching import GenerationRequest
    from paddle_tpu_torch.serving.engine import GenerationEngine
    cfg = gpt_ab["cfg"]
    eng = GenerationEngine(_tgen(gpt_ab["A"]), slots=1, paged=True)
    p_old, p_new, n = _prompt(cfg, 10), _prompt(cfg, 14), 8
    entered, go = threading.Event(), threading.Event()
    run = eng.decoder.run

    def stalled(*a, **k):
        entered.set()
        go.wait(60)
        return run(*a, **k)

    eng.decoder.run = stalled
    temp, topk, live = (np.zeros(1, np.float32), np.zeros(1, np.int32),
                        np.ones(1, bool))
    first = eng.admit([GenerationRequest(p_old, n)], [0])
    eng.prepare_step({0: p_old.size})
    with pytest.raises(tres.WatchdogTimeout):
        eng.step(first, np.array([p_old.size], np.int32), temp, topk, live,
                 budget=0.5)
    assert entered.is_set() and eng.bank_lost
    (worker, _), = eng._deposed
    eng.release_slot(0)                  # the failed row's blocks back
    tok = eng.admit([GenerationRequest(p_new, n)], [0])
    out, pos = [int(tok[0])], p_new.size
    snapshot = [t.clone() for t in eng.pool.tensors()]
    go.set()
    worker.join(60)
    assert not worker.is_alive()
    for a, b in zip(snapshot, eng.pool.tensors()):
        assert torch.equal(a, b)
    for _ in range(n - 1):
        eng.prepare_step({0: pos})
        tok = eng.step(tok, np.array([pos], np.int32), temp, topk, live,
                       budget=30.0)
        out.append(int(tok[0]))
        pos += 1
    assert not eng._deposed              # let go once its worker ended
    np.testing.assert_array_equal(out, _jref(gpt_ab["jgen_a"], p_new, n))


def test_repeated_crashes_trip_degraded_then_recover(gpt_ab):
    cfg = gpt_ab["cfg"]
    server = _gen_server(gpt_ab["A"])
    sup = server.supervisor
    sup.poll_s = 0.02
    sup.reset_secs = 0.4
    sup.breaker.failure_threshold = 2
    sup.breaker.reset_timeout = 0.4
    sup.restart_backoff = 0.01
    server.start(serve_network=False)
    try:
        p = _prompt(cfg, 4)
        server.generate(p, max_new_tokens=2, timeout=120)
        with tres.fault_injection("serving.queue", exc=RuntimeError,
                                  times=-1):
            assert _wait_until(lambda: server.state == "degraded"), \
                server.health()
            with pytest.raises(ServerOverloadedError, match="degraded"):
                server.submit_generate(p, max_new_tokens=2)
            h = server.health()
            assert h["state"] == "degraded"
            assert h["breaker"] in ("open", "half-open")
        assert _wait_until(lambda: server.state == "serving"), \
            server.health()
        server.generate(p, max_new_tokens=2, timeout=120)
        assert server.stats()["loop_restarts"] >= 2
    finally:
        server.stop()


# ---------------------------------------------------- hot weight reload

def test_reload_weights_infer_engine_matches_reference(mlp):
    """After the same reload, the port's engine and the JAX package's
    serve the same outputs (within 1e-5 of max |ref|), and both differ
    from the first weights'."""
    from paddle_tpu.serving import InferenceServer as JServer
    x = np.ones((3, 16), np.float32)
    outs = {}
    for name, srv in (("port", _server(mlp)),
                      ("jax", JServer(mlp, batch_timeout_ms=1.0))):
        srv.start(serve_network=False)
        try:
            r1, = srv.infer({"x": x}, timeout=120)
            report = srv.reload_weights(os.path.join(mlp, "ckpt_v2"))
            assert report["weights_version"] == 2
            r2, = srv.infer({"x": x}, timeout=120)
            outs[name] = (np.asarray(r1), np.asarray(r2))
            assert srv.stats()["weight_reloads"] == 1
        finally:
            srv.stop()
    for got, ref in zip(outs["port"], outs["jax"]):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert not np.array_equal(outs["port"][0], outs["port"][1])


def test_reload_weights_corrupt_checkpoint_aborts(mlp, tmp_path):
    import shutil
    ckpt = str(tmp_path / "ckpt_bad")
    shutil.copytree(os.path.join(mlp, "ckpt_v2"), ckpt)
    victim = next(f for f in sorted(os.listdir(ckpt)) if f.endswith(".npy"))
    with open(os.path.join(ckpt, victim), "r+b") as f:
        f.seek(128)
        b = f.read(1)
        f.seek(128)
        f.write(bytes([b[0] ^ 0xFF]))
    server = _server(mlp).start()
    try:
        x = np.ones((1, 16), np.float32)
        r1, = server.infer({"x": x}, timeout=60)
        with Client(server.endpoint) as c:
            with pytest.raises(tres.CheckpointCorruptError) as ei:
                c.reload_weights(ckpt)
            assert isinstance(ei.value, InternalServerError)
        with pytest.raises(tres.CheckpointCorruptError):
            server.reload_weights(ckpt)
        r2, = server.infer({"x": x}, timeout=60)
        np.testing.assert_array_equal(r1, r2)    # weights untouched
        assert server.stats()["weights_version"] == 1
        with pytest.raises(tres.CheckpointCorruptError, match="manifest"):
            server.reload_weights(str(tmp_path / "no_such_dir"))
    finally:
        server.stop()


def test_reload_weights_generation_inflight_old_new(gpt_ab):
    """A generation in flight when reload_weights lands finishes on the
    old weights (the JAX generate tokens under A); requests sent while
    the swap is pending queue; the next admission runs on the new
    weights (the JAX generate tokens under B); nothing fails."""
    cfg = gpt_ab["cfg"]
    p1, p2 = _prompt(cfg, 5), _prompt(cfg, 6)
    server = _gen_server(gpt_ab["A"])
    server.start()
    try:
        server.generate(p1, max_new_tokens=2, timeout=120)
        # slowed steps keep the long row in flight across the reload
        with tres.chaos({"serving.decode_step": {"delay": 0.02}}):
            long_req = server.submit_generate(p1, max_new_tokens=40)
            assert _wait_until(lambda: server.decode_batcher.inflight() > 0)
            with Client(server.endpoint) as c:
                box = {}
                t = threading.Thread(target=lambda: box.setdefault(
                    "r", c.reload_weights(gpt_ab["dir_b"], timeout=120)))
                t.start()
                assert _wait_until(
                    lambda: server.decode_batcher._swap is not None
                    or "r" in box)
                queued = server.submit_generate(p2, max_new_tokens=8)
                t.join(120)
        report = box["r"]
        assert report["weights_version"] == 2
        assert report["swap_pause_ms"] >= 0.0
        np.testing.assert_array_equal(long_req.wait(timeout=60)[0],
                                      _jref(gpt_ab["jgen_a"], p1, 40))
        want_b = _jref(gpt_ab["jgen_b"], p2, 8)
        np.testing.assert_array_equal(queued.wait(timeout=60)[0], want_b)
        np.testing.assert_array_equal(
            server.generate(p2, max_new_tokens=8, timeout=60), want_b)
        assert 7 in want_b                       # the steering shows
        assert server.stats()["requests_failed"] == 0
    finally:
        server.stop()


def test_reload_shape_mismatch_raises_before_any_copy(gpt_ab):
    gen = _tgen(gpt_ab["A"])
    live = gen.param_tensors()
    before = {n: t.clone() for n, t in live.items()}
    import torch
    bad = {n: t.clone() + 1.0 for n, t in live.items()}
    bad["final_ln_bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="final_ln_bias"):
        gen.swap_params(bad)
    for n, t in live.items():
        assert torch.equal(t, before[n]), n


def test_concurrent_swap_requests_fail_fast():
    from paddle_tpu_torch.serving import (DecodeBatcher, RequestQueue,
                                          SwapHandle)

    class _Engine:
        slots = 2
        max_len = 64
        pool = None

        def reset(self):
            pass

    db = DecodeBatcher(RequestQueue(max_depth=4), _Engine(), watchdog_s=0)
    applied = []
    h1 = db.request_swap(lambda: applied.append(1))   # no loop: inline
    assert h1.wait(timeout=1) is not None and applied == [1]
    db._swap = SwapHandle(lambda: None)               # one parked
    h3 = db.request_swap(lambda: applied.append(3))
    with pytest.raises(ServingError, match="already pending"):
        h3.wait(timeout=1)
    assert applied == [1]


# ------------------------------------------------------- hedged clients

def test_hedged_infer_wins_and_dedups(mlp):
    server = _server(mlp).start()
    x = _x()
    server.infer({"x": x}, timeout=60)
    c = Client(server.endpoint, hedge_ms=200.0)
    try:
        want, = c.infer({"x": x})
        assert c.hedge_stats()["hedges"] == 0
        with tres.fault_injection(
                "serving.handle", exc=lambda pt, ctx: time.sleep(2.0),
                times=1):
            t0 = time.monotonic()
            got, = c.infer({"x": x})
            dt = time.monotonic() - t0
        np.testing.assert_array_equal(got, want)
        assert dt < 1.9                   # the hedge won, not the stall
        assert c.hedge_stats() == {"hedges": 1, "hedge_wins": 1,
                                   "budget_suppressed": 0, "observed": 2}
        # the stalled primary joins its twin's request: a dedup hit
        assert _wait_until(
            lambda: server.stats()["hedge_dedup_hits"] >= 1)
        assert server.stats()["requests_completed"] == 3
    finally:
        c.close()
        server.stop()


def test_cancel_op_reclaims_inflight_request(mlp):
    server = _server(mlp, max_batch_size=1).start()
    try:
        def slow(point, ctx):
            time.sleep(0.3)

        with tres.fault_injection("serving.execute", exc=slow, times=-1):
            x = _x()
            blocker = server.submit({"x": x})
            victim = server._dedup("rid-x",
                                   lambda: server.submit({"x": x}))[0]
            with Client(server.endpoint) as c:
                assert c.cancel("rid-x") is True
                assert c.cancel("rid-x") is False     # already done
                assert c.cancel("never-seen") is False
            with pytest.raises(RequestCancelledError):
                victim.wait(timeout=10)
            blocker.wait(timeout=20)
        assert server.stats()["requests_cancelled"] == 1
    finally:
        server.stop()


def test_cancel_generation_frees_its_blocks(gpt_ab):
    """A decoding row cancelled by request id fails with
    RequestCancelledError (over the wire, Cancelled) and its blocks go
    back to the pool within a step."""
    cfg = gpt_ab["cfg"]
    server = _gen_server(gpt_ab["A"]).start()
    try:
        p = _prompt(cfg, 6)
        server.generate(p, max_new_tokens=2, timeout=120)
        pool = server.gen_engine.pool
        assert pool.blocks_in_use() == 0
        err = {}
        with tres.chaos({"serving.decode_step": {"delay": 0.02}}):
            def waiter():
                with Client(server.endpoint) as c:
                    try:
                        c.generate(p, max_new_tokens=40, rid="gen-cancel")
                    except Exception as e:  # noqa: BLE001 — checked below
                        err["e"] = e

            t = threading.Thread(target=waiter)
            t.start()
            assert _wait_until(lambda: pool.blocks_in_use() > 0)
            with Client(server.endpoint) as c:
                assert c.cancel("gen-cancel") is True
            t.join(60)
        assert isinstance(err.get("e"), RequestCancelledError)
        assert _wait_until(lambda: pool.blocks_in_use() == 0)
    finally:
        server.stop()


def test_generate_with_one_request_id_executes_once(gpt_ab):
    """Two connections send one generate with the same rid: it runs once
    (the completed count grows by one) and both get its tokens."""
    cfg = gpt_ab["cfg"]
    server = _gen_server(gpt_ab["A"]).start()
    try:
        p = _prompt(cfg, 7)
        server.generate(p, max_new_tokens=2, timeout=120)
        done0 = server.stats()["requests_completed"]
        msg = {"op": "generate", "tokens": p, "max_new_tokens": 8,
               "temperature": 0.0, "top_k": 0, "eos_id": None,
               "deadline_ms": None, "rid": "twin-1"}
        host, port = server.endpoint.rsplit(":", 1)
        socks = [socket.create_connection((host, int(port)), timeout=60)
                 for _ in range(2)]
        try:
            for s in socks:
                wire.send_frame(s, msg, None)
            replies = [wire.recv_frame(s, None, timeout=60) for s in socks]
        finally:
            for s in socks:
                s.close()
        want = _jref(gpt_ab["jgen_a"], p, 8)
        for r in replies:
            assert r["ok"]
            np.testing.assert_array_equal(r["tokens"], want)
        st = server.stats()
        assert st["requests_completed"] == done0 + 1
        assert st["hedge_dedup_hits"] == 1
    finally:
        server.stop()


def test_bad_request_reply_maps_to_typed_client_error(mlp):
    server = _server(mlp).start()
    try:
        with Client(server.endpoint) as c:
            with pytest.raises(BadRequestError, match="missing"):
                c.infer({"wrong": np.zeros((1, 16), np.float32)})
            assert not isinstance(BadRequestError("x"), InternalServerError)
            with pytest.raises(BadRequestError, match="path"):
                c._call({"op": "reload_weights"})
    finally:
        server.stop()
