"""Overload control of the port's serving layer on the CPU, mirroring the
cases of tests/test_overload.py that need no fleet: priority admission
(the lowest class shed first, expired entries failed typed, a shrunken
per-call cap refusing instead of evicting), the load-shed breaker, the
prefill-export hop left out of the class completions, deadline
propagation (a spent budget refused before the wire), hedge volume bound
by the retry budget, and the brownout ladder. The ladder and its
symmetric recovery are held step for step against the JAX package's
BrownoutController over one scripted breach sequence; the queue's
admission decisions against the JAX queue's over one scripted arrival
sequence."""
import time

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import (BrownoutController, Client,
                                      DeadlineExceededError,
                                      GenerationRequest, InferenceServer,
                                      Request, RequestQueue,
                                      ServerOverloadedError, ServingError)
from tests.torch_tiny_gpt import BUCKET_MIN, MAX_LEN, prompts

TYPED_ERRORS = (ServingError, tres.RpcDeadlineError, ConnectionError,
                TimeoutError)


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
def tiny():
    from paddle_tpu_torch.models import GPTConfig, init_params
    cfg = GPTConfig.tiny()
    return cfg, init_params(cfg, 0)


def _mksrv(tiny, **kw):
    from paddle_tpu_torch.models import GPTGenerator
    cfg, params = tiny
    kw.setdefault("decode_slots", 2)
    gen = GPTGenerator(cfg, params, max_len=MAX_LEN, bucket_min=BUCKET_MIN,
                       device="cpu")
    return InferenceServer(generator=gen, paged=True, **kw).start()


def _prompt(cfg, n=4):
    return prompts(cfg.vocab_size, [n])[0]


# ----------------------------------------------------- priority admission

def _admission_script(mod):
    """One arrival sequence through a depth-3 queue: who is shed, who is
    served, in what order (names, so both packages compare)."""
    q = mod.RequestQueue(max_depth=3)
    reqs = {"be": mod.GenerationRequest([1], priority="best_effort"),
            "ba": mod.GenerationRequest([1], priority="batch"),
            "ia": mod.GenerationRequest([1]),
            "ia2": mod.GenerationRequest([1], priority="interactive"),
            "ba2": mod.GenerationRequest([1], priority="batch")}
    refused = []
    for name in ("be", "ba", "ia", "ia2", "ba2"):
        try:
            q.put(reqs[name])
        except mod.ServerOverloadedError:
            refused.append(name)
    shed = sorted(n for n, r in reqs.items()
                  if r.done() and isinstance(r.error,
                                             mod.ServerOverloadedError))
    order = []
    while True:
        r = q.get(timeout=0)
        if r is None:
            break
        order.append(next(n for n, x in reqs.items() if x is r))
    return refused, shed, order, q.priority_evictions


def test_queue_serves_higher_class_first_and_sheds_lowest():
    got = _admission_script(tserving)
    want = _admission_script(jserving)
    assert got == want
    # ba2 (batch) finds no lower-class victim and is refused at the door;
    # be (best_effort) was evicted for ia2
    assert got == (["ba2"], ["be"], ["ia", "ia2", "ba"], 1)
    with pytest.raises(ValueError):
        GenerationRequest([1], priority="urgent")


def test_shrunken_admission_cap_refuses_instead_of_evicting():
    q = RequestQueue(max_depth=8)
    be = GenerationRequest([1], priority="best_effort")
    q.put(be)
    for _ in range(10):
        with pytest.raises(ServerOverloadedError):
            q.put(GenerationRequest([1], priority="batch"), max_depth=1)
    assert not be.done()
    assert q.priority_evictions == 0
    assert q.breaker.state == "closed"      # a cap refusal is no failure


def test_load_shed_breaker_opens_on_a_full_queue_and_recovers():
    q = RequestQueue(max_depth=1, breaker=tres.CircuitBreaker(
        "shed-unit", failure_threshold=3, reset_timeout=0.2))
    q.put(Request({"x": np.zeros((1, 2), np.float32)}))
    msgs = []
    for _ in range(5):
        with pytest.raises(ServerOverloadedError) as ei:
            q.put(Request({"x": np.zeros((1, 2), np.float32)}))
        msgs.append("load shedding" in str(ei.value))
    assert msgs == [False, False, False, True, True]
    assert q.breaker.state == "open"
    assert q.get(timeout=0) is not None     # the queue drains
    time.sleep(0.25)
    q.put(Request({"x": np.zeros((1, 2), np.float32)}))   # the probe
    assert q.breaker.state == "closed"


def test_prefill_export_hop_not_counted_as_class_completion(tiny):
    from paddle_tpu_torch.serving.metrics import _CLASS_DONE
    cfg, _ = tiny
    srv = _mksrv(tiny)
    try:
        with Client(srv.endpoint) as c:
            before = _CLASS_DONE.value(labels=("interactive",))
            kv = c.prefill(_prompt(cfg), max_new_tokens=4)
            assert "first_token" in kv
            assert _CLASS_DONE.value(labels=("interactive",)) == before
            c.generate(_prompt(cfg), max_new_tokens=2)
            assert _CLASS_DONE.value(labels=("interactive",)) == before + 1
    finally:
        srv.stop()


def test_queue_evicts_expired_entries_typed():
    q = RequestQueue(max_depth=8)
    doomed = GenerationRequest([1], deadline_ms=15.0)
    live = GenerationRequest([1])
    q.put(doomed)
    q.put(live)
    time.sleep(0.05)
    assert q.get(timeout=0) is live
    assert doomed.done() and isinstance(doomed.error, DeadlineExceededError)
    assert q.expired_in_queue == 1
    q3 = RequestQueue(max_depth=1)
    q3.put(GenerationRequest([1], deadline_ms=5.0))
    time.sleep(0.03)
    fresh = GenerationRequest([1])
    q3.put(fresh)                       # the sweep frees the slot
    assert q3.expired_in_queue == 1 and q3.priority_evictions == 0
    assert q3.get(timeout=0) is fresh


# -------------------------------------------------- deadline propagation

def test_client_rejects_spent_budget_before_the_wire(tiny):
    cfg, _ = tiny
    srv = _mksrv(tiny)
    try:
        with Client(srv.endpoint) as c:
            with pytest.raises(DeadlineExceededError):
                c.generate(_prompt(cfg), max_new_tokens=2, deadline_ms=-1.0)
        before = srv.stats_sink.counter("shed_deadline")
        with pytest.raises(DeadlineExceededError):
            srv.submit_generate(_prompt(cfg), max_new_tokens=2,
                                deadline_ms=-5.0)
        assert srv.stats_sink.counter("shed_deadline") == before + 1
        assert srv.stats_sink.counter("generate_requests") == 0
    finally:
        srv.stop()


def test_remaining_budget_arithmetic_matches_the_reference():
    from paddle_tpu_torch.serving import remaining_budget_ms
    t0 = 100.0
    for now in (100.0, 100.25, 101.0, 103.5):
        assert remaining_budget_ms(500.0, t0, now) == \
            jserving.batching.remaining_budget_ms(500.0, t0, now)
    assert Client._remaining_ms(None, t0) is None


def test_default_deadline_applies_to_infer_requests(tmp_path):
    """``serving_default_deadline_ms`` is an infer request's deadline when
    it sets none (generation deadlines stay opt-in)."""
    import paddle_tpu_torch as T
    from tests import torch_served_models as M
    import torch
    main, _, feeds, targets = M.build(T, "mlp")
    scope = T.Scope()
    for n, a in M.weights(main, np.random.default_rng(0)).items():
        scope.set(n, torch.from_numpy(a))
    d = str(tmp_path / "m")
    T.save_inference_model(d, feeds, targets, T.Executor(T.CPUPlace()),
                           main_program=main, scope=scope)
    srv = InferenceServer(d, place=T.CPUPlace(), default_deadline_ms=250.0)
    try:
        req = srv.submit({"x": np.zeros((1, 16), np.float32)})
        assert req.deadline_ms == 250.0
        req2 = srv.submit({"x": np.zeros((1, 16), np.float32)},
                          deadline_ms=9.0)
        assert req2.deadline_ms == 9.0
    finally:
        srv.stop()


# ---------------------------------------------------------- hedge volume

def test_hedge_volume_respects_budget_under_saturation(tiny):
    """Under sustained stalls a hedging client fires twins only while the
    budget grants them; once it is dry the hedges are suppressed and
    counted."""
    cfg, _ = tiny
    srv = _mksrv(tiny)
    try:
        with Client(srv.endpoint) as warm:
            warm.generate(_prompt(cfg), max_new_tokens=2)
        tres._default_budget = tres.RetryBudget(ratio=0.0, min_reserve=3.0,
                                                window_s=0)
        hedger = Client(srv.endpoint, hedge_ms=25.0)
        try:
            with tres.fault_injection("serving.handle",
                                      exc=lambda pt, ctx: time.sleep(0.2),
                                      times=-1):
                for _ in range(6):
                    try:
                        hedger._call_hedged({"op": "ping"}, 0.025)
                    except TYPED_ERRORS:
                        pass
            hs = hedger.hedge_stats()
            assert hs["hedges"] <= 3, hs
            assert hs["budget_suppressed"] >= 2, hs
            assert hs["hedges"] + hs["budget_suppressed"] >= 5, hs
        finally:
            hedger.close()
    finally:
        srv.stop()


# ------------------------------------------------------------- brownout

# (now offset s, breached rules) — one breach run escalating, a jump to
# two rules, then recovery one rung at a time with a relapse between
_SCRIPT = ((0.00, 0), (0.01, 1), (0.05, 1), (0.10, 1), (0.20, 0),
           (0.24, 0), (0.26, 0), (0.30, 1), (0.31, 0), (0.40, 0),
           (0.46, 0), (0.52, 0), (0.60, 2), (0.61, 0), (0.70, 0),
           (0.76, 0), (0.82, 0))


def _ladder(mod):
    bo = mod.BrownoutController(lambda: 0, scope="ladder-unit",
                                enabled=True, escalate_s=0.08,
                                recover_s=0.05, batch_token_cap=4)
    t0 = 1000.0
    out = []
    for dt, n in _SCRIPT:
        bo._breached_fn = lambda n=n: n
        row = [bo.level(now=t0 + dt)]
        # admission and draft depth read the level: pin its clock
        for rank in (0, 1, 2):
            real = bo.level
            bo.level = lambda now=None, t=t0 + dt, r=real: r(now=t)
            try:
                row.append(bo.admission(rank, max_new_tokens=32,
                                        queue_depth=16))
                row.append(bo.draft_depth(rank, 4))
            finally:
                bo.level = real
        out.append(row)
    return out, bo.snapshot()


def test_brownout_ladder_and_symmetric_recovery():
    """Step for step the JAX controller's levels, admission verdicts
    (shed, capped budget, depth cap) and draft depths."""
    got, snap = _ladder(tserving.brownout)
    want, jsnap = _ladder(jserving.brownout)
    assert got == want
    assert [r[0] for r in got] == [0, 1, 1, 2, 2, 2, 1, 1, 1, 0, 0, 0, 2,
                                   2, 1, 0, 0]
    assert snap == jsnap
    level1 = got[1]
    assert level1[1] == (False, 32, None) and level1[2] == 4   # interactive
    assert level1[3] == (False, 4, 8) and level1[4] == 2       # batch capped
    assert level1[5][0] and level1[6] == 0                     # best_effort
    assert BrownoutController(lambda: 5, scope="off",
                              enabled=False).level() == 0


def test_server_brownout_degrades_lowest_class_first(tiny):
    cfg, _ = tiny
    srv = _mksrv(tiny)
    p = _prompt(cfg)
    try:
        class _FakeMon:
            def breached(self):
                return ["intertoken_p99_ms"]

            def stop(self):
                pass

        if srv.slo_monitor is not None:
            srv.slo_monitor.stop()
        srv.slo_monitor = _FakeMon()
        srv.brownout.recover_s = 0.05
        assert srv.brownout.level() == 1
        assert srv.health()["brownout_level"] == 1
        with pytest.raises(ServerOverloadedError) as ei:
            srv.submit_generate(p, max_new_tokens=4, priority="best_effort")
        assert "brownout" in str(ei.value)
        out = srv.generate(p, max_new_tokens=32, priority="batch",
                           timeout=60)
        assert out.size <= srv.brownout.batch_token_cap
        out = srv.generate(p, max_new_tokens=6, timeout=60)
        assert out.size <= 6
        assert srv.stats()["brownout_shed"] >= 1
        srv.slo_monitor = None
        assert _wait_until(lambda: srv.brownout.level() == 0, timeout=5.0)
        out = srv.generate(p, max_new_tokens=3, priority="best_effort",
                           timeout=60)
        assert out.size <= 3
    finally:
        srv.stop()
