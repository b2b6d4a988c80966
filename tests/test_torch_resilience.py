"""The port's resilience primitives (paddle_tpu_torch.resilience) against
the JAX package's: the retry budget's token bucket, retry_call (recovery,
deadline, budget), the circuit breaker's state machine, watchdog and
run_with_watchdog, and the chaos harness (seeded replay call for call
against the JAX package's, every/after/times, delay, independent
streams, nesting); then the supervised-loop primitives built on them
(the MicroBatcher's watchdog, LoopSupervisor's degraded state). Pure
host code: the decisions are compared exactly."""
import time

import numpy as np
import pytest

from paddle_tpu import resilience as jres
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.observability.metrics import default_registry
from paddle_tpu_torch.observability.recorder import flight_recorder


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh process retry budgets and no armed fault points, in both
    packages, around every test."""
    for mod in (tres, jres):
        mod.reset_retry_budget()
        mod.clear_faults()
    yield
    for mod in (tres, jres):
        mod.reset_retry_budget()
        mod.clear_faults()


# ------------------------------------------------------------ retry budget

def _bucket_trace(mod):
    """One scripted sequence of deposits and withdrawals: the decisions."""
    b = mod.RetryBudget(ratio=0.5, min_reserve=2, window_s=1000,
                        what_reserve=0)
    out = [b.try_acquire(), b.try_acquire(), b.try_acquire()]
    for _ in range(4):
        b.record_request()
    out += [b.try_acquire(), b.try_acquire(), b.try_acquire()]
    snap = b.snapshot()
    return out, (snap["granted"], snap["denied"], snap["deposits"])


def test_retry_budget_token_bucket_matches_the_reference():
    """Exact: the same grants and denials as the JAX package's bucket."""
    got, want = _bucket_trace(tres), _bucket_trace(jres)
    assert got == want
    assert got[0] == [True, True, False, True, True, False]
    assert got[1] == (4, 2, 4)


def test_retry_budget_reserves_and_off_switch():
    b = tres.RetryBudget(ratio=0.5, min_reserve=0, window_s=1000,
                         what_reserve=0)
    with pytest.raises(tres.RetryBudgetExhausted):
        b.acquire(what="unit")
    # the time-based reserve keeps isolated failures retryable
    b2 = tres.RetryBudget(ratio=0.1, min_reserve=10, window_s=0.1)
    for _ in range(12):
        b2.try_acquire()
    time.sleep(0.15)
    assert b2.try_acquire()
    # ratio < 0: every acquire granted
    b3 = tres.RetryBudget(ratio=-1.0, min_reserve=0)
    assert all(b3.try_acquire() for _ in range(100))
    # each consumer holds its own emergency reserve
    b4 = tres.RetryBudget(ratio=0.0, min_reserve=0.0, window_s=10,
                          what_reserve=1.0)
    assert b4.try_acquire(what="serving-storm")
    assert not b4.try_acquire(what="serving-storm")
    assert b4.try_acquire(what="ps-recovery")
    assert not b4.try_acquire(what="ps-recovery")


def test_default_retry_budget_reads_the_flag():
    from paddle_tpu_torch import flags
    assert tres.default_retry_budget().ratio == 0.1
    assert tres.default_retry_budget() is tres.default_retry_budget()
    flags.set_flags({"retry_budget_ratio": 0.7})
    try:
        tres.reset_retry_budget()
        assert tres.default_retry_budget().ratio == 0.7
    finally:
        flags.set_flags({"retry_budget_ratio": 0.1})
        tres.reset_retry_budget()


# -------------------------------------------------------------- retry_call

def test_retry_call_recovers_from_transient_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("transient")
        return "ok"

    assert tres.retry_call(flaky, deadline=5.0, base_backoff=0.01) == "ok"
    assert calls["n"] == 3


def test_retry_call_deadline_raises_typed_error():
    def dead():
        raise ConnectionError("nope")

    t0 = time.monotonic()
    with pytest.raises(tres.RpcDeadlineError) as ei:
        tres.retry_call(dead, deadline=0.3, base_backoff=0.05,
                        endpoint="1.2.3.4:5")
    assert time.monotonic() - t0 < 10.0       # bounded by the deadline
    assert ei.value.endpoint == "1.2.3.4:5" and "1.2.3.4:5" in str(ei.value)
    assert isinstance(ei.value.__cause__, ConnectionError)


def test_retry_call_consults_budget():
    """A dry budget raises RetryBudgetExhausted (chained) instead of a
    second attempt, and an enclosing retry_call does not retry it."""
    calls = [0]

    def boom():
        calls[0] += 1
        raise ConnectionError("down")

    dry = tres.RetryBudget(ratio=0.0, min_reserve=0.0, window_s=0)
    with pytest.raises(tres.RetryBudgetExhausted) as ei:
        tres.retry_call(boom, deadline=5.0, base_backoff=0.001, budget=dry)
    assert calls[0] == 1
    assert isinstance(ei.value.__cause__, ConnectionError)
    outer_calls = [0]

    def outer():
        outer_calls[0] += 1
        tres.retry_call(boom, deadline=5.0, base_backoff=0.001, budget=dry)

    with pytest.raises(tres.RetryBudgetExhausted):
        tres.retry_call(outer, deadline=5.0, base_backoff=0.001)
    assert outer_calls[0] == 1
    ok = tres.RetryBudget(ratio=1.0, min_reserve=10)
    calls[0] = 0
    with pytest.raises(tres.RpcDeadlineError):
        tres.retry_call(boom, deadline=5.0, base_backoff=0.001, retries=3,
                        budget=ok)
    assert calls[0] == 4                  # 1 + retries attempts


def test_retry_call_never_retries_an_open_breaker():
    calls = [0]

    def refused():
        calls[0] += 1
        raise tres.CircuitOpenError("open", endpoint="x")

    with pytest.raises(tres.CircuitOpenError):
        tres.retry_call(refused, deadline=5.0, base_backoff=0.001)
    assert calls[0] == 1


# ---------------------------------------------------------- circuit breaker

def _breaker_trace(mod):
    br = mod.CircuitBreaker("ep", failure_threshold=2, reset_timeout=0.2)
    states = [br.state]
    br.before_call(); br.record_failure()
    br.before_call(); br.record_failure()
    states.append(br.state)
    try:
        br.before_call()
        states.append("admitted")
    except mod.CircuitOpenError:
        states.append("refused")
    time.sleep(0.25)
    states.append(br.state)
    br.before_call()                       # the half-open probe
    try:
        br.before_call()
        states.append("second probe admitted")
    except mod.CircuitOpenError:
        states.append("second probe refused")
    br.record_success()
    states.append(br.state)
    return states


def test_circuit_breaker_state_machine_matches_the_reference():
    got = _breaker_trace(tres)
    assert got == _breaker_trace(jres)
    assert got == ["closed", "open", "refused", "half-open",
                   "second probe refused", "closed"]


def test_breaker_state_gauge_reports_the_worst_state():
    br = tres.CircuitBreaker("gauge-test-ep", failure_threshold=1,
                             reset_timeout=60.0)
    fam = [f for f in tres._collect_breakers()
           if f["name"] == "resilience_breaker_state"][0]
    assert dict(fam["samples"])[("gauge-test-ep",)] == 0
    br.record_failure()
    fam = tres._collect_breakers()[0]
    assert dict(fam["samples"])[("gauge-test-ep",)] == 2
    assert "resilience_breaker_state" in default_registry().catalog()


# ----------------------------------------------------------------- watchdog

def test_run_with_watchdog_times_out_and_passes_results():
    with pytest.raises(tres.WatchdogTimeout):
        tres.run_with_watchdog(time.sleep, 0.2, 5.0)
    assert tres.run_with_watchdog(lambda a, b: a + b, 5.0, 2, 3) == 5
    with pytest.raises(ValueError, match="boom"):
        tres.run_with_watchdog(
            lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0)


def test_watchdog_worker_keeps_one_thread_until_a_trip():
    """WatchdogWorker runs every call on one long-lived thread, relays
    results and errors, and after a trip hands back the abandoned thread
    (which ends once its call returns) and starts a fresh one."""
    import threading
    w = tres.WatchdogWorker("test-worker")
    ids = [w.call(threading.get_ident, 5.0) for _ in range(3)]
    assert len(set(ids)) == 1 and ids[0] != threading.get_ident()
    assert w.call(lambda a, b: a + b, 5.0, 2, 3) == 5
    with pytest.raises(ValueError, match="boom"):
        w.call(lambda: (_ for _ in ()).throw(ValueError("boom")), 5.0)
    assert w.call(threading.get_ident, 5.0) == ids[0]
    release = threading.Event()
    with pytest.raises(tres.WatchdogTimeout, match="stuck") as ei:
        w.call(release.wait, 0.2, 30.0, what="stuck")
    old = ei.value.thread
    assert old.ident == ids[0] and old.is_alive()
    fresh = w.call(threading.get_ident, 5.0)
    assert fresh != ids[0]
    release.set()
    old.join(10.0)
    assert not old.is_alive()            # it exits after its call
    w.close()
    assert _ended(fresh)                 # close() lets the worker exit


def _ended(ident, timeout=10.0):
    import threading
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(t.ident == ident for t in threading.enumerate()):
            return True
        time.sleep(0.01)
    return False


def test_watchdog_context_aborts_overbudget_block():
    t0 = time.monotonic()
    with pytest.raises(tres.WatchdogTimeout, match="budget"):
        with tres.watchdog(0.3, what="stuck step"):
            time.sleep(10)
    assert time.monotonic() - t0 < 8.0        # well short of the block
    with tres.watchdog(5.0):                  # under budget: no effect
        time.sleep(0.01)


def test_watchdog_refuses_other_threads():
    import threading
    err = []

    def body():
        try:
            with tres.watchdog(1.0):
                pass
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert err and "main thread" in str(err[0])


# ------------------------------------------------------------------- chaos

def _fires(mod, points, n=200, seed=5, point="pt"):
    out = []
    with mod.chaos(points, seed=seed):
        for _ in range(n):
            try:
                mod.maybe_fail(point)
                out.append(0)
            except mod.FaultInjected:
                out.append(1)
    return out


@pytest.mark.parametrize("seed,p", [(0, 0.3), (5, 0.4), (1234, 0.05)])
def test_chaos_seeded_fire_sequence_matches_the_reference(seed, p):
    """Exact: over 200 hits the port's point fires on the very calls the
    JAX package's fires on (each point's RNG is seeded from (seed,
    point) and drawn once a hit)."""
    got = _fires(tres, {"pt": {"p": p}}, seed=seed)
    assert got == _fires(jres, {"pt": {"p": p}}, seed=seed)
    assert 0 < sum(got) < 200


def test_chaos_seeded_replay_and_seed_sensitivity():
    a = _fires(tres, {"pt": {"p": 0.4}}, n=30, seed=5)
    assert a == _fires(tres, {"pt": {"p": 0.4}}, n=30, seed=5)
    assert a != _fires(tres, {"pt": {"p": 0.4}}, n=30, seed=6)


def test_chaos_schedulable_every_after_times():
    fires = []
    with tres.chaos("pt", every=3, after=2, times=2) as monkey:
        for i in range(14):
            try:
                tres.maybe_fail("pt")
            except tres.FaultInjected:
                fires.append(i)
    assert fires == [4, 7]
    assert monkey.hits["pt"] == 14 and monkey.fired["pt"] == 2
    assert monkey.total_fired() == 2


def test_chaos_delay_injects_stall_not_error():
    with tres.chaos("pt", delay=0.15, times=1):
        t0 = time.monotonic()
        tres.maybe_fail("pt")           # stalls, does not raise
        dt = time.monotonic() - t0
        tres.maybe_fail("pt")           # spent: no stall
    assert dt >= 0.14


def test_chaos_multi_point_streams_independent():
    def fires_of_a(points):
        return _fires(tres, {pt: {"p": 0.5} for pt in points}, n=40,
                      seed=9, point="a")
    assert fires_of_a(["a"]) == fires_of_a(["a", "b", "c"])


def test_chaos_restores_previously_armed_points():
    with tres.fault_injection("pt", exc=ValueError, times=-1):
        with tres.chaos("pt", exc=tres.FaultInjected, times=1):
            with pytest.raises(tres.FaultInjected):
                tres.maybe_fail("pt")
        with pytest.raises(ValueError):      # the outer arming is back
            tres.maybe_fail("pt")
    tres.maybe_fail("pt")                    # nothing armed any more


def test_chaos_fire_is_recorded_once():
    """A chaos fire is one ``chaos`` flight event (with its seed) and one
    count of ``chaos_faults_fired_total{point}``."""
    rec = flight_recorder()
    seq0 = max([e["seq"] for e in rec.snapshot()] or [0])
    before = tres._CHAOS_FIRED.value(labels=("rec-pt",))
    with tres.chaos("rec-pt", times=1, seed=77):
        with pytest.raises(tres.FaultInjected):
            tres.maybe_fail("rec-pt")
    evs = [e for e in rec.snapshot() if e["seq"] > seq0
           and e["kind"] == "chaos" and e.get("point") == "rec-pt"]
    assert len(evs) == 1 and evs[0]["seed"] == 77
    assert tres._CHAOS_FIRED.value(labels=("rec-pt",)) == before + 1


# --------------------------------------------- supervised-loop primitives

def test_watchdog_bounds_serving_execute():
    """A hung execute fails its batch with WatchdogTimeout; the loop
    survives, and its failure streak resets on the next success."""
    from paddle_tpu_torch.serving import MicroBatcher, Request, RequestQueue

    calls = []

    def engine(reqs):
        calls.append(len(reqs))
        if len(calls) == 1:
            time.sleep(2.0)
        for r in reqs:
            r.set_result([np.zeros(1)])

    q = RequestQueue(max_depth=16)
    mb = MicroBatcher(q, engine, max_batch_size=4, batch_timeout_ms=1.0,
                      watchdog_s=0.2)
    mb.start()
    try:
        hung = q.put(Request({"x": np.zeros((1, 2), np.float32)}))
        with pytest.raises(tres.WatchdogTimeout):
            hung.wait(timeout=10)
        ok = q.put(Request({"x": np.zeros((1, 2), np.float32)}))
        ok.wait(timeout=10)
        assert mb.alive()
        deadline = time.monotonic() + 5.0
        while mb.consecutive_failures and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mb.consecutive_failures == 0
    finally:
        mb.stop()


class _FakeLoop:
    def __init__(self):
        self.heartbeat = time.monotonic()
        self.consecutive_failures = 0
        self.restarts = 0
        self._alive = True

    def alive(self):
        return self._alive

    def restart(self, reason=""):
        self.restarts += 1
        self._alive = True
        self.heartbeat = time.monotonic()


def _supervise(mod, loop, events):
    sup = mod.LoopSupervisor(watchdog_s=5.0, poll_s=0.01,
                             restart_threshold=2, reset_secs=0.2,
                             restart_backoff=0.0,
                             on_degraded=lambda: events.append("degraded"),
                             on_recovered=lambda: events.append("recovered"))
    sup.add("loop", loop)
    return sup


def test_loop_supervisor_degrades_and_recovers_as_the_reference():
    """Two deaths open the breaker (degraded); sustained health closes it
    (recovered): the same callbacks and restarts as the JAX
    supervisor's on the same scripted ticks."""
    from paddle_tpu.serving import supervise as jsup
    from paddle_tpu_torch.serving import supervise as tsup

    def script(mod):
        events, loop = [], _FakeLoop()
        sup = _supervise(mod, loop, events)
        now = time.monotonic()
        loop._alive = False
        sup._tick(now)
        loop._alive = False
        sup._tick(now + 0.1)
        mid = (list(events), sup.degraded, loop.restarts)
        loop.heartbeat = now + 1.0
        sup._tick(now + 1.0)
        return mid, list(events), sup.degraded, sup.restarts(), \
            sup.breaker.state

    got = script(tsup)
    assert got == script(jsup)
    assert got == ((["degraded"], True, 2), ["degraded", "recovered"],
                   False, 2, "closed")


def test_loop_supervisor_hang_and_failure_streaks():
    from paddle_tpu_torch.serving import LoopSupervisor
    events = []
    loop = _FakeLoop()
    sup = LoopSupervisor(watchdog_s=1.0, poll_s=0.01, restart_threshold=2,
                         reset_secs=60.0,
                         on_degraded=lambda: events.append("degraded"))
    sup.add("loop", loop)
    assert sup.hung_after_s == 2.0
    now = time.monotonic()
    sup._tick(now + 2.5)                   # stale heartbeat: a hang
    assert loop.restarts == 1
    for i in range(2):                     # alive but failing every batch
        loop.heartbeat = now + 10 + i
        loop.consecutive_failures = 2
        sup._tick(now + 10 + i)
        assert loop.consecutive_failures == 0
    assert events == ["degraded"] and loop.restarts == 1
    snap = sup.snapshot()["loop"]
    assert snap["alive"] and snap["restarts"] == 1
