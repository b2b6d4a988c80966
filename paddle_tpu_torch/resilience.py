"""Typed failures of the port, retries, breakers, watchdogs and fault
injection.

A copy of ``paddle_tpu/resilience.py``:

- typed errors: ``HierarchicalCommsError`` (the multi-slice grad-sync
  gate) and ``SliceWidthError`` (a restore at another ``dcn_dp``
  width), ``CheckpointCorruptError`` and
  ``CheckpointIncompleteError`` (``io``), ``RpcDeadlineError``,
  ``CircuitOpenError``, ``RetryBudgetExhausted``, ``NonFiniteError``
  (the executor's non-finite guard), ``WatchdogTimeout``, the training
  loop's ``PreemptedError`` and ``RestartBudgetExceeded``;
- ``RetryBudget`` (one process-wide token bucket bounding every retry,
  hedge and reconnect: ``default_retry_budget``,
  ``reset_retry_budget``) and ``retry_call`` (exponential backoff with
  jitter under a wall-clock deadline);
- ``CircuitBreaker`` (closed, open, half-open; its state by endpoint is
  the ``resilience_breaker_state`` gauge of the metrics registry);
- ``watchdog`` (main thread), ``run_with_watchdog`` (any thread) and
  ``WatchdogWorker`` (one long-lived thread for a loop that watches
  every step): work past its wall-clock budget raises
  ``WatchdogTimeout``;
- fault points: production code declares ``maybe_fail(point)``; a test
  arms one point with ``fault_injection`` or many at once with
  ``chaos`` (seeded, probabilistic or scheduled by ``every``/``after``/
  ``times``, raising or stalling with ``delay``; each point draws from
  its own seeded stream). A fault that fires is a ``chaos``
  flight-recorder event and a ``chaos_faults_fired_total{point}`` count.
"""
import queue
import random
import threading
import time
import weakref
from contextlib import contextmanager

from .framework.core import EnforceNotMet
from .observability.metrics import default_registry as _registry
from .observability.recorder import flight_recorder as _flightrec

_CHAOS_FIRED = _registry().counter(
    "chaos_faults_fired_total",
    "chaos-harness faults actually injected, by armed point",
    labels=("point",), max_series=64)
_BUDGET_EXHAUSTED = _registry().counter(
    "serving_retry_budget_exhausted_total",
    "retries/hedges/failovers refused by the process retry budget, by "
    "consumer",
    labels=("what",), max_series=16)

# every live CircuitBreaker, for the breaker-state gauge
_BREAKERS = weakref.WeakSet()
_BREAKER_STATES = {"closed": 0, "half-open": 1, "open": 2}
_BREAKER_SERIES_CAP = 64
# endpoints ever folded past the cap (the dropped count grows with the
# real cardinality, not with the scrape rate)
_folded_endpoints = set()
_fold_lock = threading.Lock()


def _collect_breakers():
    """The ``resilience_breaker_state`` family: the worst state of the
    breakers of each endpoint; past 64 endpoints the rest fold into one
    ``_other`` series (its max state, so an open breaker still shows)."""
    by_endpoint = {}
    for b in list(_BREAKERS):
        ep = b.endpoint or "unknown"
        st = _BREAKER_STATES.get(b.state, 0)
        by_endpoint[ep] = max(by_endpoint.get(ep, 0), st)
    items = sorted(by_endpoint.items())
    if len(items) > _BREAKER_SERIES_CAP:
        kept = items[:_BREAKER_SERIES_CAP - 1]
        overflow = items[_BREAKER_SERIES_CAP - 1:]
        kept.append(("_other", max(st for _ep, st in overflow)))
        items = kept
        with _fold_lock:
            _folded_endpoints.update(ep for ep, _st in overflow)
    with _fold_lock:
        dropped = len(_folded_endpoints)
    return [{"name": "resilience_breaker_state", "kind": "gauge",
             "help": "circuit breaker state by endpoint "
                     "(0=closed, 1=half-open, 2=open; max across "
                     "same-endpoint breakers)",
             "labels": ("endpoint",),
             "samples": [((ep,), st) for ep, st in items],
             "dropped": dropped}]


_registry().register_collector(
    _collect_breakers,
    families=[{"name": "resilience_breaker_state", "kind": "gauge",
               "help": "circuit breaker state by endpoint "
                       "(0=closed, 1=half-open, 2=open)",
               "labels": ("endpoint",)}])


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its manifest integrity check (sha256
    mismatch, truncation, or unreadable payload). Carries ``path``, the
    offending file."""

    def __init__(self, message, path=None):
        super().__init__(message)
        self.path = path


class CheckpointIncompleteError(CheckpointCorruptError):
    """A checkpoint loaded for training resume lacks part of the full
    training state. Carries ``missing`` (the absent variable or extra
    names)."""

    def __init__(self, message, path=None, missing=None):
        super().__init__(message, path=path)
        self.missing = list(missing or [])


class RpcDeadlineError(ConnectionError):
    """A call did not succeed within its wall-clock deadline. A
    ConnectionError, so transport-failure handlers catch it. Carries
    ``endpoint`` and ``elapsed`` (seconds spent retrying)."""

    def __init__(self, message, endpoint=None, elapsed=None):
        super().__init__(message)
        self.endpoint = endpoint
        self.elapsed = elapsed


class CircuitOpenError(RpcDeadlineError):
    """Fail-fast refusal: the endpoint's circuit breaker is open after
    repeated failures, so the call never reaches the wire."""


class RetryBudgetExhausted(RpcDeadlineError):
    """The process retry budget refused this retry, hedge or reconnect:
    the process already retries at its bound, and one more would add to
    the overload. Treat it as a fast shed, never as one more thing to
    retry (``retry_call`` lets it through unretried)."""


class WatchdogTimeout(RuntimeError):
    """Work under a watchdog exceeded its wall-clock budget."""


class NonFiniteError(EnforceNotMet):
    """``check_nan_inf`` tripped: a fetched output or an updated variable
    holds nan/inf. Carries ``var_name`` (the first offender) and
    ``count`` (its non-finite element count, or the step's count across
    outputs and state under ``run_steps``)."""

    def __init__(self, message, var_name=None, count=None):
        super().__init__(message)
        self.var_name = var_name
        self.count = count


class PreemptedError(RuntimeError):
    """The training loop was preempted and exited at a slab boundary
    after its fast checkpoint. Carries ``slab``/``step`` (progress at
    exit), ``checkpoint_no`` (the newest durable checkpoint) and
    ``reason``."""

    def __init__(self, message, slab=None, step=None, checkpoint_no=None,
                 reason=None):
        super().__init__(message)
        self.slab = slab
        self.step = step
        self.checkpoint_no = checkpoint_no
        self.reason = reason


class RestartBudgetExceeded(RuntimeError):
    """A supervised training loop crashed more times than its restart
    budget allows. Carries ``restarts`` and ``errors`` (the error names
    of every restart cause, oldest first)."""

    def __init__(self, message, restarts=None, errors=None):
        super().__init__(message)
        self.restarts = restarts
        self.errors = list(errors or [])


class FaultInjected(RuntimeError):
    """What an armed fault point raises by default: distinct from real
    failures, so a test can tell injected damage from a bug in the
    recovery."""


class HierarchicalCommsError(RuntimeError):
    """A multi-slice program FAILED the pre-run gate
    (``parallel.dcn.check_hier_sync``, ``FLAGS_dcn_assert_hier``): a
    grad the optimizer reads is not synced by a ``hier_allreduce`` or is
    synced twice, a collective across slices carries more than its 1/dp
    shard, or the bytes across slices do not beat the flat all-reduce's.
    Raised before the first slab runs. Carries ``violations``
    (human-readable strings) and ``ledger`` (the per-group byte table).
    """

    def __init__(self, message, violations=None, ledger=None):
        super().__init__(message)
        self.violations = list(violations or [])
        self.ledger = ledger


class SliceWidthError(RuntimeError):
    """A checkpoint restored at a different ``dcn_dp`` width carries
    state incompatible with the rebuilt program (a parameter or
    optimizer state whose shape disagrees with the program's
    declaration). Raised by ``train.slices.validate_restored_widths``.
    Carries ``var``, ``found`` and ``expected`` shapes."""

    def __init__(self, message, var=None, found=None, expected=None):
        super().__init__(message)
        self.var = var
        self.found = tuple(found) if found is not None else None
        self.expected = tuple(expected) if expected is not None else None


_faults = {}
_faults_lock = threading.Lock()


def maybe_fail(point, **context):
    """A failure point in production code: raises the exception a test
    armed for ``point`` (:func:`fault_injection`, :func:`chaos`), or
    stalls where a chaos ``delay`` is armed; one dict lookup
    otherwise."""
    with _faults_lock:
        spec = _faults.get(point)
        if spec is None or spec["remaining"] == 0:
            return
        spec["remaining"] -= 1
        spec["fired"] += 1
        exc = spec["exc"]
    if callable(exc) and not isinstance(exc, type):
        exc = exc(point, context)
        if exc is None:
            return
    if not spec.get("chaos"):       # a chaos point records its own fires
        _CHAOS_FIRED.inc(labels=(point,))
        _flightrec().record("chaos", point=point)
    raise exc if not isinstance(exc, type) else exc(
        f"fault injected at {point}")


def clear_faults():
    with _faults_lock:
        _faults.clear()


@contextmanager
def fault_injection(point, exc=ConnectionError, times=1):
    """Arm ``point`` to raise ``exc`` for its next ``times`` hits
    (``times=-1``: every hit while armed). ``exc`` is an exception
    class, an instance, or a callable ``(point, context) -> exception or
    None``. Yields the spec; ``spec['fired']`` counts the trips."""
    spec = {"exc": exc, "remaining": int(times), "fired": 0}
    with _faults_lock:
        prev = _faults.get(point)
        _faults[point] = spec
    try:
        yield spec
    finally:
        with _faults_lock:
            if prev is None:
                _faults.pop(point, None)
            else:
                _faults[point] = prev


# ---------------------------------------------------------------------------
# retry budget
# ---------------------------------------------------------------------------

class RetryBudget:
    """Token bucket bounding retries, hedges and reconnects process-wide.

    Every initial request deposits ``ratio`` tokens
    (:meth:`record_request`); every retry-shaped action withdraws one
    (:meth:`try_acquire`, :meth:`acquire`), so a process allows about
    ``ratio`` retries a request and an overload turns retries into fast
    typed sheds. A time-based reserve (``min_reserve`` tokens refilled
    over ``window_s``) keeps isolated failures retryable on an idle
    process, and each consumer (``what``) holds an emergency reserve of
    ``what_reserve`` tokens, reached only when the shared pool is dry,
    so one consumer's storm bounds another's recovery without starving
    it. ``window_s = 0`` turns both refills off; ``ratio < 0`` grants
    every acquire."""

    def __init__(self, ratio=None, min_reserve=10.0, window_s=10.0,
                 cap=None, what_reserve=2.0):
        if ratio is None:
            from .flags import flag
            ratio = flag("retry_budget_ratio")
        self.ratio = float(ratio)
        self.min_reserve = float(min_reserve)
        self.window_s = float(window_s)
        self.what_reserve = float(what_reserve)
        # a long quiet stretch cannot bank an unbounded retry burst
        self.cap = float(cap) if cap is not None \
            else max(4.0 * self.min_reserve, 60.0)
        self._tokens = self.min_reserve
        self._last_refill = time.monotonic()
        self._what = {}        # consumer -> [tokens, last refill]
        self._lock = threading.Lock()
        self._granted = 0
        self._denied = 0
        self._deposits = 0

    def _refill_locked(self, now):
        if self.window_s > 0:
            dt = now - self._last_refill
            if dt > 0:
                self._tokens = min(
                    self.cap,
                    self._tokens + dt * self.min_reserve / self.window_s)
        self._last_refill = now

    def _what_acquire_locked(self, what, now):
        """One token of ``what``'s emergency reserve (``what_reserve``
        tokens, refilled at ``what_reserve / window_s`` a second)."""
        if self.window_s <= 0 or self.what_reserve <= 0:
            return False
        cell = self._what.get(what)
        if cell is None:
            if len(self._what) >= 64:   # bounded like a label set
                return False
            cell = self._what[what] = [self.what_reserve, now]
        dt = now - cell[1]
        if dt > 0:
            cell[0] = min(self.what_reserve,
                          cell[0] + dt * self.what_reserve / self.window_s)
        cell[1] = now
        if cell[0] >= 1.0:
            cell[0] -= 1.0
            return True
        return False

    def record_request(self):
        """Deposit ``ratio`` tokens for one initial request."""
        if self.ratio < 0:
            return
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            self._tokens = min(self.cap, self._tokens + self.ratio)
            self._deposits += 1

    def try_acquire(self, what="retry"):
        """Withdraw one token; False (and a count of
        ``serving_retry_budget_exhausted_total{what}``) when the budget
        is spent."""
        if self.ratio < 0:
            return True
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self._granted += 1
                return True
            if self._what_acquire_locked(str(what), now):
                self._granted += 1
                return True
            self._denied += 1
        _BUDGET_EXHAUSTED.inc(labels=(str(what),))
        _flightrec().record("retry_budget_exhausted", what=str(what))
        return False

    def acquire(self, what="retry"):
        """:meth:`try_acquire` or raise :class:`RetryBudgetExhausted`."""
        if not self.try_acquire(what=what):
            raise RetryBudgetExhausted(
                f"retry budget exhausted for {what} (ratio "
                f"{self.ratio}): the process is already retrying at its "
                f"bound; shedding instead of adding to the overload")

    def snapshot(self):
        with self._lock:
            return {"tokens": round(self._tokens, 3),
                    "ratio": self.ratio, "granted": self._granted,
                    "denied": self._denied, "deposits": self._deposits}


_default_budget = None
_budget_lock = threading.Lock()


def default_retry_budget():
    """The process-wide retry budget that ``retry_call`` and the serving
    client's reconnects and hedges draw from."""
    global _default_budget
    with _budget_lock:
        if _default_budget is None:
            _default_budget = RetryBudget()
        return _default_budget


def reset_retry_budget():
    """Drop the process budget: the next use builds it anew from
    ``FLAGS_retry_budget_ratio``."""
    global _default_budget
    with _budget_lock:
        _default_budget = None


# ---------------------------------------------------------------------------
# retry with exponential backoff and jitter
# ---------------------------------------------------------------------------

def retry_call(fn, deadline=30.0, base_backoff=0.05, max_backoff=2.0,
               retries=None, retry_on=(ConnectionError, OSError),
               jitter=0.5, what="call", endpoint=None, on_retry=None,
               budget=None):
    """``fn()`` until it succeeds, a non-retryable error escapes, the
    attempts are spent (``retries`` extra ones; None: unlimited within
    the deadline) or the next attempt would land past ``deadline``
    seconds: then :class:`RpcDeadlineError`, chained to the last
    failure. Backoff ``base_backoff * 2**k`` capped at ``max_backoff``,
    plus up to ``jitter`` of it at random. The first attempt deposits in
    the retry budget (``budget``, default :func:`default_retry_budget`)
    and each retry withdraws a token; a dry budget raises
    :class:`RetryBudgetExhausted`. ``CircuitOpenError`` and
    ``RetryBudgetExhausted`` raised by ``fn`` are never retried."""
    start = time.monotonic()
    attempt = 0
    backoff = float(base_backoff)
    bud = budget if budget is not None else default_retry_budget()
    bud.record_request()
    while True:
        try:
            return fn()
        except (CircuitOpenError, RetryBudgetExhausted):
            raise
        except retry_on as exc:
            elapsed = time.monotonic() - start
            out_of_attempts = retries is not None and attempt >= retries
            # the next attempt would land past the deadline: give up now
            out_of_time = deadline is not None and \
                elapsed + backoff >= deadline
            if out_of_attempts or out_of_time:
                raise RpcDeadlineError(
                    f"{what} failed after {attempt + 1} attempt(s) over "
                    f"{elapsed:.2f}s"
                    + (f" (deadline {deadline}s)" if deadline else "")
                    + (f" to {endpoint}" if endpoint else "")
                    + f": {type(exc).__name__}: {exc}",
                    endpoint=endpoint, elapsed=elapsed) from exc
            if not bud.try_acquire(what=what):
                raise RetryBudgetExhausted(
                    f"{what} not retried after {attempt + 1} attempt(s) "
                    f"over {elapsed:.2f}s"
                    + (f" to {endpoint}" if endpoint else "")
                    + f": process retry budget exhausted (last failure "
                    f"{type(exc).__name__}: {exc})") from exc
            if on_retry is not None:
                on_retry(attempt, exc)
            time.sleep(backoff * (1.0 + jitter * random.random()))
            attempt += 1
            backoff = min(backoff * 2.0, float(max_backoff))


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Per-endpoint fail-fast gate (closed -> open -> half-open):
    ``failure_threshold`` consecutive failures open it, and calls raise
    :class:`CircuitOpenError` at once for ``reset_timeout`` seconds; then
    one probe is let through (half-open), whose success closes it and
    whose failure opens it again."""

    def __init__(self, endpoint=None, failure_threshold=3,
                 reset_timeout=5.0):
        self.endpoint = endpoint
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._failures = 0
        self._opened_at = None
        self._half_open_inflight = False
        self._lock = threading.Lock()
        _BREAKERS.add(self)

    @property
    def state(self):
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.monotonic() - self._opened_at >= self.reset_timeout:
                return "half-open"
            return "open"

    def before_call(self):
        """Admission: raises :class:`CircuitOpenError` while open, and
        while half-open with the probe already out."""
        with self._lock:
            if self._opened_at is None:
                return
            waited = time.monotonic() - self._opened_at
            if waited < self.reset_timeout:
                raise CircuitOpenError(
                    f"circuit breaker open for {self.endpoint or 'peer'} "
                    f"({self._failures} consecutive failures; retrying "
                    f"in {self.reset_timeout - waited:.1f}s)",
                    endpoint=self.endpoint)
            if self._half_open_inflight:
                raise CircuitOpenError(
                    f"circuit breaker half-open for "
                    f"{self.endpoint or 'peer'}: probe already in flight",
                    endpoint=self.endpoint)
            self._half_open_inflight = True

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._half_open_inflight = False

    def release_probe(self):
        """Give up an admitted call without judging the endpoint (the
        failure was the caller's), freeing the half-open probe slot."""
        with self._lock:
            self._half_open_inflight = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._half_open_inflight = False
            if self._failures >= self.failure_threshold:
                self._opened_at = time.monotonic()


# ---------------------------------------------------------------------------
# watchdogs
# ---------------------------------------------------------------------------

@contextmanager
def watchdog(budget_secs, what="operation"):
    """Abort the enclosed block with :class:`WatchdogTimeout` once it
    exceeds ``budget_secs``. Main thread only (the timer interrupts the
    main thread with SIGINT, which also breaks a blocking syscall); from
    another thread use :func:`run_with_watchdog`."""
    import signal
    import _thread
    main = threading.main_thread()
    if threading.current_thread() is not main:
        raise RuntimeError("watchdog() only arms on the main thread; "
                           "use run_with_watchdog elsewhere")
    fired = [False]
    armed = [True]
    # the timer signals while holding this lock and the exit path
    # disarms under it: the interrupt never lands after the block
    arm_lock = threading.Lock()

    def _fire():
        with arm_lock:
            if not armed[0]:
                return
            fired[0] = True
            try:
                signal.pthread_kill(main.ident, signal.SIGINT)
            except (AttributeError, OSError, ValueError):
                _thread.interrupt_main()

    timer = threading.Timer(float(budget_secs), _fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    except KeyboardInterrupt:
        if fired[0]:
            raise WatchdogTimeout(
                f"{what} exceeded its {budget_secs}s wall-clock budget")
        raise
    finally:
        try:
            with arm_lock:
                armed[0] = False
        except KeyboardInterrupt:
            armed[0] = False
            if not fired[0]:
                raise           # a real Ctrl-C, not the timer
            # the timer fired as the block finished within its budget:
            # the late interrupt is absorbed
        timer.cancel()


def _caller_card():
    """The calling thread's CUDA device once CUDA is in use, else None: a
    new thread starts on card 0, and a rank of a launched world must
    keep its own card (its collectives' tensors live there)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or \
            not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device()


def run_with_watchdog(fn, budget_secs, *args, what=None, **kwargs):
    """``fn(*args, **kwargs)`` on a worker thread bound to the caller's
    CUDA device; raises :class:`WatchdogTimeout` when it does not finish
    within ``budget_secs``. Safe from any thread. An overrunning worker
    is left to finish as a daemon and its result is dropped."""
    box = {}
    card = _caller_card()

    def _target():
        if card is not None:
            import torch
            torch.cuda.set_device(card)
        try:
            box["result"] = fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 — relayed to caller
            box["error"] = exc

    t = threading.Thread(target=_target, daemon=True)
    t.start()
    t.join(float(budget_secs))
    if t.is_alive():
        what = what or getattr(fn, "__name__", "operation")
        _flightrec().record("watchdog", what=str(what),
                            budget_s=float(budget_secs))
        raise WatchdogTimeout(
            f"{what} exceeded its {budget_secs}s wall-clock budget")
    if "error" in box:
        raise box["error"]
    return box.get("result")


class WatchdogWorker:
    """:func:`run_with_watchdog` for a loop that watches every step (a
    serving batcher): the calls run on one long-lived worker thread
    instead of a thread started per call. A call past its budget raises
    :class:`WatchdogTimeout` whose ``thread`` attribute is the worker
    left running it: that thread finishes the call, then exits, and the
    next call starts a fresh worker. Calls are serialized."""

    def __init__(self, name="watchdog-worker"):
        self.name = name
        self._lock = threading.Lock()
        self._inbox = None
        self._thread = None

    @staticmethod
    def _serve(inbox):
        while True:
            job = inbox.get()
            if job is None:
                return
            fn, args, kwargs, box, done = job
            # drop the call's references before it is reported done: a
            # caller that frees what the call used must not find it kept
            del job
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — relayed
                box["error"] = exc
            del fn, args, kwargs, box
            done.release()

    def call(self, fn, budget_secs, *args, what=None, **kwargs):
        """``fn(*args, **kwargs)`` on the worker; raises
        :class:`WatchdogTimeout` when it does not finish within
        ``budget_secs``."""
        with self._lock:
            if self._thread is None:
                self._inbox = queue.SimpleQueue()
                self._thread = threading.Thread(
                    target=self._serve, args=(self._inbox,),
                    name=self.name, daemon=True)
                self._thread.start()
            box = {}
            done = threading.Lock()
            done.acquire()
            self._inbox.put((fn, args, kwargs, box, done))
            if not done.acquire(timeout=float(budget_secs)):
                thread, self._thread = self._thread, None
                self._inbox.put(None)   # it exits once the call returns
                what = what or getattr(fn, "__name__", "operation")
                _flightrec().record("watchdog", what=str(what),
                                    budget_s=float(budget_secs))
                exc = WatchdogTimeout(
                    f"{what} exceeded its {budget_secs}s wall-clock budget")
                exc.thread = thread
                raise exc
        if "error" in box:
            raise box.pop("error")
        return box.get("result")

    def close(self):
        """Let the worker exit after what it runs (idempotent)."""
        with self._lock:
            if self._thread is not None:
                self._inbox.put(None)
                self._thread = None


# ---------------------------------------------------------------------------
# chaos harness (seeded, probabilistic, scheduled fault points)
# ---------------------------------------------------------------------------

class ChaosMonkey:
    """What :func:`chaos` yields: per point, ``hits[point]`` (times the
    armed point was reached) and ``fired[point]`` (times it injected a
    fault or a delay)."""

    def __init__(self, seed):
        self.seed = seed
        self.hits = {}
        self.fired = {}
        self._lock = threading.Lock()

    def _record(self, point, fire):
        with self._lock:
            self.hits[point] = self.hits.get(point, 0) + 1
            if fire:
                self.fired[point] = self.fired.get(point, 0) + 1
        if fire:
            _CHAOS_FIRED.inc(labels=(point,))
            _flightrec().record("chaos", point=point, seed=self.seed)

    def total_fired(self):
        with self._lock:
            return sum(self.fired.values())


def _chaos_spec(point, cfg, monkey):
    """One armed point from its config: ``p`` (fire probability a hit),
    ``after`` (skip the first N hits), ``every`` (fire on every N-th hit
    after those, overriding ``p``), ``times`` (stop after N fires; -1:
    never), ``delay`` (stall that many seconds instead of raising),
    ``exc`` (the exception class or instance raised). Each point draws
    from its own RNG seeded from ``(seed, point)``, one draw a hit
    whether it fires or not."""
    p = float(cfg.get("p", 1.0))
    after = int(cfg.get("after", 0))
    every = cfg.get("every")
    times = int(cfg.get("times", -1))
    delay = cfg.get("delay")
    exc = cfg.get("exc", FaultInjected)
    rng = random.Random(f"{monkey.seed}/{point}")
    state = {"hits": 0, "fires": 0}
    lock = threading.Lock()

    def _fire(pt, context):
        with lock:
            state["hits"] += 1
            hit = state["hits"]
            draw = rng.random()       # drawn on every hit: the stream
            if hit <= after:          # stays aligned, fire or not
                fire = False
            elif times >= 0 and state["fires"] >= times:
                fire = False
            elif every is not None:
                fire = (hit - after) % int(every) == 0
            else:
                fire = draw < p
            if fire:
                state["fires"] += 1
        monkey._record(pt, fire)
        if not fire:
            return None
        if delay:
            time.sleep(float(delay))
            return None
        if isinstance(exc, type):
            return exc(f"fault injected at {pt}")
        return exc

    return {"exc": _fire, "remaining": -1, "fired": 0, "chaos": True}


@contextmanager
def chaos(points, p=1.0, seed=None, exc=FaultInjected, times=-1,
          after=0, every=None, delay=None):
    """Arm many fault points at once. ``points``: a name, an iterable of
    names, or ``{name: overrides}`` (any of ``p``, ``after``, ``every``,
    ``times``, ``delay``, ``exc``); the keyword arguments are the
    defaults. ``seed`` None reads ``FLAGS_chaos_seed``. One thread
    replays the same fire pattern run after run, and arming another
    point never shifts a point's pattern. Points armed before are
    restored on exit. Yields a :class:`ChaosMonkey`."""
    if seed is None:
        from .flags import flag
        seed = flag("chaos_seed")
    if isinstance(points, str):
        points = {points: {}}
    elif not isinstance(points, dict):
        points = {pt: {} for pt in points}
    monkey = ChaosMonkey(seed)
    defaults = {"p": p, "after": after, "every": every, "times": times,
                "delay": delay, "exc": exc}
    prev = {}
    with _faults_lock:
        for pt, overrides in points.items():
            cfg = dict(defaults)
            cfg.update(overrides or {})
            prev[pt] = _faults.get(pt)
            _faults[pt] = _chaos_spec(pt, cfg, monkey)
    try:
        yield monkey
    finally:
        with _faults_lock:
            for pt, old in prev.items():
                if old is None:
                    _faults.pop(pt, None)
                else:
                    _faults[pt] = old
