"""Requests, the admission queue, the micro-batcher and the continuous
decode batcher.

Counterpart of ``paddle_tpu/serving/batching.py``: the typed serving
errors, ``next_bucket``, priority classes, ``Request`` (one infer
request: feeds with a leading example dim) and ``GenerationRequest``, a
bounded ``RequestQueue`` (depth backpressure, deadline at admission,
higher priority classes served first, typed refusal once closed),
``MicroBatcher`` (requests grouped by per-example signature, a group
flushed at ``max_batch_size`` rows at once or when its oldest member
has waited ``batch_timeout_ms``) and ``DecodeBatcher`` — ORCA-style
iteration-level scheduling over a fixed bank of decode slots: requests
are admitted between steps, a row finishes on EOS, on its token budget
or on its deadline and frees its slot at once, and rows still in flight
when the loop stops fail with a typed error; between steps it advances
chunked prefills, drafts for speculative steps and serves prefill-only
(KV export) and migrated (KV import) requests.

Resilience: the queue's load-shed breaker (``serving_shed_*``: a run of
queue-full refusals opens it, and while open admission refuses at
once), the sweep of entries whose deadline passed while queued, the
eviction of the youngest lowest-class entry to admit a higher class
under backpressure, the brownout ladder's shrunken per-call depth cap
and ``quiesce`` (drain: admission closed, the queue still flowing).
Each batcher stamps a ``heartbeat`` every iteration, runs its execute or
decode step under the watchdog (``serving_loop_watchdog_s``) on a
long-lived ``resilience.WatchdogWorker`` thread (replaced only after a
trip) and is restarted by ``supervise.LoopSupervisor`` when it dies or
hangs (``restart``: the old thread deposed by an epoch bump, its
requests failed typed). A decode step that fails otherwise than by the watchdog
fails its rows and ends the decode loop, so the restart resets the
engine the failure may have left in any state. A hot
weight swap is parked on the decode loop (``request_swap``, a
:class:`SwapHandle`): admission pauses, rows in flight finish on the old
weights and the swap applies between steps once the bank is empty. A
request failed from outside (``cancel``: ``RequestCancelledError``) is
dropped by the batcher at its next step. Fault points:
``serving.admit`` and ``serving.queue``.

Telemetry: a request keeps the trace context that was ambient when it
was made (``observability.tracing``); the batchers record its
``serving/queue`` span and each decode step's ``serving/decode`` span
under it. Admission outcomes go to the flight recorder (sampled: the
first of each outcome, then every 64th, with the running count), and
the priority-class registry families count sheds, queue expiries and
completions; the speculative loop exports its windowed acceptance rate.
"""
import threading
import time
from collections import deque

import numpy as np

from ..observability import tracing as _trace
from ..observability.recorder import flight_recorder as _flightrec
from ..resilience import (CircuitBreaker, CircuitOpenError, WatchdogTimeout,
                          WatchdogWorker, maybe_fail)
from .metrics import (record_class_done, record_class_shed,
                      record_expired_in_queue, record_spec_accept_ratio)


def remaining_budget_ms(budget_ms, t0, now=None):
    """The deadline budget still unspent at ``now`` in ms (<= 0: spent):
    the one copy of the arithmetic the client's re-sends and hedges
    share."""
    return float(budget_ms) \
        - ((time.monotonic() if now is None else now) - t0) * 1e3


class ServingError(RuntimeError):
    """Base class for serving-runtime request failures."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed. Carries ``deadline_ms`` (the
    budget) and ``waited_ms`` (time spent when the expiry was seen)."""

    def __init__(self, message, deadline_ms=None, waited_ms=None):
        super().__init__(message)
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms


class ServerOverloadedError(ServingError):
    """Admission refused (queue at its depth limit, pool exhausted):
    back off and retry. Wire ``etype: "Overloaded"``."""


class ServerShutdownError(ServerOverloadedError):
    """The server is stopping: admission is closed and requests still
    queued or decoding are failed with this. Wire ``etype:
    "Shutdown"``."""


class RequestCancelledError(ServingError):
    """The request was cancelled by its client (the losing twin of a
    hedged pair, or an abandoned call), by request id. Wire ``etype:
    "Cancelled"``."""


class InternalServerError(ServingError):
    """Client-side face of an ``etype: "Internal"`` reply."""


class BadRequestError(ServingError):
    """The request was validated and refused (overlong prompt, malformed
    input): retrying without fixing it cannot help. Wire ``etype:
    "BadRequest"``."""


# priority classes, highest first
PRIORITIES = ("interactive", "batch", "best_effort")
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


def priority_rank(priority):
    """Rank (0 = highest) of a priority-class name; None is the default
    class."""
    if priority is None:
        return 0
    try:
        return _PRIORITY_RANK[priority]
    except KeyError:
        raise ValueError(f"unknown priority class {priority!r}: one of "
                         f"{PRIORITIES}") from None


def _record_queue_span(req, now):
    """The ``serving/queue`` span of a traced request: it ends now and
    covers the monotonic time since enqueue, re-based onto the
    profiler's perf_counter clock."""
    if req.trace is None:
        return
    pc = time.perf_counter()
    _trace.record_child("serving/queue", pc - (now - req.t_enqueue), pc,
                        req.trace)


def next_bucket(rows, min_bucket=1):
    """Smallest power-of-two >= rows (>= min_bucket): bounded padding
    waste (< 2x) and a bounded universe of shapes."""
    b = max(int(min_bucket), 1)
    rows = max(int(rows), 1)
    while b < rows:
        b <<= 1
    return b


class _Lifecycle:
    """Deadline, priority and reply bookkeeping shared by the request
    kinds. The reply arrives through :meth:`wait`, or the recorded
    error is raised."""

    def _init_lifecycle(self, deadline_ms, priority=None):
        self.rank = priority_rank(priority)
        self.priority = PRIORITIES[self.rank]
        self.deadline_ms = deadline_ms
        self.t_enqueue = time.monotonic()
        self.deadline_at = (self.t_enqueue + deadline_ms / 1e3
                            if deadline_ms else None)
        self.result = None
        self.error = None
        self._done = threading.Event()
        # the request's trace context: the one ambient when it was made
        # (the server's handler span); its stage spans parent here
        self.trace = _trace.current()

    def expired(self, now=None):
        return self.deadline_at is not None \
            and (now or time.monotonic()) > self.deadline_at

    def expire(self, now=None, where="queue"):
        now = now or time.monotonic()
        waited = (now - self.t_enqueue) * 1e3
        self.set_error(DeadlineExceededError(
            f"request deadline of {self.deadline_ms:.1f}ms exceeded in "
            f"{where} after {waited:.1f}ms",
            deadline_ms=self.deadline_ms, waited_ms=waited))

    def set_result(self, result):
        self.result = result
        self._done.set()

    def set_error(self, exc):
        self.error = exc
        self._done.set()

    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"no reply within {timeout}s (request still in flight)")
        if self.error is not None:
            raise self.error
        return self.result


class Request(_Lifecycle):
    """One prediction request: ``feeds`` is ``{name: np.ndarray}``, every
    array with a leading example dim (``(rows, *example_shape)``), all
    agreeing on ``rows``. Requests share a batch only when their
    ``example_sig`` (each feed's trailing dims and dtype) matches. The
    reply is the list of fetches (numpy arrays, this request's rows)."""

    def __init__(self, feeds, deadline_ms=None, priority=None):
        self.feeds = {n: np.ascontiguousarray(a) for n, a in feeds.items()}
        if not self.feeds:
            raise ValueError("request has no feeds")
        rows = {a.shape[0] if a.ndim else 1 for a in self.feeds.values()}
        if len(rows) != 1:
            raise ValueError(
                f"feeds disagree on the leading example dim: "
                f"{ {n: a.shape for n, a in self.feeds.items()} }")
        self.rows = rows.pop()
        if self.rows < 1:
            raise ValueError("request carries zero examples")
        self.example_sig = tuple(sorted(
            (n, tuple(a.shape[1:]), str(a.dtype))
            for n, a in self.feeds.items()))
        self.t_flush = None
        self._init_lifecycle(deadline_ms, priority)


class GenerationRequest(_Lifecycle):
    """One generation request: a 1-D int prompt plus sampling knobs and
    a token-level deadline (re-checked between decode steps). The reply
    arrives through :meth:`wait`: ``[np.int32 new tokens]``, or the
    recorded error is raised.

    Disaggregated prefill and decode: with ``export_kv=True`` the request
    is prefill-only, and its reply is ``[payload]``, the slot's KV blocks
    (``KVBlockPool.export_slot``) with ``first_token`` and
    ``prompt_tokens``; with ``kv=`` (such a payload) and ``first_token=``
    it skips prefill, takes the blocks into its slot and decodes from
    ``first_token``."""

    def __init__(self, prompt, max_new_tokens=32, temperature=0.0, top_k=0,
                 eos_id=None, deadline_ms=None, export_kv=False, kv=None,
                 first_token=None, priority=None):
        prompt = np.asarray(prompt, dtype=np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("generation request has an empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if kv is not None and export_kv:
            raise ValueError("a request cannot both import (kv=) and "
                             "export (export_kv=True) KV state")
        if (kv is None) != (first_token is None):
            raise ValueError("kv= and first_token= come together: the "
                             "migrated blocks are decoded FROM the token "
                             "sampled where the prefill ran")
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.out_tokens = []
        self.slot = None
        self.export_kv = bool(export_kv)
        self.kv = kv
        self.first_token = None if first_token is None else int(first_token)
        self.rows = 1
        self._init_lifecycle(deadline_ms, priority)


class RequestQueue:
    """Bounded priority queue with admission control. ``put`` is the one
    gate every request passes: the load-shed breaker, the deadline, the
    depth (backpressure, the lowest class shed first), and a typed
    refusal once :meth:`close` or :meth:`quiesce` ran
    (:class:`ServerShutdownError`). ``get`` serves the highest priority
    class first (FIFO within a class) and fails entries whose deadline
    expired while queued."""

    def __init__(self, max_depth=None, breaker=None, stats=None):
        from ..flags import flag
        if max_depth is None:
            max_depth = flag("serving_queue_depth")
        self.max_depth = int(max_depth)
        self.stats = stats
        self._items = [deque() for _ in PRIORITIES]
        self._cv = threading.Condition()
        self._closed = False
        self._draining = False
        self._adm_lock = threading.Lock()
        self._adm_counts = {}
        self.expired_in_queue = 0
        self.priority_evictions = 0
        if breaker is None:
            breaker = CircuitBreaker(
                endpoint="serving-admission",
                failure_threshold=flag("serving_shed_failures"),
                reset_timeout=flag("serving_shed_reset_secs"))
        self.breaker = breaker

    def _record_admission(self, outcome, **fields):
        """Flight-record one admission outcome, sampled per outcome (the
        first, then every 64th, each with the running count): a shed
        storm must not turn the ring over and evict the rare events it
        exists to keep."""
        with self._adm_lock:
            n = self._adm_counts.get(outcome, 0) + 1
            self._adm_counts[outcome] = n
        if n == 1 or n % 64 == 0:
            _flightrec().record("admission", outcome=outcome, n=n,
                                **fields)

    def _depth_locked(self):
        return sum(len(q) for q in self._items)

    def __len__(self):
        with self._cv:
            return self._depth_locked()

    def _sweep_expired_locked(self, now):
        """Drop every queued entry whose deadline passed (and every
        abandoned one); returns the expired ones, which the caller fails
        outside the lock."""
        dead = []
        for q in self._items:
            live = deque()
            for req in q:
                if req.done():
                    continue
                if req.expired(now):
                    dead.append(req)
                else:
                    live.append(req)
            q.clear()
            q.extend(live)
        return dead

    def _fail_expired(self, dead):
        if not dead:
            return
        self.expired_in_queue += len(dead)
        record_expired_in_queue(len(dead))
        for req in dead:
            if self.stats:
                self.stats.bump("shed_deadline")
            req.expire(where="queue")

    def put(self, req, max_depth=None):
        """Admit ``req`` or raise :class:`ServerOverloadedError`,
        :class:`DeadlineExceededError` or :class:`ServerShutdownError`;
        never blocks. At a full queue the expired entries are swept out
        first, then the youngest entry of a strictly lower class than
        ``req``'s is evicted (typed) to admit it; only without such a
        victim is ``req`` refused. ``max_depth`` caps the depth for this
        one admission (the brownout ladder shrinking a degraded class):
        a request refused by it evicts nothing and does not count
        against the load-shed breaker."""
        maybe_fail("serving.admit")
        depth_cap = self.max_depth if max_depth is None \
            else min(int(max_depth), self.max_depth)
        try:
            self.breaker.before_call()
        except CircuitOpenError as e:
            if self.stats:
                self.stats.bump("shed_overload")
            record_class_shed(req.priority)
            self._record_admission("shed_breaker")
            raise ServerOverloadedError(f"load shedding: {e}") from e
        if req.expired():
            self.breaker.release_probe()        # not the server's fault
            if self.stats:
                self.stats.bump("shed_deadline")
            self._record_admission("shed_deadline",
                                   deadline_ms=req.deadline_ms)
            req.expire(where="admission")
            raise req.error
        dead, victim, genuinely_full = [], None, False
        with self._cv:
            if self._closed or self._draining:
                self.breaker.release_probe()
                self._record_admission("shutdown")
                raise ServerShutdownError(
                    "server is draining: admission closed"
                    if self._draining and not self._closed
                    else "server is shutting down")
            if self._depth_locked() >= depth_cap:
                dead = self._sweep_expired_locked(time.monotonic())
            overloaded = False
            if self._depth_locked() >= depth_cap:
                genuinely_full = self._depth_locked() >= self.max_depth
                if max_depth is None and genuinely_full:
                    # the youngest entry of the lowest populated class
                    # strictly below req's: the least sunk cost
                    for r in range(len(PRIORITIES) - 1, req.rank, -1):
                        if self._items[r]:
                            victim = self._items[r].pop()
                            self.priority_evictions += 1
                            break
                overloaded = victim is None
            if not overloaded:
                self._items[req.rank].append(req)
                self._cv.notify()
        self._fail_expired(dead)
        if victim is not None:
            if self.stats:
                self.stats.bump("shed_overload")
            record_class_shed(victim.priority)
            self._record_admission("shed_evicted", victim=victim.priority)
            victim.set_error(ServerOverloadedError(
                f"queued {victim.priority} request shed to admit "
                f"{req.priority} traffic under backpressure: back off "
                f"and retry"))
        if overloaded:
            if genuinely_full:
                self.breaker.record_failure()
            else:
                self.breaker.release_probe()    # a per-call cap refused it
            if self.stats:
                self.stats.bump("shed_overload")
            record_class_shed(req.priority)
            self._record_admission("shed_overload", depth=depth_cap)
            raise ServerOverloadedError(
                f"request queue at depth limit ({depth_cap}); retry with "
                f"backoff")
        self.breaker.record_success()
        if self.stats:
            self.stats.bump("requests_admitted")
        self._record_admission("admitted", rows=getattr(req, "rows", 1))
        return req

    def get(self, timeout=None):
        """Oldest live request of the highest populated class, or None
        on timeout/close."""
        maybe_fail("serving.queue")
        dead, out = [], None
        with self._cv:
            if not self._depth_locked() and not self._closed:
                self._cv.wait(timeout)
            now = time.monotonic()
            for q in self._items:
                while q:
                    req = q.popleft()
                    if req.done():            # abandoned while queued
                        continue
                    if req.expired(now):
                        dead.append(req)
                        continue
                    out = req
                    break
                if out is not None:
                    break
        self._fail_expired(dead)
        return out

    def wake(self):
        with self._cv:
            self._cv.notify_all()

    def quiesce(self):
        """Stop admitting (``put`` raises :class:`ServerShutdownError`)
        while what is queued still flows to the batcher: the first half
        of ``drain``."""
        with self._cv:
            self._draining = True

    def close(self):
        """Stop admitting; fail whatever is still queued at once."""
        with self._cv:
            self._closed = True
            drained = [r for q in self._items for r in q]
            for q in self._items:
                q.clear()
            self._cv.notify_all()
        for req in drained:
            req.set_error(ServerShutdownError(
                "server shut down with the request still queued"))


class SwapHandle:
    """A hot weight swap parked on the decode loop
    (:meth:`DecodeBatcher.request_swap`): :meth:`wait` returns once the
    loop applied it between steps (the admission pause in ms, also
    ``pause_ms``) or raises its failure."""

    def __init__(self, apply_fn):
        self.apply_fn = apply_fn
        self.requested_at = time.monotonic()
        self.pause_ms = None
        self.error = None
        self._done = threading.Event()

    def apply(self):
        try:
            self.apply_fn()
            self.pause_ms = (time.monotonic() - self.requested_at) * 1e3
        except Exception as exc:  # noqa: BLE001 — relayed to the waiter
            self.error = exc
        self._done.set()

    def fail(self, exc):
        self.error = exc
        self._done.set()

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"weight swap not applied within {timeout}s "
                               f"(decode rows still draining)")
        if self.error is not None:
            raise self.error
        return self.pause_ms


class MicroBatcher:
    """Pulls requests off the queue, groups them by per-example
    signature, and flushes a group to ``execute_fn(requests)`` when it
    reaches ``max_batch_size`` rows (at once) or its oldest member has
    waited ``batch_timeout_ms``. One execution thread: batches reach the
    card one after another; concurrency lives in the connection
    threads. An execute runs on the batcher's ``WatchdogWorker`` under
    its watchdog (``watchdog_s``, None -> ``FLAGS_serving_loop_watchdog_s``;
    0: none, the loop thread runs it): a hung one
    fails its batch with :class:`~paddle_tpu_torch.resilience.
    WatchdogTimeout` and the loop goes on. A request still forming a
    batch when the loop stops fails with :class:`ServerShutdownError`."""

    def __init__(self, queue, execute_fn, max_batch_size=None,
                 batch_timeout_ms=None, stats=None, watchdog_s=None):
        from ..flags import flag
        self.queue = queue
        self.execute_fn = execute_fn
        self.max_batch_size = int(max_batch_size
                                  if max_batch_size is not None
                                  else flag("serving_max_batch_size"))
        timeout_ms = (batch_timeout_ms if batch_timeout_ms is not None
                      else flag("serving_batch_timeout_ms"))
        self.batch_timeout_s = float(timeout_ms) / 1e3
        self.watchdog_s = float(watchdog_s if watchdog_s is not None
                                else flag("serving_loop_watchdog_s"))
        self._worker = WatchdogWorker("serving-execute")
        self.stats = stats
        self._stop = threading.Event()
        self._thread = None
        # sig -> {"reqs": [...], "rows": n, "flush_at": t}; the loop
        # thread owns it
        self._pending = {}
        # supervision: the loop stamps the heartbeat every iteration; an
        # epoch bump (restart) deposes a hung thread, which then leaves
        # every shared structure alone
        self.heartbeat = time.monotonic()
        self._epoch = 0
        self._executing = 0           # requests inside execute_fn now
        self._ingesting = 0           # popped, not yet in _pending
        self.consecutive_failures = 0

    def start(self):
        self.heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-microbatcher")
        self._thread.start()
        return self

    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def inflight(self):
        """Requests forming a batch, being ingested or inside the engine
        (``drain`` waits for 0)."""
        return (sum(len(ent["reqs"]) for ent in self._pending.values())
                + self._executing + self._ingesting)

    def stop(self, timeout=30):
        """Stop the loop; requests still forming a batch fail typed (the
        loop does it on its way out). A batch inside ``execute_fn``
        finishes and is delivered."""
        self._stop.set()
        self.queue.wake()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return
        self._worker.close()
        self._fail_pending()

    def restart(self, reason="supervisor restart"):
        """Replace a dead or hung loop thread (the supervisor's call):
        depose the old thread, fail the batches it was forming, start a
        fresh loop."""
        self._epoch += 1
        err = ServingError(f"batcher loop restarted ({reason}); the "
                           f"request was failed mid-batch")
        for ent in self._pending.values():
            for req in ent["reqs"]:
                if not req.done():
                    req.set_error(err)
                    if self.stats:
                        self.stats.bump("requests_failed")
        self._pending = {}
        self.consecutive_failures = 0
        self.start()

    def _fail_pending(self):
        for ent in self._pending.values():
            for req in ent["reqs"]:
                if not req.done():
                    req.set_error(ServerShutdownError(
                        "server stopped while the request was batching"))
        self._pending = {}

    def _admit_to_batch(self, req, now):
        if req.expired(now):
            if self.stats:
                self.stats.bump("shed_deadline")
            req.expire(now, where="queue")
            return
        ent = self._pending.get(req.example_sig)
        if ent is None:
            ent = {"reqs": [], "rows": 0,
                   "flush_at": now + self.batch_timeout_s}
            self._pending[req.example_sig] = ent
        ent["reqs"].append(req)
        ent["rows"] += req.rows
        # a full group flushes at once, so no group grows past
        # max_batch_size (+ its last request's rows)
        if ent["rows"] >= self.max_batch_size:
            del self._pending[req.example_sig]
            self._flush(ent["reqs"], time.monotonic())

    def _flush_ready(self, now):
        for sig in list(self._pending):
            ent = self._pending[sig]
            if now >= ent["flush_at"]:
                del self._pending[sig]
                self._flush(ent["reqs"], now)

    def _flush(self, reqs, now):
        live = []
        for req in reqs:
            if req.expired(now):
                if self.stats:
                    self.stats.bump("shed_deadline")
                req.expire(now, where="batcher")
            else:
                req.t_flush = now
                if self.stats:
                    self.stats.hist["queue"].observe(now - req.t_enqueue)
                _record_queue_span(req, now)
                live.append(req)
        if not live:
            return
        self._executing = len(live)
        try:
            if self.watchdog_s > 0:
                self._worker.call(self.execute_fn, self.watchdog_s, live,
                                  what="serving execute")
            else:
                self.execute_fn(live)
            self.consecutive_failures = 0
        except Exception as exc:  # noqa: BLE001 — must reach the clients
            self.consecutive_failures += 1
            failed = [req for req in live if not req.done()]
            for req in failed:
                req.set_error(exc)
            if self.stats:
                self.stats.bump("engine_failures")
                if isinstance(exc, WatchdogTimeout):
                    self.stats.bump("watchdog_timeouts")
                self.stats.bump("requests_failed", len(failed))
        finally:
            self._executing = 0

    def _loop(self):
        epoch = self._epoch
        try:
            while not self._stop.is_set() and self._epoch == epoch:
                self.heartbeat = time.monotonic()
                now = time.monotonic()
                if self._pending:
                    wake = min(ent["flush_at"]
                               for ent in self._pending.values())
                    timeout = max(min(wake - now, 0.1), 0.0)
                else:
                    timeout = 0.1
                req = self.queue.get(timeout=timeout)
                if self._epoch != epoch:
                    # deposed while blocked: the new loop owns _pending
                    if req is not None and not req.done():
                        req.set_error(ServingError(
                            "batcher loop restarted; the request was "
                            "failed mid-ingest"))
                        if self.stats:
                            self.stats.bump("requests_failed")
                    return
                if req is not None:
                    self._ingesting = 1
                    self._admit_to_batch(req, time.monotonic())
                    # drain what is already queued before sleeping, so a
                    # burst coalesces; timed-out groups are flushed inside
                    # the drain, so a busy signature cannot starve a rare
                    # one past its batch_timeout_ms. The heartbeat is
                    # stamped here too: busy is not hung
                    while not self._stop.is_set() and self._epoch == epoch:
                        self.heartbeat = time.monotonic()
                        nxt = self.queue.get(timeout=0)
                        if nxt is None:
                            break
                        now = time.monotonic()
                        self._admit_to_batch(nxt, now)
                        self._flush_ready(now)
                    self._ingesting = 0
                if self._epoch != epoch:
                    return
                self._flush_ready(time.monotonic())
        finally:
            self._ingesting = 0
            # a deposed thread leaves _pending to the restarted loop
            if self._epoch == epoch and (self._stop.is_set()
                                         or self._pending):
                self._fail_pending()


class DecodeBatcher:
    """Continuous batching over the engine's bank of decode slots: one
    thread admits queued requests into free slots (prefill + first
    token, a migrated KV payload, or a chunked prefill advanced one
    chunk per round), then steps the whole bank one token at a time, or
    one speculative span (``spec_k`` > 0, None -> ``FLAGS_decode_spec_k``;
    paged only: each live row drafts up to K tokens, one verify pass,
    rejection sampling). Per-row state (position, current token,
    sampling config) lives here; the KV state lives in the
    ``GenerationEngine``. Every 256 steps the pool is swept for blocks
    held by slots no longer live. Each step runs under the engine's
    watchdog (``watchdog_s``, None -> ``FLAGS_serving_loop_watchdog_s``;
    0: none): a hung step fails the bank's rows with
    :class:`~paddle_tpu_torch.resilience.WatchdogTimeout` and the engine
    rebuilds its bank. ``brownout`` (a ``brownout.BrownoutController``)
    shrinks degraded classes' draft depth."""

    def __init__(self, queue, engine, stats=None, spec_k=None,
                 drafter=None, watchdog_s=None, brownout=None):
        from ..flags import flag
        self.queue = queue
        self.engine = engine
        self.slots = engine.slots
        self.stats = stats
        if watchdog_s is None:
            watchdog_s = flag("serving_loop_watchdog_s")
        self.watchdog_s = float(watchdog_s)
        if spec_k is None:
            spec_k = flag("decode_spec_k")
        self.spec_k = int(spec_k) \
            if getattr(engine, "pool", None) is not None else 0
        self._drafter = drafter          # lazy: make_drafter on first use
        # the brownout ladder's per-class draft depth (None: every row at
        # the adaptive depth)
        self.brownout = brownout
        self._accept_window = deque(maxlen=64)   # (accepted, proposed)
        self._spec_scope = f"decode-{id(self) & 0xffffff:x}"
        self._stop = threading.Event()
        self._thread = None
        self._free = list(range(self.slots))
        self._active = {}                       # slot -> request
        # chunked-prefill states (engine.start_prefill): rows that hold a
        # slot while their prompt goes in, one chunk per round
        self._prefilling = []
        self._steps_since_sweep = 0
        self._tok = np.zeros((self.slots,), np.int32)
        self._pos = np.zeros((self.slots,), np.int32)
        self._temp = np.zeros((self.slots,), np.float32)
        self._topk = np.zeros((self.slots,), np.int32)
        # supervision: the loop stamps the heartbeat every iteration; an
        # epoch bump (restart) deposes a hung thread, which then leaves
        # the row state alone
        self.heartbeat = time.monotonic()
        self._epoch = 0
        self.consecutive_failures = 0
        self._swap = None                       # the parked SwapHandle
        self._swap_lock = threading.Lock()
        self._admitting = 0     # popped from the queue, not yet in a slot
        self._admitting_reqs = []

    # -- lifecycle --------------------------------------------------------
    def start(self):
        self.heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-decode-batcher")
        self._thread.start()
        return self

    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def inflight(self):
        """Rows decoding, requests popped but not yet in a slot, and rows
        mid chunked prefill (``drain`` waits for 0)."""
        return len(self._active) + self._admitting + len(self._prefilling)

    def free_slots(self):
        return len(self._free)

    def stop(self, timeout=30):
        """Stop the loop; rows still decoding or prefilling fail with
        :class:`ServerShutdownError` (the loop does it on its way out)."""
        self._stop.set()
        self.queue.wake()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return
        stop_worker = getattr(self.engine, "stop_worker", None)
        if stop_worker is not None:
            stop_worker()

    def restart(self, reason="supervisor restart"):
        """Replace a dead or hung loop thread (the supervisor's call):
        depose the old thread, fail every row in flight, reset the bank
        (``engine.reset``: every block freed, the device pool and its
        decode graphs released), fail a parked swap, start a fresh
        loop."""
        self._epoch += 1
        err = ServingError(f"decode loop restarted ({reason}); the "
                           f"request's decode state was lost")
        for req in list(self._active.values()) \
                + [st["req"] for st in self._prefilling]:
            if not req.done():
                req.set_error(err)
                if self.stats:
                    self.stats.bump("requests_failed")
        self._active.clear()
        self._prefilling = []
        self._free = list(range(self.slots))
        self._temp[:] = 0.0
        self._topk[:] = 0
        self._admitting = 0
        self.engine.reset()
        with self._swap_lock:
            sw, self._swap = self._swap, None
        if sw is not None:
            sw.fail(ServingError(f"weight swap abandoned: {reason}"))
        self.consecutive_failures = 0
        self.start()

    def request_swap(self, apply_fn):
        """Park ``apply_fn`` (a weight swap) on the decode loop: admission
        pauses (new requests stay queued, not failed), the rows in flight
        finish on the old weights, and the loop applies the swap between
        steps once the bank is empty. Returns a :class:`SwapHandle`. With
        no loop running the swap applies at once. A swap requested while
        another is parked fails at once (one reload at a time)."""
        handle = SwapHandle(apply_fn)
        with self._swap_lock:
            if self._swap is not None:
                handle.fail(ServingError("another weight swap is already "
                                         "pending: one reload at a time"))
                return handle
            parked = self.alive()
            if parked:
                self._swap = handle
        if not parked:
            handle.apply()
            return handle
        self.queue.wake()
        # the loop may have exited between the liveness check and the
        # store (its exit fails only a swap it saw): apply it here
        with self._swap_lock:
            orphaned = not self.alive() and self._swap is handle
            if orphaned:
                self._swap = None
        if orphaned:
            handle.apply()
        return handle

    def spec_snapshot(self):
        """The configured draft depth, the window-adapted one and the
        windowed acceptance rate (None before any drafting)."""
        win = list(self._accept_window)
        proposed = sum(p for _, p in win)
        return {"spec_k": self.spec_k,
                "spec_k_effective": (self._adaptive_spec_k(self.spec_k)
                                     if self.spec_k > 0 else 0),
                "spec_accept_window": (round(sum(a for a, _ in win)
                                             / proposed, 4)
                                       if proposed else None)}

    # -- row lifecycle ----------------------------------------------------
    def _release(self, slot):
        self._free.append(slot)
        self._temp[slot] = 0.0      # a stale temperature > 0 would keep
        self._topk[slot] = 0        # the bank off its greedy graph
        self.engine.release_slot(slot)

    def _finish(self, req, error=None):
        slot = req.slot
        if slot is not None and self._active.get(slot) is req:
            del self._active[slot]
            self._release(slot)
        if req.done():                 # abandoned by its waiter
            return
        if error is not None:
            req.set_error(error)
            if self.stats:
                self.stats.bump("requests_failed")
            return
        req.set_result([np.asarray(req.out_tokens, np.int32)])
        record_class_done(req.priority, time.monotonic() - req.t_enqueue)
        if self.stats:
            self.stats.bump("requests_completed")
            self.stats.hist["total"].observe(
                time.monotonic() - req.t_enqueue)

    def _deliver_token(self, req, tok):
        """Record one sampled token; finish the row on EOS or budget.
        Returns True while the row stays live."""
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req)
            return False
        req.out_tokens.append(tok)
        if self.stats:
            self.stats.bump("tokens_generated")
        if len(req.out_tokens) >= req.max_new_tokens:
            self._finish(req)
            return False
        return True

    def _join_bank(self, req, slot, tok):
        """A prefilled (or imported) row enters the decode bank, or, for
        a prefill-only request, delivers its KV payload."""
        if self.stats:
            self.stats.bump("generate_requests")
        if req.export_kv:
            self._finish_export(req, slot, int(tok))
            return
        req.slot = slot
        self._active[slot] = req
        self._pos[slot] = req.prompt.size
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._tok[slot] = tok
        self._deliver_token(req, int(tok))

    def _finish_export(self, req, slot, tok):
        """A prefill-only request: the slot's blocks are serialized as
        the reply (``first_token`` and ``prompt_tokens`` inside) and the
        slot is freed at once; the row decodes elsewhere."""
        try:
            payload = self.engine.export_slot(slot)
        except Exception as exc:  # noqa: BLE001 — typed to the client
            self._release(slot)
            if not req.done():
                req.set_error(exc)
                if self.stats:
                    self.stats.bump("requests_failed")
            return
        self._release(slot)
        payload["first_token"] = tok
        payload["prompt_tokens"] = int(req.prompt.size)
        if req.done():
            return
        req.set_result([payload])
        if self.stats:
            self.stats.bump("kv_exports")
            self.stats.bump("requests_completed")
            self.stats.hist["total"].observe(
                time.monotonic() - req.t_enqueue)

    def _check_deadlines(self, now):
        for req in list(self._active.values()):
            if req.expired(now):
                waited = (now - req.t_enqueue) * 1e3
                if self.stats:
                    self.stats.bump("shed_deadline")
                self._finish(req, DeadlineExceededError(
                    f"token-level deadline of {req.deadline_ms:.1f}ms "
                    f"exceeded after {waited:.1f}ms with "
                    f"{len(req.out_tokens)} tokens generated",
                    deadline_ms=req.deadline_ms, waited_ms=waited))
        still = []
        for st in self._prefilling:
            req = st["req"]
            if not (req.done() or req.expired(now)):
                still.append(st)
                continue
            if not req.done():
                waited = (now - req.t_enqueue) * 1e3
                if self.stats:
                    self.stats.bump("shed_deadline")
                req.set_error(DeadlineExceededError(
                    f"deadline of {req.deadline_ms:.1f}ms exceeded after "
                    f"{waited:.1f}ms mid chunked prefill",
                    deadline_ms=req.deadline_ms, waited_ms=waited))
            self._release(st["slot"])
        self._prefilling[:] = still

    # -- speculative decoding ---------------------------------------------
    def _get_drafter(self):
        if self._drafter is None:
            from ..models.generation import make_drafter
            self._drafter = make_drafter(generator=self.engine.gen)
        return self._drafter

    def _adaptive_spec_k(self, k):
        """The draft depth from the windowed acceptance rate: below 50%
        half of K, below 25% one draft (never 0, so the window keeps
        measuring); K until 32 drafts were proposed."""
        proposed = sum(p for _, p in self._accept_window)
        if proposed < 32:
            return k
        rate = sum(a for a, _ in self._accept_window) / proposed
        if rate >= 0.5:
            return k
        if rate >= 0.25:
            return max(k // 2, 1)
        return 1

    def _propose_drafts(self, k):
        """np int32 ``(drafts [slots, k], num_draft [slots])`` for every
        live row: the adapted depth, capped to the row's remaining budget
        minus one (a verify step always emits one real token)."""
        drafts = np.zeros((self.slots, k), np.int32)
        nd = np.zeros((self.slots,), np.int32)
        k_eff = self._adaptive_spec_k(k)
        for slot, req in self._active.items():
            kr = k_eff
            if self.brownout is not None:
                kr = self.brownout.draft_depth(req.rank, kr)
            kr = min(int(kr), req.max_new_tokens - len(req.out_tokens) - 1)
            if kr <= 0:
                continue
            ctx = np.concatenate([req.prompt,
                                  np.asarray(req.out_tokens, np.int32)])
            d = np.asarray(self._get_drafter().draft(ctx, kr),
                           np.int32).reshape(-1)[:kr]
            drafts[slot, :d.size] = d
            nd[slot] = d.size
        return drafts, nd

    def _deliver_spec(self, out, acc, nd):
        """Deliver one verify step: slot s takes ``acc[s]`` drafts and the
        correction or bonus token, stopping at EOS or budget (the rest of
        the span is garbage past the row's position, overwritten before
        it is ever read)."""
        accepted = proposed = rejected = 0
        for slot in list(self._active):
            req = self._active[slot]
            if req.done():
                self._finish(req)
                continue
            a, n = int(acc[slot]), int(nd[slot])
            accepted += a
            proposed += n
            if a < n:
                rejected += 1
                _flightrec().record("spec_rejected", slot=slot,
                                    proposed=n, accepted=a)
            alive = True
            for j in range(a + 1):
                alive = self._deliver_token(req, int(out[slot, j]))
                if not alive:
                    break
            if alive:
                self._pos[slot] += a + 1
                self._tok[slot] = int(out[slot, a])
        self._accept_window.append((accepted, proposed))
        if self.stats:
            self.stats.bump("spec_steps")
            self.stats.bump("spec_drafted", proposed)
            self.stats.bump("spec_accepted", accepted)
            self.stats.bump("spec_rejected", rejected)
        win_p = sum(p for _, p in self._accept_window)
        if win_p:
            record_spec_accept_ratio(
                self._spec_scope,
                sum(a for a, _ in self._accept_window) / win_p)

    # -- admission --------------------------------------------------------
    def _admit(self, epoch):
        try:
            self._admit_inner(epoch)
        except BaseException:
            # a crash mid-collection (a queue fault on a later pop) must
            # not drop the requests already taken off the queue
            for req in self._admitting_reqs:
                if not req.done():
                    req.set_error(ServingError(
                        "decode loop crashed during admission"))
                    if self.stats:
                        self.stats.bump("requests_failed")
            raise
        finally:
            self._admitting_reqs = []
            self._admitting = 0

    def _admit_inner(self, epoch):
        take = self._admitting_reqs
        while len(take) < len(self._free) and not self._stop.is_set() \
                and self._epoch == epoch:
            # block briefly only while the bank is idle
            timeout = 0.05 if not (self._active or self._prefilling
                                   or take) else 0
            req = self.queue.get(timeout=timeout)
            if req is None:
                break
            try:
                self.engine.admission_check(
                    req.prompt.size, req.max_new_tokens,
                    pending_tokens=[r.prompt.size for r in take])
            except ServerOverloadedError as exc:
                req.set_error(exc)            # typed shed: back off, retry
                if self.stats:
                    self.stats.bump("shed_overload")
                continue
            except ServingError as exc:
                req.set_error(exc)
                if self.stats:
                    self.stats.bump("requests_failed")
                continue
            _record_queue_span(req, time.monotonic())
            take.append(req)
            self._admitting = len(take)
        if not take:
            return
        if self._epoch != epoch:
            self._fail_deposed(take)
            return
        fresh = [r for r in take if r.kv is None]
        imported = [r for r in take if r.kv is not None]
        if fresh and self.engine.incremental_prefill_enabled():
            for req in fresh:
                slot = self._free.pop()
                try:
                    st = self.engine.start_prefill(req, slot)
                except Exception as exc:  # noqa: BLE001 — to the client
                    self._release(slot)
                    req.set_error(exc)
                    if self.stats:
                        self.stats.bump("requests_failed")
                    continue
                req.slot = slot
                self._prefilling.append(st)
            fresh = []
        # fresh prompts admit as one batch; each migrated payload alone,
        # so one refused payload fails only its own request
        groups = ([(fresh, self.engine.admit)] if fresh else []) \
            + [([r], self.engine.admit_imported) for r in imported]
        for group, admit in groups:
            slots = [self._free.pop() for _ in group]
            try:
                first = admit(group, slots)
            except Exception as exc:  # noqa: BLE001 — reaches the clients
                for req in group:
                    req.set_error(exc)
                    if self.stats:
                        self.stats.bump("requests_failed")
                if self._epoch != epoch:
                    # deposed: the slot bank is the restarted loop's
                    self._fail_deposed(take)
                    return
                self._free.extend(slots)
                if isinstance(exc, BadRequestError):
                    continue        # the request's own fault, not the card's
                self.consecutive_failures += 1
                if self.stats:
                    self.stats.bump("engine_failures")
                self._fail_active_if_bank_lost(exc)
                continue
            if self._epoch != epoch:
                self._fail_deposed(take)
                return
            if admit is not self.engine.admit and self.stats:
                self.stats.bump("kv_imports", len(group))
            for tok, req, slot in zip(first, group, slots):
                self._join_bank(req, slot, tok)

    def _fail_deposed(self, take):
        """The loop was restarted while this deposed thread held requests
        it had popped: fail each (the restarted loop never sees them)."""
        for req in take:
            if not req.done():
                req.set_error(ServingError(
                    "decode loop restarted during admission; the "
                    "request's prefill was discarded"))
                if self.stats:
                    self.stats.bump("requests_failed")

    def _fail_active_if_bank_lost(self, exc):
        """After an engine failure that cost the bank (``engine.bank_lost``:
        a watchdog trip released the pool's device arrays), the keys and
        values of every row decoding or mid chunked prefill are gone:
        fail those rows rather than let them run on a fresh bank."""
        if not getattr(self.engine, "bank_lost", False):
            return
        err = ServingError(f"decode slot bank lost to an engine failure "
                           f"({type(exc).__name__}: {exc}); the row's "
                           f"cache is unrecoverable")
        for req in list(self._active.values()):
            self._finish(req, err)
        for st in self._prefilling:
            self._release(st["slot"])
            if not st["req"].done():
                st["req"].set_error(err)
                if self.stats:
                    self.stats.bump("requests_failed")
        self._prefilling = []

    def _advance_prefill(self, epoch):
        """Advance the oldest chunked prefill by one chunk (round robin);
        a finished prompt samples its first token and joins the bank."""
        if not self._prefilling:
            return
        st = self._prefilling.pop(0)
        req, slot = st["req"], st["slot"]
        if req.done():                  # abandoned mid-prefill
            self._release(slot)
            return
        try:
            done = self.engine.prefill_chunk(st)
            tok = self.engine.finish_prefill(st) if done else None
        except Exception as exc:  # noqa: BLE001 — reaches the client
            if self._epoch != epoch:
                return          # deposed: restart() owns the row state
            self._release(slot)
            req.set_error(exc)
            if isinstance(exc, ServerOverloadedError):
                if self.stats:
                    self.stats.bump("shed_overload")
                return
            self.consecutive_failures += 1
            if self.stats:
                self.stats.bump("engine_failures")
                self.stats.bump("requests_failed")
            self._fail_active_if_bank_lost(exc)
            return
        if self._epoch != epoch:
            return
        if not done:
            self._prefilling.append(st)
            return
        self._join_bank(req, slot, tok)

    # -- core loop --------------------------------------------------------
    def _shed(self, shed):
        for slot, exc in shed.items():
            req = self._active.get(slot)
            if req is None:
                continue
            if isinstance(exc, ServerOverloadedError):
                if not req.done():
                    req.set_error(exc)
                if self.stats:
                    self.stats.bump("shed_overload")
                self._finish(req)
            else:
                self._finish(req, exc)

    def _step(self, epoch):
        """Draft (speculative rows), grow and copy-on-write the blocks the
        step writes, run the step under the watchdog and deliver its
        tokens."""
        drafts = nd = None
        if self.spec_k > 0:
            drafts, nd = self._propose_drafts(self.spec_k)
        widths = None if nd is None else {
            slot: int(nd[slot]) + 1 for slot in self._active}
        self._shed(self.engine.prepare_step(
            {slot: int(self._pos[slot]) for slot in self._active},
            widths=widths))
        if not self._active:
            return
        # per-token spans for traced rows only (sampled at the client):
        # untraced traffic pays one list over <= slots entries a step
        traced = [r for r in self._active.values() if r.trace is not None]
        t0 = time.perf_counter()
        live = np.zeros((self.slots,), bool)
        live[list(self._active)] = True
        budget = self.watchdog_s or None
        try:
            if drafts is not None:
                out, acc = self.engine.spec_step(
                    self._tok, self._pos, self._temp, self._topk, drafts,
                    nd, live, budget=budget)
            else:
                toks = self.engine.step(self._tok, self._pos, self._temp,
                                        self._topk, live, budget=budget)
        except Exception as exc:  # noqa: BLE001 — fail the rows
            if self._epoch != epoch:
                return          # deposed mid-step: restart() owns the rows
            self.consecutive_failures += 1
            if self.stats:
                self.stats.bump("engine_failures")
                if isinstance(exc, WatchdogTimeout):
                    self.stats.bump("watchdog_timeouts")
            for req in list(self._active.values()):
                self._finish(req, exc)
            self._fail_active_if_bank_lost(exc)
            if not isinstance(exc, WatchdogTimeout):
                # a step that failed otherwise than by the watchdog (which
                # released the bank itself) leaves the bank and its graphs
                # in a state the loop cannot vouch for: the loop ends here
                # and the supervisor restarts it on a reset engine
                raise
            return
        if self._epoch != epoch:
            return              # deposed while blocked in the step
        self.consecutive_failures = 0
        t1 = time.perf_counter()
        for r in traced:
            _trace.record_child("serving/decode", t0, t1, r.trace)
        if self.stats:
            self.stats.hist["token"].observe(t1 - t0)
            self.stats.observe_decode_step(len(self._active), self.slots)
        if drafts is not None:
            self._deliver_spec(out, acc, nd)
            return
        for slot in list(self._active):
            req = self._active[slot]
            if req.done():            # abandoned or cancelled
                self._finish(req)
                continue
            self._pos[slot] += 1
            self._tok[slot] = toks[slot]
            self._deliver_token(req, int(toks[slot]))

    def _loop(self):
        epoch = self._epoch
        try:
            while not self._stop.is_set() and self._epoch == epoch:
                self.heartbeat = time.monotonic()
                sw = self._swap
                if sw is not None:
                    # a parked swap stops admission so the bank drains; the
                    # rows in flight run on the old weights
                    if not (self._active or self._prefilling):
                        sw.apply()
                        with self._swap_lock:
                            if self._swap is sw:
                                self._swap = None
                        continue
                else:
                    self._admit(epoch)
                if not (self._active or self._prefilling):
                    continue
                self._check_deadlines(time.monotonic())
                self._advance_prefill(epoch)
                if self._epoch != epoch:
                    return
                if self._active:
                    self._step(epoch)
                    if self._epoch != epoch:
                        return
                self._steps_since_sweep += 1
                if self._steps_since_sweep >= 256:
                    self._steps_since_sweep = 0
                    self.engine.reclaim_leaks(
                        list(self._active)
                        + [st["slot"] for st in self._prefilling])
        finally:
            # a deposed thread (restart() owns the row state) touches
            # nothing; otherwise the rows still in flight fail typed
            if self._epoch == epoch:
                self._admitting = 0
                for req in list(self._active.values()):
                    self._finish(req, ServerShutdownError(
                        "server stopped while the request was decoding"))
                for st in self._prefilling:
                    self._release(st["slot"])
                    if not st["req"].done():
                        st["req"].set_error(ServerShutdownError(
                            "server stopped while the request was "
                            "prefilling"))
                self._prefilling = []
                with self._swap_lock:
                    sw, self._swap = self._swap, None
                if sw is not None:
                    sw.fail(ServerShutdownError(
                        "decode loop exited with the weight swap pending"))
