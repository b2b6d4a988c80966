"""Generation requests, the admission queue and the continuous decode
batcher.

Counterpart of ``paddle_tpu/serving/batching.py``, cut to what the
generation path needs: the typed serving errors, ``next_bucket``,
``GenerationRequest``, a bounded ``RequestQueue`` (depth backpressure,
deadline at admission, typed refusal once closed) and ``DecodeBatcher``
— ORCA-style iteration-level scheduling over a fixed bank of decode
slots: requests are admitted between steps, a row finishes on EOS, on
its token budget or on its deadline and frees its slot at once, and rows
still in flight when the loop stops fail with a typed error.
"""
import threading
import time
from collections import deque

import numpy as np


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


class InternalServerError(ServingError):
    """Client-side face of an ``etype: "Internal"`` reply."""


class BadRequestError(ServingError):
    """The request was validated and refused (overlong prompt, malformed
    input): retrying without fixing it cannot help. Wire ``etype:
    "BadRequest"``."""


def next_bucket(rows, min_bucket=1):
    """Smallest power-of-two >= rows (>= min_bucket): bounded padding
    waste (< 2x) and a bounded universe of shapes."""
    b = max(int(min_bucket), 1)
    rows = max(int(rows), 1)
    while b < rows:
        b <<= 1
    return b


class GenerationRequest:
    """One generation request: a 1-D int prompt plus sampling knobs and
    a token-level deadline (re-checked between decode steps). The reply
    arrives through :meth:`wait`: ``[np.int32 new tokens]``, or the
    recorded error is raised."""

    def __init__(self, prompt, max_new_tokens=32, temperature=0.0, top_k=0,
                 eos_id=None, deadline_ms=None):
        prompt = np.asarray(prompt, dtype=np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("generation request has an empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.out_tokens = []
        self.slot = None
        self.deadline_ms = deadline_ms
        self.t_enqueue = time.monotonic()
        self.deadline_at = (self.t_enqueue + deadline_ms / 1e3
                            if deadline_ms else None)
        self.result = None
        self.error = None
        self._done = threading.Event()

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


class RequestQueue:
    """Bounded FIFO with admission control: ``put`` refuses in O(1) when
    the queue is at ``max_depth`` (:class:`ServerOverloadedError`), when
    the request's deadline already passed, or once :meth:`close` ran
    (:class:`ServerShutdownError`). ``get`` skips and fails entries whose
    deadline expired while queued."""

    def __init__(self, max_depth=None, stats=None):
        if max_depth is None:
            from ..flags import flag
            max_depth = flag("serving_queue_depth")
        self.max_depth = int(max_depth)
        self.stats = stats
        self._items = deque()
        self._cv = threading.Condition()
        self._closed = False

    def __len__(self):
        with self._cv:
            return len(self._items)

    def put(self, req):
        if req.expired():
            if self.stats:
                self.stats.bump("shed_deadline")
            req.expire(where="admission")
            raise req.error
        with self._cv:
            if self._closed:
                raise ServerShutdownError("server is shutting down")
            if len(self._items) >= self.max_depth:
                if self.stats:
                    self.stats.bump("shed_overload")
                raise ServerOverloadedError(
                    f"request queue at depth limit ({self.max_depth}); "
                    f"retry with backoff")
            self._items.append(req)
            self._cv.notify()
        if self.stats:
            self.stats.bump("requests_admitted")
        return req

    def get(self, timeout=None):
        """Oldest live request, or None on timeout/close."""
        dead, out = [], None
        with self._cv:
            if not self._items and not self._closed:
                self._cv.wait(timeout)
            now = time.monotonic()
            while self._items:
                req = self._items.popleft()
                if req.done():                # abandoned while queued
                    continue
                if req.expired(now):
                    dead.append(req)
                    continue
                out = req
                break
        for req in dead:
            if self.stats:
                self.stats.bump("shed_deadline")
            req.expire(where="queue")
        return out

    def wake(self):
        with self._cv:
            self._cv.notify_all()

    def close(self):
        """Stop admitting; fail whatever is still queued at once."""
        with self._cv:
            self._closed = True
            drained = list(self._items)
            self._items.clear()
            self._cv.notify_all()
        for req in drained:
            req.set_error(ServerShutdownError(
                "server shut down with the request still queued"))


class DecodeBatcher:
    """Continuous batching over the engine's bank of decode slots: one
    thread admits queued requests into free slots (prefill + first
    token), then steps the whole bank one token at a time. Per-row state
    (position, current token, sampling config) lives here; the KV state
    lives in the ``GenerationEngine``."""

    def __init__(self, queue, engine, stats=None):
        self.queue = queue
        self.engine = engine
        self.slots = engine.slots
        self.stats = stats
        self._stop = threading.Event()
        self._thread = None
        self._free = list(range(self.slots))
        self._active = {}                       # slot -> request
        self._tok = np.zeros((self.slots,), np.int32)
        self._pos = np.zeros((self.slots,), np.int32)
        self._temp = np.zeros((self.slots,), np.float32)
        self._topk = np.zeros((self.slots,), np.int32)

    # -- lifecycle --------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-decode-batcher")
        self._thread.start()
        return self

    def free_slots(self):
        return len(self._free)

    def stop(self, timeout=30):
        """Stop the loop; rows still decoding fail with
        :class:`ServerShutdownError` (the loop does it on its way out)."""
        self._stop.set()
        self.queue.wake()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- row lifecycle ----------------------------------------------------
    def _finish(self, req, error=None):
        slot = req.slot
        if slot is not None and self._active.get(slot) is req:
            del self._active[slot]
            self._free.append(slot)
            self._temp[slot] = 0.0
            self._topk[slot] = 0
            self.engine.release_slot(slot)
        if req.done():                 # abandoned by its waiter
            return
        if error is not None:
            req.set_error(error)
            if self.stats:
                self.stats.bump("requests_failed")
            return
        req.set_result([np.asarray(req.out_tokens, np.int32)])
        if self.stats:
            self.stats.bump("requests_completed")
            self.stats.hist["total"].observe(
                time.monotonic() - req.t_enqueue)

    def _deliver_token(self, req, tok):
        """Record one sampled token; finish the row on EOS or budget."""
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req)
            return
        req.out_tokens.append(tok)
        if self.stats:
            self.stats.bump("tokens_generated")
        if len(req.out_tokens) >= req.max_new_tokens:
            self._finish(req)

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

    # -- admission --------------------------------------------------------
    def _admit(self):
        take = []
        while len(take) < len(self._free) and not self._stop.is_set():
            # block briefly only while the bank is idle
            timeout = 0.05 if not (self._active or take) else 0
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
            take.append(req)
        if not take:
            return
        slots = [self._free.pop() for _ in take]
        try:
            first = self.engine.admit(take, slots)
        except Exception as exc:  # noqa: BLE001 — reaches the clients
            self._free.extend(slots)
            for req in take:
                req.set_error(exc)
                if self.stats:
                    self.stats.bump("requests_failed")
            return
        for tok, req, slot in zip(first, take, slots):
            if self.stats:
                self.stats.bump("generate_requests")
            req.slot = slot
            self._active[slot] = req
            self._pos[slot] = req.prompt.size
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._tok[slot] = tok
            self._deliver_token(req, int(tok))

    # -- core loop --------------------------------------------------------
    def _loop(self):
        try:
            while not self._stop.is_set():
                self._admit()
                if not self._active:
                    continue
                self._check_deadlines(time.monotonic())
                shed = self.engine.prepare_step(
                    {slot: int(self._pos[slot]) for slot in self._active})
                for slot, exc in shed.items():
                    if slot in self._active:
                        if self.stats and isinstance(
                                exc, ServerOverloadedError):
                            self.stats.bump("shed_overload")
                        self._finish(self._active[slot], exc)
                if not self._active:
                    continue
                t0 = time.perf_counter()
                try:
                    toks = self.engine.step(self._tok, self._pos,
                                            self._temp, self._topk)
                except Exception as exc:  # noqa: BLE001 — fail the rows
                    if self.stats:
                        self.stats.bump("engine_failures")
                    for req in list(self._active.values()):
                        self._finish(req, exc)
                    continue
                if self.stats:
                    self.stats.hist["token"].observe(
                        time.perf_counter() - t0)
                    self.stats.observe_decode_step(len(self._active),
                                                   self.slots)
                for slot in list(self._active):
                    req = self._active[slot]
                    if req.done():            # abandoned by its waiter
                        self._finish(req)
                        continue
                    self._pos[slot] += 1
                    self._tok[slot] = toks[slot]
                    self._deliver_token(req, int(toks[slot]))
        finally:
            for req in list(self._active.values()):
                self._finish(req, ServerShutdownError(
                    "server stopped while the request was decoding"))
