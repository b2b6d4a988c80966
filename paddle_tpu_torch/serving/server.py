"""Prediction and generation service over the typed wire framing.

Counterpart of ``paddle_tpu/serving/server.py`` (``ServingConfig``,
``InferenceServer``, ``Client``). ``InferenceServer(model_dir)`` serves a
saved inference model: connection threads speak the length-prefixed,
HMAC-optional frames of ``distributed/wire.py``, admission happens on
the connection thread (backpressure is refused at once, never queued),
and one ``MicroBatcher`` thread feeds the ``ServingEngine`` padded
batches of requests grouped across clients. ``generator=`` adds the
generation endpoint: one ``DecodeBatcher`` thread drives the decode
bank, and the ``prefill`` op with ``generate``'s ``kv=`` split a request
between two servers (disaggregated prefill and decode over the wire).

Resilience: the server walks a lifecycle (created -> warming -> serving
-> draining -> stopped, and serving <-> degraded while the loop
supervisor's breaker is open: generation then sheds, ``ping``,
``health`` and ``stats`` answer). A ``supervise.LoopSupervisor``
restarts a crashed or hung batcher loop; each execute and decode step
runs under ``FLAGS_serving_loop_watchdog_s``; a breached SLO walks the
``brownout`` ladder (lowest priority class shed first). ``drain()``
closes admission and lets in-flight work finish; ``reload_weights()``
swaps a manifest-verified checkpoint in without dropping traffic (an
in-place copy into the live tensors: in-flight generations finish on the
old weights, queued ones wait, later ones read the new). Requests may
carry a client request id (``rid``): a twin with the same id joins the
first's execution (a hedged pair runs once) and ``cancel`` fails it
typed. ``FLAGS_serving_default_deadline_ms`` is the infer requests'
default deadline. The ``Client`` reconnects once after a bounce,
retries its idempotent ops (``resilience.retry_call``), sends each
deadline as the budget left, and hedges ``infer`` (``hedge_ms``) under
the process retry budget. Fault point: ``serving.handle``.

Wire protocol:

    request  {"op": "infer", "feed": {name: ndarray},
              "deadline_ms": float|None, "priority": str|None}
    reply    {"ok": True, "fetch": (ndarray, ...), "batched": int}
    request  {"op": "generate", "tokens": int array, "max_new_tokens": int,
              "temperature": float, "top_k": int, "eos_id": int|None,
              "deadline_ms": float|None}
    reply    {"ok": True, "tokens": int32 array, "generated": int}
             (with "kv": payload and "first_token": int the request
              decodes migrated KV blocks from that token: no prefill)
    request  {"op": "prefill", "tokens": int array, "max_new_tokens": int,
              "temperature": float, "top_k": int,
              "deadline_ms": float|None}
    reply    {"ok": True, "kv": payload, "first_token": int}
             (the prefill half of disaggregated serving: the prompt's KV
              blocks out of the paged pool, KVBlockPool.export_slot's
              payload with first_token and prompt_tokens inside)
    error    {"ok": False, "etype": "DeadlineExceeded"|"Overloaded"
                                    |"Shutdown"|"Cancelled"|"Watchdog"
                                    |"CheckpointCorrupt"|"BadRequest"
                                    |"TPGroupLost"|"Internal",
              "error": str}
    (``infer``, ``generate`` and ``prefill`` may carry "rid": str and
     "priority": str)
    request  {"op": "health"}  -> {"ok": True, "health": {state, queue
             depths, loop liveness and restarts, breaker, weights_version,
             brownout_level, kvpool occupancy (paged)}}
    request  {"op": "cancel", "rid": str} -> {"ok": True, "cancelled": bool}
    request  {"op": "reload_weights", "path": str, "timeout": float}
             -> {"ok": True, "weights_version": int, "swap_pause_ms": float}
    request  {"op": "stats"}   -> {"ok": True, "stats": {...}}
    request  {"op": "metrics"} -> {"ok": True, "metrics": str}
             (Prometheus text exposition of the process metrics registry)
    request  {"op": "debug_dump", "write": bool}
             -> {"ok": True, "events": [...], "path": str|None}
             (the flight recorder's events; with write, also a JSON dump
              server-side)
    request  {"op": "ping"}    -> {"ok": True}

Tensor-parallel generation (``generator=GPTGenerator(tp=N)``, every rank
of a launched world of N running the same script): the tp group's
leader (tp index 0) builds the server above over a
``serving.tp.TPLeaderEngine`` and alone binds the port; on every other
rank ``start()`` runs the follower loop (``serving.tp.TPFollower``) and
nothing else, and ``join()`` waits for the leader's ``drain``/``stop``
to end it. ``health`` lists the ranks (``tp_ranks``) and whether the
group is lost (``tp_group``); a lost group fails every request queued
and in flight with ``TPGroupLostError`` (etype ``"TPGroupLost"``, a
port-only reply) and is not restarted. A world larger than N raises:
replicas behind a router are ROADMAP.md Queue 1 item 8b.

Tracing: ``infer``, ``generate``, ``prefill``, ``stats`` and ``metrics``
requests may carry a ``"trace"`` dict (``{"tid", "sid"}``, the JAX
package's), minted by the ``Client`` at ``FLAGS_trace_sample_rate`` or
taken from an ambient ``tracing.span``. The client records
``client/send``; the server records ``serving/handle`` (or
``serving/<op>``) around the request and ``serving/reply`` around the
reply, and the request's stages parent under the handler span. Under
``FLAGS_slo_monitor`` ``start()`` runs the default SLO monitor
(``observability.slo.default_server_rules``, or ``slo_rules=``).
"""
import contextlib
import socket
import threading
import time
import uuid
from collections import OrderedDict, deque

import numpy as np

from ..distributed.wire import WireError, default_key, recv_frame, send_frame
from ..observability import tracing as _trace
from ..observability.metrics import render_metrics
from ..observability.recorder import flight_recorder as _flightrec
from ..resilience import (CheckpointCorruptError, CircuitBreaker,
                          WatchdogTimeout, default_retry_budget, maybe_fail,
                          retry_call)
from .batching import (BadRequestError, DeadlineExceededError,
                       DecodeBatcher, GenerationRequest, InternalServerError,
                       MicroBatcher, Request, RequestCancelledError,
                       RequestQueue, ServerOverloadedError,
                       ServerShutdownError, priority_rank,
                       remaining_budget_ms)
from .brownout import BrownoutController
from .engine import GenerationEngine, ServingEngine
from .metrics import ServingStats, record_class_shed
from .supervise import LoopSupervisor
from .tp import TPGroupLostError


class ServingConfig:
    """Serving knobs, each defaulting from its ``FLAGS_serving_*`` flag:
    ``max_batch_size``, ``batch_timeout_ms``, ``queue_depth``,
    ``default_deadline_ms``, ``cache_entries``, ``cache_bytes``,
    ``shed_failures``, ``shed_reset_secs`` and ``loop_watchdog_s``."""

    _FLAG_FIELDS = {
        "max_batch_size": "serving_max_batch_size",
        "batch_timeout_ms": "serving_batch_timeout_ms",
        "queue_depth": "serving_queue_depth",
        "default_deadline_ms": "serving_default_deadline_ms",
        "cache_entries": "serving_cache_entries",
        "cache_bytes": "serving_cache_bytes",
        "shed_failures": "serving_shed_failures",
        "shed_reset_secs": "serving_shed_reset_secs",
        "loop_watchdog_s": "serving_loop_watchdog_s",
    }

    def __init__(self, **overrides):
        from ..flags import flag
        for field, fname in self._FLAG_FIELDS.items():
            val = overrides.pop(field, None)
            setattr(self, field, flag(fname) if val is None else val)
        if overrides:
            raise TypeError(f"unknown ServingConfig fields: "
                            f"{sorted(overrides)}")


class InferenceServer:
    """Serving front end of a saved inference model and/or a generator:

        server = InferenceServer(model_dir, max_batch_size=64).start()
        out = server.infer({"x": batch})           # or submit() for async
        fetch = Client(server.endpoint).infer({"x": batch})

        server = InferenceServer(generator=gen, decode_slots=8,
                                 paged=True).start()
        tokens = Client(server.endpoint).generate(prompt, 32)

    ``place`` (None: the GPU) is where the model runs. ``start()`` binds
    a socket (default loopback, OS-assigned port). Set
    ``PADDLE_PS_AUTH_KEY`` (or ``auth_key=``) on both ends to
    authenticate frames; a non-loopback bind without a key is refused
    unless ``allow_insecure=True``. ``slo_rules``: the SLO monitor's
    rules (a list, ``[]`` for none, or a callable of the server; None:
    ``observability.slo.default_server_rules``)."""

    def __init__(self, model_dir=None, *, engine=None, generator=None,
                 decode_slots=None, paged=None, config=None, place=None,
                 host="127.0.0.1", port=0, auth_key=None,
                 allow_insecure=False, slo_rules=None, **config_overrides):
        self.config = config or ServingConfig(**config_overrides)
        self.stats_sink = ServingStats()
        # tensor-parallel generation (serving.tp): the tp group's leader
        # serves, every other rank runs the follower loop and nothing else
        tp = getattr(generator, "tp", 1) if generator is not None else 1
        self.tp_follower = None
        follower = tp > 1 and generator.mesh.coords()["tp"] != 0
        if engine is None and not follower \
                and (model_dir is not None or generator is None):
            from .cache import ExecutableCache
            cache = ExecutableCache(max_entries=self.config.cache_entries,
                                    max_bytes=self.config.cache_bytes)
            engine = ServingEngine(model_dir, cache=cache,
                                   stats=self.stats_sink, place=place)
        elif engine is not None:
            engine.stats = engine.stats or self.stats_sink
        self.engine = engine          # None for a generation-only server
        self.queue = self.batcher = None
        if engine is not None:
            self.queue = self._queue()
            self.batcher = MicroBatcher(
                self.queue, self.engine.execute,
                max_batch_size=self.config.max_batch_size,
                batch_timeout_ms=self.config.batch_timeout_ms,
                stats=self.stats_sink,
                watchdog_s=self.config.loop_watchdog_s)
        self.gen_engine = self.gen_queue = self.decode_batcher = None
        if tp > 1:
            from .tp import tp_generation_engine
            eng = tp_generation_engine(generator, slots=decode_slots,
                                       stats=self.stats_sink, paged=paged)
            if follower:
                self.tp_follower = eng
            else:
                self.gen_engine = eng
                eng.on_lost.append(self._on_tp_lost)
        elif generator is not None:
            self.gen_engine = GenerationEngine(
                generator, slots=decode_slots, stats=self.stats_sink,
                paged=paged)
        if self.gen_engine is not None:
            self.gen_queue = self._queue()
            self.decode_batcher = DecodeBatcher(
                self.gen_queue, self.gen_engine, stats=self.stats_sink,
                watchdog_s=self.config.loop_watchdog_s)
        # dead or hung loops restart with backoff; repeated restarts open
        # the supervisor's breaker: degraded (generation sheds)
        self.supervisor = LoopSupervisor(
            stats=self.stats_sink, watchdog_s=self.config.loop_watchdog_s,
            on_degraded=lambda: self._set_state("degraded",
                                                only_from=("serving",)),
            on_recovered=lambda: self._set_state("serving",
                                                 only_from=("degraded",)))
        if self.batcher is not None:
            self.supervisor.add("microbatcher", self.batcher)
        if self.decode_batcher is not None:
            self.supervisor.add("decode", self.decode_batcher)
        self._slo_rules = slo_rules
        self.slo_monitor = None
        # the brownout ladder reads the live SLO monitor's breaches; it is
        # also the decode bank's per-class draft-depth knob
        self.brownout = BrownoutController(
            lambda: (len(self.slo_monitor.breached())
                     if self.slo_monitor is not None else 0),
            scope=f"server-{id(self) & 0xffffff:x}")
        if self.decode_batcher is not None:
            self.decode_batcher.brownout = self.brownout
        self.host = host
        self.port = int(port)
        self._key = auth_key if auth_key is not None else default_key()
        self._allow_insecure = allow_insecure
        self._sock = None
        self._stop = threading.Event()
        self._threads = []
        self._conns = set()
        self._conns_lock = threading.Lock()
        self._started_at = time.monotonic()
        self._state_lock = threading.Lock()
        self._lifecycle = "created"
        self._weights_version = 1
        # request-id table: a twin joins the first's in-flight request
        # (a hedged pair executes once); LRU-capped
        self._rids = OrderedDict()
        self._rids_lock = threading.Lock()
        self._rid_cap = 2048
        # requests whose wire handler has not sent its reply yet: drain()
        # waits for them too, so stop() never cuts a reply off
        self._replying = 0
        self._replying_lock = threading.Lock()

    def _queue(self):
        return RequestQueue(
            max_depth=self.config.queue_depth, stats=self.stats_sink,
            breaker=CircuitBreaker(
                endpoint="serving-admission",
                failure_threshold=self.config.shed_failures,
                reset_timeout=self.config.shed_reset_secs))

    @property
    def endpoint(self):
        return f"{self.host}:{self.port}"

    @property
    def state(self):
        """created -> warming -> serving -> draining -> stopped, and
        serving <-> degraded while the supervisor's breaker is open."""
        with self._state_lock:
            return self._lifecycle

    def _set_state(self, new, only_from=None):
        with self._state_lock:
            if self._lifecycle == "stopped":      # terminal
                return False
            if only_from is not None and self._lifecycle not in only_from:
                return False
            self._lifecycle = new
            return True

    def start(self, serve_network=True, warmup_batch_sizes=None,
              warmup_signature_file=None):
        """Start the batchers, their supervisor and (unless
        ``serve_network=False``) the socket front end. Warmup captures
        the model's programs at the buckets of ``warmup_batch_sizes``
        (and the recorded signatures) before the first request. On a
        tensor-parallel follower rank it starts the follower loop
        (:meth:`join` waits for the leader to end it)."""
        if self.tp_follower is not None:
            self.tp_follower.start()
            self._set_state("serving")
            return self
        self._set_state("warming")
        if (warmup_batch_sizes or warmup_signature_file) \
                and self.engine is not None:
            self.engine.warmup(batch_sizes=warmup_batch_sizes or (),
                               signature_file=warmup_signature_file)
        if serve_network:
            loopback = self.host.startswith("127.") \
                or self.host in ("localhost", "::1")
            if not loopback and self._key is None \
                    and not self._allow_insecure:
                raise PermissionError(
                    f"refusing to bind the inference server on "
                    f"non-loopback {self.host}:{self.port} without "
                    f"authentication — set PADDLE_PS_AUTH_KEY (both "
                    f"ends) or pass allow_insecure=True")
        if self.batcher is not None:
            self.batcher.start()
        if self.decode_batcher is not None:
            self.decode_batcher.start()
        self.supervisor.start()
        if serve_network:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((self.host, self.port))
            self.port = self._sock.getsockname()[1]
            self._sock.listen(128)
            t = threading.Thread(target=self._accept_loop, daemon=True,
                                 name="serving-accept")
            t.start()
            self._threads.append(t)
        from ..flags import flag
        if flag("slo_monitor") and self.slo_monitor is None:
            from ..observability import slo as _slo
            if callable(self._slo_rules):
                rules = self._slo_rules(self)
            elif self._slo_rules is not None:
                rules = self._slo_rules         # [] = monitor off
            else:
                rules = _slo.default_server_rules(self)
            if rules:
                scope = self.endpoint if serve_network \
                    else f"server-{id(self) & 0xffffff:x}"
                self.slo_monitor = _slo.SloMonitor(rules,
                                                   scope=scope).start()
        self._set_state("serving", only_from=("warming", "created"))
        return self

    def join(self, timeout=None):
        """Wait until this rank's serving ends: a follower's loop (the
        leader's ``drain``/``stop`` ends it; returns the error that ended
        it otherwise), a leader's :meth:`stop`. Returns None."""
        if self.tp_follower is not None:
            return self.tp_follower.join(timeout)
        self._stop.wait(timeout)
        return None

    def _on_tp_lost(self, reason):
        """The tp group lost a rank: nothing more is admitted, and every
        request queued or in flight fails typed (a step blocked on the
        lost rank may never return)."""
        self._set_state("degraded", only_from=("serving", "warming"))
        err = TPGroupLostError(f"the serving tp group is lost: {reason}")
        if self.gen_queue is not None:
            self.gen_queue.close(error=err)
        if self.decode_batcher is not None:
            self.decode_batcher.fail_inflight(err)

    def _inflight(self):
        n = self._replying
        for q in (self.queue, self.gen_queue):
            if q is not None:
                n += len(q)
        for b in (self.batcher, self.decode_batcher):
            if b is not None:
                n += b.inflight()
        return n

    def drain(self, timeout=30.0):
        """Graceful shutdown: close admission (new requests get
        :class:`ServerShutdownError`), let every queued request, batch
        and decode row finish (deadlines stay enforced), then
        :meth:`stop`. ``ping``, ``stats`` and ``health`` answer
        throughout. Returns ``{"drained": bool, "remaining": n}``
        (``remaining``: requests the hard stop cut off at ``timeout``)."""
        self._set_state("draining")
        for q in (self.queue, self.gen_queue):
            if q is not None:
                q.quiesce()
        deadline = time.monotonic() + float(timeout)
        zero_streak = 0
        while time.monotonic() < deadline:
            if self._inflight() == 0:
                # consecutive zero reads: a request can sit between the
                # queue and a batcher for an instant
                zero_streak += 1
                if zero_streak >= 3:
                    break
            else:
                zero_streak = 0
            time.sleep(0.005)
        remaining = self._inflight()
        self.stop()
        return {"drained": remaining == 0, "remaining": remaining}

    def stop(self):
        """Close admission (queued requests fail typed), stop the
        supervisor and the batchers (requests still batching or decoding
        fail typed; a batch inside the engine finishes), close the socket
        and every connection, and join the threads."""
        self._set_state("stopped")
        if self.tp_follower is not None:
            return          # the leader's stop ends the follower loop
        if self.slo_monitor is not None:
            self.slo_monitor.stop()
            self.slo_monitor = None
        self.supervisor.stop()
        self._stop.set()
        for q in (self.queue, self.gen_queue):
            if q is not None:
                q.close()
        for b in (self.batcher, self.decode_batcher):
            if b is not None:
                b.stop()
        shutdown = getattr(self.gen_engine, "shutdown", None)
        if shutdown is not None:
            shutdown()              # ends the tp followers' loops
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- in-process path --------------------------------------------------
    def _brownout_gate(self, priority, max_new_tokens=None):
        """The brownout verdict at the infer and generate doors: raises
        the typed shed for a degraded class, else returns
        ``(max_new_tokens, depth_cap)`` with the class's cap applied."""
        shed, mnt, depth_cap = self.brownout.admission(
            priority_rank(priority), max_new_tokens=max_new_tokens,
            queue_depth=self.config.queue_depth)
        if shed:
            self.stats_sink.bump("shed_overload")
            record_class_shed(priority)
            raise ServerOverloadedError(
                f"brownout level {self.brownout.level()}: {priority} "
                f"traffic is shed while the server works off its SLO "
                f"breach; retry later or upgrade the request's class")
        return mnt, depth_cap

    def submit(self, feeds, deadline_ms=None, priority=None):
        """Admit an infer request (``{name: array}`` with a leading
        example dim); returns the Request (``.wait()`` -> the fetch
        list). Feeds other than the model's, in another dtype or with
        other trailing dims are refused with :class:`BadRequestError`;
        a full queue with :class:`ServerOverloadedError`. Without
        ``deadline_ms`` the config's ``default_deadline_ms`` (if > 0)
        applies."""
        if self.queue is None:
            raise BadRequestError("no inference model loaded: this server "
                                  "only serves 'generate'")
        self.engine.check_feeds(feeds)
        if deadline_ms is None and self.config.default_deadline_ms > 0:
            deadline_ms = self.config.default_deadline_ms
        _mnt, depth_cap = self._brownout_gate(priority)
        return self.queue.put(Request(
            {n: np.asarray(feeds[n]) for n in self.engine.feed_names},
            deadline_ms=deadline_ms, priority=priority),
            max_depth=depth_cap)

    def infer(self, feeds, deadline_ms=None, timeout=None, priority=None):
        """The fetch list (numpy arrays) of one infer request."""
        return self.submit(feeds, deadline_ms=deadline_ms,
                           priority=priority).wait(timeout=timeout)

    def submit_generate(self, tokens, max_new_tokens=32, temperature=0.0,
                        top_k=0, eos_id=None, deadline_ms=None,
                        export_kv=False, kv=None, first_token=None,
                        priority=None):
        """Admit a generation request; returns the GenerationRequest
        (``.wait()`` -> ``[np.int32 tokens]``, or ``[payload]`` with
        ``export_kv``). A request that could never run (prompt +
        max_new_tokens past the cache, or bigger than the whole pool), a
        migration without the paged pool, or a payload that does not
        cover this prompt is refused here with
        :class:`BadRequestError`; a degraded server, or a class the
        brownout ladder sheds, with :class:`ServerOverloadedError`.
        Generation deadlines are opt-in (the default deadline is an infer
        batch's)."""
        if self.gen_queue is None:
            raise BadRequestError("this server has no generator: pass "
                                  "generator= to InferenceServer")
        if getattr(self.gen_engine, "lost", None) is not None:
            raise self.gen_engine.lost_error()
        ntokens = np.asarray(tokens).size
        self.gen_engine.admission_check(ntokens, max_new_tokens,
                                        static_only=True)
        if (export_kv or kv is not None) and self.gen_engine.pool is None:
            raise BadRequestError(
                "disaggregated prefill/decode requires the paged KV pool "
                "(paged=True / FLAGS_kv_paged) — the dense bank's rows are "
                "not migratable")
        if kv is not None:
            claimed = kv.get("tokens") if isinstance(kv, dict) else None
            if claimed != ntokens:
                raise BadRequestError(
                    f"migrated KV payload covers {claimed!r} tokens but "
                    f"the prompt has {ntokens} — prefill and decode halves "
                    f"disagree")
        if self.state == "degraded":
            self.stats_sink.bump("shed_overload")
            raise ServerOverloadedError(
                "server is degraded (supervisor breaker open after "
                "repeated loop failures): generation is shed; "
                "ping/health/stats still answer")
        max_new_tokens, depth_cap = self._brownout_gate(
            priority, max_new_tokens=int(max_new_tokens))
        return self.gen_queue.put(GenerationRequest(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_id=eos_id, deadline_ms=deadline_ms,
            export_kv=export_kv, kv=kv, first_token=first_token,
            priority=priority), max_depth=depth_cap)

    def generate(self, tokens, max_new_tokens=32, temperature=0.0, top_k=0,
                 eos_id=None, deadline_ms=None, timeout=None, priority=None):
        """New tokens for one prompt as a 1-D np.int32 array."""
        return self.submit_generate(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_id=eos_id, deadline_ms=deadline_ms,
            priority=priority).wait(timeout=timeout)[0]

    def stats(self):
        """One snapshot: admission counters, stage histograms, batch
        occupancy, the captured-program cache's hits, misses and
        evictions, queue depths, the lifecycle state, the weights
        version and the brownout level."""
        extra = {}
        if self.queue is not None:
            extra["queue_depth"] = len(self.queue)
            extra["breaker_state"] = self.queue.breaker.state
            for k, v in self.engine.cache.stats().items():
                extra[f"cache_{k}"] = v
        if self.gen_queue is not None:
            extra["decode_queue_depth"] = len(self.gen_queue)
            extra["decode_free_slots"] = self.decode_batcher.free_slots()
            if self.gen_engine.pool is not None:
                for k, v in self.gen_engine.pool.stats().items():
                    extra[f"kvpool_{k}"] = v
            if self.decode_batcher.spec_k > 0:
                extra.update(self.decode_batcher.spec_snapshot())
        extra["state"] = self.state
        extra["weights_version"] = self._weights_version
        extra["brownout_level"] = self.brownout.level()
        extra["brownout_shed"] = self.brownout.snapshot()["shed"]
        for q, key in ((self.queue, "expired_in_queue"),
                       (self.gen_queue, "decode_expired_in_queue")):
            if q is not None:
                extra[key] = q.expired_in_queue
                extra[key.replace("expired_in_queue",
                                  "priority_evictions")] = \
                    q.priority_evictions
        return self.stats_sink.snapshot(extra=extra)

    def health(self):
        """Liveness and readiness, cheap enough for a poller: the
        lifecycle state, queue depths, each loop's liveness, heartbeat
        age and restarts, the supervisor's breaker, the weights version,
        the brownout level, the SLO breaches and the paged pool's
        occupancy."""
        if self.tp_follower is not None:
            return {"state": self.state, "tp_role": "follower",
                    "tp_loop_alive": self.tp_follower.alive()}
        h = {"state": self.state,
             "weights_version": self._weights_version,
             "uptime_s": round(time.monotonic() - self._started_at, 3),
             "loops": self.supervisor.snapshot(),
             "breaker": self.supervisor.breaker.state,
             "brownout_level": self.brownout.level(),
             "queue_capacity": int(self.config.queue_depth)}
        if self.slo_monitor is not None:
            breached = self.slo_monitor.breached()
            h["slo_breached"] = len(breached)
            if breached:
                h["slo_breached_rules"] = ",".join(sorted(breached))
        if self.queue is not None:
            h["queue_depth"] = len(self.queue)
        if self.gen_queue is not None:
            h["decode_queue_depth"] = len(self.gen_queue)
            h["decode_active_rows"] = self.decode_batcher.inflight()
            if self.decode_batcher.spec_k > 0:
                h.update(self.decode_batcher.spec_snapshot())
            pool = self.gen_engine.pool
            if pool is not None:
                cap = pool.capacity_blocks
                h["kvpool_occupancy"] = round(
                    pool.blocks_in_use() / cap, 4) if cap else 0.0
                h["kvpool_evictable_blocks"] = pool.cached_blocks()
            if hasattr(self.gen_engine, "liveness"):
                lost = self.gen_engine.lost
                h["tp_group"] = "lost" if lost is not None else "ok"
                h["tp_size"] = self.gen_engine.gen.tp
                h["tp_ranks"] = self.gen_engine.liveness()
                if lost is not None:
                    h["tp_lost_reason"] = lost
        return h

    def tp_pool_digests(self, timeout=60.0):
        """The tp group's ``KVBlockPool.digest`` s, the leader's first,
        read between decode steps with the bank empty (parked on the loop
        like a weight swap)."""
        box = {}
        self.decode_batcher.request_swap(
            lambda: box.setdefault("digests",
                                   self.gen_engine.pool_digests())
        ).wait(timeout)
        return box["digests"]

    def reload_weights(self, path, timeout=120.0):
        """Hot weight reload: read and verify a manifest-carrying
        checkpoint directory and stage it on the device, off the serving
        loops, then copy it into the live tensors: the infer engine
        between micro-batches, the decode bank between steps once its
        rows in flight finished on the old weights (admission pauses
        meanwhile: requests queue, none fails). A corrupt or incomplete
        checkpoint raises ``CheckpointCorruptError`` (a shape or dtype
        mismatch ``ValueError``) with the weights untouched. Returns
        ``{"weights_version", "swap_pause_ms"}``."""
        if self.state == "stopped":
            raise ServerShutdownError("cannot reload weights on a stopped "
                                      "server")
        # load and verify everything first: a failure in either engine's
        # checkpoint leaves both untouched
        new_state = staged = None
        if self.engine is not None:
            new_state = self.engine.load_state_snapshot(path)
        if self.gen_engine is not None:
            staged = self.gen_engine.stage_snapshot(path)
        pause_ms = 0.0
        if new_state is not None:
            self.engine.swap_state(new_state)
        if staged is not None:
            handle = self.decode_batcher.request_swap(
                lambda: self.gen_engine.apply_params(staged))
            pause_ms = handle.wait(timeout)
        with self._state_lock:
            self._weights_version += 1
            version = self._weights_version
        self.stats_sink.bump("weight_reloads")
        pause_ms = round(float(pause_ms or 0.0), 3)
        _flightrec().record("weight_reload", path=str(path),
                            weights_version=version, swap_pause_ms=pause_ms)
        return {"weights_version": version, "swap_pause_ms": pause_ms}

    def metrics(self):
        """Prometheus text exposition of the process metrics registry
        (serving counters and histograms, the executor cache, the pass
        pipeline, the kvpool, the utilization gauges, the SLO rules,
        the breakers: everything that reports into
        ``observability.default_registry()``)."""
        return render_metrics()

    # -- network front end ------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="serving-conn")
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn):
        with self._conns_lock:
            self._conns.add(conn)
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_frame(conn, self._key)
                except (ConnectionError, OSError, WireError):
                    return      # closed, or an unauthenticated frame
                counted = isinstance(msg, dict) and msg.get("op") in (
                    "infer", "generate", "prefill")
                if counted:
                    with self._replying_lock:
                        self._replying += 1
                try:
                    try:
                        # fault point: a stalled or failing handler (the
                        # request reached the server, its reply is late)
                        maybe_fail("serving.handle")
                    except Exception as e:  # noqa: BLE001 — typed reply
                        reply = _error_reply(e)
                    else:
                        reply = self._handle(msg)
                    tr = msg.get("trace") if isinstance(msg, dict) else None
                    t_r0 = time.perf_counter() if tr is not None else 0.0
                    try:
                        send_frame(conn, reply, self._key)
                    except (ConnectionError, OSError):
                        return
                finally:
                    if counted:
                        with self._replying_lock:
                            self._replying -= 1
                if tr is not None:
                    _trace.record_child("serving/reply", t_r0,
                                        time.perf_counter(),
                                        _trace.from_wire(tr))
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dedup(self, rid, admit):
        """Request-id dedup: the second of a pair with one ``rid`` joins
        the first's request instead of admitting a second execution.
        ``admit`` (the non-blocking queue put) runs under the table's
        lock, so racing twins cannot both admit. Returns ``(request,
        joined)``."""
        if not rid:
            return admit(), False
        with self._rids_lock:
            req = self._rids.get(rid)
            if req is not None:
                self._rids.move_to_end(rid)
                return req, True
            req = admit()
            self._rids[rid] = req
            while len(self._rids) > self._rid_cap:
                self._rids.popitem(last=False)
            return req, False

    def _handle(self, msg):
        if not isinstance(msg, dict) or "op" not in msg:
            return {"ok": False, "etype": "BadRequest",
                    "error": "expected a dict with an 'op' field"}
        op = msg["op"]
        if op == "ping":
            return {"ok": True}
        if op == "debug_dump":
            return self._handle_debug_dump(msg)
        if op == "reload_weights":
            return self._handle_reload(msg)
        if op not in ("stats", "metrics", "health", "cancel", "infer",
                      "generate", "prefill"):
            return {"ok": False, "etype": "BadRequest",
                    "error": f"unknown op {op!r}"}
        # the handler span is ambient for the whole body, so a request
        # made inside parents its stage spans under it; a None parent
        # (untraced) costs nothing
        name = "serving/handle" if op in ("infer", "generate", "prefill") \
            else f"serving/{op}"
        with _trace.span(name, parent=_trace.from_wire(msg.get("trace"))):
            if op == "stats":
                return {"ok": True, "stats": self.stats()}
            if op == "metrics":
                return {"ok": True, "metrics": self.metrics()}
            if op == "health":
                return {"ok": True, "health": self.health()}
            if op == "cancel":
                return self._handle_cancel(msg)
            if op == "infer":
                return self._handle_infer(msg)
            return self._handle_generate(msg, export_kv=op == "prefill")

    def _handle_debug_dump(self, msg):
        """The flight recorder's snapshot over the wire; ``"write":
        True`` also dumps it to a JSON file server-side and returns the
        path."""
        rec = _flightrec()
        path = None
        if msg.get("write"):
            try:
                path = rec.dump(reason="debug_dump wire op")
            except OSError as e:
                return _error_reply(e)
        return {"ok": True, "events": rec.snapshot(), "path": path}

    def _handle_cancel(self, msg):
        """Cancel by request id: a request still in flight fails with
        :class:`RequestCancelledError` (the batchers drop done requests
        at their next step, freeing the row's slot and blocks); a
        finished one is left alone."""
        rid = msg.get("rid")
        req = None
        if rid:
            with self._rids_lock:
                req = self._rids.get(rid)
        cancelled = False
        if req is not None and not req.done():
            req.set_error(RequestCancelledError(
                f"cancelled by the client (request id {rid})"))
            cancelled = True
            self.stats_sink.bump("requests_cancelled")
        return {"ok": True, "cancelled": cancelled}

    def _handle_reload(self, msg):
        path = msg.get("path")
        if not isinstance(path, str) or not path:
            return {"ok": False, "etype": "BadRequest",
                    "error": "'path' (checkpoint dir) is required"}
        try:
            out = self.reload_weights(
                path, timeout=float(msg.get("timeout", 120.0)))
        except Exception as e:  # noqa: BLE001 — typed reply
            return _error_reply(e)
        return {"ok": True, **out}

    def _handle_infer(self, msg):
        try:
            feed = msg.get("feed")
            if not isinstance(feed, dict) or not feed:
                raise BadRequestError("'feed' must be a non-empty dict of "
                                      "arrays")
            req, joined = self._dedup(msg.get("rid"), lambda: self.submit(
                feed, deadline_ms=msg.get("deadline_ms"),
                priority=msg.get("priority")))
            if joined:
                self.stats_sink.bump("hedge_dedup_hits")
        except Exception as e:  # noqa: BLE001 — typed refusal reply
            return _error_reply(e)
        budget = msg.get("deadline_ms")
        wait_s = (budget / 1e3 + 60.0) if budget else 300.0
        try:
            outs = req.wait(timeout=wait_s)
            return {"ok": True, "fetch": tuple(outs),
                    "batched": int(req.rows)}
        except TimeoutError:
            err = DeadlineExceededError(
                f"server-side wait budget of {wait_s:.0f}s exceeded; the "
                f"request was abandoned")
            req.set_error(err)
            return _error_reply(err)
        except Exception as e:  # noqa: BLE001 — surface, don't die
            return _error_reply(e)

    def _handle_generate(self, msg, export_kv=False):
        """``generate`` (with ``kv``/``first_token``: from migrated
        blocks) and, with ``export_kv``, ``prefill``."""
        try:
            tokens = msg.get("tokens")
            if tokens is None:
                raise ValueError("'tokens' (1-D int prompt) is required")
            first = msg.get("first_token")
            req, joined = self._dedup(
                msg.get("rid"), lambda: self.submit_generate(
                    np.asarray(tokens),
                    max_new_tokens=int(msg.get("max_new_tokens", 32)),
                    temperature=float(msg.get("temperature", 0.0)),
                    top_k=int(msg.get("top_k", 0)),
                    eos_id=msg.get("eos_id"),
                    deadline_ms=msg.get("deadline_ms"), export_kv=export_kv,
                    kv=None if export_kv else msg.get("kv"),
                    first_token=None if export_kv or first is None
                    else int(first), priority=msg.get("priority")))
            if joined:
                self.stats_sink.bump("hedge_dedup_hits")
        except Exception as e:  # noqa: BLE001 — typed refusal reply
            return _error_reply(e)
        budget = msg.get("deadline_ms")
        wait_s = (budget / 1e3 + 120.0) if budget else 600.0
        try:
            out, = req.wait(timeout=wait_s)
        except TimeoutError:
            # abandoned: the batcher reclaims the slot on its next step
            err = DeadlineExceededError(
                f"server-side wait budget of {wait_s:.0f}s exceeded; the "
                f"request was abandoned")
            req.set_error(err)
            return _error_reply(err)
        except Exception as e:  # noqa: BLE001 — surface, don't die
            return _error_reply(e)
        if export_kv:
            return {"ok": True, "kv": out,
                    "first_token": int(out["first_token"])}
        return {"ok": True, "tokens": np.asarray(out, np.int32),
                "generated": int(np.asarray(out).size)}


class CheckpointCorruptReply(CheckpointCorruptError, InternalServerError):
    """Client-side face of an ``etype: "CheckpointCorrupt"`` reply: a
    ``reload_weights`` whose checkpoint failed its integrity check
    (:class:`~paddle_tpu_torch.resilience.CheckpointCorruptError`), also
    an :class:`InternalServerError` (the JAX package's client reads the
    etype as Internal)."""


class WatchdogError(WatchdogTimeout, InternalServerError):
    """Client-side face of an ``etype: "Watchdog"`` reply: a server-side
    :class:`~paddle_tpu_torch.resilience.WatchdogTimeout` (a hung execute
    or decode step), which is also an :class:`InternalServerError`."""


# reply etype <-> exception; subclasses before their bases
_ETYPE_MAP = (
    ("TPGroupLost", TPGroupLostError),
    ("Cancelled", RequestCancelledError),
    ("Shutdown", ServerShutdownError),
    ("DeadlineExceeded", DeadlineExceededError),
    ("Overloaded", ServerOverloadedError),
    ("Watchdog", WatchdogTimeout),
    ("CheckpointCorrupt", CheckpointCorruptError),
    ("BadRequest", (BadRequestError, ValueError, TypeError)),
)
# the client raises the typed serving errors (input refusals stay apart
# from server faults)
_ETYPES = {etype: cls for etype, cls in _ETYPE_MAP if isinstance(cls, type)}
_ETYPES["BadRequest"] = BadRequestError
_ETYPES["Watchdog"] = WatchdogError
_ETYPES["CheckpointCorrupt"] = CheckpointCorruptReply


_ierr_lock = threading.Lock()
_ierr_counts = {}       # exception type name -> cumulative count


def _record_internal_error(exc):
    """Flight-record an internal error crossing the server boundary,
    sampled per exception type (the first, then every 64th, each with
    the running count): an engine failing every request must not turn
    the ring over."""
    key = type(exc).__name__
    with _ierr_lock:
        n = _ierr_counts.get(key, 0) + 1
        _ierr_counts[key] = n
    if n == 1 or n % 64 == 0:
        _flightrec().record("internal_error", etype=key, n=n,
                            error=str(exc)[:200])


def _error_reply(exc):
    """The typed wire reply of ``exc``. An Internal or Watchdog error
    crossing the server boundary triggers an automatic flight-recorder
    dump (rate-limited; only with ``FLAGS_flight_recorder_dir`` set); an
    Internal one is flight-recorded too."""
    for etype, cls in _ETYPE_MAP:
        if isinstance(exc, cls):
            if etype == "Watchdog":
                _flightrec().auto_dump(
                    f"Watchdog error crossed the server boundary: {exc}")
            return {"ok": False, "etype": etype, "error": str(exc)}
    _record_internal_error(exc)
    _flightrec().auto_dump(
        f"Internal error crossed the server boundary: "
        f"{type(exc).__name__}: {exc}")
    return {"ok": False, "etype": "Internal",
            "error": f"{type(exc).__name__}: {exc}"}


class _Unset:
    """"Argument not given" for per-call timeouts (None means: block)."""

    def __repr__(self):
        return "<unset>"


_UNSET = _Unset()


class Client:
    """Wire-protocol client: one socket, serial request/reply (run one
    Client per concurrent caller; the server batches across them).
    Error replies raise their typed exceptions; transport failures raise
    ConnectionError.

    A dead cached socket is reconnected once before any error surfaces
    (a bounced server does not strand old clients); ``ping``, ``stats``,
    ``metrics`` and ``health`` retry with backoff
    (``resilience.retry_call``); each ``infer``, ``generate`` and
    ``prefill`` carries a request id (the server dedups, so a retried or
    hedged pair runs once); a deadline goes on the wire as the budget
    still unspent. ``infer`` hedges: when no reply lands within
    ``hedge_ms`` (default ``FLAGS_serving_hedge_ms``; the observed p99
    once 16 latencies are banked) a twin races on a second connection,
    the first reply wins and the loser is cancelled by id. Reconnects
    and hedges draw on the process retry budget (``retry_budget``
    overrides it)."""

    def __init__(self, endpoint, auth_key=None, timeout=None,
                 connect_retries=20, hedge_ms=None, retry_budget=None):
        from ..flags import flag
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self._addr = (host, int(port))
        self._key = auth_key if auth_key is not None else default_key()
        self._timeout = timeout
        self._connect_retries = connect_retries
        self._retry_budget = retry_budget
        self._sock = None
        self._hedge_ms = float(hedge_ms if hedge_ms is not None
                               else flag("serving_hedge_ms"))
        self._lat_s = deque(maxlen=256)     # winning infer latencies
        self._hedges = 0
        self._hedge_wins = 0
        self._hedges_suppressed = 0         # refused by the retry budget

    def _budget(self):
        return (self._retry_budget if self._retry_budget is not None
                else default_retry_budget())

    @staticmethod
    def _remaining_ms(budget_ms, t0):
        """The deadline budget unspent now (what goes on the wire);
        raises the typed expiry when nothing is left."""
        if budget_ms is None:
            return None
        rem = remaining_budget_ms(budget_ms, t0)
        if rem <= 0:
            raise DeadlineExceededError(
                f"deadline budget of {float(budget_ms):.1f}ms spent "
                f"client-side before the request reached a server",
                deadline_ms=float(budget_ms),
                waited_ms=(time.monotonic() - t0) * 1e3)
        return rem

    def _ensure(self, timeout=_UNSET):
        if self._sock is None:
            t = self._timeout if timeout is _UNSET else timeout
            # an explicit per-call timeout bounds the connect retries too
            deadline = 10.0 if timeout is _UNSET or timeout is None \
                else max(float(timeout), 0.05)
            self._sock = retry_call(
                lambda: socket.create_connection(self._addr, timeout=t),
                deadline=deadline, retries=self._connect_retries,
                what="serving connect", endpoint=self.endpoint,
                budget=self._budget())
        return self._sock

    def _transact(self, sock, msg, timeout=_UNSET):
        """One request/reply exchange on ``sock``; error replies raise
        their typed exceptions. A failure inside the exchange poisons the
        socket (its reply may still be in flight): the cached socket is
        dropped and the next call reconnects."""
        t = self._timeout if timeout is _UNSET else timeout
        try:
            send_frame(sock, msg, self._key, timeout=t)
            reply = recv_frame(sock, self._key, timeout=t)
        except BaseException:
            if sock is self._sock:
                self.close()
            raise
        if not isinstance(reply, dict):
            raise WireError(f"malformed serving reply: {type(reply)}")
        if reply.get("ok"):
            return reply
        etype = _ETYPES.get(reply.get("etype"), InternalServerError)
        raise etype(reply.get("error", "serving request failed"))

    def _call(self, msg, timeout=_UNSET, budget_ms=None, t0=None):
        """An exchange with reconnect-once: a transport failure on the
        cached socket (a bounced server) retries the exchange on a fresh
        connection (a reconnect draws on the retry budget). Safe: the
        request ops carry an id the server dedups, the rest are
        idempotent. With ``budget_ms`` the wire deadline is rewritten to
        the budget left before every attempt."""
        for attempt in (0, 1):
            if budget_ms is not None:
                msg["deadline_ms"] = self._remaining_ms(budget_ms, t0)
            sock = self._ensure(timeout=timeout)
            try:
                return self._transact(sock, msg, timeout=timeout)
            except (ConnectionError, OSError) as e:
                self.close()
                # an explicit per-call timeout expiring is the answer
                # (the replica hangs), not a stale socket
                if attempt or (timeout is not _UNSET
                               and isinstance(e, socket.timeout)):
                    raise
                self._budget().acquire(what="client-reconnect")
        raise AssertionError("unreachable")

    # -- hedging -----------------------------------------------------------
    def _hedge_delay_s(self, hedge_ms):
        """The hedge trigger: the observed p99 infer latency once 16 are
        banked (at least 1 ms), else the configured delay; 0: none."""
        base = self._hedge_ms if hedge_ms is None else float(hedge_ms)
        if base <= 0:
            return 0.0
        if len(self._lat_s) >= 16:
            p99 = float(np.percentile(np.asarray(self._lat_s), 99)) * 1e3
            return max(p99, 1.0) / 1e3
        return base / 1e3

    def hedge_stats(self):
        return {"hedges": self._hedges, "hedge_wins": self._hedge_wins,
                "budget_suppressed": self._hedges_suppressed,
                "observed": len(self._lat_s)}

    def _call_hedged(self, msg, delay_s, budget_ms=None, t0=None):
        """Race the exchange against a twin on a fresh connection, sent
        ``delay_s`` later if no reply came by then; the first reply wins
        and the loser is cancelled by request id (the server's dedup
        table makes the pair run once). The twin draws on the retry
        budget; a dry budget suppresses it."""
        state = {"reply": None, "who": None, "errors": [], "done": 0}
        cv = threading.Condition()

        def attempt(tag, fn):
            try:
                r, err = fn(), None
            except Exception as e:  # noqa: BLE001 — judged by the racer
                r, err = None, e
            with cv:
                if r is not None and state["reply"] is None:
                    state["reply"], state["who"] = r, tag
                elif r is None:
                    state["errors"].append(err)
                state["done"] += 1
                cv.notify_all()

        if budget_ms is not None:
            msg["deadline_ms"] = self._remaining_ms(budget_ms, t0)
        sock = self._ensure()
        threading.Thread(target=attempt,
                         args=("primary", lambda: self._transact(sock, msg)),
                         daemon=True, name="serving-client-primary").start()
        launched = 1
        with cv:
            cv.wait_for(lambda: state["reply"] is not None
                        or state["done"] >= launched, timeout=delay_s)
            fire_hedge = state["reply"] is None and state["done"] < 1
        # the twin owns a copy of the message carrying the budget left
        # now; a spent budget sends no twin (checked before the retry
        # budget, so no token leaks)
        hmsg = dict(msg) if fire_hedge else None
        if fire_hedge and budget_ms is not None:
            try:
                hmsg["deadline_ms"] = self._remaining_ms(budget_ms, t0)
            except DeadlineExceededError:
                fire_hedge = False
        if fire_hedge and not self._budget().try_acquire(
                what="client-hedge"):
            self._hedges_suppressed += 1
            fire_hedge = False
        if fire_hedge:
            self._hedges += 1

            def hedge_fn():
                hs = socket.create_connection(self._addr,
                                              timeout=self._timeout)
                try:
                    return self._transact(hs, hmsg)
                finally:
                    try:
                        hs.close()
                    except OSError:
                        pass

            threading.Thread(target=attempt, args=("hedge", hedge_fn),
                             daemon=True, name="serving-client-hedge").start()
            launched = 2
        with cv:
            cv.wait_for(lambda: state["reply"] is not None
                        or state["done"] >= launched)
            reply, who = state["reply"], state["who"]
            errors = list(state["errors"])
        if reply is None:
            if all(isinstance(e, (ConnectionError, OSError))
                   for e in errors):
                # both died on transport: reconnect once (the request id
                # makes the replay run once server-side)
                self.close()
                self._budget().acquire(what="client-reconnect")
                return self._call(msg, budget_ms=budget_ms, t0=t0)
            raise errors[0]
        if who == "hedge":
            self._hedge_wins += 1
            # the primary is still blocked on the cached socket: drop it
            self.close()
        if launched == 2:
            try:
                self._call({"op": "cancel", "rid": msg["rid"]})
            except Exception:  # noqa: BLE001 — cancel is best-effort
                pass
        return reply

    @contextlib.contextmanager
    def _traced(self, msg):
        """Attach the sampled (``FLAGS_trace_sample_rate``) or ambient
        trace context to an outgoing request and record the
        ``client/send`` span around the call."""
        ctx = _trace.maybe_trace()
        if ctx is not None:
            msg["trace"] = _trace.to_wire(ctx)
        t0 = time.perf_counter() if ctx is not None else 0.0
        try:
            yield
        finally:
            if ctx is not None:
                _trace.record_span("client/send", t0, time.perf_counter(),
                                   ctx)

    # -- ops ---------------------------------------------------------------
    def infer(self, feeds, deadline_ms=None, priority=None, hedge_ms=None):
        """The fetch list (numpy arrays) of one infer request; error
        replies raise their typed exceptions. ``deadline_ms`` is a
        budget (what goes on the wire is the part left at send time);
        ``hedge_ms`` overrides the hedging delay for this call (0: no
        hedge)."""
        msg = {"op": "infer", "feed": {n: np.asarray(a)
                                       for n, a in feeds.items()},
               "deadline_ms": deadline_ms, "rid": uuid.uuid4().hex}
        if priority is not None:
            msg["priority"] = str(priority)
        delay_s = self._hedge_delay_s(hedge_ms)
        t0 = time.monotonic()
        self._budget().record_request()
        with self._traced(msg):
            if delay_s <= 0:
                reply = self._call(msg, budget_ms=deadline_ms, t0=t0)
            else:
                reply = self._call_hedged(msg, delay_s,
                                          budget_ms=deadline_ms, t0=t0)
        self._lat_s.append(time.monotonic() - t0)
        return [np.asarray(a) for a in reply["fetch"]]

    def generate(self, tokens, max_new_tokens=32, temperature=0.0, top_k=0,
                 eos_id=None, deadline_ms=None, kv=None, first_token=None,
                 priority=None, rid=None):
        """New tokens for one prompt (1-D int) as np.int32 (EOS
        excluded). With ``kv`` (a :meth:`prefill` payload from another
        server) the server decodes from those blocks and ``first_token``
        (default: the payload's) with no prefill; the reply then starts
        with that first token. ``rid``: the request id (default a fresh
        one; :meth:`cancel` takes it)."""
        msg = {
            "op": "generate",
            "tokens": np.asarray(tokens, dtype=np.int32).ravel(),
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "top_k": int(top_k),
            "eos_id": None if eos_id is None else int(eos_id),
            "deadline_ms": deadline_ms,
            "rid": str(rid) if rid is not None else uuid.uuid4().hex,
        }
        if priority is not None:
            msg["priority"] = str(priority)
        if kv is not None:
            msg["kv"] = dict(kv)
            msg["first_token"] = int(kv["first_token"] if first_token is None
                                     else first_token)
        t0 = time.monotonic()
        self._budget().record_request()
        with self._traced(msg):
            reply = self._call(msg, budget_ms=deadline_ms, t0=t0)
        return np.asarray(reply["tokens"], dtype=np.int32)

    def prefill(self, tokens, max_new_tokens=32, temperature=0.0, top_k=0,
                deadline_ms=None):
        """The prefill half of disaggregated serving: the server (paged)
        prefills the prompt, samples its first token and returns the KV
        payload (``first_token`` and ``prompt_tokens`` inside), ready for
        another server's :meth:`generate` ``kv=``."""
        msg = {
            "op": "prefill",
            "tokens": np.asarray(tokens, dtype=np.int32).ravel(),
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "top_k": int(top_k),
            "deadline_ms": deadline_ms,
            "rid": uuid.uuid4().hex,
        }
        with self._traced(msg):
            return self._call(msg)["kv"]

    def reload_weights(self, path, timeout=120.0):
        """Hot weight reload on the server (manifest-verified, in place).
        Returns ``{"weights_version", "swap_pause_ms"}``."""
        reply = self._call({"op": "reload_weights", "path": str(path),
                            "timeout": float(timeout)})
        return {"weights_version": reply["weights_version"],
                "swap_pause_ms": reply["swap_pause_ms"]}

    def cancel(self, rid):
        """Cancel an in-flight request by its id; True if the server
        cancelled something."""
        msg = {"op": "cancel", "rid": str(rid)}
        with self._traced(msg):
            return bool(self._call(msg).get("cancelled"))

    def _idempotent(self, msg, timeout=_UNSET):
        deadline = 10.0 if timeout is _UNSET or timeout is None \
            else max(float(timeout), 0.05)
        return retry_call(lambda: self._call(msg, timeout=timeout),
                          deadline=deadline, retries=2,
                          what=f"serving {msg['op']}",
                          endpoint=self.endpoint, budget=self._budget())

    def stats(self, timeout=_UNSET):
        msg = {"op": "stats"}
        with self._traced(msg):
            return self._idempotent(msg, timeout=timeout)["stats"]

    def metrics(self, timeout=_UNSET):
        """Prometheus text exposition of the server process's metrics
        registry."""
        msg = {"op": "metrics"}
        with self._traced(msg):
            return self._idempotent(msg, timeout=timeout)["metrics"]

    def health(self, timeout=_UNSET):
        """The server's lifecycle and liveness snapshot (state, queue
        depths, loop heartbeats and restarts, weights version, pool
        occupancy when paged)."""
        msg = {"op": "health"}
        with self._traced(msg):
            return self._idempotent(msg, timeout=timeout)["health"]

    def debug_dump(self, write=False):
        """The server's flight recorder: ``{"ok", "events", "path"}``,
        events oldest first; ``write=True`` also dumps them to a JSON file
        server-side (``path``; one attempt: the write is not
        idempotent)."""
        msg = {"op": "debug_dump", "write": bool(write)}
        if write:
            return self._call(msg)
        return self._idempotent(msg)

    def ping(self, timeout=_UNSET):
        return bool(self._idempotent({"op": "ping"},
                                     timeout=timeout).get("ok"))

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
