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
Supervision, the load-shed breaker, brownout, hedging, request dedup,
hot weight reload and the ``health`` and ``cancel`` ops are not ported.

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
                                    |"Shutdown"|"BadRequest"|"Internal",
              "error": str}
    request  {"op": "stats"}   -> {"ok": True, "stats": {...}}
    request  {"op": "metrics"} -> {"ok": True, "metrics": str}
             (Prometheus text exposition of the process metrics registry)
    request  {"op": "debug_dump", "write": bool}
             -> {"ok": True, "events": [...], "path": str|None}
             (the flight recorder's events; with write, also a JSON dump
              server-side)
    request  {"op": "ping"}    -> {"ok": True}

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

import numpy as np

from ..distributed.wire import WireError, default_key, recv_frame, send_frame
from ..observability import tracing as _trace
from ..observability.metrics import render_metrics
from ..observability.recorder import flight_recorder as _flightrec
from .batching import (BadRequestError, DeadlineExceededError,
                       DecodeBatcher, GenerationRequest, InternalServerError,
                       MicroBatcher, Request, RequestQueue,
                       ServerOverloadedError, ServerShutdownError)
from .engine import GenerationEngine, ServingEngine
from .metrics import ServingStats


class ServingConfig:
    """Serving knobs, each defaulting from its ``FLAGS_serving_*`` flag:
    ``max_batch_size``, ``batch_timeout_ms``, ``queue_depth``,
    ``cache_entries`` and ``cache_bytes``."""

    _FLAG_FIELDS = {
        "max_batch_size": "serving_max_batch_size",
        "batch_timeout_ms": "serving_batch_timeout_ms",
        "queue_depth": "serving_queue_depth",
        "cache_entries": "serving_cache_entries",
        "cache_bytes": "serving_cache_bytes",
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
        if engine is None and (model_dir is not None or generator is None):
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
            self.queue = RequestQueue(max_depth=self.config.queue_depth,
                                      stats=self.stats_sink)
            self.batcher = MicroBatcher(
                self.queue, self.engine.execute,
                max_batch_size=self.config.max_batch_size,
                batch_timeout_ms=self.config.batch_timeout_ms,
                stats=self.stats_sink)
        self.gen_engine = self.gen_queue = self.decode_batcher = None
        if generator is not None:
            self.gen_engine = GenerationEngine(
                generator, slots=decode_slots, stats=self.stats_sink,
                paged=paged)
            self.gen_queue = RequestQueue(max_depth=self.config.queue_depth,
                                          stats=self.stats_sink)
            self.decode_batcher = DecodeBatcher(
                self.gen_queue, self.gen_engine, stats=self.stats_sink)
        self.host = host
        self.port = int(port)
        self._key = auth_key if auth_key is not None else default_key()
        self._allow_insecure = allow_insecure
        self._sock = None
        self._stop = threading.Event()
        self._threads = []
        self._conns = set()
        self._conns_lock = threading.Lock()
        self._slo_rules = slo_rules
        self.slo_monitor = None

    @property
    def endpoint(self):
        return f"{self.host}:{self.port}"

    def start(self, serve_network=True, warmup_batch_sizes=None,
              warmup_signature_file=None):
        """Start the batchers and (unless ``serve_network=False``) the
        socket front end. Warmup captures the model's programs at the
        buckets of ``warmup_batch_sizes`` (and the recorded signatures)
        before the first request."""
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
        return self

    def stop(self):
        """Close admission (queued requests fail typed), stop the
        batchers (requests still batching or decoding fail typed; a batch
        inside the engine finishes), close the socket and every
        connection, and join the threads."""
        if self.slo_monitor is not None:
            self.slo_monitor.stop()
            self.slo_monitor = None
        self._stop.set()
        for q in (self.queue, self.gen_queue):
            if q is not None:
                q.close()
        for b in (self.batcher, self.decode_batcher):
            if b is not None:
                b.stop()
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

    def drain(self, *args, **kwargs):
        raise NotImplementedError("paddle_tpu_torch: graceful drain and "
                                  "the server lifecycle are not ported")

    def reload_weights(self, *args, **kwargs):
        raise NotImplementedError("paddle_tpu_torch: hot weight reload is "
                                  "not ported")

    # -- in-process path --------------------------------------------------
    def submit(self, feeds, deadline_ms=None, priority=None):
        """Admit an infer request (``{name: array}`` with a leading
        example dim); returns the Request (``.wait()`` -> the fetch
        list). Feeds other than the model's, in another dtype or with
        other trailing dims are refused with :class:`BadRequestError`;
        a full queue with :class:`ServerOverloadedError`."""
        if self.queue is None:
            raise BadRequestError("no inference model loaded: this server "
                                  "only serves 'generate'")
        self.engine.check_feeds(feeds)
        return self.queue.put(Request(
            {n: np.asarray(feeds[n]) for n in self.engine.feed_names},
            deadline_ms=deadline_ms, priority=priority))

    def infer(self, feeds, deadline_ms=None, timeout=None, priority=None):
        """The fetch list (numpy arrays) of one infer request."""
        return self.submit(feeds, deadline_ms=deadline_ms,
                           priority=priority).wait(timeout=timeout)

    def submit_generate(self, tokens, max_new_tokens=32, temperature=0.0,
                        top_k=0, eos_id=None, deadline_ms=None,
                        export_kv=False, kv=None, first_token=None):
        """Admit a generation request; returns the GenerationRequest
        (``.wait()`` -> ``[np.int32 tokens]``, or ``[payload]`` with
        ``export_kv``). A request that could never run (prompt +
        max_new_tokens past the cache, or bigger than the whole pool), a
        migration without the paged pool, or a payload that does not
        cover this prompt is refused here with
        :class:`BadRequestError`."""
        if self.gen_queue is None:
            raise BadRequestError("this server has no generator: pass "
                                  "generator= to InferenceServer")
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
        return self.gen_queue.put(GenerationRequest(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_id=eos_id, deadline_ms=deadline_ms,
            export_kv=export_kv, kv=kv, first_token=first_token))

    def generate(self, tokens, max_new_tokens=32, temperature=0.0, top_k=0,
                 eos_id=None, deadline_ms=None, timeout=None):
        """New tokens for one prompt as a 1-D np.int32 array."""
        return self.submit_generate(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_id=eos_id,
            deadline_ms=deadline_ms).wait(timeout=timeout)[0]

    def stats(self):
        """One snapshot: admission counters, stage histograms, batch
        occupancy, the captured-program cache's hits, misses and
        evictions, queue depths."""
        extra = {}
        if self.queue is not None:
            extra["queue_depth"] = len(self.queue)
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
        return self.stats_sink.snapshot(extra=extra)

    def metrics(self):
        """Prometheus text exposition of the process metrics registry
        (serving counters and histograms, the executor cache, the pass
        pipeline, the kvpool, the utilization gauges, the SLO rules:
        everything that reports into ``observability.default_registry()``)."""
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
                reply = self._handle(msg)
                tr = msg.get("trace") if isinstance(msg, dict) else None
                t_r0 = time.perf_counter() if tr is not None else 0.0
                try:
                    send_frame(conn, reply, self._key)
                except (ConnectionError, OSError):
                    return
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

    def _handle(self, msg):
        if not isinstance(msg, dict) or "op" not in msg:
            return {"ok": False, "etype": "BadRequest",
                    "error": "expected a dict with an 'op' field"}
        op = msg["op"]
        if op == "ping":
            return {"ok": True}
        if op == "debug_dump":
            return self._handle_debug_dump(msg)
        if op not in ("stats", "metrics", "infer", "generate", "prefill"):
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

    def _handle_infer(self, msg):
        try:
            feed = msg.get("feed")
            if not isinstance(feed, dict) or not feed:
                raise BadRequestError("'feed' must be a non-empty dict of "
                                      "arrays")
            req = self.submit(feed, deadline_ms=msg.get("deadline_ms"),
                              priority=msg.get("priority"))
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
            req = self.submit_generate(
                np.asarray(tokens),
                max_new_tokens=int(msg.get("max_new_tokens", 32)),
                temperature=float(msg.get("temperature", 0.0)),
                top_k=int(msg.get("top_k", 0)), eos_id=msg.get("eos_id"),
                deadline_ms=msg.get("deadline_ms"), export_kv=export_kv,
                kv=None if export_kv else msg.get("kv"),
                first_token=None if export_kv or first is None
                else int(first))
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


# reply etype <-> exception; subclasses before their bases
_ETYPE_MAP = (
    ("Shutdown", ServerShutdownError),
    ("DeadlineExceeded", DeadlineExceededError),
    ("Overloaded", ServerOverloadedError),
    ("BadRequest", (BadRequestError, ValueError, TypeError)),
)
_ETYPES = {etype: cls for etype, cls in _ETYPE_MAP if isinstance(cls, type)}
_ETYPES["BadRequest"] = BadRequestError


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
    """The typed wire reply of ``exc``. An Internal error crossing the
    server boundary is flight-recorded and triggers an automatic dump
    (rate-limited; only with ``FLAGS_flight_recorder_dir`` set)."""
    for etype, cls in _ETYPE_MAP:
        if isinstance(exc, cls):
            return {"ok": False, "etype": etype, "error": str(exc)}
    _record_internal_error(exc)
    _flightrec().auto_dump(
        f"Internal error crossed the server boundary: "
        f"{type(exc).__name__}: {exc}")
    return {"ok": False, "etype": "Internal",
            "error": f"{type(exc).__name__}: {exc}"}


class Client:
    """Wire-protocol client: one socket, serial request/reply (run one
    Client per concurrent caller; the server batches across them).
    Error replies raise their typed exceptions; transport failures raise
    ConnectionError."""

    def __init__(self, endpoint, auth_key=None, timeout=None):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self._addr = (host, int(port))
        self._key = auth_key if auth_key is not None else default_key()
        self._timeout = timeout
        self._sock = None

    def _call(self, msg):
        if self._sock is None:
            self._sock = socket.create_connection(self._addr,
                                                  timeout=self._timeout)
        try:
            send_frame(self._sock, msg, self._key, timeout=self._timeout)
            reply = recv_frame(self._sock, self._key, timeout=self._timeout)
        except BaseException:
            # a half-done exchange poisons the socket: never reuse it
            self.close()
            raise
        if not isinstance(reply, dict):
            raise WireError(f"malformed serving reply: {type(reply)}")
        if reply.get("ok"):
            return reply
        etype = _ETYPES.get(reply.get("etype"), InternalServerError)
        raise etype(reply.get("error", "serving request failed"))

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

    def infer(self, feeds, deadline_ms=None, priority=None):
        """The fetch list (numpy arrays) of one infer request; error
        replies raise their typed exceptions."""
        msg = {"op": "infer", "feed": {n: np.asarray(a)
                                       for n, a in feeds.items()},
               "deadline_ms": deadline_ms}
        if priority is not None:
            msg["priority"] = str(priority)
        with self._traced(msg):
            reply = self._call(msg)
        return [np.asarray(a) for a in reply["fetch"]]

    def generate(self, tokens, max_new_tokens=32, temperature=0.0, top_k=0,
                 eos_id=None, deadline_ms=None, kv=None, first_token=None):
        """New tokens for one prompt (1-D int) as np.int32 (EOS
        excluded). With ``kv`` (a :meth:`prefill` payload from another
        server) the server decodes from those blocks and ``first_token``
        (default: the payload's) with no prefill; the reply then starts
        with that first token."""
        msg = {
            "op": "generate",
            "tokens": np.asarray(tokens, dtype=np.int32).ravel(),
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "top_k": int(top_k),
            "eos_id": None if eos_id is None else int(eos_id),
            "deadline_ms": deadline_ms,
        }
        if kv is not None:
            msg["kv"] = dict(kv)
            msg["first_token"] = int(kv["first_token"] if first_token is None
                                     else first_token)
        with self._traced(msg):
            reply = self._call(msg)
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
        }
        with self._traced(msg):
            return self._call(msg)["kv"]

    def stats(self):
        msg = {"op": "stats"}
        with self._traced(msg):
            return self._call(msg)["stats"]

    def metrics(self):
        """Prometheus text exposition of the server process's metrics
        registry."""
        msg = {"op": "metrics"}
        with self._traced(msg):
            return self._call(msg)["metrics"]

    def debug_dump(self, write=False):
        """The server's flight recorder: ``{"ok", "events", "path"}``,
        events oldest first; ``write=True`` also dumps them to a JSON file
        server-side (``path``)."""
        return self._call({"op": "debug_dump", "write": bool(write)})

    def ping(self):
        return bool(self._call({"op": "ping"}).get("ok"))

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
