"""Generation service over the typed wire framing.

Counterpart of ``paddle_tpu/serving/server.py`` (``InferenceServer`` with
``generator=``, ``Client``), cut to the generation endpoint. Connection
threads speak the length-prefixed, HMAC-optional frames of
``distributed/wire.py``; admission happens on the connection thread
(backpressure is refused at once, never queued); one ``DecodeBatcher``
thread drives the decode bank.

Wire protocol:

    request  {"op": "generate", "tokens": int array, "max_new_tokens": int,
              "temperature": float, "top_k": int, "eos_id": int|None,
              "deadline_ms": float|None}
    reply    {"ok": True, "tokens": int32 array, "generated": int}
           | {"ok": False, "etype": "DeadlineExceeded"|"Overloaded"
                                    |"Shutdown"|"BadRequest"|"Internal",
              "error": str}
    request  {"op": "stats"}   -> {"ok": True, "stats": {...}}
    request  {"op": "ping"}    -> {"ok": True}
"""
import socket
import threading

import numpy as np

from ..distributed.wire import WireError, default_key, recv_frame, send_frame
from .batching import (BadRequestError, DeadlineExceededError,
                       DecodeBatcher, GenerationRequest, InternalServerError,
                       RequestQueue, ServerOverloadedError,
                       ServerShutdownError)
from .engine import GenerationEngine
from .metrics import ServingStats


class InferenceServer:
    """Generation server over a ``models.generation.GPTGenerator``:

        server = InferenceServer(generator=gen, decode_slots=8,
                                 paged=True).start()
        tokens = Client(server.endpoint).generate(prompt, 32)

    ``start()`` binds a socket (default loopback, OS-assigned port).
    Set ``PADDLE_PS_AUTH_KEY`` (or ``auth_key=``) on both ends to
    authenticate frames; a non-loopback bind without a key is refused
    unless ``allow_insecure=True``."""

    def __init__(self, *, generator, decode_slots=None, paged=None,
                 host="127.0.0.1", port=0, auth_key=None,
                 allow_insecure=False):
        self.stats_sink = ServingStats()
        self.gen_engine = GenerationEngine(
            generator, slots=decode_slots, stats=self.stats_sink,
            paged=paged)
        self.gen_queue = RequestQueue(stats=self.stats_sink)
        self.decode_batcher = DecodeBatcher(self.gen_queue, self.gen_engine,
                                            stats=self.stats_sink)
        self.host = host
        self.port = int(port)
        self._key = auth_key if auth_key is not None else default_key()
        self._allow_insecure = allow_insecure
        self._sock = None
        self._stop = threading.Event()
        self._threads = []
        self._conns = set()
        self._conns_lock = threading.Lock()

    @property
    def endpoint(self):
        return f"{self.host}:{self.port}"

    def start(self):
        loopback = self.host.startswith("127.") \
            or self.host in ("localhost", "::1")
        if not loopback and self._key is None and not self._allow_insecure:
            raise PermissionError(
                f"refusing to bind the inference server on non-loopback "
                f"{self.host}:{self.port} without authentication — set "
                f"PADDLE_PS_AUTH_KEY (both ends) or pass "
                f"allow_insecure=True")
        self.decode_batcher.start()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(128)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="serving-accept")
        t.start()
        self._threads.append(t)
        return self

    def stop(self):
        """Close admission (queued requests fail typed), stop the decode
        loop (decoding rows fail typed), close the socket and every
        connection, and join the threads."""
        self._stop.set()
        self.gen_queue.close()
        self.decode_batcher.stop()
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

    # -- in-process path --------------------------------------------------
    def submit_generate(self, tokens, max_new_tokens=32, temperature=0.0,
                        top_k=0, eos_id=None, deadline_ms=None):
        """Admit a generation request; returns the GenerationRequest
        (``.wait()`` -> ``[np.int32 tokens]``). A request that could never
        run (prompt + max_new_tokens past the cache, or bigger than the
        whole pool) is refused here with :class:`BadRequestError`."""
        ntokens = np.asarray(tokens).size
        self.gen_engine.admission_check(ntokens, max_new_tokens,
                                        static_only=True)
        return self.gen_queue.put(GenerationRequest(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_id=eos_id, deadline_ms=deadline_ms))

    def generate(self, tokens, max_new_tokens=32, temperature=0.0, top_k=0,
                 eos_id=None, deadline_ms=None, timeout=None):
        """New tokens for one prompt as a 1-D np.int32 array."""
        return self.submit_generate(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_id=eos_id,
            deadline_ms=deadline_ms).wait(timeout=timeout)[0]

    def stats(self):
        extra = {"decode_queue_depth": len(self.gen_queue),
                 "decode_free_slots": self.decode_batcher.free_slots()}
        if self.gen_engine.pool is not None:
            for k, v in self.gen_engine.pool.stats().items():
                extra[f"kvpool_{k}"] = v
        return self.stats_sink.snapshot(extra=extra)

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
                try:
                    send_frame(conn, self._handle(msg), self._key)
                except (ConnectionError, OSError):
                    return
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
        if op == "stats":
            return {"ok": True, "stats": self.stats()}
        if op == "generate":
            return self._handle_generate(msg)
        return {"ok": False, "etype": "BadRequest",
                "error": f"unknown op {op!r}"}

    def _handle_generate(self, msg):
        try:
            tokens = msg.get("tokens")
            if tokens is None:
                raise ValueError("'tokens' (1-D int prompt) is required")
            req = self.submit_generate(
                np.asarray(tokens),
                max_new_tokens=int(msg.get("max_new_tokens", 32)),
                temperature=float(msg.get("temperature", 0.0)),
                top_k=int(msg.get("top_k", 0)), eos_id=msg.get("eos_id"),
                deadline_ms=msg.get("deadline_ms"))
        except Exception as e:  # noqa: BLE001 — typed refusal reply
            return _error_reply(e)
        budget = msg.get("deadline_ms")
        wait_s = (budget / 1e3 + 120.0) if budget else 600.0
        try:
            out, = req.wait(timeout=wait_s)
            return {"ok": True, "tokens": np.asarray(out, np.int32),
                    "generated": int(np.asarray(out).size)}
        except TimeoutError:
            # abandoned: the batcher reclaims the slot on its next step
            err = DeadlineExceededError(
                f"server-side wait budget of {wait_s:.0f}s exceeded; the "
                f"request was abandoned")
            req.set_error(err)
            return _error_reply(err)
        except Exception as e:  # noqa: BLE001 — surface, don't die
            return _error_reply(e)


# reply etype <-> exception; subclasses before their bases
_ETYPE_MAP = (
    ("Shutdown", ServerShutdownError),
    ("DeadlineExceeded", DeadlineExceededError),
    ("Overloaded", ServerOverloadedError),
    ("BadRequest", (BadRequestError, ValueError, TypeError)),
)
_ETYPES = {etype: cls for etype, cls in _ETYPE_MAP if isinstance(cls, type)}
_ETYPES["BadRequest"] = BadRequestError


def _error_reply(exc):
    for etype, cls in _ETYPE_MAP:
        if isinstance(exc, cls):
            return {"ok": False, "etype": etype, "error": str(exc)}
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

    def generate(self, tokens, max_new_tokens=32, temperature=0.0, top_k=0,
                 eos_id=None, deadline_ms=None):
        """New tokens for one prompt (1-D int) as np.int32 (EOS
        excluded)."""
        reply = self._call({
            "op": "generate",
            "tokens": np.asarray(tokens, dtype=np.int32).ravel(),
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "top_k": int(top_k),
            "eos_id": None if eos_id is None else int(eos_id),
            "deadline_ms": deadline_ms,
        })
        return np.asarray(reply["tokens"], dtype=np.int32)

    def stats(self):
        return self._call({"op": "stats"})["stats"]

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
