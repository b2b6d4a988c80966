"""Flight recorder: a bounded ring of recent structured events.

Counterpart of ``paddle_tpu/observability/recorder.py``. Subsystems
``record(kind, **fields)`` cheap structured events (admissions, fault
firings, non-finite steps, cache evictions, kvpool leaks, SLO breaches);
the ring (``FLAGS_flight_recorder_events`` entries) keeps the most
recent N. Dumps:

- the ``"debug_dump"`` serving wire op returns the events inline;
- :meth:`FlightRecorder.dump` writes a JSON file on demand;
- :meth:`FlightRecorder.auto_dump` fires when an Internal error crosses
  the serving wire boundary, rate-limited, under
  ``FLAGS_flight_recorder_dir`` (empty: automatic dumps off).

Event fields are coerced into the wire's value universe
(str/int/float/bool/None), so a snapshot crosses the wire unchanged.
"""
import json
import os
import threading
import time
from collections import deque

from ..flags import flag as _flag
from .metrics import default_registry

_EVENTS = default_registry().counter(
    "flight_recorder_events_total",
    "structured events recorded into the flight-recorder ring",
    labels=("kind",), max_series=64)
_DUMPS = default_registry().counter(
    "flight_recorder_dumps_total",
    "flight-recorder JSON dumps written (manual + automatic)")

_AUTO_DUMP_MIN_INTERVAL_S = 30.0


def _wire_safe(v):
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    return str(v)


class FlightRecorder:
    """Thread-safe bounded event ring with JSON dumps."""

    def __init__(self, capacity=None):
        # capacity=None tracks FLAGS_flight_recorder_events live (the
        # singleton); an explicit capacity stays pinned
        self._flag_sized = capacity is None
        cap = int(capacity if capacity is not None
                  else _flag("flight_recorder_events"))
        self._ring = deque(maxlen=max(cap, 1))
        self._lock = threading.Lock()
        self._seq = 0
        self._dumps = 0
        self._last_auto = 0.0

    def _maybe_resize(self):
        """set_flags({"flight_recorder_events": N}) must take effect on
        the live singleton — every other telemetry flag is read per
        call, so a pre-soak resize silently ignored would shrink the
        postmortem window with no error. Rebuilds the deque (keeping
        the most recent events) only when the flag actually changed."""
        if not self._flag_sized:
            return
        cap = max(int(_flag("flight_recorder_events")), 1)
        if cap != self._ring.maxlen:
            with self._lock:
                if cap != self._ring.maxlen:
                    self._ring = deque(self._ring, maxlen=cap)

    def record(self, kind, **fields):
        """Append one event; ``fields`` coerced wire-safe. Cheap enough
        for per-request call sites (dict build + deque append under a
        lock)."""
        self._maybe_resize()
        ev = {"kind": str(kind), "t": time.time()}
        for k, v in fields.items():
            ev[k] = _wire_safe(v)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
        _EVENTS.inc(labels=(str(kind),))
        return ev

    def snapshot(self):
        """The retained events, oldest first (copies — wire-safe)."""
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def counts(self):
        """{kind: n} over the retained window."""
        out = {}
        with self._lock:
            for ev in self._ring:
                out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()

    def dump(self, path=None, reason=None):
        """Write the ring to a JSON file (atomic tmp+rename) and return
        the path. Default path lands in ``FLAGS_flight_recorder_dir``
        (or the OS tempdir when the flag is empty) as
        ``flightrec-<pid>-<seq>.json``."""
        events = self.snapshot()
        if path is None:
            import tempfile
            d = _flag("flight_recorder_dir") or tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            with self._lock:
                self._dumps += 1
                n = self._dumps
            # per-recorder dump counter in the name: two dumps with no
            # intervening events must not overwrite each other
            path = os.path.join(
                d, f"flightrec-{os.getpid()}-{n:04d}.json")
        doc = {"reason": reason, "dumped_at": time.time(),
               "events": events}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        _DUMPS.inc()
        return path

    def auto_dump(self, reason):
        """The server-boundary trigger: dump iff
        ``FLAGS_flight_recorder_dir`` is set, rate-limited to one dump
        per 30s so an error storm costs one file, not thousands.
        Returns the path or None."""
        d = _flag("flight_recorder_dir")
        if not d:
            return None
        now = time.monotonic()
        with self._lock:
            if now - self._last_auto < _AUTO_DUMP_MIN_INTERVAL_S:
                return None
            self._last_auto = now
        try:
            return self.dump(reason=reason)
        except OSError:
            return None          # a full disk must not break serving


_recorder = None
_recorder_lock = threading.Lock()


def flight_recorder():
    """The process-global recorder (lazily sized from
    ``FLAGS_flight_recorder_events``)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder
