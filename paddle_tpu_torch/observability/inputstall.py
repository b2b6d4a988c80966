"""Input-pipeline stall profiler.

Counterpart of ``paddle_tpu/observability/inputstall.py``: a
:class:`StallTracker` per producer/consumer queue exports

- ``dataio_queue_occupancy_ratio{queue}``, sampled every 16th pull,
- ``dataio_producer_wait_ms{queue}`` / ``dataio_consumer_wait_ms{queue}``
  wait histograms, observed only when a put or get blocked,
- ``dataio_data_stalls_total{queue}`` and a ``data_stall``
  flight-recorder event when, over a window of at least
  ``FLAGS_dataio_stall_window_s``, consumer waits exceed
  ``FLAGS_dataio_stall_ratio`` of wall time,
- a ``dataio/queue_depth/<queue>`` counter track under an active
  profiler.

Its hook sites (the buffered reader and the data loader's queue) are
not ported yet.
"""
import time

from ..flags import flag as _flag
from .metrics import default_registry as _registry
from .recorder import flight_recorder as _flightrec

_WAIT_BOUNDS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 5000.0)

_OCC = _registry().gauge(
    "dataio_queue_occupancy_ratio",
    "input-pipeline queue fill level (size/capacity) at the last "
    "sampled consumer pull, by queue",
    labels=("queue",), max_series=16)
_PROD_WAIT = _registry().histogram(
    "dataio_producer_wait_ms",
    "time an input-pipeline producer spent blocked on a full queue "
    "(consumer-bound pipeline), by queue",
    labels=("queue",), bounds=_WAIT_BOUNDS_MS, max_series=16)
_CONS_WAIT = _registry().histogram(
    "dataio_consumer_wait_ms",
    "time an input-pipeline consumer spent blocked on an empty queue "
    "(producer-bound pipeline — the training loop is data-stalled), "
    "by queue",
    labels=("queue",), bounds=_WAIT_BOUNDS_MS, max_series=16)
_STALLS = _registry().counter(
    "dataio_data_stalls_total",
    "windows in which consumer waits dominated wall time "
    "(FLAGS_dataio_stall_window_s / FLAGS_dataio_stall_ratio) — each "
    "one also lands a data_stall flight-recorder event",
    labels=("queue",), max_series=16)


class StallTracker:
    """Per-queue wait accounting + stall-window detection. One tracker
    per queue instance; metric families are shared (labeled by the
    queue's role name, e.g. ``buffered`` / ``dataloader``)."""

    def __init__(self, queue_label, capacity):
        self.label = str(queue_label)
        self.capacity = max(int(capacity), 1)
        self._labels = (self.label,)
        self._n_pulls = 0
        self._win_t0 = time.perf_counter()
        self._win_wait = 0.0

    # -- wait observations (called only when a block actually happened)
    def producer_wait(self, seconds):
        _PROD_WAIT.observe(float(seconds) * 1e3, labels=self._labels)

    def consumer_wait(self, seconds):
        s = float(seconds)
        _CONS_WAIT.observe(s * 1e3, labels=self._labels)
        self._win_wait += s
        self._window_tick(time.perf_counter())

    def _window_tick(self, now):
        """Close the current stall window when it has run its span.
        Ticked from EVERY consumer pull (blocking or not) — a window
        must never stretch across minutes of healthy pipeline and
        dilute a real stall below the flag threshold."""
        elapsed = now - self._win_t0
        if elapsed < float(_flag("dataio_stall_window_s")):
            return
        frac = self._win_wait / elapsed if elapsed > 0 else 0.0
        if self._win_wait > 0 \
                and frac >= float(_flag("dataio_stall_ratio")):
            _STALLS.inc(labels=self._labels)
            _flightrec().record(
                "data_stall", queue=self.label,
                wait_ms=round(self._win_wait * 1e3, 3),
                window_s=round(elapsed, 3),
                fraction=round(frac, 4))
        self._win_t0 = now
        self._win_wait = 0.0

    def sample_occupancy(self, qsize):
        """Sample the queue fill level (every 16th pull — a gauge set
        per sample would make telemetry the hot path). Also advances
        the stall window on every pull so healthy stretches close
        their (empty) windows instead of accumulating into the next
        stall's denominator."""
        self._window_tick(time.perf_counter())
        self._n_pulls += 1
        if (self._n_pulls - 1) & 15:   # first pull, then every 16th
            return
        _OCC.set(min(int(qsize) / self.capacity, 1.0),
                 labels=self._labels)
        from .. import profiler as _prof
        if _prof.is_profiling():
            _prof.record_counter(f"dataio/queue_depth/{self.label}",
                                 time.perf_counter(), int(qsize))
