"""Training goodput ledger: every second of a supervised run, attributed.

Counterpart of ``paddle_tpu/observability/goodput.py``. A
:class:`GoodputLedger` attributes a run's wall clock to the closed
category set :data:`CATEGORIES` (``compute``, ``compile``,
``data_stall``, ``h2d``, ``checkpoint``, ``recovery``, ``preempt`` and
``other``, the unattributed remainder, so the categories sum to wall
and an over-count shows as ``overcount_s``). Exports:

- ``train_time_seconds_total{category}`` counters and the
  ``train_goodput_ratio`` gauge,
- a ``goodput/<category>_s`` counter track under an active profiler,
- :meth:`GoodputLedger.report`, the structured dict.

Its caller is ``train.TrainingSupervisor``, one ledger a supervised
run.
"""
import threading
import time
from contextlib import contextmanager

from .metrics import default_registry as _registry

CATEGORIES = ("compute", "compile", "data_stall", "h2d", "checkpoint",
              "recovery", "preempt", "other")

_TIME = _registry().counter(
    "train_time_seconds_total",
    "supervised-training wall seconds attributed per goodput-ledger "
    "category (compute/compile/data_stall/h2d/checkpoint/recovery/"
    "preempt/other)",
    labels=("category",), max_series=16)
_GOODPUT = _registry().gauge(
    "train_goodput_ratio",
    "compute seconds / wall seconds of the most recent supervised "
    "training run (goodput in the MegaScale sense)")


class GoodputLedger:
    """Per-run wall-time attribution. One ledger per supervised run;
    ``add``/``span`` charge seconds to a category, ``report`` closes
    the books (``other`` absorbs the unattributed remainder)."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._acc = {c: 0.0 for c in CATEGORIES}
        self._t0 = None
        self._t_end = None

    # -- lifecycle --------------------------------------------------------
    def start(self):
        self._t0 = self._clock()
        self._t_end = None
        return self

    def stop(self):
        if self._t0 is not None and self._t_end is None:
            self._t_end = self._clock()
            # fold the unattributed remainder into the exported
            # ``other`` counter so the Prometheus series sum to wall
            # like the in-process report does (idempotent: only the
            # first stop folds)
            with self._lock:
                attributed = sum(self._acc.values())
            rem = self.wall_s() - attributed
            if rem > 0:
                self.add("other", rem)
        return self

    def wall_s(self):
        if self._t0 is None:
            return 0.0
        end = self._t_end if self._t_end is not None else self._clock()
        return max(end - self._t0, 0.0)

    # -- recording --------------------------------------------------------
    def add(self, category, seconds):
        """Charge ``seconds`` to ``category`` (exported immediately;
        the per-run books live in this ledger)."""
        if category not in self._acc:
            raise ValueError(
                f"unknown goodput category {category!r} "
                f"(one of {CATEGORIES})")
        s = max(float(seconds), 0.0)
        with self._lock:
            self._acc[category] += s
            cum = self._acc[category]
            compute = self._acc["compute"]
        _TIME.inc(s, labels=(category,))
        wall = self.wall_s()
        if wall > 0:
            _GOODPUT.set(min(compute / wall, 1.0))
        # Perfetto counter track (active profiler only): cumulative
        # seconds per category, timestamped on the profiler's clock
        from .. import profiler as _prof
        if _prof.is_profiling():
            _prof.record_counter(f"goodput/{category}_s",
                                 self._clock(), cum)
        return s

    @contextmanager
    def span(self, category):
        """Charge the duration of the block to ``category`` (exception-
        safe — a raising block still lands its elapsed time)."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(category, self._clock() - t0)

    # -- reporting --------------------------------------------------------
    def report(self):
        """Close the books: ``{"wall_s", "categories", "goodput_ratio",
        "attributed_s", "unattributed_s", "overcount_s", "sum_s"}``.
        ``categories`` includes ``other`` = explicit other + the
        unattributed remainder, so ``sum_s`` equals ``wall_s`` unless
        the explicit categories OVER-counted (then ``overcount_s``
        > 0)."""
        wall = self.wall_s()
        with self._lock:
            acc = dict(self._acc)
        attributed = sum(acc.values())
        remainder = wall - attributed
        cats = dict(acc)
        cats["other"] += max(remainder, 0.0)
        total = sum(cats.values())
        compute = cats["compute"]
        return {
            "wall_s": wall,
            "categories": cats,
            "goodput_ratio": (compute / wall) if wall > 0 else 0.0,
            "attributed_s": attributed,
            "unattributed_s": max(remainder, 0.0),
            "overcount_s": max(-remainder, 0.0),
            "sum_s": total,
        }
