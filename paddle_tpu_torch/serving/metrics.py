"""Serving statistics: per-stage latency histograms and counters.

Counterpart of ``paddle_tpu/serving/metrics.py`` (``ServingStats``,
``LatencyHistogram``), without the process-wide metrics registry. The
infer stages are ``queue`` (enqueue to batch flush), ``pad`` (batch
assembly), ``compile`` (capture of a new signature), ``execute`` (one
padded batch through its captured program) and ``total`` (enqueue to
reply); the generation stages are ``prefill``, ``decode``, ``sample``
and ``token`` (one whole decode-loop step). The generation counters
include the speculative steps (``spec_steps``, ``spec_drafted``,
``spec_accepted``, ``spec_rejected``: verify steps with a rejected
draft) and the KV migrations (``kv_exports``, ``kv_imports``).
``snapshot()`` adds ``throughput_rps``, ``mean_batch_size``,
``batch_occupancy`` (real rows over bucket rows), ``tokens_per_s``,
``decode_occupancy`` and ``spec_accept_ratio``; the server adds the
pool's ``kvpool_*`` gauges (occupancy, prefix-cache hits, evictions,
copy-on-writes, leaks) beside them.
"""
import threading
import time

# log-spaced upper bounds in milliseconds (last bucket +inf)
DEFAULT_BOUNDS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                     100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class LatencyHistogram:
    """Fixed-bucket histogram (observations in seconds, bounds in ms);
    percentiles interpolate linearly inside the winning bucket."""

    def __init__(self):
        self.bounds_ms = DEFAULT_BOUNDS_MS
        self._counts = [0] * (len(self.bounds_ms) + 1)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds):
        ms = seconds * 1e3
        idx = next((i for i, b in enumerate(self.bounds_ms) if ms <= b),
                   len(self.bounds_ms))
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += seconds
            self._max = max(self._max, seconds)

    def _estimate(self, counts, count, mx, p):
        if not count:
            return 0.0
        target = count * (float(p) / 100.0)
        seen = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if seen + c >= target:
                lo = self.bounds_ms[i - 1] if i > 0 else 0.0
                hi = (self.bounds_ms[i] if i < len(self.bounds_ms)
                      else mx * 1e3)
                return (lo + (max(hi, lo) - lo) * (target - seen) / c) / 1e3
            seen += c
        return mx

    def snapshot(self):
        with self._lock:
            counts, count, total, mx = (list(self._counts), self._count,
                                        self._sum, self._max)
        return {
            "count": count,
            "mean_ms": round(total / count * 1e3, 3) if count else 0.0,
            "p50_ms": round(self._estimate(counts, count, mx, 50) * 1e3, 3),
            "p99_ms": round(self._estimate(counts, count, mx, 99) * 1e3, 3),
            "max_ms": round(mx * 1e3, 3),
        }


_COUNTER_KEYS = (
    "requests_admitted", "requests_completed", "requests_failed",
    "shed_overload", "shed_deadline", "engine_failures",
    "batches", "rows", "padded_rows", "compiles",
    "generate_requests", "tokens_generated", "decode_steps",
    "decode_rows", "decode_slot_rows", "kv_exports", "kv_imports",
    "spec_steps", "spec_drafted", "spec_accepted", "spec_rejected",
)


class ServingStats:
    """One stats sink shared by queue, batcher, engine, generator and
    server. ``snapshot()`` is plain ints and floats, so it crosses the
    wire unchanged."""

    STAGES = ("queue", "pad", "compile", "execute", "total", "prefill",
              "decode", "sample", "token")

    def __init__(self):
        self.hist = {s: LatencyHistogram() for s in self.STAGES}
        self._lock = threading.Lock()
        self._started = time.monotonic()
        self._c = {k: 0 for k in _COUNTER_KEYS}

    def bump(self, name, n=1):
        with self._lock:
            self._c[name] += n

    def counter(self, name):
        with self._lock:
            return self._c[name]

    def observe_batch(self, rows, capacity):
        """One executed batch: ``rows`` real rows in a bucket of
        ``capacity``."""
        with self._lock:
            self._c["batches"] += 1
            self._c["rows"] += rows
            self._c["padded_rows"] += capacity

    def observe_decode_step(self, live_rows, slots):
        with self._lock:
            self._c["decode_steps"] += 1
            self._c["decode_rows"] += live_rows
            self._c["decode_slot_rows"] += slots

    def snapshot(self, extra=None):
        with self._lock:
            c = dict(self._c)
            uptime = time.monotonic() - self._started
        out = {"uptime_s": round(uptime, 3)}
        out.update(c)
        out["throughput_rps"] = round(
            c["requests_completed"] / uptime, 3) if uptime > 0 else 0.0
        out["mean_batch_size"] = round(
            c["rows"] / c["batches"], 3) if c["batches"] else 0.0
        out["batch_occupancy"] = round(
            c["rows"] / c["padded_rows"], 4) if c["padded_rows"] else 0.0
        out["tokens_per_s"] = round(c["tokens_generated"] / uptime, 3) \
            if uptime > 0 else 0.0
        out["decode_occupancy"] = round(
            c["decode_rows"] / c["decode_slot_rows"], 4) \
            if c["decode_slot_rows"] else 0.0
        out["spec_accept_ratio"] = round(
            c["spec_accepted"] / c["spec_drafted"], 4) \
            if c["spec_drafted"] else 0.0
        for s, h in self.hist.items():
            for k, v in h.snapshot().items():
                out[f"{s}_{k}"] = v
        if extra:
            out.update(extra)
        return out
