"""Serving statistics: per-stage latency histograms and counters.

Counterpart of ``paddle_tpu/serving/metrics.py`` (``ServingStats``,
``LatencyHistogram``). The infer stages are ``queue`` (enqueue to batch
flush), ``pad`` (batch assembly), ``compile`` (capture of a new
signature), ``execute`` (one padded batch through its captured program)
and ``total`` (enqueue to reply); the generation stages are ``prefill``,
``decode``, ``sample`` and ``token`` (one whole decode-loop step). The
generation counters include the speculative steps (``spec_steps``,
``spec_drafted``, ``spec_accepted``, ``spec_rejected``) and the KV
migrations (``kv_exports``, ``kv_imports``). ``snapshot()`` adds
``throughput_rps``, ``mean_batch_size``, ``batch_occupancy``,
``tokens_per_s``, ``decode_occupancy`` and ``spec_accept_ratio``; the
server adds the pool's ``kvpool_*`` gauges beside them.

Three export paths share one measurement: each stage duration lands in
a ``LatencyHistogram`` (always on), in the profiler's event table
(``profiler.record_duration``, while profiling is active), and,
aggregated across every live ``ServingStats``, in the process
``observability`` registry through a scrape-time collector
(``serving_<counter>_total`` and the ``serving_stage_latency_ms``
histogram). The priority-class families (``serving_admission_shed_total``,
``serving_class_completed_total``, ``serving_class_latency_ms``,
``serving_expired_in_queue_total``, ``serving_spec_accept_ratio``) are
native registry families. The ``snapshot()`` payload does not change.

Unlike the JAX package's estimate, a percentile never exceeds the
histogram's maximum (nor falls below 0): the interpolation inside the
winning bucket is clamped to ``[0, max]``.
"""
import threading
import time

from .. import profiler as _prof
from ..observability.metrics import DEFAULT_BOUNDS_MS  # noqa: F401
from ..observability.metrics import InstanceAggregator, default_registry


class LatencyHistogram:
    """Fixed-bucket latency histogram (observations in seconds, bounds in
    ms). Percentiles are linear-interpolated within the winning bucket —
    the standard prometheus-style estimate, good to a bucket width."""

    def __init__(self, name, bounds_ms=DEFAULT_BOUNDS_MS):
        self.name = name
        self.bounds_ms = tuple(float(b) for b in bounds_ms)
        self._counts = [0] * (len(self.bounds_ms) + 1)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds):
        ms = seconds * 1e3
        idx = len(self.bounds_ms)
        for i, b in enumerate(self.bounds_ms):
            if ms <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += seconds
            if seconds > self._max:
                self._max = seconds
        _prof.record_duration(self.name, seconds)

    @property
    def count(self):
        return self._count

    def _state(self):
        """One consistent copy of everything derived values need."""
        with self._lock:
            return list(self._counts), self._count, self._sum, self._max

    def _estimate(self, counts, count, mx, p):
        """Percentile from a CONSISTENT (counts, count, max) snapshot —
        all of snapshot()'s derived values come from one copy, so p50/
        p99 can never disagree with count under concurrent observe() —
        clamped to [0, max]: a bucket's linear interpolation can land
        past the largest observation in it (one 51 ms observation in
        the (50, 100] bucket would read p50 75 ms)."""
        if not count:
            return 0.0
        target = count * (float(p) / 100.0)
        seen = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if seen + c >= target:
                lo = self.bounds_ms[i - 1] if i > 0 else 0.0
                hi = (self.bounds_ms[i]
                      if i < len(self.bounds_ms) else mx * 1e3)
                frac = (target - seen) / c
                est = (lo + (max(hi, lo) - lo) * frac) / 1e3
                return min(max(est, 0.0), mx)
            seen += c
        return mx

    def percentile(self, p):
        """p in [0, 100] -> estimated latency in seconds."""
        counts, count, _total, mx = self._state()
        return self._estimate(counts, count, mx, p)

    def snapshot(self):
        counts, count, total, mx = self._state()
        return {
            "count": count,
            "mean_ms": round(total / count * 1e3, 3) if count else 0.0,
            "p50_ms": round(self._estimate(counts, count, mx, 50) * 1e3,
                            3),
            "p99_ms": round(self._estimate(counts, count, mx, 99) * 1e3,
                            3),
            "max_ms": round(mx * 1e3, 3),
        }


# -- priority-class admission telemetry --------------------------------
#
# Native registry families (not ServingStats counters) because they are
# class-labeled and shared across every queue/server in the process:
# one `class` axis is what dashboards slice.

_CLASS_SHED = default_registry().counter(
    "serving_admission_shed_total",
    "requests shed at admission by overload machinery (queue-full "
    "refusal, priority eviction, breaker, brownout), by priority class",
    labels=("class",), max_series=8)
_CLASS_DONE = default_registry().counter(
    "serving_class_completed_total",
    "requests completed end-to-end, by priority class",
    labels=("class",), max_series=8)
_CLASS_LAT = default_registry().histogram(
    "serving_class_latency_ms",
    "end-to-end request latency (admission -> result), by priority "
    "class",
    labels=("class",), max_series=8)
_EXPIRED_IN_QUEUE = default_registry().counter(
    "serving_expired_in_queue_total",
    "queued requests evicted because their deadline expired while "
    "waiting (failed typed instead of dequeuing into a doomed batch)")


_SPEC_ACCEPT = default_registry().gauge(
    "serving_spec_accept_ratio",
    "windowed draft-token acceptance rate of the speculative decode "
    "loop (accepted / proposed over the recent window), by decode-loop "
    "scope — the signal that drives adaptive per-request draft depth",
    labels=("scope",), max_series=256)


def record_spec_accept_ratio(scope, ratio):
    _SPEC_ACCEPT.set(float(ratio), labels=(str(scope),))


def record_class_shed(priority):
    _CLASS_SHED.inc(labels=(str(priority),))


def record_class_done(priority, seconds):
    """One completed request of ``priority`` that took ``seconds`` from
    admission to result — feeds the per-class goodput counters and the
    per-class latency histogram."""
    _CLASS_DONE.inc(labels=(str(priority),))
    _CLASS_LAT.observe(float(seconds) * 1e3, labels=(str(priority),))


def record_expired_in_queue(n=1):
    _EXPIRED_IN_QUEUE.inc(n)


# -- registry bridge ---------------------------------------------------

# counter banking across sink churn lives in the shared
# InstanceAggregator (see its docstring for the monotonicity
# rationale); the stage-HISTOGRAM mass of garbage-collected sinks is
# serving-specific and banked here, riding the same finalizer
_retired_lock = threading.Lock()
_retired_stages = {}            # stage -> [bucket counts, count, sum]


def _merge_hist(stages, stage, hist):
    """Fold one LatencyHistogram's consistent (counts, count, sum)
    snapshot into ``stages[stage]`` — the one copy of the bucket merge
    shared by the retire bank and the live scrape."""
    with hist._lock:
        counts, count, tot = list(hist._counts), hist._count, hist._sum
    agg = stages.get(stage)
    if agg is None:
        stages[stage] = [counts, count, tot]
    else:
        agg[0] = [a + b for a, b in zip(agg[0], counts)]
        agg[1] += count
        agg[2] += tot


def _retire_hists(hists):
    """Fold a dead sink's stage histograms into the retired totals (the
    closure keeps only the histogram dict alive, not the sink)."""
    with _retired_lock:
        for stage, h in hists.items():
            _merge_hist(_retired_stages, stage, h)

# ServingStats counter keys (module-level so the metrics collector can
# DECLARE serving_<key>_total families without an instance)
_COUNTER_KEYS = (
    "requests_admitted",
    "requests_completed",
    "requests_failed",
    "shed_overload",
    "shed_deadline",
    "batches",
    "rows",               # real example rows executed
    "padded_rows",        # bucket capacity across executed batches
    "compiles",
    # -- generation (decode batching) --
    "generate_requests",
    "tokens_generated",
    "decode_steps",
    "decode_rows",        # live generation rows stepped
    "decode_slot_rows",   # slot capacity across steps
    # -- disaggregated prefill/decode (KV migration) --
    "kv_exports",         # prefill-only requests serialized out
    "kv_imports",         # migrated requests admitted from KV blocks
    "engine_failures",    # failed execute / decode steps
    "watchdog_timeouts",  # executes and decode steps killed by the watchdog
    "loop_restarts",      # supervisor-restarted loop threads
    "weight_reloads",     # successful reload_weights swaps
    "hedge_dedup_hits",   # hedged twins joined in flight
    "requests_cancelled",  # cancel op (hedge losers, abandoned calls)
    # -- speculative decoding (paged verify + rejection sampling) --
    "spec_steps",         # verify steps taken (vs plain decode_steps)
    "spec_drafted",       # draft tokens proposed across all rows
    "spec_accepted",      # draft tokens accepted by verification
    "spec_rejected",      # verify runs with >= 1 rejected draft
)


_sink_agg = InstanceAggregator(_COUNTER_KEYS)


def _collect():
    """Scrape-time collector: aggregate counters and stage histograms
    across every live ServingStats sink (multiple servers in one
    process sum — one card, one exposition) PLUS the retired totals of
    collected sinks, so the exported counters never decrease."""
    totals = _sink_agg.totals(lambda s: s._counts_copy())
    sinks = _sink_agg.live()
    with _retired_lock:
        stage_counts = {stage: [list(a[0]), a[1], a[2]]
                        for stage, a in _retired_stages.items()}
    for s in sinks:
        for stage, h in s.hist.items():
            _merge_hist(stage_counts, stage, h)
    fams = [{"name": f"serving_{k}_total", "kind": "counter",
             "help": f"ServingStats counter {k!r}", "labels": (),
             "samples": [((), totals[k])]} for k in _COUNTER_KEYS]
    hsamples = []
    for stage in sorted(stage_counts):
        counts, count, tot = stage_counts[stage]
        cum, buckets = 0, []
        for le, c in zip(DEFAULT_BOUNDS_MS + (float("inf"),), counts):
            cum += c
            buckets.append((le, cum))
        hsamples.append(((stage,), {"buckets": buckets, "count": count,
                                    "sum": round(tot * 1e3, 6)}))
    fams.append({"name": "serving_stage_latency_ms", "kind": "histogram",
                 "help": "per-stage serving latency (sum in ms)",
                 "labels": ("stage",), "samples": hsamples})
    return fams


default_registry().register_collector(
    _collect,
    families=[{"name": f"serving_{k}_total", "kind": "counter",
               "help": f"ServingStats counter {k!r}", "labels": ()}
              for k in _COUNTER_KEYS]
    + [{"name": "serving_stage_latency_ms", "kind": "histogram",
        "help": "per-stage serving latency (sum in ms)",
        "labels": ("stage",)}])


class ServingStats:
    """One shared stats sink for queue, batcher, engine and server: stage
    histograms plus monotonic counters. ``snapshot()`` is the
    ``server.stats()`` payload — plain ints/floats only, so it crosses
    the wire protocol's typed value universe unchanged. Every live sink
    also aggregates into the process metrics registry (see module
    docstring)."""

    STAGES = ("queue", "pad", "compile", "execute", "total",
              # generation pipeline stages (KV-cached decoding):
              # prefill = prompt ingestion forward, decode = one
              # incremental step over the slot batch, sample = the
              # next-token selection executable, token = one WHOLE
              # decode-loop step (engine.step wall: decode + sample +
              # host work — the inter-token latency the SLO monitor's
              # default p99 rule watches; a stall anywhere in the step
              # lands here even if the compiled call itself was fast)
              "prefill", "decode", "sample", "token")

    def __init__(self):
        self.hist = {s: LatencyHistogram(f"serving/{s}")
                     for s in self.STAGES}
        self._lock = threading.Lock()
        self._started = time.monotonic()
        self._c = {k: 0 for k in _COUNTER_KEYS}
        # closures bind the stat containers, never self
        _sink_agg.track(self, lambda c=self._c: dict(c),
                        extra_retire=lambda h=self.hist: _retire_hists(h))

    def _counts_copy(self):
        with self._lock:
            return dict(self._c)

    def bump(self, name, n=1):
        with self._lock:
            self._c[name] += n

    def observe_batch(self, rows, capacity):
        with self._lock:
            self._c["batches"] += 1
            self._c["rows"] += rows
            self._c["padded_rows"] += capacity

    def observe_decode_step(self, live_rows, slots):
        with self._lock:
            self._c["decode_steps"] += 1
            self._c["decode_rows"] += live_rows
            self._c["decode_slot_rows"] += slots

    def counter(self, name):
        with self._lock:
            return self._c[name]

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
        out["tokens_per_s"] = round(
            c["tokens_generated"] / uptime, 3) if uptime > 0 else 0.0
        out["decode_occupancy"] = round(
            c["decode_rows"] / c["decode_slot_rows"], 4) \
            if c["decode_slot_rows"] else 0.0
        out["spec_accept_ratio"] = round(
            c["spec_accepted"] / c["spec_drafted"], 4) \
            if c["spec_drafted"] else 0.0
        for s, h in self.hist.items():
            snap = h.snapshot()
            for k, v in snap.items():
                out[f"{s}_{k}"] = v
        if extra:
            out.update(extra)
        return out
