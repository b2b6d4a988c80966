"""Profiler surface (reference: python/paddle/fluid/profiler.py:
profiler context manager :253, start_profiler :129, stop_profiler :180,
reset_profiler :113, cuda_profiler :39).

Counterpart of ``paddle_tpu/profiler.py``. The host event table and the
unified span table are the JAX package's: ``Executor.run`` reports
``run/program_<uid>`` spans, the pass pipeline ``pass/<name>``, the
serving stages ``serving/<stage>``, ``record_event`` covers user scopes,
and traced requests (``observability.tracing``) land in the same span
table, so ``stop_profiler(profile_path=...)`` writes the JSON that
``tools/timeline.py`` reads. The device tracer is ``torch.profiler``:
with ``trace_dir`` a session records CPU activity (``state="CPU"``) or
CUDA activity too (``"GPU"``, ``"All"``; these raise without a card) and
``stop_profiler`` writes its Chrome trace into ``trace_dir``.
``profile_program`` interprets a program once with per-op timers.
"""
import contextlib
import os
import threading
import time

import numpy as np

_events = {}          # name -> [calls, total_s, max_s, min_s]
# (name, start_s, end_s, tid[, trace_id, span_id, parent_id]) — the
# unified timeline source: profiler events AND sampled request-trace
# spans (observability.tracing) land here, so tools/timeline.py renders
# one Chrome trace interleaving both. A deque: at the _MAX_SPANS cap a
# bounded PROFILING session keeps the first N (a run's head is what a
# bench wants), while the always-on traced stream of a long-lived
# server rotates the OLDEST span out (a postmortem wants the newest) —
# either way drops are counted, never silent
import collections as _collections
_spans = _collections.deque()
# the traced stream appends from server threads while a caller may be
# dumping/clearing — every structural span-table access takes this lock
# (appends are rare enough that a ~100ns lock is in the noise)
_spans_lock = threading.Lock()
_MAX_SPANS = 200000   # bound memory on long profiled runs
_spans_dropped = 0    # spans lost to the _MAX_SPANS cap since reset
_spans_dropped_cum = 0  # process-lifetime drop total: reset_profiler
                        # zeroes the session counter only, so the
                        # exported telemetry_spans_dropped_total stays
                        # monotonic (Prometheus counter contract)
_active = False
_trace_dir = None

# step-time histogram: log2 buckets over per-step wall time, fed by the
# training loop (Executor.run_steps amortizes one slab measurement over
# its K steps). Bounded by construction — counters, not samples.
_STEP_BUCKETS_MS = (0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0,
                    300.0, 1000.0, 3000.0, 10000.0)
_step_hist = [0] * (len(_STEP_BUCKETS_MS) + 1)
_step_stats = [0, 0.0]  # count, total_s


def _record(name, seconds, start=None):
    global _spans_dropped, _spans_dropped_cum
    if not _active:
        return
    row = _events.setdefault(name, [0, 0.0, 0.0, float("inf")])
    row[0] += 1
    row[1] += seconds
    row[2] = max(row[2], seconds)
    row[3] = min(row[3], seconds)
    if start is not None:
        with _spans_lock:
            if len(_spans) < _MAX_SPANS:
                _spans.append((name, start, start + seconds,
                               threading.get_ident()))
            else:
                # count the loss: silent truncation reads as full
                # coverage
                _spans_dropped += 1
                _spans_dropped_cum += 1


def record_span(name, start_s, end_s, trace=None):
    """Append a completed span to the unified span table. ``trace`` is
    an optional ``(trace_id, span_id, parent_id)`` triple from
    ``observability.tracing``; TRACED spans record even while profiling
    is inactive (they are the always-on sampled request stream).
    Untraced spans record only under an active profiler. At the
    ``_MAX_SPANS`` cap an active profiling session keeps the FIRST N
    spans, the always-on traced stream rotates the oldest out — a
    long-lived server's stream never silently dies; drops are counted
    either way (:func:`spans_dropped`)."""
    global _spans_dropped, _spans_dropped_cum
    if trace is None and not _active:
        return
    row = (name, float(start_s), float(end_s), threading.get_ident())
    with _spans_lock:
        if len(_spans) >= _MAX_SPANS:
            _spans_dropped += 1
            _spans_dropped_cum += 1
            if _active:
                return          # profiling session: keep the run's head
            _spans.popleft()    # traced stream: keep the newest
        _spans.append(row if trace is None else row + tuple(trace))


# counter track: (name, t_s, value) samples — the memory profiler's
# hbm_live_bytes live-set timeline rides here so tools/timeline.py can
# render a Perfetto counter track under the op-level spans. Bounded
# like the span table; recorded only under an active profiler (the
# always-on path is the measured-op TABLE, not the counter track).
_counters = _collections.deque()
_MAX_COUNTERS = 100000


def record_counter(name, t_s, value):
    """Append one counter sample to the counter track (no-op while
    profiling is inactive; silently bounded at ``_MAX_COUNTERS``)."""
    if not _active:
        return
    with _spans_lock:
        if len(_counters) >= _MAX_COUNTERS:
            return
        _counters.append((str(name), float(t_s), float(value)))


def counters():
    """Snapshot of the counter track (name, t_s, value) rows."""
    with _spans_lock:
        return [list(c) for c in _counters]


def spans_dropped():
    """Spans lost to the ``_MAX_SPANS`` cap since the last
    ``reset_profiler()``."""
    return _spans_dropped


def spans_dropped_total():
    """Process-lifetime span-drop total — NEVER reset (the monotonic
    counter the metrics exposition exports)."""
    return _spans_dropped_cum


def is_profiling():
    return _active


def record_duration(name, seconds):
    """Record an externally timed span into the event table (no-op while
    profiling is off). The serving runtime's stage histograms feed their
    measurements through here, so a ``profiler.profiler()`` block around
    live traffic shows ``serving/*`` rows in the summary table."""
    _record(name, float(seconds))


def record_step_time(seconds, steps=1):
    """Accumulate `steps` training steps of `seconds` each into the
    step-time histogram (no-op while profiling is off). The fused loop
    measures once per slab and amortizes over its K steps."""
    if not _active:
        return
    import bisect
    i = bisect.bisect_left(_STEP_BUCKETS_MS, float(seconds) * 1e3)
    _step_hist[i] += int(steps)
    _step_stats[0] += int(steps)
    _step_stats[1] += float(seconds) * int(steps)


def step_time_histogram():
    """{"count", "mean_ms", "buckets": [(le_ms, n), ..., (inf, n)]} of
    every step recorded since the last reset_profiler()."""
    buckets = [(le, n) for le, n in zip(_STEP_BUCKETS_MS, _step_hist)]
    buckets.append((float("inf"), _step_hist[-1]))
    count = _step_stats[0]
    return {"count": count,
            "mean_ms": (_step_stats[1] / count * 1e3) if count else 0.0,
            "buckets": buckets}


@contextlib.contextmanager
def record_event(name):
    """RAII event span (reference platform::RecordEvent)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0, start=t0)


def reset_profiler():
    """reference profiler.py:113."""
    global _spans_dropped
    _events.clear()
    with _spans_lock:
        _spans.clear()
        _counters.clear()
        _spans_dropped = 0
    for i in range(len(_step_hist)):
        _step_hist[i] = 0
    _step_stats[0] = 0
    _step_stats[1] = 0.0


# the device tracer of the open session (torch.profiler.profile) and
# what the last one wrote
_device_prof = None
_last_device_trace = None


def _activities(state):
    """torch.profiler activities of ``state``: CPU for "CPU", CUDA for
    "GPU", both for "All". CUDA activity needs a card."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = []
    if state in ("CPU", "All"):
        acts.append(ProfilerActivity.CPU)
    if state in ("GPU", "All"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"profiler state {state!r} traces the GPU and there is no "
                f"CUDA device; use state='CPU' on the CPU")
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_profiler(state="All", tracer_option="Default",
                   trace_dir=None):
    """reference profiler.py:129. Starts the host event and span tables;
    with ``trace_dir`` also a ``torch.profiler`` session of ``state``'s
    activities (CUDA for "GPU"/"All", which raise without a card).
    ``state="GPU"`` needs a card even without ``trace_dir``."""
    global _active, _trace_dir, _spans_dropped, _spans_dropped_cum
    global _device_prof
    if state not in ("CPU", "GPU", "All"):
        raise ValueError("state must be 'CPU', 'GPU' or 'All'")
    if state == "GPU" or trace_dir:
        acts = _activities(state)
    # the always-on traced stream may have filled the span table while
    # profiling was off; the session keeps the FIRST N spans, so it
    # starts from the newest half of the backlog (drops counted)
    with _spans_lock:
        keep = _MAX_SPANS // 2
        while len(_spans) > keep:
            _spans.popleft()
            _spans_dropped += 1
            _spans_dropped_cum += 1
    if trace_dir:
        from torch.profiler import profile
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
        _device_prof = prof
        _trace_dir = trace_dir
    _active = True


def stop_profiler(sorted_key=None, profile_path="/tmp/profile"):
    """reference profiler.py:180: stop, print the summary table, write
    the recorded spans to ``profile_path`` (the file ``tools/timeline.py``
    converts to a Chrome trace) and, when a device trace was started,
    stop it and write its Chrome trace into the session's ``trace_dir``
    (:func:`last_device_trace` names it)."""
    global _active, _trace_dir, _device_prof, _last_device_trace
    _active = False
    if _device_prof is not None:
        prof, _device_prof = _device_prof, None
        prof.stop()
        path = os.path.join(
            _trace_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        _last_device_trace = {"path": path, "profile": prof}
        print(f"[profiler] device trace written to {path} (load in "
              f"Perfetto or chrome://tracing)")
        _trace_dir = None
    with _spans_lock:       # a traced request may append mid-dump
        span_snapshot = [list(s) for s in _spans]
        counter_snapshot = [list(c) for c in _counters]
    if profile_path and span_snapshot:
        import json
        with open(profile_path, "w") as f:
            json.dump({"spans": span_snapshot,
                       "counters": counter_snapshot,
                       "dropped": _spans_dropped}, f)
    if _spans_dropped:
        print(f"[profiler] {_spans_dropped} spans dropped (span table "
              f"capped at {_MAX_SPANS}; the event table and step "
              f"histogram still cover every call)")
    rows = summary(sorted_key)
    if rows:
        print(_format_table(rows))
    hist = step_time_histogram()
    if hist["count"]:
        buckets = ", ".join(
            (f"<={le:g}ms: {n}" if le != float("inf")
             else f">{_STEP_BUCKETS_MS[-1]:g}ms: {n}")
            for le, n in hist["buckets"] if n)
        print(f"[profiler] step time: {hist['count']} steps, mean "
              f"{hist['mean_ms']:.3f}ms [{buckets}]")
    return rows


def last_device_trace():
    """``{"path", "profile"}`` of the last device trace a session wrote
    (the Chrome trace file and the stopped ``torch.profiler.profile``,
    whose ``events()`` hold the kernel records), or None."""
    return _last_device_trace


def summary(sorted_key=None):
    rows = [(name, c, tot, tot / c, mx, mn)
            for name, (c, tot, mx, mn) in _events.items()]
    key = {None: lambda r: 0, "calls": lambda r: -r[1],
           "total": lambda r: -r[2], "ave": lambda r: -r[3],
           "max": lambda r: -r[4], "min": lambda r: -r[5]}.get(sorted_key)
    if key is None:
        raise ValueError(f"unknown sorted_key {sorted_key!r}")
    return sorted(rows, key=key)


def _format_table(rows):
    head = (f"{'Event':<44} {'Calls':>7} {'Total(ms)':>11} "
            f"{'Ave(ms)':>9} {'Max(ms)':>9} {'Min(ms)':>9}")
    lines = ["-------------------------     Profiling Report     "
             "-------------------------", head]
    for name, c, tot, ave, mx, mn in rows:
        lines.append(f"{name[:44]:<44} {c:>7} {tot * 1e3:>11.3f} "
                     f"{ave * 1e3:>9.3f} {mx * 1e3:>9.3f} "
                     f"{mn * 1e3:>9.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path="/tmp/profile",
             tracer_option="Default", trace_dir=None):
    """reference profiler.py:253 context manager."""
    start_profiler(state, tracer_option, trace_dir=trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*a, **k):
    """reference profiler.py:39: brackets the block with the CUDA
    profiler's start and stop (``torch.cuda.profiler``), for an external
    profiler attached to the process; a no-op without a card."""
    import torch
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.profiler.start()
    try:
        yield
    finally:
        torch.cuda.profiler.stop()


def profile_program(program, feed, scope=None, repeat=1, sync=True):
    """Reference-style PER-OP cost table: interpret the global block
    ``repeat`` times, timing each op (the device synchronized after each
    with ``sync``) through ``observability.profiling.measure_op_times``
    with side effects allowed (this walk IS the execution the caller
    asked for). It reads the scope and the feed and writes neither.
    Returns [(op_type, calls, total_s)] sorted by total."""
    from .framework.executor import global_scope
    from .observability import profiling as _profiling

    scope = scope or global_scope()
    env = {}
    for name, val in scope.items():
        env[name] = val
    for name, val in (feed or {}).items():
        env[name] = np.asarray(val)
    per_op = {}
    for _ in range(repeat):
        out = _profiling.measure_op_times(
            program, env, tag=f"program_{program._uid}",
            allow_side_effects=True, sync=sync)
        for r in out["rows"]:
            row = per_op.setdefault(r["type"], [0, 0.0])
            row[0] += 1
            row[1] += r["ms"] / 1e3
    rows = sorted(((t, c, tot) for t, (c, tot) in per_op.items()),
                  key=lambda r: -r[2])
    return rows
