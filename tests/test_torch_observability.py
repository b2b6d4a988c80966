"""The port's telemetry core against the JAX package's, on the CPU:
the metrics registry (byte-identical Prometheus text for the same
calls), the flight recorder, the profiler's span table, wire-compatible
traces, the utilization gauges and the card's peak tables, the
executor's cost counters, the LatencyHistogram percentile clamp, the
metric catalog, and the ``metrics`` / ``debug_dump`` wire ops with a
traced infer request through a served MLP."""
import gc
import json
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import observability as jobs
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.observability import (FlightRecorder, MetricsRegistry,
                                            flight_recorder, render_metrics,
                                            set_peaks, tracing)
from paddle_tpu_torch.observability import utilization as util
from paddle_tpu_torch.serving.metrics import LatencyHistogram, ServingStats

import torch_served_models as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = T.CPUPlace()


# ------------------------------------------------------- MetricsRegistry

def _script_counter_gauge(reg):
    c = reg.counter("x_requests_total", "reqs", labels=("kind",))
    g = reg.gauge("x_depth_count", "depth")
    c.inc(labels=("a",))
    c.inc(2, labels=("b",))
    c.inc(0.5, labels=("a",))
    g.set(7)
    reg.gauge("x_nan_value").set(float("nan"))
    reg.gauge("x_inf_value", labels=("s",)).set(float("-inf"),
                                                labels=("n",))


def _script_histogram(reg):
    h = reg.histogram("x_lat_ms", "lat", bounds=(1.0, 10.0),
                      labels=("stage",))
    for v in (0.5, 0.6, 5.0, 50.0, 1.0, 10.0):
        h.observe(v, labels=("q",))
    h.observe(3.25, labels=("e",))


def _script_escaping(reg):
    c = reg.counter("x_esc_total", labels=("p",))
    c.inc(labels=('a"b\\c\nd',))
    c.inc(3, labels=("plain",))


def _script_cardinality(reg):
    c = reg.counter("x_card_total", labels=("k",), max_series=4)
    for i in range(10):
        c.inc(labels=(f"v{i}",))
    g = reg.gauge("x_cardg_count", labels=("k",), max_series=2)
    for i in range(5):
        g.set(i, labels=(f"w{i}",))


def _script_collector(reg):
    reg.register_collector(
        lambda: [{"name": "y_things_total", "kind": "counter", "help": "h",
                  "labels": ("a",), "samples": [(("x",), 5), (("y",), 2)],
                  "dropped": 3},
                 {"name": "y_lat_ms", "kind": "histogram", "help": "l",
                  "labels": (), "samples": [((), {
                      "buckets": [(1.0, 1), (float("inf"), 2)],
                      "count": 2, "sum": 4.5})]}],
        families=[{"name": "y_things_total", "kind": "counter",
                   "help": "h", "labels": ("a",)},
                  {"name": "y_lat_ms", "kind": "histogram", "help": "l",
                   "labels": ()}])
    reg.register_collector(lambda: 1 / 0, families=[])   # a broken sink
    reg.counter("z_native_total").inc(4)


SCRIPTS = {"counter_gauge": _script_counter_gauge,
           "histogram": _script_histogram, "escaping": _script_escaping,
           "cardinality": _script_cardinality,
           "collector": _script_collector}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_renders_identically(name):
    """The same registry calls give byte-identical Prometheus text and
    the same catalog and structured snapshot in both packages."""
    regs = (jobs.MetricsRegistry(), MetricsRegistry())
    for reg in regs:
        SCRIPTS[name](reg)
    j, t = regs
    assert t.render() == j.render()
    assert t.catalog() == j.catalog()
    tc, jc = t.collect(), j.collect()
    assert json.dumps(tc, sort_keys=True, default=str) == \
        json.dumps(jc, sort_keys=True, default=str)


def test_registry_name_validation_and_uniqueness():
    for reg in (MetricsRegistry(), jobs.MetricsRegistry()):
        with pytest.raises(ValueError, match="snake_case"):
            reg.counter("BadName_total")
        with pytest.raises(ValueError, match="unit suffix"):
            reg.counter("x_requests")
        reg.counter("dup_total")
        reg.counter("dup_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("dup_total")
    assert tobs.UNIT_SUFFIXES == jobs.UNIT_SUFFIXES
    assert tobs.DEFAULT_BOUNDS_MS == jobs.DEFAULT_BOUNDS_MS


def test_counters_monotonic_across_sink_gc():
    """A collected ServingStats banks its counts: the exported counter
    never falls (InstanceAggregator)."""
    def admitted():
        m = re.search(r"^serving_requests_admitted_total (\S+)$",
                      render_metrics(), re.M)
        return float(m.group(1))

    base = admitted()
    s = ServingStats()
    s.bump("requests_admitted", 5)
    s.hist["queue"].observe(0.001)
    assert admitted() == base + 5
    del s
    gc.collect()
    assert admitted() == base + 5


# ------------------------------------------------- LatencyHistogram clamp

def test_latency_histogram_percentile_never_exceeds_max():
    """One 51 ms observation lands in the (50, 100] bucket, whose linear
    interpolation reads p50 75 ms and p99 99.5 ms in the JAX package;
    the port clamps every percentile to [0, max]."""
    h = LatencyHistogram("t")
    h.observe(0.051)
    s = h.snapshot()
    assert s["max_ms"] == 51.0
    assert s["p50_ms"] == s["p99_ms"] == 51.0
    assert h.percentile(50) == pytest.approx(0.051)
    jh = __import__("paddle_tpu.serving.metrics",
                    fromlist=["x"]).LatencyHistogram("t")
    jh.observe(0.051)
    assert jh.snapshot()["p50_ms"] == 75.0       # the reference's reading
    # where the interpolation stays under the max, both agree exactly
    for hist in (h, jh):
        for v in (0.0004, 0.003, 0.02, 0.2, 0.999, 0.999):
            hist.observe(v)
    assert h.snapshot() == jh.snapshot()
    assert h.snapshot()["p99_ms"] <= h.snapshot()["max_ms"]


def test_serving_stats_snapshot_keys():
    """The stats payload is the JAX package's, the resilience counters
    (watchdog, loop restarts, weight reloads, hedging, cancel)
    included."""
    jkeys = set(__import__("paddle_tpu.serving.metrics", fromlist=["x"])
                .ServingStats().snapshot())
    assert set(ServingStats().snapshot()) == jkeys


# --------------------------------------------------- profiler span table

def test_spans_dropped_total_monotonic_across_reset(monkeypatch):
    base = tprof.spans_dropped_total()
    monkeypatch.setattr(tprof, "_MAX_SPANS", 1)
    root = tracing.new_trace()
    tracing.record_child("a", 0.0, 1.0, root)
    tracing.record_child("b", 0.0, 1.0, root)
    monkeypatch.undo()
    tprof.reset_profiler()
    assert tprof.spans_dropped() == 0
    assert tprof.spans_dropped_total() >= base + 1
    line = [ln for ln in render_metrics().splitlines()
            if ln.startswith("telemetry_spans_dropped_total ")][0]
    assert float(line.split()[1]) == tprof.spans_dropped_total()


def test_profiler_counts_dropped_spans(tmp_path, capsys, monkeypatch):
    tprof.reset_profiler()
    monkeypatch.setattr(tprof, "_MAX_SPANS", 3)
    tprof.start_profiler(state="CPU")
    for _ in range(5):
        with tprof.record_event("ev"):
            pass
    path = str(tmp_path / "prof.json")
    tprof.stop_profiler(profile_path=path)
    assert "2 spans dropped" in capsys.readouterr().out
    assert tprof.spans_dropped() == 2
    with open(path) as f:
        doc = json.load(f)
    assert doc["dropped"] == 2 and len(doc["spans"]) == 3
    tprof.reset_profiler()
    assert tprof.spans_dropped() == 0


# -------------------------------------------------------- flight recorder

def test_flight_recorder_ring_and_dump_match_reference(tmp_path):
    recs = (jobs.FlightRecorder(capacity=3), FlightRecorder(capacity=3))
    for rec in recs:
        for i in range(5):
            rec.record("ev", i=i, arr=np.int32(7), f=1.5, none=None)
    jev, tev = (r.snapshot() for r in recs)
    strip = [[{k: v for k, v in e.items() if k != "t"} for e in evs]
             for evs in (jev, tev)]
    assert strip[0] == strip[1]
    assert [e["i"] for e in tev] == [2, 3, 4]
    assert isinstance(tev[0]["arr"], str)
    assert recs[1].counts() == recs[0].counts() == {"ev": 3}
    path = recs[1].dump(path=str(tmp_path / "d.json"), reason="test")
    with open(path) as f:
        doc = json.load(f)
    assert doc["reason"] == "test" and len(doc["events"]) == 3


def test_flight_recorder_auto_dump_gated_and_rate_limited(tmp_path,
                                                          monkeypatch):
    """Off without FLAGS_flight_recorder_dir; then one dump per 30 s on
    a fake clock, in both packages alike."""
    clock = [1000.0]
    for pkg, rec_mod in ((T, tobs.recorder), (J, jobs.recorder)):
        monkeypatch.setattr(rec_mod.time, "monotonic", lambda: clock[0])
        rec = rec_mod.FlightRecorder(capacity=8)
        rec.record("x")
        assert rec.auto_dump("r") is None
        pkg.set_flags({"flight_recorder_dir": str(tmp_path / pkg.__name__)})
        try:
            got = []
            for dt in (0.0, 1.0, 28.0, 2.0, 0.5):
                clock[0] += dt
                got.append(rec.auto_dump("r") is not None)
            assert got == [True, False, False, True, False]
        finally:
            pkg.set_flags({"flight_recorder_dir": ""})


def test_flight_recorder_singleton_tracks_capacity_flag():
    rec = flight_recorder()
    default_cap = rec._ring.maxlen
    try:
        T.set_flags({"flight_recorder_events": 4})
        rec.record("cap_probe", i=0)
        assert rec._ring.maxlen == 4
        for i in range(1, 7):
            rec.record("cap_probe", i=i)
        kept = [e["i"] for e in rec.snapshot() if e["kind"] == "cap_probe"]
        assert kept == [3, 4, 5, 6]
        pinned = FlightRecorder(capacity=2)
        pinned.record("x")
        assert pinned._ring.maxlen == 2
    finally:
        T.set_flags({"flight_recorder_events": default_cap})
        rec.record("cap_probe", i=99)
        assert rec._ring.maxlen == default_cap


def test_fault_firings_land_in_recorder_and_registry():
    from paddle_tpu_torch import resilience
    rec = flight_recorder()
    before = rec.counts().get("chaos", 0)

    def fired():
        m = re.search(r'^chaos_faults_fired_total\{point="obs\.test_point"'
                      r'\} (\S+)$', render_metrics(), re.M)
        return float(m.group(1)) if m else 0.0

    base = fired()
    with resilience.fault_injection("obs.test_point", times=2):
        for _ in range(3):
            try:
                resilience.maybe_fail("obs.test_point")
            except ConnectionError:
                pass
    points = [e["point"] for e in rec.snapshot() if e["kind"] == "chaos"]
    assert points.count("obs.test_point") == 2
    assert rec.counts().get("chaos", 0) == before + 2
    assert fired() == base + 2


# ----------------------------------------------------------- utilization

def test_utilization_gauges_match_reference_formula():
    """observe_execution gives the JAX package's readings for the same
    observations: flops/s over the peak, bytes/s over the peak."""
    out = []
    for mod in (util, jobs.utilization):
        mod.reset_windows()
        mod.set_peaks(flops_per_s=1e12, hbm_bytes_per_s=1e11)
        try:
            cost = {"flops": 2e9, "bytes": 1e8}
            for s in (0.01, 0.02, 0.01, 0.005):
                mod.observe_execution("testwhere", cost, s)
            u = mod.utilization("testwhere")
            out.append((u["mfu"], u["hbm_bw_util"], u["stale"]))
        finally:
            mod.set_peaks()
            mod.reset_windows()
    assert out[0] == out[1]
    assert out[0][0] == pytest.approx(4 * 2e9 / 0.045 / 1e12)


def test_peak_tables_are_the_card_s(monkeypatch):
    """The H100 SXM's name gives its peaks; the H100 PCIe (lower peaks),
    another card and the CPU give none, so their gauges report no
    ratio."""
    assert util.ICI_PEAK["NVIDIA H100 80GB HBM3"] == pytest.approx(
        18 * 26.562e9)
    util.set_peaks()
    for name, flops, hbm in (("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
                             ("NVIDIA H100 PCIe", None, None),
                             ("NVIDIA H100 NVL", None, None),
                             ("", None, None)):
        monkeypatch.setattr(util, "_device_kind", lambda d, n=name: n)
        assert (util.peak_flops(), util.hbm_peak()) == (flops, hbm)
    monkeypatch.undo()
    assert util.peak_flops() is None and util.hbm_peak() is None
    util.reset_windows()
    util.observe_execution("nopeak", {"flops": 1.0, "bytes": 1.0}, 0.1)
    assert "nopeak" not in util._windows
    assert util.utilization("nopeak") == {"mfu": 0.0, "hbm_bw_util": 0.0,
                                          "stale": False}


def test_execution_timer_reads_host_interval_on_cpu():
    timer = util.ExecutionTimer(max_pending=2)
    for i in range(3):
        timer.end(timer.begin(torch.device("cpu")), i)
    got = timer.poll()
    assert [p for _, p in got] == [1, 2] and all(s >= 0 for s, _ in got)
    assert timer.poll() == []


def test_gpt_step_cost_hand_count():
    """A decode step of 2 rows at positions 5 and 9 and a prefill of 4
    rows x 8 tokens, counted by hand from GPTConfig.tiny()'s shapes."""
    from paddle_tpu_torch.models import GPTConfig, param_shapes
    cfg = GPTConfig.tiny()
    shapes = param_shapes(cfg)
    nonemb = sum(int(np.prod(s)) for n, s in shapes.items()
                 if "embedding" not in n)
    d, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    c = util.gpt_step_cost(cfg, [5, 9])
    assert c["flops"] == 2 * nonemb * 2 + 2 * V * d * 2 \
        + 4 * d * L * (6 + 10)
    assert c["bytes"] == (nonemb + V * d) * 4 + 2 * L * d * 4 * (14 + 2)
    p = util.gpt_step_cost(cfg, [0] * 4, new_tokens=8, kv_itemsize=2)
    assert p["flops"] == 2 * nonemb * 32 + 2 * V * d * 4 \
        + 4 * d * L * 4 * 36
    assert p["bytes"] == (nonemb + V * d) * 4 + 2 * L * d * 2 * 32
    v = util.gpt_step_cost(cfg, [3], new_tokens=3, logits_per_row=3)
    assert v["flops"] == 2 * nonemb * 3 + 2 * V * d * 3 \
        + 4 * d * L * (3 * 3 + 6)


def test_decode_gauge_leaves_out_graph_capture():
    """A decode step whose call captured a graph adds only its execution
    to ``device_compute_ms_total{where="decode"}`` and the decode stage
    histogram (the JAX package leaves compile time out of both); the
    capture goes to the compile stats. On the CPU nothing captures, so
    a decoder that sleeps 0.3 s and counts it as capture stands in."""
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    cfg = GPTConfig.tiny()
    stats = ServingStats()
    gen = GPTGenerator(cfg, init_params(cfg, 0), max_len=32, device="cpu",
                       stats=stats)
    real = gen.decoder
    slept = 0.3

    class CapturingDecoder:
        captures, capture_s = 0, 0.0

        def run(self, *args, **kw):
            time.sleep(slept)
            self.captures += 1
            self.capture_s += slept
            return real.run(*args, **kw)

    fams = tobs.default_registry()._families
    ms = fams["device_compute_ms_total"]
    kv = gen.new_dense_caches(2)
    step = (np.array([3, 4], np.int32), np.array([5, 9], np.int32),
            np.zeros(2, np.float32), np.zeros(2, np.int32), kv)
    for decoder, captured in ((real, False), (CapturingDecoder(), True)):
        before = ms.value(("decode",))
        n, total = stats.hist["decode"].count, stats.hist["decode"]._sum
        compiles = stats._c["compiles"]
        t0 = time.perf_counter()
        gen.decode(*step, decoder=decoder)
        wall = time.perf_counter() - t0
        grew = ms.value(("decode",)) - before
        stage = stats.hist["decode"]._sum - total
        assert stats.hist["decode"].count == n + 1
        assert 0 < grew <= (wall - captured * slept) * 1e3
        assert 0 < stage <= wall - captured * slept
        assert stats._c["compiles"] == compiles + captured
    assert stats.hist["compile"]._max == pytest.approx(slept)


def _sgd_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [-1, 8], dtype="float32")
        y = pkg.layers.data("y", [-1, 1], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(x, 1), y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_executor_exports_cost_counters():
    main, startup, loss = _sgd_program(T)
    exe = T.Executor(CPU)
    scope = T.Scope()
    feed = {"x": np.zeros((4, 8), np.float32),
            "y": np.zeros((4, 1), np.float32)}

    def counter(where):
        m = re.search(rf'^device_flops_total\{{where="{where}"\}} (\S+)$',
                      render_metrics(), re.M)
        return float(m.group(1)) if m else 0.0

    base_step, base_train = counter("step"), counter("train")
    with T.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss])
        slab = {n: np.stack([a] * 4) for n, a in feed.items()}
        for _ in range(3):
            exe.run_steps(main, feed=slab, fetch_list=[loss])
    assert counter("step") > base_step
    # the first slab seeds the cadence; two slabs of 4 steps counted
    (key, cost), = [(k, c) for k, c in exe._costs.items()
                    if k[2] == (("x", (4, 8)), ("y", (4, 1)))]
    assert counter("train") - base_train == 2 * 4 * cost["flops"]
    stats = exe.cache_stats()
    assert stats["compiles"] == 1 and stats["hits"] >= 4
    txt = render_metrics()
    assert "executor_cache_hits_total" in txt
    assert 'program_pass_runs_total{pass="dce"}' in txt


def test_utilization_cadence_reseeds_after_sustained_slowdown(monkeypatch):
    """A durable >10x slowdown re-seeds the cadence after three
    over-cadence executions instead of freezing the gauges."""
    from paddle_tpu_torch.framework import executor as executor_mod
    exe = T.Executor(CPU)
    observed = []
    monkeypatch.setattr(executor_mod._util, "observe_execution",
                        lambda where, cost, s: observed.append(s))

    def step(dt):
        exe._observe_utilization("step", "k", {"flops": 1.0, "bytes": 1.0},
                                 dt)

    step(0.001)                     # seeds the cadence (dropped)
    for _ in range(5):
        step(0.001)
    assert len(observed) == 5
    for _ in range(3):
        step(0.015)                 # two outliers, the third re-seeds
    assert len(observed) == 5
    for _ in range(4):
        step(0.015)
    assert len(observed) == 9, "gauges froze after sustained slowdown"


def test_admission_sheds_sampled_into_flight_recorder():
    """A shed storm does not churn the ring: each admission outcome is
    recorded first, then every 64th time, with the running count; the
    class-labeled shed counter counts every refusal."""
    from paddle_tpu_torch.serving.batching import Request, RequestQueue
    from paddle_tpu_torch.serving.metrics import _CLASS_SHED
    rec = flight_recorder()
    seq0 = max([e["seq"] for e in rec.snapshot()] or [0])
    shed0 = _CLASS_SHED.value(labels=("batch",))
    # a breaker that never opens: every refusal is a queue-full shed
    q = RequestQueue(max_depth=1, breaker=T.resilience.CircuitBreaker(
        endpoint="shed-test", failure_threshold=10**9))
    q.put(Request({"x": np.zeros((1, 2), np.float32)}, priority="batch"))
    for _ in range(130):
        with pytest.raises(T.serving.ServerOverloadedError):
            q.put(Request({"x": np.zeros((1, 2), np.float32)},
                          priority="batch"))
    evs = [e for e in rec.snapshot() if e["seq"] > seq0
           and e["kind"] == "admission"]
    assert [e["outcome"] for e in evs] == ["admitted"] + ["shed_overload"] * 3
    assert [e["n"] for e in evs[1:]] == [1, 64, 128]
    assert _CLASS_SHED.value(labels=("batch",)) == shed0 + 130
    q.close()


# --------------------------------------------------------------- tracing

def test_maybe_trace_sampling():
    T.set_flags({"trace_sample_rate": 0.0})
    try:
        assert tracing.maybe_trace() is None
        T.set_flags({"trace_sample_rate": 1.0})
        ctx = tracing.maybe_trace()
        assert ctx is not None and ctx.parent_id == ""
        with tracing.ambient(ctx):
            child = tracing.maybe_trace()
            assert child.trace_id == ctx.trace_id
            assert child.parent_id == ctx.span_id
    finally:
        T.set_flags({"trace_sample_rate": 0.01})
    assert T.get_flags("trace_sample_rate") == J.get_flags(
        "trace_sample_rate")


GARBAGE = [None, "x", 3, [], {"tid": 3, "sid": "a"}, {"tid": "a"},
           {"sid": "b"}, {"tid": "a", "sid": None}]


@pytest.mark.parametrize("i", range(len(GARBAGE)))
def test_from_wire_rejects_the_same_garbage(i):
    assert tracing.from_wire(GARBAGE[i]) is None
    assert jobs.tracing.from_wire(GARBAGE[i]) is None


def test_trace_dicts_cross_both_packages():
    """A context JAX's to_wire made is read by the port's from_wire and
    the other way round; long ids are capped alike."""
    jctx = jobs.tracing.new_trace().child()
    tctx = tracing.from_wire(jobs.tracing.to_wire(jctx))
    assert (tctx.trace_id, tctx.span_id) == (jctx.trace_id, jctx.span_id)
    tctx = tracing.new_trace().child()
    back = jobs.tracing.from_wire(tracing.to_wire(tctx))
    assert (back.trace_id, back.span_id) == (tctx.trace_id, tctx.span_id)
    assert tracing.to_wire(tctx) == {"tid": tctx.trace_id,
                                     "sid": tctx.span_id}
    long = {"tid": "t" * 100, "sid": "s" * 70}
    for mod in (tracing, jobs.tracing):
        ctx = mod.from_wire(long)
        assert ctx.trace_id == "t" * 64 and ctx.span_id == "s" * 64


def test_traced_spans_record_without_profiler():
    tprof.reset_profiler()
    assert not tprof.is_profiling()
    root = tracing.new_trace()
    tracing.record_child("unit/span", 0.0, 1.0, root)
    spans = [s for s in tprof._spans if len(s) >= 7]
    assert spans and spans[-1][0] == "unit/span"
    assert spans[-1][4] == root.trace_id and spans[-1][6] == root.span_id
    with tracing.span("unit/untraced") as ctx:      # no ambient: free
        assert ctx is None
    tprof.reset_profiler()


# ---------------------------------------------------- the metric catalog

def test_metric_names_pass_the_lint_against_the_readme():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import lint_metrics
    import paddle_tpu_torch.models.generation  # noqa: F401
    import paddle_tpu_torch.serving  # noqa: F401
    names = sorted(tobs.default_registry().catalog())
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        readme = f.read()
    assert lint_metrics.check(names, readme,
                              suffixes=tobs.UNIT_SUFFIXES) == []


def _families_of(pkg_name, module):
    """The families ``module`` of ``pkg_name`` declares: its native
    Family objects and what its scrape-time collectors emit."""
    import importlib
    mod = importlib.import_module(f"{pkg_name}.{module}")
    obs = importlib.import_module(f"{pkg_name}.observability.metrics")
    names = {v.name for v in vars(mod).values()
             if isinstance(v, obs.Family)}
    reg = obs.default_registry()
    for fn in list(reg._collectors):
        if getattr(fn, "__module__", None) == mod.__name__:
            names |= {f["name"] for f in fn()}
    return names


# subsystem -> the JAX families the port leaves out with the feature
SUBSYSTEMS = {
    "framework.executor": {"executor_cache_evictions_total",
                           "executor_compile_trace_ms_total",
                           "executor_compile_xla_ms_total"},
    "framework.passes": set(),
    "serving.metrics": set(),
    "serving.brownout": set(),
    "serving.kvpool": set(),
    "serving.engine": set(), "serving.batching": set(),
    "serving.server": set(), "serving.cache": set(),
    "models.generation": set(),
    "resilience": set(),
    "train.supervisor": set(),
    "train.health": set(),
    "observability.utilization": set(),
    "observability.recorder": set(),
    "observability.tracing": set(),
    "observability.profiling": set(),
    "observability.slo": set(),
    "observability.goodput": set(),
    "observability.inputstall": set(),
}


@pytest.mark.parametrize("module", sorted(SUBSYSTEMS))
def test_subsystem_families_are_the_reference_s(module):
    """Each wired subsystem declares the JAX package's families, less
    only those of features it does not have: none that the reference
    lacks."""
    jf = _families_of("paddle_tpu", module)
    tf = _families_of("paddle_tpu_torch", module)
    assert tf == jf - SUBSYSTEMS[module]
    assert SUBSYSTEMS[module] <= jf


# ------------------------------------ wire integration (a served MLP)

@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mlp"))
    main, _, feeds, targets = M.build(T, "mlp")
    scope = T.Scope()
    for n, a in M.weights(main, np.random.default_rng(0)).items():
        scope.set(n, torch.from_numpy(a))
    T.save_inference_model(d, feeds, targets, T.Executor(CPU),
                           main_program=main, scope=scope)
    return d


def test_metrics_wire_op_and_trace_propagation(mlp_dir):
    """The ``metrics`` op returns Prometheus text covering the serving,
    executor-cache, pass and utilization families; ``debug_dump``
    returns the recorder's events; one traced request yields client
    send, handle, queue, pad, execute and reply spans under one trace id
    with an unbroken parent chain, each child inside its parent."""
    tprof.reset_profiler()
    server = T.serving.InferenceServer(mlp_dir, place=CPU,
                                       batch_timeout_ms=1.0).start()
    try:
        with T.serving.Client(server.endpoint) as c:
            root = tracing.new_trace()
            with tracing.ambient(root):
                c.infer(M.feeds("mlp", 2, np.random.default_rng(1)))
            txt = c.metrics()
            dump = c.debug_dump()
        for needle in ("serving_requests_admitted_total",
                       "serving_stage_latency_ms_bucket",
                       "executor_cache_hits_total",
                       "program_pass_runs_total", "device_flops_total",
                       "slo_rule_state", "kvpool_", "flight_recorder_"):
            assert needle in txt, needle
        assert txt == txt.rstrip("\n") + "\n"
        assert any(e["kind"] == "admission" and e["outcome"] == "admitted"
                   for e in dump["events"])
        assert dump["path"] is None
    finally:
        server.stop()
    spans = [s for s in tprof._spans if len(s) >= 7]
    assert {s[4] for s in spans} == {root.trace_id}
    names = {s[0] for s in spans}
    for required in ("client/send", "serving/handle", "serving/queue",
                     "serving/pad", "serving/execute", "serving/reply"):
        assert required in names, (required, names)
    by_id = {s[5]: s for s in spans}
    for s in spans:
        parent = by_id.get(s[6])
        if parent is not None and s[0] != "serving/reply":
            assert parent[1] <= s[1] + 1e-6 and s[2] <= parent[2] + 1e-6, \
                (s[0], parent[0])
        cur, hops = s, 0
        while cur[6] not in (root.span_id, "") and hops < 16:
            cur = by_id.get(cur[6])
            assert cur is not None, f"broken parent chain from {s[0]}"
            hops += 1
    tprof.reset_profiler()


def test_serving_engine_feeds_infer_utilization(mlp_dir):
    util.reset_windows()
    set_peaks(flops_per_s=1e12, hbm_bytes_per_s=1e11)
    try:
        server = T.serving.InferenceServer(
            mlp_dir, place=CPU, batch_timeout_ms=1.0).start(
                serve_network=False)
        try:
            for i in range(3):
                server.infer(M.feeds("mlp", 2, np.random.default_rng(i)),
                             timeout=60)
        finally:
            server.stop()
        u = util.utilization("infer")
        assert 0.0 < u["mfu"] <= 1.0
    finally:
        set_peaks()
        util.reset_windows()


def test_internal_error_is_recorded_and_auto_dumped(tmp_path, monkeypatch):
    from paddle_tpu_torch.serving import server as srv
    monkeypatch.setattr(srv, "_ierr_counts", {})
    rec = flight_recorder()
    monkeypatch.setattr(rec, "_last_auto", -1e9)
    T.set_flags({"flight_recorder_dir": str(tmp_path)})
    try:
        reply = srv._error_reply(KeyError("boom"))
    finally:
        T.set_flags({"flight_recorder_dir": ""})
    assert reply["etype"] == "Internal"
    ev = [e for e in rec.snapshot() if e["kind"] == "internal_error"][-1]
    assert ev["etype"] == "KeyError" and ev["n"] == 1
    assert os.listdir(tmp_path)
