"""The port's profiler and the training-side telemetry against the JAX
package's, on the CPU: the profiler's event table, step-time histogram
and device tracer states (``torch.profiler``; the GPU states raise
without a card), ``tools/timeline.py`` (run unedited) over the port's
``stop_profiler`` JSON with op spans and the memory counter track, the
executor's and the pass pipeline's profiler events, ``profile_program``,
the goodput ledger and the input-stall tracker on a fake clock, and a
tiny GPT served over the wire whose traced generate request and
``metrics`` exposition hold the JAX server's spans and families."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import observability as jobs
from paddle_tpu import profiler as jprof
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.observability import (CATEGORIES, GoodputLedger,
                                            StallTracker, flight_recorder,
                                            render_metrics, set_peaks,
                                            tracing)
from paddle_tpu_torch.observability import utilization as util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = T.CPUPlace()


def _timeline(tmp_path, prof_path):
    out = str(tmp_path / "timeline.json")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "timeline.py"),
         "--profile_path", prof_path, "--timeline_path", out],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        return json.load(f)["traceEvents"]


# -------------------------------------------------------- device tracer

def test_gpu_states_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.start_profiler(state="GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.start_profiler(state="All", trace_dir=str(tmp_path))
    assert not tprof.is_profiling()
    with pytest.raises(ValueError):
        tprof.start_profiler(state="TPU")


def test_cpu_device_trace_is_written(tmp_path, capsys):
    tprof.reset_profiler()
    d = str(tmp_path / "trace")
    with tprof.profiler(state="CPU", trace_dir=d, profile_path=None):
        with tprof.record_event("unit/mm"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    last = tprof.last_device_trace()
    assert last["path"].startswith(d) and os.path.exists(last["path"])
    with open(last["path"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert "device trace written" in capsys.readouterr().out
    tprof.reset_profiler()


def test_event_table_and_step_histogram_match_reference(capsys):
    """The same record_* calls give the same summary rows (calls, total,
    max, min) and step-time histogram in both packages, and
    ``stop_profiler`` prints the same report."""
    outs = []
    for prof in (jprof, tprof):
        prof.reset_profiler()
        prof.record_duration("off", 1.0)       # inactive: dropped
        prof.start_profiler(state="CPU")
        for name, s in (("a", 0.002), ("b", 0.5), ("a", 0.004)):
            prof.record_duration(name, s)
        prof.record_step_time(0.0025, 8)
        prof.record_step_time(2.0, 1)
        rows = prof.stop_profiler(sorted_key="total", profile_path=None)
        outs.append((rows, prof.step_time_histogram(),
                     capsys.readouterr().out))
        with pytest.raises(ValueError):
            prof.summary("bogus")
        prof.reset_profiler()
    assert outs[1] == outs[0]
    assert [r[0] for r in outs[1][0]] == ["b", "a"]


def test_cuda_profiler_and_dygraph_hooks():
    with tprof.cuda_profiler("unused"):
        pass
    T.dygraph.start_gperf_profiler()
    assert tprof.is_profiling()
    T.dygraph.stop_gperf_profiler()
    assert not tprof.is_profiling()


# --------------------------------------------- timeline.py round trips

def test_timeline_round_trip(tmp_path):
    tprof.reset_profiler()
    tprof.start_profiler(state="CPU")
    for name in ("a", "b", "c"):
        with tprof.record_event(name):
            pass
    root = tracing.new_trace()
    tracing.record_child("traced/child", 10.0, 10.5, root)
    path = str(tmp_path / "prof.json")
    tprof.stop_profiler(profile_path=path)
    events = [e for e in _timeline(tmp_path, path) if e["ph"] == "X"]
    assert len(events) == 4
    traced = [e for e in events if e.get("args", {}).get("trace_id")]
    assert len(traced) == 1 and traced[0]["args"]["trace_id"] == \
        root.trace_id
    tprof.reset_profiler()


def _relu_fc(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [-1, 8], dtype="float32")
        y = pkg.layers.mean(pkg.layers.relu(pkg.layers.fc(x, 4)))
    return main, startup, y


def test_timeline_op_spans_and_memory_counter_round_trip(tmp_path):
    """A FLAGS_profile_ops replay under the profiler: op spans chained
    under one profile span and a time-ordered hbm_live_bytes counter
    track, rendered by tools/timeline.py."""
    tprof.reset_profiler()
    tprof.start_profiler(state="CPU")
    main, startup, y = _relu_fc(T)
    exe = T.Executor(CPU)
    scope = T.Scope()
    T.set_flags({"FLAGS_profile_ops": 1})
    try:
        with T.scope_guard(scope):
            exe.run(startup)
            exe.run(main, feed={"x": np.ones((2, 8), np.float32)},
                    fetch_list=[y])
    finally:
        T.set_flags({"FLAGS_profile_ops": 0})
    path = str(tmp_path / "prof.json")
    tprof.stop_profiler(profile_path=path)
    with open(path) as f:
        assert json.load(f).get("counters")
    events = _timeline(tmp_path, path)
    ops = [e for e in events
           if e["ph"] == "X" and e["name"].startswith("op/")]
    parents = [e for e in events
               if e["ph"] == "X" and e["name"].startswith("profile/ops_")]
    assert ops and parents
    ids = {p["args"]["span_id"] for p in parents}
    assert all(e["args"]["parent_span_id"] in ids for e in ops)
    counters = [e for e in events
                if e["ph"] == "C" and e["name"] == "hbm_live_bytes"]
    ts = [e["ts"] for e in counters]
    assert counters and ts == sorted(ts)
    assert all(e["args"]["value"] >= 0 for e in counters)
    tprof.reset_profiler()


# ---------------------------------- executor / pass pipeline events

def test_executor_and_pass_events(tmp_path):
    """Under the profiler a run records run/program_<uid>, the passes
    pass/<name> and pass/program_<uid>; a slab of K steps records
    h2d/slab, its dispatch and span and K step times."""
    main, startup, y = _relu_fc(T)
    exe = T.Executor(CPU)
    scope = T.Scope()
    with T.scope_guard(scope):
        exe.run(startup)
        tprof.reset_profiler()
        tprof.start_profiler(state="CPU")
        exe.run(main, feed={"x": np.ones((2, 8), np.float32)},
                fetch_list=[y])
        exe.run_steps(main, feed={"x": np.ones((3, 2, 8), np.float32)},
                      fetch_list=[y])
        rows = {r[0]: r[1] for r in tprof.stop_profiler(profile_path=None)}
    uid = main._uid
    for name in (f"run/program_{uid}", f"pass/program_{uid}", "pass/dce",
                 "pass/cse", "h2d/slab", f"dispatch/program_{uid}_x3",
                 f"scan/program_{uid}_x3"):
        assert name in rows, (name, sorted(rows))
    assert tprof.step_time_histogram()["count"] == 3
    tprof.reset_profiler()


def test_profile_program_rows_match_reference():
    """profiler.profile_program times every op of the program once per
    repeat, as the JAX package's does; the scope is left as it was."""
    rows = []
    for pkg, place in ((J, None), (T, CPU)):
        main, startup, y = _relu_fc(pkg)
        exe = pkg.Executor(place) if place else pkg.Executor()
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe.run(startup)
        before = {k: np.array(v) for k, v in scope.items()
                  if not k.startswith("@")}
        r = pkg.profiler.profile_program(
            main, {"x": np.ones((2, 8), np.float32)}, scope=scope,
            repeat=2)
        rows.append(sorted((t, c) for t, c, _ in r))
        for k, v in before.items():
            assert np.array_equal(np.array(scope.find_var(k)), v)
    assert rows[1] == rows[0] and all(c == 2 for _, c in rows[1])


# ------------------------------------------ goodput and input stalls

def test_goodput_ledger_matches_reference():
    """The same intervals on the same fake clock give the same report
    and the same exported category counters."""
    reps = []
    for mod in (jobs.goodput, T.observability.goodput):
        clock = [10.0]
        led = mod.GoodputLedger(clock=lambda: clock[0]).start()
        before = {c: mod._TIME.value(labels=(c,)) for c in mod.CATEGORIES}
        for cat, dt in (("compute", 2.0), ("data_stall", 0.5),
                        ("checkpoint", 0.25), ("compute", 1.0)):
            with led.span(cat):
                clock[0] += dt
        clock[0] += 0.75                     # unattributed: other
        led.stop()
        with pytest.raises(ValueError):
            led.add("nope", 1.0)
        delta = {c: mod._TIME.value(labels=(c,)) - before[c]
                 for c in mod.CATEGORIES}
        reps.append((led.report(), delta, mod._GOODPUT.value()))
    assert reps[1] == reps[0]
    rep = reps[1][0]
    assert set(rep["categories"]) == set(CATEGORIES)
    assert rep["sum_s"] == rep["wall_s"] == 4.5
    assert rep["goodput_ratio"] == pytest.approx(3.0 / 4.5)
    led = GoodputLedger(clock=lambda: 1.0).start()
    led.add("compute", 5.0)
    assert led.report()["overcount_s"] == 5.0


def test_stall_tracker_matches_reference(monkeypatch):
    """The same waits and pulls on the same fake clock give the same
    data_stall flight events, stall counts, wait histograms and
    occupancy readings."""
    out = []
    for mod, pkg, rec in ((jobs.inputstall, J, jobs.flight_recorder()),
                          (T.observability.inputstall, T,
                           flight_recorder())):
        clock = [100.0]
        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock[0])
        pkg.set_flags({"dataio_stall_window_s": 1.0,
                       "dataio_stall_ratio": 0.5})
        label = f"unitq_{pkg.__name__}"
        tr = mod.StallTracker(label, capacity=4)
        seen = len([e for e in rec.snapshot() if e["kind"] == "data_stall"
                    and e["queue"] == label])
        for step, (dt, wait, qsize) in enumerate(
                [(0.3, 0.2, 0), (0.4, 0.3, 1), (0.5, 0.1, 4), (0.2, 0.0, 2),
                 (0.9, 0.0, 3), (0.3, 0.0, 4), (1.2, 0.9, 0)] * 3):
            clock[0] += dt
            if wait:
                tr.consumer_wait(wait)
                tr.producer_wait(wait / 2)
            tr.sample_occupancy(qsize)
        evs = [{k: v for k, v in e.items() if k not in ("t", "seq",
                                                        "queue")}
               for e in rec.snapshot()
               if e["kind"] == "data_stall" and e["queue"] == label][seen:]
        lab = (label,)
        out.append((evs, mod._STALLS.value(labels=lab),
                    mod._CONS_WAIT.value(labels=lab),
                    mod._PROD_WAIT.value(labels=lab),
                    mod._OCC.value(labels=lab)))
    assert out[1] == out[0]
    assert out[1][0] and out[1][1] == len(out[1][0])
    assert isinstance(StallTracker("x", 2), StallTracker)


# ---------------------------- generation served and traced over the wire

@pytest.fixture(scope="module")
def gpt_pair():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_tiny_gpt import tiny_pair
    tgen, jgen, _scope = tiny_pair()
    return tgen, jgen


def _traced_generate(pkg, gen, prompt, **kw):
    """One traced generate through ``pkg``'s server over the wire:
    ``(tokens, {span name: count}, spans, exposition)``."""
    pkg.profiler.reset_profiler()
    server = pkg.serving.InferenceServer(generator=gen, decode_slots=2,
                                         **kw).start()
    try:
        with pkg.serving.Client(server.endpoint) as c:
            tr = __import__(f"{pkg.__name__}.observability.tracing",
                            fromlist=["x"])
            root = tr.new_trace()
            with tr.ambient(root):
                toks = c.generate(prompt, max_new_tokens=4)
            txt = c.metrics()
    finally:
        server.stop()
    spans = [s for s in pkg.profiler._spans
             if len(s) >= 7 and s[4] == root.trace_id]
    names = {}
    for s in spans:
        names[s[0]] = names.get(s[0], 0) + 1
    pkg.profiler.reset_profiler()
    return toks, names, spans, txt


def _families(txt):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", txt, re.M)}


def test_generate_trace_and_metrics_match_the_jax_server(gpt_pair):
    """The same greedy tokens; the trace of one generate request holds
    the JAX server's span names (client send, handle, queue, prefill,
    one decode span per step, reply), each child inside its parent; the
    ``metrics`` op's families are the JAX server's less those of
    features the port lacks."""
    tgen, jgen = gpt_pair
    prompt = np.array([3, 9, 4, 1, 7], np.int32)
    tt, tnames, tspans, ttxt = _traced_generate(T, tgen, prompt,
                                                paged=True)
    jt, jnames, _, jtxt = _traced_generate(J, jgen, prompt)
    assert np.array_equal(tt, jt)
    assert set(tnames) == set(jnames)
    assert tnames["serving/decode"] == jnames["serving/decode"] == 3
    for s in tspans:
        parent = [p for p in tspans if p[5] == s[6]]
        if parent and s[0] != "serving/reply":
            assert parent[0][1] <= s[1] + 1e-6 and s[2] <= parent[0][2] + 1e-6
    tf, jf = _families(ttxt), _families(jtxt)
    assert tf <= jf, sorted(tf - jf)
    assert "device_flops_total" in tf and "kvpool_occupancy_ratio" in tf


def test_decode_utilization_and_kvpool_gauges(gpt_pair):
    """Served decode feeds the decode and prefill gauges (under
    set_peaks) and the kvpool gauges track the rows in flight."""
    tgen, _ = gpt_pair
    util.reset_windows()
    set_peaks(flops_per_s=1e12, hbm_bytes_per_s=1e11)

    def counter(name, where):
        m = re.search(rf'^{name}\{{where="{where}"\}} (\S+)$',
                      render_metrics(), re.M)
        return float(m.group(1)) if m else 0.0

    try:
        base = counter("device_flops_total", "decode")
        server = T.serving.InferenceServer(
            generator=tgen, decode_slots=2, paged=True).start(
                serve_network=False)
        try:
            reqs = [server.submit_generate(np.arange(1, 9), 6)
                    for _ in range(2)]
            for r in reqs:
                r.wait(timeout=60)
            pool = server.gen_engine.pool.name
        finally:
            server.stop()
        assert counter("device_flops_total", "decode") > base
        assert 0.0 < util.utilization("decode")["mfu"] <= 1.0
        assert util.utilization("prefill")["mfu"] > 0.0
        fam = T.observability.default_registry().collect()
        caps = dict(fam["kvpool_capacity_blocks_count"]["samples"])
        assert caps[(pool,)] > 0
        allocated = dict(fam["kvpool_blocks_allocated_total"]["samples"])
        assert allocated[(pool,)] > 0
    finally:
        set_peaks()
        util.reset_windows()
