"""The port's performance attribution and SLO monitor against the JAX
package's, on the CPU: ``profile_program``'s per-op estimate (op for op
equal on an fc + softmax + Adam MLP and a 2-layer GPT training program,
but the attention ops, which take their kernels' counts), the HBM
live-set ``memory_profile``, the ``FLAGS_profile_ops`` measured replay
(a bitwise step, side-effect programs skipped), and the ``SloMonitor``
(the same breach and recovery events and states fed the same stream on
a fake clock), ``_bucket_quantile``, the staleness of the utilization
windows and a server's default monitor."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu import observability as jobs
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.observability import (flight_recorder, profiling,
                                            render_metrics, set_peaks, slo)
from paddle_tpu_torch.observability import utilization as util
from paddle_tpu_torch.observability.metrics import MetricsRegistry

CPU = T.CPUPlace()
RNG = np.random.default_rng(7)


def _mlp_adam(pkg):
    """fc + relu + fc + softmax (fetched) + softmax_with_cross_entropy,
    Adam."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [-1, 8], dtype="float32")
        y = pkg.layers.data("y", [-1, 1], dtype="int64")
        h = pkg.layers.fc(x, 16, act="relu")
        logits = pkg.layers.fc(h, 4)
        pkg.layers.softmax(logits)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _gpt_train(pkg):
    gm = __import__(f"{pkg.__name__}.models.gpt", fromlist=["x"])
    cfg = gm.GPTConfig.tiny()
    cfg.num_layers = 2
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        out = gm.gpt_pretrain(cfg, 2, 16)
        pkg.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
    return main, startup, out["loss"]


PROGRAMS = {"mlp_adam": (_mlp_adam, {"x": (4, 8), "y": (4, 1)}, None),
            "gpt_2layer": (_gpt_train, None, 2)}


@pytest.fixture
def peaks():
    set_peaks(flops_per_s=1e12, hbm_bytes_per_s=1e11)
    jobs.set_peaks(flops_per_s=1e12, hbm_bytes_per_s=1e11)
    yield
    set_peaks()
    jobs.set_peaks()


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_profile_program_matches_reference(name, optimize, peaks):
    """Op for op the same type, FLOPs, bytes, rule and est_ms as the JAX
    estimator, but ``flash_attention`` and its grad (rule "attention",
    checked against their formulas in the next test); the same report
    totals once those rows are set aside."""
    build, feed, batch = PROGRAMS[name]
    (jm, _, jl), (tm, _, tl) = build(J), build(T)
    kw = dict(feed=feed, measured=False, optimize=optimize, batch=batch)
    jr = jobs.profiling.profile_program(jm, fetch_list=[jl], **kw)
    tr = profiling.profile_program(tm, fetch_list=[tl], **kw)
    assert tr["n_ops"] == jr["n_ops"]
    jrows = sorted(jr["ops"], key=lambda r: r["index"])
    trows = sorted(tr["ops"], key=lambda r: r["index"])
    attention = 0
    for a, b in zip(jrows, trows):
        assert (a["index"], a["type"], a["outputs"]) == \
            (b["index"], b["type"], b["outputs"])
        if b["type"].startswith("flash_attention"):
            assert b["rule"] == "attention" and a["bytes"] == b["bytes"]
            attention += 1
            continue
        assert (a["flops"], a["bytes"], a["rule"], a["bound"]) == \
            (b["flops"], b["bytes"], b["rule"], b["bound"]), a["type"]
        assert a["est_ms"] == pytest.approx(b["est_ms"], rel=1e-12)
    assert attention == (4 if name == "gpt_2layer" else 0)
    if not attention:
        assert tr["totals"] == jr["totals"]
        assert tr["named_share"] == jr["named_share"]


def test_attention_rules_are_the_kernel_counts(peaks):
    """flash_attention: 4·B·H·Sq·Sk·D halved when causal (K1's count);
    its grad K2's five products, 10·B·H·Sq·Sk·D halved; the paged decode
    read 4·B·H·S·D over every position its tables reach, and K5's bytes
    in place of the whole pools."""
    main, _, loss = _gpt_train(T)
    rep = profiling.profile_program(main, fetch_list=[loss], batch=2,
                                    measured=False, optimize=False)
    B, H, S, D = 2, 2, 16, 16
    rows = {r["type"]: r for r in rep["ops"]
            if r["type"].startswith("flash_attention")}
    assert rows["flash_attention"]["flops"] == 4.0 * B * H * S * S * D / 2
    assert rows["flash_attention_grad"]["flops"] == \
        10.0 * B * H * S * S * D / 2

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving.kvpool import pool_feed_names
    cfg = gpt.GPTConfig.tiny()
    prog, start = T.Program(), T.Program()
    with T.unique_name.guard(), T.program_guard(prog, start):
        out = gpt.gpt_decode_step_paged(cfg)
    rows_b, nblk, nb, bs = 3, 4, 13, 8
    feed = {"token": (rows_b,), "pos": (rows_b,),
            "block_tables": (rows_b, nblk)}
    for n in pool_feed_names(cfg.num_layers, False):
        feed[n] = (nb, cfg.num_heads, bs, cfg.d_head)
    rep = profiling.profile_program(prog, feed=feed, measured=False,
                                    optimize=False,
                                    fetch_list=[out["logits"]])
    (pa,) = [r for r in rep["ops"] if r["type"] == "paged_attention"]
    Dh = cfg.d_head
    keys = nblk * bs
    assert pa["flops"] == 4.0 * rows_b * cfg.num_heads * 1 * keys * Dh
    q_bytes = rows_b * cfg.num_heads * Dh * 4
    assert pa["bytes"] == 2 * rows_b * keys * cfg.num_heads * Dh * 4 \
        + 2 * q_bytes + rows_b * nblk * 4 + rows_b * 4
    assert pa["rule"] == "attention"


def test_program_cost_is_the_report_total(peaks):
    main, _, loss = _mlp_adam(T)
    feed = {"x": (4, 8), "y": (4, 1)}
    rep = profiling.profile_program(main, feed=feed, fetch_list=[loss],
                                    measured=False, optimize=False)
    cost = profiling.program_cost(main, feed)
    assert cost == {"flops": rep["totals"]["flops"],
                    "bytes": rep["totals"]["bytes"]}


def test_matmul_flop_estimate_exact():
    main, startup = T.Program(), T.Program()
    with T.program_guard(main, startup):
        x = T.layers.data("x", [4, 8], dtype="float32")
        out = T.layers.fc(x, 16)
    report = profiling.profile_program(main, fetch_list=[out],
                                       optimize=False, measured=False)
    muls = [r for r in report["ops"] if r["type"] == "mul"]
    assert muls and muls[0]["flops"] == 2.0 * 4 * 8 * 16
    assert muls[0]["rule"] == "matmul"


def test_profile_report_ranked_and_never_mutates():
    main, _, loss = _mlp_adam(T)
    version, n_ops = main.version, len(main.global_block().ops)
    feed = {"x": np.zeros((4, 8), np.float32),
            "y": np.zeros((4, 1), np.int64)}
    report = profiling.profile_program(main, feed=feed, fetch_list=[loss],
                                       measured=False)
    rows = report["ops"]
    assert rows == sorted(rows, key=lambda r: -r["est_ms"])
    tot = report["totals"]
    assert tot["flops"] == pytest.approx(sum(r["flops"] for r in rows))
    assert sum(r["share"] for r in rows) == pytest.approx(1.0)
    rep2 = profiling.profile_program(
        main, feed=feed, fetch_list=[loss], measured=False,
        cost={"flops": tot["flops"] * 2, "bytes": tot["bytes"]})
    assert rep2["coverage"]["est_vs_xla_flops_ratio"] == pytest.approx(0.5)
    assert main.version == version
    assert len(main.global_block().ops) == n_ops
    assert "TOTAL" in profiling.format_table(report)


def _relu_chain(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4, 1024], dtype="float32")
        a = pkg.layers.relu(x)
        b = pkg.layers.relu(a)
        c = pkg.layers.relu(b)
    return main, a, c


MEMORY = {
    "relu_chain": lambda pkg: (lambda m, a, c: (m, (c.name,), {}))(
        *_relu_chain(pkg)),
    "relu_chain_pinned": lambda pkg: (lambda m, a, c: (
        m, (a.name, c.name), {}))(*_relu_chain(pkg)),
    "mlp_adam": lambda pkg: (lambda m, s, l: (
        m, (l.name,), {"feed": {"x": (4, 8), "y": (4, 1)}}))(*_mlp_adam(pkg)),
    "gpt_2layer": lambda pkg: (lambda m, s, l: (m, (l.name,), {"batch": 2}))(
        *_gpt_train(pkg)),
}


@pytest.mark.parametrize("name", sorted(MEMORY))
def test_memory_profile_matches_reference(name):
    """The same peak bytes, op index at the peak, baseline, timeline and
    top tensors as the JAX package's live-set profile."""
    jm, jf, jkw = MEMORY[name](J)
    tm, tf, tkw = MEMORY[name](T)
    a = jobs.profiling.memory_profile(jm, fetch_names=jf, **jkw)
    b = profiling.memory_profile(tm, fetch_names=tf, **tkw)
    for k in ("peak_bytes", "peak_op_index", "peak_op_type",
              "baseline_bytes", "timeline", "n_ops"):
        assert a[k] == b[k], k
    assert [(r["bytes"], r["kind"]) for r in a["top"]] == \
        [(r["bytes"], r["kind"]) for r in b["top"]]


# ------------------------------------- FLAGS_profile_ops measured mode

def _dropout_adam(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [-1, 8], dtype="float32")
        y = pkg.layers.data("y", [-1, 1], dtype="float32")
        h = pkg.layers.dropout(pkg.layers.fc(x, 16, act="relu"), 0.3)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, 1), y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _train(flag, n=3):
    main, startup, loss = _dropout_adam(T)
    feed = {"x": RNG.standard_normal((4, 8)).astype(np.float32),
            "y": RNG.standard_normal((4, 1)).astype(np.float32)}
    exe = T.Executor(CPU)
    scope = T.Scope()
    torch.manual_seed(0)
    out = []
    with T.scope_guard(scope):
        T.set_flags({"FLAGS_profile_ops": 0})
        exe.run(startup)
        T.set_flags({"FLAGS_profile_ops": flag})
        for _ in range(n):
            v, = exe.run(main, feed=feed, fetch_list=[loss])
            out.append(v)
    T.set_flags({"FLAGS_profile_ops": 0})
    return out, {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in scope.items()}


def test_profile_ops_measured_replay_is_bitwise():
    """flag=1 records a per-op table and op spans under one profile
    span; the fetches and every scope value (the run seed included) are
    bitwise those with the flag off, dropout and Adam's in-place
    updates notwithstanding; flag=4 replays the 1st and 5th of 6 runs."""
    from paddle_tpu_torch.observability.profiling import _REPLAYS
    tprof.reset_profiler()
    global RNG
    try:
        RNG = np.random.default_rng(7)
        off, off_scope = _train(0)
        base = _REPLAYS.value()
        RNG = np.random.default_rng(7)
        on, on_scope = _train(1)
        assert _REPLAYS.value() == base + 3
        for a, b in zip(off, on):
            assert np.array_equal(a, b)
        assert off_scope.keys() == on_scope.keys()
        for k, v in off_scope.items():
            w = on_scope[k]
            assert (torch.equal(v, w) if isinstance(v, torch.Tensor)
                    else v == w), k
        prof = profiling.last_op_profile()
        assert prof["n_ops"] == len(prof["rows"]) > 5
        assert all(r["ms"] >= 0 for r in prof["rows"])
        assert prof["peak_bytes"] > 0
        spans = [s for s in tprof._spans if len(s) >= 7]
        op_spans = [s for s in spans if s[0].startswith("op/")]
        parents = {s[5] for s in spans if s[0].startswith("profile/ops_")}
        assert op_spans and parents
        assert all(s[6] in parents for s in op_spans)
        base = _REPLAYS.value()
        _train(4, n=6)
        assert _REPLAYS.value() == base + 2
    finally:
        T.set_flags({"FLAGS_profile_ops": 0})
        tprof.reset_profiler()


def test_profile_ops_skips_side_effect_programs():
    from paddle_tpu_torch.observability.profiling import _REPLAYS
    main, startup = T.Program(), T.Program()
    with T.program_guard(main, startup):
        x = T.layers.data("x", [-1, 4], dtype="float32")
        out = T.layers.mean(T.layers.relu(x))
        T.layers.Print(out, message="side effect")
    exe = T.Executor(CPU)
    scope = T.Scope()
    with T.scope_guard(scope):
        exe.run(startup)
    base = _REPLAYS.value()
    T.set_flags({"FLAGS_profile_ops": 1})
    try:
        with T.scope_guard(scope):
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[out])
    finally:
        T.set_flags({"FLAGS_profile_ops": 0})
    assert _REPLAYS.value() == base


# ------------------------------------------------------- SLO monitor

def _slo_pair(make_rules, scope, registries=(None, None)):
    """One monitor per package over rules ``make_rules(pkg_slo, side)``;
    ``side`` is "j" or "t"."""
    mons, events = [], []
    for side, mod, reg in (("j", jobs.slo, registries[0]),
                           ("t", slo, registries[1])):
        ev = []
        mons.append(mod.SloMonitor(
            make_rules(mod, side), scope=f"{scope}_{side}", registry=reg,
            on_event=lambda r, b, v, ev=ev: ev.append((r.name, b, v))))
        events.append(ev)
    return mons, events


def _flight(scope):
    recs = (jobs.flight_recorder(), flight_recorder())
    return [[(e["kind"], e["rule"], e["value"], e["threshold"], e["op"])
             for e in rec.snapshot() if e.get("scope") == f"{scope}_{s}"]
            for rec, s in zip(recs, "jt")]


def _slo_getter(box):
    def rules(mod, side):
        return [mod.SloRule("held", ">", 10.0, getter=lambda: box["v"],
                            for_s=10.0),
                mod.SloRule("low", "<", 1.0, getter=lambda: box["w"])]

    def stream(step):
        for now, v, w in ((100.0, 99.0, 5.0), (105.0, 99.0, 0.5),
                          (110.5, 99.0, 0.5), (111.0, 0.0, None),
                          (112.0, 99.0, 2.0), (130.0, 99.0, 2.0)):
            box["v"], box["w"] = v, w
            step(now)
    return rules, stream, (None, None)


def _slo_hist(box):
    hists = {}

    def rules(mod, side):
        metrics = __import__(f"{mod.__name__.split('.')[0]}.serving.metrics",
                             fromlist=["x"])
        hists[side] = metrics.LatencyHistogram("slo_unit")
        return [mod.SloRule("p99_ms", ">", 100.0, hist=hists[side],
                            q=0.99)]

    def stream(step):
        for now, obs in ((1.0, [0.5] * 5), (2.0, [0.001] * 50),
                         (3.0, []), (4.0, [0.2, 0.001]),
                         (5.0, [0.04] * 9 + [0.3])):
            for h in hists.values():
                for o in obs:
                    h.observe(o)
            step(now)
    return rules, stream, (None, None)


def _slo_registry(box):
    regs = (jobs.MetricsRegistry(), MetricsRegistry())
    fams = []
    for reg in regs:
        g = reg.gauge("unit_depth_count", labels=("q",))
        c = reg.counter("unit_reqs_total")
        h = reg.histogram("unit_lat_ms", bounds=(1.0, 10.0, 100.0))
        g.set(5, labels=("a",))
        c.inc()
        fams.append((g, c, h))

    def rules(mod, side):
        return [mod.SloRule("depth", ">", 3.0, metric="unit_depth_count",
                            labels=("a",)),
                mod.SloRule("req_rate", ">", 10.0, metric="unit_reqs_total",
                            source="rate"),
                mod.SloRule("lat_p90", ">=", 9.0, metric="unit_lat_ms",
                            source="quantile", q=0.9),
                mod.SloRule("missing", ">", 0.0, metric="unit_none_total")]

    def stream(step):
        for now, inc, depth, lat in ((0.0, 0, 5, [0.5]), (2.0, 100, 5, [50.0]),
                                     (4.0, 0, 1, [5.0, 0.5]),
                                     (6.0, 30, 4, [])):
            for g, c, h in fams:
                c.inc(inc)
                g.set(depth, labels=("a",))
                for v in lat:
                    h.observe(v)
            step(now)
    return rules, stream, regs


SLO_CASES = {"getter_for_s": _slo_getter, "windowed_hist": _slo_hist,
             "registry_sources": _slo_registry}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_monitor_emits_the_reference_events(case):
    """Fed the same stream on the same fake clock, both packages'
    monitors make the same transitions, callbacks, flight events and
    snapshots, and export the same slo_rule_state / slo_breached_total
    values."""
    box = {}
    rules, stream, regs = SLO_CASES[case](box)
    mons, events = _slo_pair(rules, f"t_{case}", regs)
    snaps = [[], []]

    def step(now):
        for i, m in enumerate(mons):
            snaps[i].append(m.evaluate_once(now=now))

    stream(step)
    assert snaps[1] == snaps[0]
    assert events[1] == events[0] and events[0]
    fj, ft = _flight(f"t_{case}")
    assert ft == fj and ft
    for mod, m in ((jobs.slo, mons[0]), (slo, mons[1])):
        for r in m.rules:
            lab = (m.scope, r.name)
            assert mod._STATE.value(labels=lab) == \
                (1 if m.snapshot()[r.name]["breached"] else 0)
    assert [slo._BREACHED.value(labels=(mons[1].scope, r.name))
            for r in mons[1].rules] == \
        [jobs.slo._BREACHED.value(labels=(mons[0].scope, r.name))
         for r in mons[0].rules]
    for m in mons:
        m.stop()


BUCKETS = [((1.0, 10.0, 100.0), [0, 0, 0, 0], 0.99),
           ((1.0, 10.0, 100.0), [0, 10, 0, 0], 0.5),
           ((1.0, 10.0, 100.0), [0, 0, 0, 5], 0.99),
           ((0.5, 2.0), [3, 1, 1], 0.9), ((0.5, 2.0), [3, 1, 1], 0.1),
           ((1.0,), [0, 2], 0.5), ((1.0, 5.0, 9.0), [1, 0, 7, 2], 0.75)]


@pytest.mark.parametrize("i", range(len(BUCKETS)))
def test_bucket_quantile_matches_reference(i):
    bounds, counts, q = BUCKETS[i]
    assert slo._bucket_quantile(bounds, counts, q) == \
        jobs.slo._bucket_quantile(bounds, counts, q)


def test_server_default_slo_monitor_wired():
    """A generation server starts the default monitor: the JAX
    package's rules for the same flags, its states exported, gone on
    stop."""
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    from paddle_tpu_torch.serving import InferenceServer
    cfg = GPTConfig.tiny()
    gen = GPTGenerator(cfg, init_params(cfg, 0), max_len=48, device="cpu")
    T.set_flags({"slo_mfu_floor": 0.1})
    try:
        server = InferenceServer(generator=gen, decode_slots=2, paged=True)
        server.start(serve_network=False)
        try:
            names = [r.name for r in server.slo_monitor.rules]
            assert names == ["intertoken_p99_ms", "decode_queue_ratio",
                             "kvpool_occupancy", "decode_mfu_floor"]
            server.generate(np.arange(1, 6), max_new_tokens=3, timeout=60)
            server.slo_monitor.evaluate_once()
            txt = render_metrics()
            scope = server.slo_monitor.scope
            for n in names:
                assert (f'slo_rule_state{{scope="{scope}",rule="{n}"}} 0'
                        in txt), n
            monitor = server.slo_monitor
        finally:
            server.stop()
        assert server.slo_monitor is None and monitor._thread is None
    finally:
        T.set_flags({"slo_mfu_floor": 0.0})
    assert T.get_flags(["slo_monitor", "slo_poll_s", "slo_decode_p99_ms",
                        "slo_queue_ratio", "slo_kvpool_ratio",
                        "slo_mfu_floor"]) == J.get_flags(
        ["slo_monitor", "slo_poll_s", "slo_decode_p99_ms",
         "slo_queue_ratio", "slo_kvpool_ratio", "slo_mfu_floor"])


def test_slo_rules_off_when_flag_off():
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    from paddle_tpu_torch.serving import InferenceServer
    cfg = GPTConfig.tiny()
    gen = GPTGenerator(cfg, init_params(cfg, 0), max_len=48, device="cpu")
    T.set_flags({"slo_monitor": False})
    try:
        server = InferenceServer(generator=gen, decode_slots=2)
        server.start(serve_network=False)
        assert server.slo_monitor is None
        server.stop()
    finally:
        T.set_flags({"slo_monitor": True})
    server = InferenceServer(generator=gen, decode_slots=2, slo_rules=[])
    server.start(serve_network=False)
    assert server.slo_monitor is None
    server.stop()


# -------------------------------------------- utilization staleness

def test_utilization_staleness_and_collector_skip():
    util.reset_windows()
    set_peaks(flops_per_s=1e12, hbm_bytes_per_s=1e11)
    try:
        cost = {"flops": 2e9, "bytes": 1e8}
        for _ in range(4):
            util.observe_execution("fresh_w", cost, 0.01)
            util.observe_execution("stale_w", cost, 0.01)
        assert util.utilization("stale_w")["stale"] is False
        assert 'device_mfu_ratio{where="stale_w"}' in render_metrics()
        w = util._windows["stale_w"]
        with w.lock:
            w.last_wall -= 1000.0
            w.obs = type(w.obs)(
                ((s, f, b, wall - 1000.0) for s, f, b, wall in w.obs),
                maxlen=w.obs.maxlen)
        u = util.utilization("stale_w")
        assert u["stale"] is True and u["mfu"] > 0
        txt = render_metrics()
        assert 'device_mfu_ratio{where="stale_w"}' not in txt
        assert 'device_mfu_ratio{where="fresh_w"}' in txt
        assert 'device_hbm_bw_util_ratio{where="stale_w"}' not in txt
    finally:
        set_peaks()
        util.reset_windows()
