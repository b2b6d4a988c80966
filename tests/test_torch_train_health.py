"""Training observability of the port's supervised loop on the CPU,
mirroring tests/test_train_observability.py: the goodput ledger's
attribution of a supervised run (categories summing to wall within 1%, a
producer delay landing in ``data_stall``, a kill-restart in
``recovery``, a preemption in ``preempt``, a slab's capture in
``compile``) and the model-health monitor (health fetches leaving the
other slabs bitwise unchanged, a seeded grad spike breaching before the
NaN guard, a forward-only program refused at construction). Against the
JAX package: the grad norm and the update ratio of the same program and
slabs from the same start within 1e-5 of the JAX ``HealthMonitor``'s,
and the spike rules' breaches over one scripted observation sequence
exactly its."""
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import train
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.observability import default_registry
from paddle_tpu_torch.observability.goodput import CATEGORIES, GoodputLedger
from paddle_tpu_torch.observability.recorder import flight_recorder
from paddle_tpu_torch.resilience import RestartBudgetExceeded

CPU = fluid.CPUPlace()
_shared_cache = {}


@pytest.fixture(autouse=True)
def _clean():
    train.clear_preemption()
    tres.clear_faults()
    yield
    train.clear_preemption()
    tres.clear_faults()


def _build(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [-1, 4], dtype="float32")
        y = pkg.layers.data("y", [-1, 1], dtype="float32")
        h = pkg.layers.fc(x, 16, act="relu")
        loss = pkg.layers.mean(
            pkg.layers.square_error_cost(pkg.layers.fc(h, 1), y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _shared():
    if not _shared_cache:
        main, startup, loss = _build(fluid)
        _shared_cache.update(main=main, startup=startup, loss=loss,
                             exe=fluid.Executor(CPU))
    c = _shared_cache
    return c["main"], c["startup"], c["loss"], c["exe"]


def _slabs(n=6, k=4, batch=8):
    out = []
    for i in range(n):
        r = np.random.default_rng(i)
        out.append({"x": r.standard_normal((k, batch, 4)).astype(np.float32),
                    "y": r.standard_normal((k, batch, 1)).astype(np.float32)})
    return out


def _supervisor(tmp, name, **kw):
    main, startup, loss, exe = _shared()
    kw.setdefault("checkpoint_every_n_slabs", 3)
    kw.setdefault("restart_backoff", 0.01)
    kw.setdefault("scope", fluid.Scope())
    return train.TrainingSupervisor(
        exe, main, os.path.join(tmp, name), startup_program=startup,
        steps_per_run=4, **kw)


def _dataset(n_batches=12, batch=8):
    main = _shared()[0]
    gb = main.global_block()
    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(batch)
    ds.set_use_var([gb.var("x"), gb.var("y")])
    r = np.random.default_rng(7)
    ds._samples = [(r.standard_normal(4).astype(np.float32),
                    r.standard_normal(1).astype(np.float32))
                   for _ in range(batch * n_batches)]
    return ds


def _within_1pct(gp):
    assert abs(gp["sum_s"] - gp["wall_s"]) <= 0.01 * gp["wall_s"], gp
    assert gp["overcount_s"] <= 0.01 * gp["wall_s"], gp


# ------------------------------------------------------------ the ledger

def test_ledger_categories_sum_to_wall_and_other_absorbs():
    led = GoodputLedger().start()
    with led.span("compute"):
        time.sleep(0.02)
    with led.span("checkpoint"):
        time.sleep(0.01)
    time.sleep(0.02)
    led.stop()
    rep = led.report()
    assert set(rep["categories"]) == set(CATEGORIES)
    _within_1pct(rep)
    assert rep["categories"]["compute"] >= 0.02
    assert rep["categories"]["other"] >= 0.015
    with pytest.raises(ValueError):
        led.add("not_a_category", 1.0)


def test_supervised_run_attribution_sums_within_1pct(tmp_path):
    main, startup, loss, exe = _shared()
    sup = _supervisor(str(tmp_path), "clean")
    r = sup.run_slabs(_slabs(), fetch_list=[loss])
    gp = r["goodput"]
    _within_1pct(gp)
    assert gp["categories"]["compute"] > 0
    assert gp["categories"]["checkpoint"] > 0
    assert sup.goodput_report()["wall_s"] == pytest.approx(gp["wall_s"],
                                                           rel=1e-6)


def test_first_capture_lands_in_compile(tmp_path):
    """The slab that makes the executor's captured step puts its capture
    ms (``cache_stats()["capture_ms"]``) into ``compile``, not
    ``compute``; a program already captured puts nothing there."""
    main, startup, loss = _build(fluid)
    exe = fluid.Executor(CPU)
    sup = train.TrainingSupervisor(exe, main, str(tmp_path / "c1"),
                                   startup_program=startup,
                                   scope=fluid.Scope(), steps_per_run=4,
                                   checkpoint_every_n_slabs=100)
    gp = sup.run_slabs(_slabs(2), fetch_list=[loss])["goodput"]
    assert exe.cache_stats()["capture_ms"] > 0
    assert gp["categories"]["compile"] > 0
    _within_1pct(gp)
    sup2 = train.TrainingSupervisor(exe, main, str(tmp_path / "c2"),
                                    startup_program=startup,
                                    scope=fluid.Scope(), steps_per_run=4,
                                    checkpoint_every_n_slabs=100)
    gp2 = sup2.run_slabs(_slabs(2), fetch_list=[loss])["goodput"]
    assert gp2["categories"]["compile"] <= 0.01 * gp2["wall_s"]


def test_producer_delay_chaos_lands_in_data_stall(tmp_path):
    main, startup, loss, exe = _shared()
    sup = _supervisor(str(tmp_path), "stall",
                      checkpoint_every_n_slabs=10 ** 9)
    with tres.chaos({"dataio.producer": {"delay": 0.04}}):
        r = sup.train(_dataset(), fetch_list=[loss])
    gp = r["goodput"]
    cats = gp["categories"]
    assert cats["data_stall"] >= 0.3, cats      # 12 x 40 ms injected
    non_compute = {c: s for c, s in cats.items()
                   if c not in ("compute", "compile")}
    assert max(non_compute, key=non_compute.get) == "data_stall", cats
    _within_1pct(gp)


def test_kill_restart_lands_in_recovery(tmp_path):
    main, startup, loss, exe = _shared()
    sup = _supervisor(str(tmp_path), "kill", restart_budget=2,
                      checkpoint_every_n_slabs=2)
    with tres.chaos({"train.dispatch": {"after": 4, "times": 1}}):
        r = sup.run_slabs(_slabs(), fetch_list=[loss])
    assert r["restarts"] == 1
    cats = r["goodput"]["categories"]
    assert cats["recovery"] > 0 and cats["compute"] > 0, cats
    _within_1pct(r["goodput"])


def test_preemption_lands_in_preempt(tmp_path):
    main, startup, loss, exe = _shared()
    sup = _supervisor(str(tmp_path), "pre", checkpoint_every_n_slabs=2,
                      on_slab_end=lambda s, st, f:
                      train.request_preemption("test") if s == 3 else None)
    with pytest.raises(train.PreemptedError):
        sup.run_slabs(_slabs(), fetch_list=[loss])
    gp = sup.goodput_report()
    assert gp["categories"]["preempt"] > 0, gp
    _within_1pct(gp)


# ------------------------------------------------------ health monitors

def _state(scope, main):
    out = {}
    for v in main.global_block().vars.values():
        if getattr(v, "persistable", False):
            t = scope.find_var(v.name)
            if isinstance(t, torch.Tensor):
                out[v.name] = t.detach().cpu().numpy()
    return out


def test_health_fetches_bitwise_unchanged_and_gauges(tmp_path):
    main, startup, loss, exe = _shared()
    slabs = _slabs()
    s_off, s_on = fluid.Scope(), fluid.Scope()
    r_off = _supervisor(str(tmp_path), "hoff", scope=s_off).run_slabs(
        slabs, fetch_list=[loss])
    sup_on = _supervisor(str(tmp_path), "hon", scope=s_on,
                         health_every_n=2)
    r_on = sup_on.run_slabs(slabs, fetch_list=[loss])
    off, on = _state(s_off, main), _state(s_on, main)
    assert off.keys() == on.keys()
    for n in off:
        assert np.array_equal(off[n], on[n]), n
    np.testing.assert_array_equal(r_off["last_fetches"][0],
                                  r_on["last_fetches"][0])
    hr = sup_on.health_report()
    assert hr["values"]["loss"] is not None
    assert hr["values"]["grad_norm"] > 0 and hr["values"]["update_ratio"] > 0
    assert hr["breached"] == []
    fam = default_registry().collect()
    assert fam["train_health_grad_norm_value"]["samples"]
    v0 = main.version                    # a second monitor reuses the ops
    _supervisor(str(tmp_path), "hon2", health_every_n=2).run_slabs(
        slabs[:2], fetch_list=[loss])
    assert main.version == v0


def test_grad_norm_and_update_ratio_match_the_jax_monitor(tmp_path):
    """The same program and slabs from the JAX startup's values: each
    health slab's loss, grad norm and update ratio (and their EMAs)
    within 1e-5 of max |ref| of the JAX HealthMonitor's."""
    import paddle_tpu as jfluid
    from paddle_tpu import train as jtrain
    slabs = _slabs(3)
    jmain, jstartup, jloss = _build(jfluid)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    start = {n: np.array(v) for n, v in jscope.items() if n != "@RNG_KEY@"}
    reports = {}
    jsup = jtrain.TrainingSupervisor(
        jexe, jmain, str(tmp_path / "jax"), startup_program=jstartup,
        scope=jscope, steps_per_run=4, checkpoint_every_n_slabs=100,
        health_every_n=1)
    seen = {"jax": [], "port": []}
    orig = jsup.health.observe

    def jobs(idx, values, now=None):
        seen["jax"].append([float(np.asarray(v).reshape(-1)[-1])
                            for v in values])
        return orig(idx, values, now)
    jsup.health.observe = jobs
    jsup.run_slabs(slabs, fetch_list=[jloss])
    reports["jax"] = jsup.health_report()

    tmain, tstartup, tloss = _build(fluid)
    texe, tscope = fluid.Executor(CPU), fluid.Scope()
    texe.run(tstartup, scope=tscope)
    scope_from_arrays(tscope, start)
    tsup = train.TrainingSupervisor(
        texe, tmain, str(tmp_path / "port"), startup_program=tstartup,
        scope=tscope, steps_per_run=4, checkpoint_every_n_slabs=100,
        health_every_n=1)
    torig = tsup.health.observe

    def tobs(idx, values, now=None):
        seen["port"].append([float(np.asarray(v).reshape(-1)[-1])
                             for v in values])
        return torig(idx, values, now)
    tsup.health.observe = tobs
    tsup.run_slabs(slabs, fetch_list=[tloss])
    reports["port"] = tsup.health_report()
    got, want = np.asarray(seen["port"]), np.asarray(seen["jax"])
    assert got.shape == want.shape == (3, 3)
    for col in range(3):                 # loss, grad norm, update ratio
        assert np.abs(got[:, col] - want[:, col]).max() \
            <= 1e-5 * np.abs(want[:, col]).max(), col
    for key in ("loss", "grad_norm"):
        a, b = reports["port"]["ema"][key], reports["jax"]["ema"][key]
        assert abs(a - b) <= 1e-5 * abs(b)


def test_seeded_grad_spike_breaches_before_nan_guard(tmp_path):
    """A diverging run trips the health rules (flight event + callback)
    strictly before the non-finite guard raises."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [-1, 4], dtype="float32")
        y = fluid.layers.data("y", [-1, 1], dtype="float32")
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(20.0).minimize(loss)   # seeded divergence
    r = np.random.default_rng(3)
    slabs = [{"x": r.standard_normal((4, 8, 4)).astype(np.float32),
              "y": r.standard_normal((4, 8, 1)).astype(np.float32)}
             for _ in range(20)]
    flight_recorder().clear()
    breaches = []
    sup = train.TrainingSupervisor(
        fluid.Executor(CPU), main, str(tmp_path / "spike"),
        startup_program=startup, scope=fluid.Scope(), steps_per_run=4,
        checkpoint_every_n_slabs=10 ** 9, restart_budget=0,
        health_every_n=1,
        on_health_breach=lambda rule, v: breaches.append(rule))
    fluid.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(RestartBudgetExceeded) as ei:
            sup.run_slabs(slabs, fetch_list=[loss])
    finally:
        fluid.set_flags({"check_nan_inf": False})
    assert "NonFiniteError" in str(ei.value)
    assert breaches, "the health monitor never breached"
    events = flight_recorder().snapshot()
    breach_seq = min(e["seq"] for e in events
                     if e["kind"] == "train_health_breach")
    nan_seq = min(e["seq"] for e in events if e["kind"] == "nonfinite")
    assert breach_seq < nan_seq
    assert any(e["kind"] == "slo_breach" and e.get("scope") == "train_health"
               for e in events)


def test_health_on_forward_only_program_fails_fast(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [-1, 4], dtype="float32")
        fluid.layers.mean(fluid.layers.fc(x, 1))
    with pytest.raises(ValueError, match="param@GRAD"):
        train.TrainingSupervisor(
            fluid.Executor(CPU), main, str(tmp_path / "ck"),
            startup_program=startup, scope=fluid.Scope(), steps_per_run=2,
            health_every_n=1)


def _spike_script(pkg, hmod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [-1, 2], dtype="float32")
        y = pkg.layers.data("y", [-1, 1], dtype="float32")
        loss = pkg.layers.mean(
            pkg.layers.square_error_cost(pkg.layers.fc(x, 1), y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    hm = hmod.HealthMonitor(main, every_n=1, scope_label="spike-unit")
    names = hm.ensure_fetches(loss.name)
    seq = ((1.0, 1.0), (1.05, 1.1), (1.0, 0.9), (10.0, 1.0), (1.0, 1.0),
           (1.1, 20.0), (1.0, 1.0))
    for i, (lv, gn) in enumerate(seq):
        hm.observe(i, [np.asarray([lv]), np.asarray([gn]),
                       np.asarray([0.01])], now=float(i))
    return len(names), names[0] == loss.name, \
        [(r, round(v, 6), s) for r, v, s in hm.breaches], \
        {k: round(v, 9) for k, v in hm.snapshot()["ema"].items()}


def test_health_monitor_spike_rules_match_the_reference():
    import paddle_tpu as jfluid
    from paddle_tpu.train import health as jhealth
    from paddle_tpu_torch.train import health as thealth
    got = _spike_script(fluid, thealth)
    assert got == _spike_script(jfluid, jhealth)
    n, first_is_loss, breaches, _ema = got
    assert n == 3 and first_is_loss
    assert [(r, s) for r, _v, s in breaches] == [("loss_spike", 3),
                                                 ("grad_norm_spike", 5)]
