"""The port's elastic training loop (paddle_tpu_torch.train) on the CPU,
mirroring tests/test_elastic_training.py without its mesh and fleet
cases: the dataset's resumable cursor and its fault point, preemption
and resume (prestacked slabs and a dataset), a chaos crash and a hung
step restarted from the newest checkpoint, a crash before the first
checkpoint, rollback composed with resume, steps_per_run 1 against 4,
the restart budget, the bounded-deadline preemption save, SIGTERM, and a
chaos mini-soak: each ends bitwise where the uninterrupted port run ends
(port against port: the dropout masks are torch's). Against the JAX
package: the clean supervised run of the same program without dropout,
from the JAX startup's values, ends with params within 1e-5 of max |ref|
of the JAX ``TrainingSupervisor``'s."""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import train
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.framework.executor import scope_from_arrays
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


def _build(pkg, dropout=0.3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [-1, 4], dtype="float32")
        y = pkg.layers.data("y", [-1, 1], dtype="float32")
        h = pkg.layers.fc(x, 16, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        loss = pkg.layers.mean(
            pkg.layers.square_error_cost(pkg.layers.fc(h, 1), y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _shared():
    """One program and executor shared by the parity tests (their scopes
    and checkpoint directories keep them apart; sharing keeps the
    captured steps made once)."""
    if not _shared_cache:
        main, startup, loss = _build(fluid)
        _shared_cache.update(main=main, startup=startup, loss=loss,
                             exe=fluid.Executor(CPU))
    c = _shared_cache
    return c["main"], c["startup"], c["loss"], c["exe"]


def _slabs(n=6, k=4, batch=8, bad_at=None):
    out = []
    for i in range(n):
        r = np.random.default_rng(i)
        s = {"x": r.standard_normal((k, batch, 4)).astype(np.float32),
             "y": r.standard_normal((k, batch, 1)).astype(np.float32)}
        if bad_at is not None and bad_at[0] == i:
            s["x"][bad_at[1], 0, 0] = np.inf
        out.append(s)
    return out


def _value(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _assert_scopes_bitwise_equal(s1, s2):
    names = sorted(s1.keys())
    assert names == sorted(s2.keys())
    for n in names:
        a, b = _value(s1.find_var(n)), _value(s2.find_var(n))
        assert np.array_equal(a, b, equal_nan=True), \
            f"scope var {n!r} diverged between runs"


def _assert_fetch_overlap_equal(r_clean, r_other):
    assert r_other["fetches"], "no fetches collected"
    for i in sorted(r_other["fetches"]):
        a, b = r_clean["fetches"][i][0], r_other["fetches"][i][0]
        assert np.array_equal(a, b, equal_nan=True), \
            f"reported losses diverged at slab {i}"


def _supervisor(ckpt_dir, program=None, **kw):
    main, startup, loss, exe = _shared()
    kw.setdefault("steps_per_run", 4)
    kw.setdefault("checkpoint_every_n_slabs", 2)
    kw.setdefault("scope", fluid.Scope())
    kw.setdefault("restart_backoff", 0.01)
    return train.TrainingSupervisor(
        exe, program if program is not None else main, ckpt_dir,
        startup_program=startup, **kw)


def _clean_run(tmp, slabs=None):
    main, startup, loss, exe = _shared()
    sup = _supervisor(os.path.join(tmp, "clean"))
    return sup, sup.run_slabs(slabs or _slabs(), fetch_list=[loss],
                              collect_fetches=True)


def _dataset(n_batches=24, batch=8):
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


def _preempt_at(slab_no):
    def cb(slab, step, fetches):
        if slab == slab_no:
            train.request_preemption("test")
    return cb


# ------------------------------------------------------ dataset position

def test_positioned_iterator_resumes_bitwise():
    ds = _dataset(n_batches=10)
    it = ds.batch_iterator(position={"epoch": 0, "batches": 0})
    [next(it) for _ in range(4)]
    pos = it.position()
    assert pos["batches"] == 4 and pos["skipped"] == 0
    rest = list(it)
    it2 = ds.batch_iterator(position=pos)
    assert it2.position()["skipped"] == 4
    rest2 = list(it2)
    assert len(rest) == len(rest2) == 6
    for a, b in zip(rest, rest2):
        for n in a:
            assert np.array_equal(a[n], b[n])


def test_producer_fault_point_armed():
    ds = _dataset(n_batches=4)
    with tres.fault_injection("dataio.producer", exc=RuntimeError, times=1):
        with pytest.raises(RuntimeError):
            list(ds.batch_iterator())
    assert len(list(ds.batch_iterator())) == 4


# ------------------------------------------------- bitwise resume parity

def test_preempt_resume_bitwise_run_slabs(tmp_path):
    main, startup, loss, exe = _shared()
    sup1, r1 = _clean_run(str(tmp_path))
    sup2 = _supervisor(str(tmp_path / "pre"), on_slab_end=_preempt_at(3))
    with pytest.raises(train.PreemptedError) as ei:
        sup2.run_slabs(_slabs(), fetch_list=[loss], collect_fetches=True)
    assert ei.value.slab == 3 and ei.value.checkpoint_no is not None
    assert ei.value.reason == "test"
    train.clear_preemption()
    sup3 = _supervisor(str(tmp_path / "pre"))
    r3 = sup3.run_slabs(_slabs(), fetch_list=[loss], collect_fetches=True)
    assert sorted(r3["fetches"]) == [3, 4, 5]   # resumed exactly at 3
    _assert_fetch_overlap_equal(r1, r3)
    _assert_scopes_bitwise_equal(sup1.scope, sup3.scope)


def test_preempt_resume_bitwise_dataset(tmp_path):
    main, startup, loss, exe = _shared()
    ds = _dataset()
    sup1 = _supervisor(str(tmp_path / "clean"))
    r1 = sup1.train(ds, fetch_list=[loss], collect_fetches=True)
    assert r1["slabs"] == 6 and r1["steps"] == 24
    sup2 = _supervisor(str(tmp_path / "pre"), on_slab_end=_preempt_at(3))
    with pytest.raises(train.PreemptedError):
        sup2.train(ds, fetch_list=[loss], collect_fetches=True)
    train.clear_preemption()
    sup3 = _supervisor(str(tmp_path / "pre"))
    r3 = sup3.train(ds, fetch_list=[loss], collect_fetches=True)
    assert sorted(r3["fetches"]) == [3, 4, 5]
    _assert_fetch_overlap_equal(r1, r3)
    _assert_scopes_bitwise_equal(sup1.scope, sup3.scope)


def test_chaos_kill_restart_bitwise_and_reuses_the_captured_step(tmp_path):
    """A fault at slab 4's dispatch crashes the loop; the restart from
    the newest checkpoint (a fresh scope) finishes bitwise the clean run,
    through the executor's captured step (no new entry)."""
    main, startup, loss, exe = _shared()
    sup1, r1 = _clean_run(str(tmp_path))
    entries = exe.cache_stats()["entries"]
    sup2 = _supervisor(str(tmp_path / "chaos"), checkpoint_every_n_slabs=1)
    with tres.chaos({"train.dispatch": {"after": 3, "times": 1}}):
        r2 = sup2.run_slabs(_slabs(), fetch_list=[loss],
                            collect_fetches=True)
    assert r2["restarts"] == 1 and r2["restart_errors"] == ["FaultInjected"]
    assert r2["recoveries_ms"] and r2["recoveries_ms"][0] > 0
    assert exe.cache_stats()["entries"] == entries
    _assert_fetch_overlap_equal(r1, r2)
    _assert_scopes_bitwise_equal(sup1.scope, sup2.scope)


def test_crash_before_first_checkpoint_restarts_from_scratch(tmp_path):
    main, startup, loss, exe = _shared()
    sup1, r1 = _clean_run(str(tmp_path))
    sup2 = _supervisor(str(tmp_path / "early"),
                       checkpoint_every_n_slabs=100)
    with tres.chaos({"train.h2d": {"after": 1, "times": 1}}):
        r2 = sup2.run_slabs(_slabs(), fetch_list=[loss],
                            collect_fetches=True)
    assert r2["restarts"] == 1
    _assert_fetch_overlap_equal(r1, r2)
    _assert_scopes_bitwise_equal(sup1.scope, sup2.scope)


def test_skip_nonfinite_rollback_composes_with_resume(tmp_path):
    main, startup, loss, exe = _shared()
    bad = _slabs(bad_at=(4, 1))
    sup1 = _supervisor(str(tmp_path / "clean"), skip_nonfinite_steps=True)
    r1 = sup1.run_slabs(bad, fetch_list=[loss], collect_fetches=True)
    sup2 = _supervisor(str(tmp_path / "pre"), skip_nonfinite_steps=True,
                       on_slab_end=_preempt_at(3))
    with pytest.raises(train.PreemptedError):
        sup2.run_slabs(bad, fetch_list=[loss], collect_fetches=True)
    train.clear_preemption()
    sup3 = _supervisor(str(tmp_path / "pre"), skip_nonfinite_steps=True)
    r3 = sup3.run_slabs(bad, fetch_list=[loss], collect_fetches=True)
    _assert_fetch_overlap_equal(r1, r3)
    _assert_scopes_bitwise_equal(sup1.scope, sup3.scope)


def test_steps_per_run_1_dataset_parity(tmp_path):
    main, startup, loss, exe = _shared()
    ds = _dataset()
    sup1 = _supervisor(str(tmp_path / "k4"))
    r1 = sup1.train(ds, fetch_list=[loss])
    sup2 = _supervisor(str(tmp_path / "k1"), steps_per_run=1,
                       checkpoint_every_n_slabs=8)
    r2 = sup2.train(ds, fetch_list=[loss])
    assert r2["steps"] == r1["steps"] == 24 and r2["slabs"] == 24
    _assert_scopes_bitwise_equal(sup1.scope, sup2.scope)


# --------------------------------------- supervision: hangs and budgets

def test_hung_step_trips_watchdog_and_restarts(tmp_path):
    """A stalled slab (a chaos delay past the watchdog) raises a typed
    WatchdogTimeout; the supervisor deposes the hung worker's scope,
    restarts from the checkpoint and still ends bitwise. The abandoned
    worker, awake, refuses its slab: the deposed scope keeps the state
    it had and the live one never sees it."""
    main, startup, loss, exe = _shared()
    sup1, r1 = _clean_run(str(tmp_path))
    sup2 = _supervisor(str(tmp_path / "hang"), checkpoint_every_n_slabs=1,
                       step_watchdog_s=0.5)
    first_scope = sup2.scope
    with tres.chaos({"train.dispatch":
                     {"after": 3, "times": 1, "delay": 1.5}}):
        r2 = sup2.run_slabs(_slabs(), fetch_list=[loss],
                            collect_fetches=True)
    assert "WatchdogTimeout" in r2["restart_errors"]
    assert first_scope.deposed is not None and sup2.scope is not first_scope
    time.sleep(1.3)                      # the abandoned worker wakes up
    _assert_fetch_overlap_equal(r1, r2)
    _assert_scopes_bitwise_equal(sup1.scope, sup2.scope)
    with pytest.raises(RuntimeError, match="deposed"):
        exe.run_steps(main, feed=_slabs(1)[0], fetch_list=[loss],
                      scope=first_scope)


def test_restart_budget_exceeded_typed(tmp_path):
    main, startup, loss, exe = _shared()
    sup = _supervisor(str(tmp_path / "budget"), restart_budget=2)
    with tres.chaos("train.dispatch"):          # every dispatch crashes
        with pytest.raises(RestartBudgetExceeded) as ei:
            sup.run_slabs(_slabs(2), fetch_list=[loss])
    assert ei.value.restarts == 3
    assert set(ei.value.errors) == {"FaultInjected"}
    assert isinstance(ei.value.__cause__, tres.FaultInjected)


def test_preempt_fast_checkpoint_bounded_deadline(tmp_path):
    """A checkpoint write stalled past the preemption deadline does not
    hold the exit: the save is abandoned, PreemptedError names no
    durable checkpoint, and the stalled save, once done, is dropped with
    its staging directory."""
    main, startup, loss, exe = _shared()
    asked = {}

    def cb(slab, step, fetches):
        if slab == 3:
            asked["t"] = time.monotonic()
            train.request_preemption("test")

    sup = _supervisor(str(tmp_path / "dl"), checkpoint_every_n_slabs=100,
                      preempt_deadline_s=0.3, on_slab_end=cb)
    with tres.chaos({"io.fsync_write": {"delay": 2.0, "times": 1}}):
        with pytest.raises(train.PreemptedError) as ei:
            sup.run_slabs(_slabs(), fetch_list=[loss])
        elapsed = time.monotonic() - asked["t"]
    assert elapsed < 1.9, f"the preemption exit took {elapsed:.1f}s"
    assert ei.value.checkpoint_no is None and ei.value.slab == 3
    time.sleep(2.5)
    assert sup.checkpoint.latest_no() is None
    assert not any(e.endswith(".tmp")
                   for e in os.listdir(str(tmp_path / "dl")))


def test_sigterm_triggers_typed_preemption(tmp_path):
    main, startup, loss, exe = _shared()

    def cb(slab, step, fetches):
        if slab == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    sup = _supervisor(str(tmp_path / "sig"), handle_signals=True,
                      on_slab_end=cb)
    with pytest.raises(train.PreemptedError) as ei:
        sup.run_slabs(_slabs(), fetch_list=[loss])
    assert ei.value.reason == "signal SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is prev    # handler restored


def test_signal_preemption_is_a_passthrough_off_the_main_thread():
    prev = signal.getsignal(signal.SIGTERM)
    seen = []

    def body():
        with train.signal_preemption():
            seen.append(signal.getsignal(signal.SIGTERM))

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert seen == [prev]
    train.request_preemption("first")
    train.request_preemption("second")
    assert train.preemption_requested()
    assert train.preemption_reason() == "first"
    train.clear_preemption()
    assert not train.preemption_requested()
    assert train.preemption_reason() is None


_SOAK_TYPED = {"FaultInjected", "WatchdogTimeout", "CheckpointCorruptError",
               "CheckpointIncompleteError", "RuntimeError"}


def test_train_chaos_mini_soak(tmp_path):
    """Faults across dispatch, h2d, the dataset producer and checkpoint
    writes: only typed errors, no leaked temporaries, bitwise params."""
    main, startup, loss, exe = _shared()
    feed = _slabs(6)
    sup1, r1 = _clean_run(str(tmp_path), slabs=feed)
    ckdir = str(tmp_path / "soak")
    sup2 = _supervisor(ckdir, checkpoint_every_n_slabs=1, restart_budget=60,
                       max_backoff=0.05)
    with tres.chaos({"train.dispatch": {"p": 0.1},
                     "train.h2d": {"p": 0.05},
                     "dataio.producer": {"p": 0.02},
                     "io.fsync_write": {"p": 0.03}}, seed=11) as monkey:
        r2 = sup2.run_slabs(feed, fetch_list=[loss], collect_fetches=True)
    assert monkey.total_fired() > 0 and r2["restarts"] > 0
    assert set(r2["restart_errors"]) <= _SOAK_TYPED, r2["restart_errors"]
    assert not [e for e in os.listdir(ckdir) if e.endswith(".tmp")]
    _assert_fetch_overlap_equal(r1, r2)
    _assert_scopes_bitwise_equal(sup1.scope, sup2.scope)


# ------------------------------------------------- against the JAX package

def test_clean_supervised_run_matches_the_jax_supervisor(tmp_path):
    """The same program (no dropout) and slabs from the JAX startup's
    values: the port's supervised run ends with every param and Adam
    slot within 1e-5 of max |ref| of the JAX TrainingSupervisor's, and
    its reported losses within 1e-5 too."""
    import paddle_tpu as jfluid
    from paddle_tpu import train as jtrain
    slabs = _slabs(4)
    jmain, jstartup, jloss = _build(jfluid, dropout=0)
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    start = {n: np.array(v) for n, v in jscope.items() if n != "@RNG_KEY@"}
    jsup = jtrain.TrainingSupervisor(
        jexe, jmain, str(tmp_path / "jax"), startup_program=jstartup,
        scope=jscope, steps_per_run=4, checkpoint_every_n_slabs=2)
    jr = jsup.run_slabs(slabs, fetch_list=[jloss], collect_fetches=True)

    tmain, tstartup, tloss = _build(fluid, dropout=0)
    texe, tscope = fluid.Executor(CPU), fluid.Scope()
    texe.run(tstartup, scope=tscope)
    scope_from_arrays(tscope, start)
    tsup = train.TrainingSupervisor(
        texe, tmain, str(tmp_path / "port"), startup_program=tstartup,
        scope=tscope, steps_per_run=4, checkpoint_every_n_slabs=2)
    tr = tsup.run_slabs(slabs, fetch_list=[tloss], collect_fetches=True)
    assert (tr["slabs"], tr["steps"], tr["checkpoints"]) == \
        (jr["slabs"], jr["steps"], jr["checkpoints"])
    for i in sorted(jr["fetches"]):
        a, b = tr["fetches"][i][0], np.asarray(jr["fetches"][i][0])
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    for n, ref in ((n, np.asarray(jsup.scope.find_var(n))) for n in start):
        if ref.dtype.kind != "f":
            continue
        got = _value(tsup.scope.find_var(n))
        assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(),
                                                     1e-30), n
