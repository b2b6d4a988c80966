"""Exact training resume in the port (``io.save_checkpoint`` /
``load_checkpoint``, ``io.CheckpointSaver``, ``train.TrainCheckpoint``)
against the JAX package, on the CPU.

- The cases of JAX's ``tests/test_elastic_training.py:137-260, 434`` and
  ``tests/test_resilience.py:76-246, 479`` that need no supervisor, with
  the port's own ``resilience.fault_injection``: a checkpoint round trip
  resumes ``run_steps`` bitwise (dropout on: the run seed comes back);
  a params-only directory and one without the RNG record raise
  ``CheckpointIncompleteError`` (``strict=False`` takes the latter); a
  rewritten ``train_state.json``, a flipped byte and a truncated file
  fail the manifest; the saver's retention, background saves, distinct
  numbers, surfaced background failures and stale-temp collection; a
  single-archive checkpoint; a corrupt RNG file on a manifest-less
  directory raises.
- Across the packages: a JAX ``save_checkpoint`` resumed by the port and
  a port ``save_checkpoint`` resumed by the JAX package (strict, through
  the JAX key the port writes beside its seed), every value bitwise and
  3 more dropout-free steps within 1e-5; the train state both ways.
- ``TrainCheckpoint.restore_latest`` skips a corrupt newest checkpoint.
- ``BertConfig.tiny()`` with flash attention under LAMB + global-norm
  clipping at a warm-up + polynomial LR, dropout 0.1: a ``run_steps``
  slab, a synchronous and a background ``TrainCheckpoint.save`` (the
  background one while the next slab runs), then ``restore_latest`` in
  a fresh scope and in the same scope: the next slab's losses and the
  whole scope, run seed included, bitwise the uninterrupted run's, and
  the background checkpoint's files those of the synchronous one.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import io as jio

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import resilience, train
from paddle_tpu_torch.framework.executor import RNG_STATE_NAME
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.resilience import (CheckpointCorruptError,
                                         CheckpointIncompleteError)

JAX_RNG = "@RNG_KEY@"
CPU = tfluid.CPUPlace()


@pytest.fixture
def faults():
    resilience.clear_faults()
    yield resilience
    resilience.clear_faults()


def build(fluid, dropout=0.3):
    """JAX test_elastic_training's ``_shared`` program: fc 16 relu,
    dropout, fc 1, squared error, Adam(0.01)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [-1, 4], dtype="float32")
        y = fluid.layers.data("y", [-1, 1], dtype="float32")
        h = fluid.layers.fc(x, 16, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def slabs(n=3, k=4, batch=8):
    out = []
    for i in range(n):
        r = np.random.default_rng(i)
        out.append({"x": r.standard_normal((k, batch, 4)).astype(np.float32),
                    "y": r.standard_normal((k, batch, 1)).astype(np.float32)})
    return out


def started(dropout=0.3):
    main, startup, loss = build(tfluid, dropout)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, loss, exe, scope


def assert_scopes_bitwise(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for n in a.keys():
        va, vb = a.find_var(n), b.find_var(n)
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and torch.equal(va, vb), n
        else:
            assert va == vb, n


# ----------------------------------------- save_checkpoint/load_checkpoint

def test_save_load_checkpoint_roundtrips_opt_state_and_rng(tmp_path):
    main, loss, exe, s1 = started()
    ss = slabs()
    exe.run_steps(main, feed=ss[0], fetch_list=[loss], scope=s1)
    d = str(tmp_path / "ck")
    tio.save_checkpoint(exe, d, main_program=main, scope=s1,
                        train_state={"slab": 1})
    ref = [exe.run_steps(main, feed=s, fetch_list=[loss], scope=s1)[0]
           for s in ss[1:]]
    s2 = tfluid.Scope()
    assert tio.load_checkpoint(exe, d, main_program=main,
                               scope=s2) == {"slab": 1}
    got = [exe.run_steps(main, feed=s, fetch_list=[loss], scope=s2)[0]
           for s in ss[1:]]
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    assert_scopes_bitwise(s1, s2)


def test_load_checkpoint_params_only_raises_typed(tmp_path):
    main, loss, exe, scope = started()
    exe.run_steps(main, feed=slabs(1)[0], fetch_list=[loss], scope=scope)
    tio.save_params(exe, str(tmp_path / "params"), main_program=main,
                    scope=scope)
    fresh = tfluid.Scope()
    with pytest.raises(CheckpointIncompleteError) as ei:
        tio.load_checkpoint(exe, str(tmp_path / "params"),
                            main_program=main, scope=fresh)
    assert "optimizer state" in str(ei.value)
    assert any("moment" in n for n in ei.value.missing)
    assert isinstance(ei.value, CheckpointCorruptError)
    assert not list(fresh.keys())


def test_load_checkpoint_missing_rng_raises_unless_lenient(tmp_path):
    main, loss, exe, scope = started()
    exe.run_steps(main, feed=slabs(1)[0], fetch_list=[loss], scope=scope)
    d = str(tmp_path / "norng")
    tio.save_vars(exe, d, main_program=main, predicate=tio.is_persistable,
                  scope=scope)
    with pytest.raises(CheckpointIncompleteError) as ei:
        tio.load_checkpoint(exe, d, main_program=main, scope=tfluid.Scope())
    assert RNG_STATE_NAME in ei.value.missing
    tio.load_checkpoint(exe, d, main_program=main, scope=tfluid.Scope(),
                        strict=False)


def test_train_state_is_manifest_covered(tmp_path):
    main, loss, exe, scope = started()
    d = tmp_path / "ck"
    tio.save_checkpoint(exe, str(d), main_program=main, scope=scope,
                        train_state={"slab": 1})
    (d / tio.TRAIN_STATE_FILE).write_text(json.dumps({"slab": 999}))
    with pytest.raises(CheckpointCorruptError):
        tio.load_checkpoint(exe, str(d), main_program=main,
                            scope=tfluid.Scope())


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_damaged_checkpoint_rejected(tmp_path, damage):
    """JAX's test_corrupt_checkpoint_byte_rejected and
    test_truncated_checkpoint_rejected through load_checkpoint: the
    error names the file and the scope stays empty."""
    main, loss, exe, scope = started()
    d = str(tmp_path / "ck")
    tio.save_checkpoint(exe, d, main_program=main, scope=scope)
    victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    path = os.path.join(d, victim)
    blob = bytearray(open(path, "rb").read())
    if damage == "flip":
        blob[-1] ^= 0xFF
    else:
        blob = blob[:len(blob) // 2]
    open(path, "wb").write(bytes(blob))
    fresh = tfluid.Scope()
    with pytest.raises(CheckpointCorruptError,
                       match="truncated" if damage == "truncate"
                       else "integrity") as ei:
        tio.load_checkpoint(exe, d, main_program=main, scope=fresh)
    assert victim in str(ei.value) and ei.value.path == path
    assert not list(fresh.keys())


def test_load_vars_aggregates_all_missing(tmp_path):
    main, loss, exe, scope = started()
    d = str(tmp_path / "ck")
    tio.save_params(exe, d, main_program=main, scope=scope)
    params = sorted(p.name for p in main.all_parameters())
    for name in params[:2]:
        os.remove(os.path.join(d, name + ".npy"))
    os.remove(os.path.join(d, "_manifest.json"))
    before = {n: scope.find_var(n).clone() for n in params}
    with pytest.raises(RuntimeError) as ei:
        tio.load_params(exe, d, main_program=main, scope=scope)
    assert all(n in str(ei.value) for n in params[:2])
    assert "2 variable(s)" in str(ei.value)
    for n in params:
        assert torch.equal(scope.find_var(n), before[n])


def test_load_checkpoint_single_archive_roundtrip(tmp_path):
    main, loss, exe, s1 = started()
    exe.run_steps(main, feed=slabs(1)[0], fetch_list=[loss], scope=s1)
    tio.save_persistables(exe, str(tmp_path / "ar"), main_program=main,
                          filename="all", scope=s1)
    s2 = tfluid.Scope()
    tio.load_checkpoint(exe, str(tmp_path / "ar"), main_program=main,
                        scope=s2, filename="all")
    assert_scopes_bitwise(s1, s2)


def test_load_vars_corrupt_rng_extra_raises(tmp_path):
    main, loss, exe, scope = started()
    scope.set(RNG_STATE_NAME, 99)
    d = str(tmp_path / "ck")
    tio.save_persistables(exe, d, main, scope=scope)
    os.remove(os.path.join(d, "_manifest.json"))
    rng_file = os.path.join(d, RNG_STATE_NAME + ".npy")
    assert os.path.exists(rng_file)
    open(rng_file, "wb").write(b"\x00" * 8)
    with pytest.raises(RuntimeError, match="unreadable"):
        tio.load_persistables(exe, d, main, scope=tfluid.Scope())


# ----------------------------------------------------------- the saver

def test_checkpoint_saver_retention_async_and_restore(tmp_path):
    main, loss, exe, scope = started()
    saver = tfluid.CheckpointSaver(str(tmp_path / "s"), max_to_keep=2,
                                   prefix="ckpt-")
    ss = slabs(3, k=1)
    for i in range(3):
        exe.run_steps(main, feed=ss[i], fetch_list=[loss], scope=scope)
        assert saver.save(exe, main_program=main, scope=scope) == i
    no = saver.save_async(exe, main_program=main, scope=scope)
    saver.wait()
    assert no == 3 and saver.checkpoint_numbers() == [2, 3]
    fresh = tfluid.Scope()
    assert saver.restore(exe, main_program=main, scope=fresh) == 3
    assert_scopes_bitwise(scope, fresh)


def test_checkpoint_saver_async_error_surfaces(tmp_path, faults):
    main, loss, exe, scope = started()
    saver = tfluid.CheckpointSaver(str(tmp_path / "s"), max_to_keep=None)
    with faults.fault_injection("io.fsync_write", exc=OSError("disk full"),
                                times=1):
        saver.save_async(exe, main_program=main, scope=scope)
        with pytest.raises(OSError, match="disk full"):
            saver.wait()


def test_checkpoint_saver_concurrent_async_distinct_numbers(tmp_path):
    main, loss, exe, scope = started()
    saver = tfluid.CheckpointSaver(str(tmp_path / "s"), max_to_keep=None)
    nos = [saver.save_async(exe, main_program=main, scope=scope)
           for _ in range(3)]
    saver.wait()
    assert nos == [0, 1, 2] and saver.checkpoint_numbers() == [0, 1, 2]
    for n in nos:
        tio.verify_checkpoint(str(tmp_path / "s" / f"{saver.prefix}{n}"))


def test_checkpoint_saver_gcs_stale_temps(tmp_path):
    d = str(tmp_path / "cks")
    os.makedirs(os.path.join(d, "__paddle_checkpoint__3.tmp"))
    open(os.path.join(d, "__paddle_checkpoint__3.tmp", "w.npy.tmp"),
         "w").write("half-written")
    open(os.path.join(d, "junk.npy.tmp"), "w").write("orphan")
    saver = tfluid.CheckpointSaver(d)
    assert not any(e.endswith(".tmp") for e in os.listdir(d))
    no, stage = saver._stage()
    os.makedirs(stage, exist_ok=True)
    saver._gc_stale_temps()
    assert os.path.isdir(stage)
    saver._release(no)
    saver._gc_stale_temps()
    assert not os.path.isdir(stage)


def test_failed_commit_leaves_no_checkpoint_and_is_gced(tmp_path, faults):
    """A failed rename (``io.rename``) leaks the staging dir until the
    next saver collects it; a failed ``io.commit`` publishes nothing; an
    abandoned background save is never published."""
    main, loss, exe, scope = started()
    d = str(tmp_path / "cks")
    ck = train.TrainCheckpoint(d)
    assert ck.save(exe, program=main, scope=scope, train_state={}) == 0
    with faults.fault_injection("io.rename", exc=OSError, times=1):
        with pytest.raises(OSError):
            ck.save(exe, program=main, scope=scope, train_state={})
    assert any(e.endswith(".tmp") for e in os.listdir(d))
    with faults.fault_injection("io.commit") as spec:
        with pytest.raises(ConnectionError):
            ck.save(exe, program=main, scope=scope, train_state={})
    assert spec["fired"] == 1
    ck2 = train.TrainCheckpoint(d)
    assert not any(e.endswith(".tmp") for e in os.listdir(d))
    assert ck2.latest_no() == 0
    no, state = ck2.restore_latest(exe, program=main, scope=tfluid.Scope())
    assert (no, state) == (0, {})
    # abandoned while its files are being written
    with faults.fault_injection("io.fsync_write", exc=lambda p, c: (
            ck2.saver.abandon_inflight(), None)[1]):
        ck2.save(exe, program=main, scope=scope, async_save=True)
        ck2.wait()
    assert ck2.latest_no() == 0
    assert not any(e.endswith(".tmp") for e in os.listdir(d))


def test_restore_latest_skips_a_corrupt_newest(tmp_path, capsys):
    main, loss, exe, scope = started()
    ck = train.TrainCheckpoint(str(tmp_path / "tc"))
    ss = slabs(2, k=2)
    exe.run_steps(main, feed=ss[0], fetch_list=[loss], scope=scope)
    ck.save(exe, program=main, scope=scope, train_state={"slab": 1})
    want = {n: v.clone() if isinstance(v, torch.Tensor) else v
            for n, v in scope.items()}
    exe.run_steps(main, feed=ss[1], fetch_list=[loss], scope=scope)
    ck.save(exe, program=main, scope=scope, train_state={"slab": 2},
            async_save=True)
    ck.wait()
    newest = os.path.join(str(tmp_path / "tc"), "__train_checkpoint__1")
    victim = os.path.join(newest, sorted(
        f for f in os.listdir(newest) if f.endswith(".npy"))[0])
    blob = bytearray(open(victim, "rb").read())
    blob[-1] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    fresh = tfluid.Scope()
    assert ck.restore_latest(exe, program=main, scope=fresh) == \
        (0, {"slab": 1})
    assert "unusable" in capsys.readouterr().out
    for n, v in want.items():
        got = fresh.find_var(n)
        assert torch.equal(got, v) if isinstance(v, torch.Tensor) \
            else got == v, n
    for name in ("TrainingSupervisor", "HealthMonitor", "SliceSupervisor",
                 "request_preemption"):
        with pytest.raises(NotImplementedError, match="Queue 1"):
            getattr(train, name)()
    empty = train.TrainCheckpoint(str(tmp_path / "none"))
    assert empty.restore_latest(exe, program=main) == (None, None)


# ------------------------------------------------------ across packages

def _jax_state():
    main, startup, loss = build(jfluid, dropout=0)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    return main, loss, exe, scope


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jmain, jloss, jexe, jscope = _jax_state()
    ss = slabs(2, k=3)
    jexe.run_steps(jmain, feed=ss[0], fetch_list=[jloss], scope=jscope)
    d = str(tmp_path / "jax")
    jio.save_checkpoint(jexe, d, main_program=jmain, scope=jscope,
                        train_state={"slab": 1})
    want = np.asarray(jexe.run_steps(jmain, feed=ss[1], fetch_list=[jloss],
                                     scope=jscope)[0])
    main, loss, exe, _ = started(dropout=0)
    scope = tfluid.Scope()
    assert tio.load_checkpoint(exe, d, main_program=main,
                               scope=scope) == {"slab": 1}
    jvals = {n: np.load(os.path.join(d, n + ".npy"))
             for n in scope.keys() if n != RNG_STATE_NAME}
    for n, v in jvals.items():
        assert np.array_equal(scope.find_var(n).numpy(), v), n
    key = np.load(os.path.join(d, JAX_RNG + ".npy"))
    assert scope.find_var(RNG_STATE_NAME) == tio.fold_jax_key(key)
    got = exe.run_steps(main, feed=ss[1], fetch_list=[loss], scope=scope)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    main, loss, exe, scope = started(dropout=0)
    ss = slabs(2, k=3)
    exe.run_steps(main, feed=ss[0], fetch_list=[loss], scope=scope)
    d = str(tmp_path / "port")
    tio.save_checkpoint(exe, d, main_program=main, scope=scope,
                        train_state={"slab": 1})
    want = exe.run_steps(main, feed=ss[1], fetch_list=[loss],
                         scope=scope)[0]
    jmain, jloss, jexe, _ = _jax_state()
    jscope = jfluid.Scope()
    assert jio.load_checkpoint(jexe, d, main_program=jmain,
                               scope=jscope) == {"slab": 1}
    seed = int(np.load(os.path.join(d, RNG_STATE_NAME + ".npy"))[0])
    assert np.array_equal(np.asarray(jscope.find_var(JAX_RNG)),
                          [seed >> 32, seed & 0xFFFFFFFF])
    for n in jscope.keys():
        if n != JAX_RNG:
            assert np.array_equal(np.asarray(jscope.find_var(n)),
                                  np.load(os.path.join(d, n + ".npy"))), n
    got = np.asarray(jexe.run_steps(jmain, feed=ss[1], fetch_list=[jloss],
                                    scope=jscope)[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ----------------------------------- BERT under LAMB + clip, resumed

def bert_lamb(fluid, B=2, S=16, P=4):
    """``BertConfig.tiny()`` (2 layers) with flash attention and dropout
    0.1 under LAMB(weight decay 0.01, 0.9, 0.999, 1e-6) with global-norm
    clipping at 1.0 over a linear warm-up into a polynomial decay."""
    cfg = tbert.BertConfig.tiny()
    cfg.attn_mechanism = "flash"
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = tbert.bert_pretrain(cfg, B, S, P)
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(1e-3, 100, 0.0, power=1.0),
            4, 0.0, 1e-3)
        fluid.optimizer.LambOptimizer(
            lr, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
            epsilon=1e-6,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)).minimize(
                out["loss"])
    return cfg, main, startup, out, lr


def test_bert_lamb_clip_resume_is_bitwise(tmp_path):
    cfg, main, startup, out, lr = bert_lamb(tfluid)
    types = [op.type for op in main.global_block().ops]
    assert types.count("lamb") == len(main.all_parameters())
    assert types.count("squared_l2_norm") == len(main.all_parameters())
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(3)
    feeds = [tbert.random_batch(cfg, 2, 16, 4, rng=rng) for _ in range(4)]
    slab1 = {n: np.stack([f[n] for f in feeds[:2]]) for n in feeds[0]}
    slab2 = {n: np.stack([f[n] for f in feeds[2:]]) for n in feeds[0]}
    fetch = [out["loss"], lr]
    exe.run_steps(main, feed=slab1, fetch_list=fetch, scope=scope)
    ck = train.TrainCheckpoint(str(tmp_path / "ck"), max_to_keep=2)
    assert ck.save(exe, program=main, scope=scope,
                   train_state={"slab": 1}) == 0
    assert ck.save(exe, program=main, scope=scope, train_state={"slab": 1},
                   async_save=True) == 1
    want = exe.run_steps(main, feed=slab2, fetch_list=fetch, scope=scope)
    ck.wait()
    man = [json.load(open(os.path.join(str(tmp_path / "ck"),
                                       f"__train_checkpoint__{i}",
                                       "_manifest.json")))
           for i in (0, 1)]
    assert man[0]["files"] == man[1]["files"]   # the snapshot predates slab 2
    fresh_exe, fresh = tfluid.Executor(CPU), tfluid.Scope()
    assert ck.restore_latest(fresh_exe, program=main, scope=fresh) == \
        (1, {"slab": 1})
    got = fresh_exe.run_steps(main, feed=slab2, fetch_list=fetch,
                              scope=fresh)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    assert_scopes_bitwise(scope, fresh)
    # the same scope, which the executor's step holds, restored in place
    final = {n: v.clone() if isinstance(v, torch.Tensor) else v
             for n, v in scope.items()}
    assert ck.restore_latest(exe, program=main, scope=scope)[0] == 1
    again = exe.run_steps(main, feed=slab2, fetch_list=fetch, scope=scope)
    for a, b in zip(want, again):
        assert np.array_equal(a, b)
    for n, v in final.items():
        got_v = scope.find_var(n)
        assert torch.equal(got_v, v) if isinstance(v, torch.Tensor) \
            else got_v == v, n
