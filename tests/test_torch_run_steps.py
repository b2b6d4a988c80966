"""The port's training loop against K sequential runs and the JAX
package, on the CPU.

- ``Executor.run_steps`` is bitwise K sequential ``Executor.run`` calls
  in the port (losses, the noam LR and every scope tensor, the run seed
  included) on ``BertConfig.tiny()`` with flash attention and noam Adam
  under ``RecomputeOptimizer`` (``__graft_entry__``'s composition), with
  dropout 0 and 0.1, with the guard off and on, from a prestacked slab
  and from a list of feed dicts;
- losses and final parameters are within 1e-5 (rtol) of the JAX
  package's ``run_steps`` from the same start state (a 6-layer MLP with
  Adam, dropout off);
- ``check_nan_inf`` raises ``NonFiniteError`` naming the first bad fused
  step and its first offender as the JAX package does, after every step
  ran; ``run(check_nan_inf=True)`` names the first offender;
- ``skip_nonfinite_steps`` rolls back only the bad steps: the scope is
  bitwise a sequential ``run(skip_nonfinite_steps=True)`` over the same
  feeds, a write-only persistable that the scope lacked included (it
  stays out of the scope when every step rolled back), and within 1e-5
  of the JAX package's;
- the feed-validation errors carry the JAX package's messages;
- ``train_from_dataset`` with ``steps_per_run=4`` (run_steps slabs and a
  short tail through ``run``) ends bitwise where the stepwise path ends,
  with ``fetch_every_n`` > 1 too;
- the training loop's flags default as the JAX package's, but
  ``FLAGS_cudnn_deterministic``, on in the port;
  ``FLAGS_check_nan_inf`` turns the guard on for ``run`` and
  ``run_steps``; ``FLAGS_cudnn_deterministic`` holds cuDNN deterministic
  around the conv calls only."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.framework import unique_name as j_unique_name
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework.executor import RNG_STATE_NAME
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.resilience import NonFiniteError

from test_torch_recompute import B, P, S, bert_graft, carried, copy_scope

JAX = (jfluid, jbert, j_unique_name)
PORT = (tfluid, tbert, tfluid.unique_name)
K = 4


def mlp(pkg, last_loss=False):
    """A 6-layer MLP with Adam(0.01); ``last_loss`` also writes the loss
    into a persistable var that no startup op creates (a write-only
    persistable the scope lacks)."""
    fluid, _, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 32], "float32")
        y = fluid.data("y", [-1, 1], "float32")
        h = x
        for _ in range(6):
            h = fluid.layers.fc(h, 32, act="relu")
        loss = fluid.layers.mean(fluid.layers.square(fluid.layers.fc(h, 1)
                                                     - y))
        if last_loss:
            keep = main.global_block().create_var(
                name="last_loss", shape=loss.shape, dtype="float32",
                persistable=True)
            fluid.layers.assign(loss, output=keep)
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    return main, startup, loss.name


def mlp_feeds(k, nan_at=(), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(k, 8, 32).astype(np.float32)
    for i in nan_at:
        x[i, 0, 0] = np.nan
    return {"x": x, "y": rng.randn(k, 8, 1).astype(np.float32)}


def rows(slab):
    k = len(next(iter(slab.values())))
    return [{n: a[i] for n, a in slab.items()} for i in range(k)]


def assert_scopes_equal(a, b):
    assert set(a.keys()) == set(b.keys())
    for n in a.keys():
        va, vb = a.find_var(n), b.find_var(n)
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), n
        else:
            assert va == vb, n


def _bert_start(dropout):
    cfg, main, startup, out = bert_graft(PORT, True, dropout)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(1)
    feeds = [tbert.random_batch(cfg, B, S, P, rng=rng) for _ in range(K)]
    return main, out, exe, scope, feeds


@pytest.mark.parametrize("listed", [False, True])
@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_run_steps_is_bitwise_sequential_runs(dropout, guard, listed):
    main, out, exe, scope, feeds = _bert_start(dropout)
    fetch = [out["loss"], out["mlm_loss"]]
    seq = copy_scope(scope)
    want = [exe.run(main, feed=f, fetch_list=fetch, scope=seq,
                    check_nan_inf=guard) for f in feeds]
    slab = feeds if listed else {n: np.stack([f[n] for f in feeds])
                                 for n in feeds[0]}
    got = exe.run_steps(main, feed=slab, fetch_list=fetch, scope=scope,
                        check_nan_inf=guard)
    for i in range(len(fetch)):
        assert np.array_equal(got[i], np.stack([w[i] for w in want]))
    assert_scopes_equal(scope, seq)
    # a second slab replays the cached entry over the scope it left
    more = exe.run_steps(main, feed=slab, fetch_list=fetch, scope=scope,
                         check_nan_inf=guard)
    again = [exe.run(main, feed=f, fetch_list=fetch, scope=seq,
                     check_nan_inf=guard) for f in feeds]
    assert np.array_equal(more[0], np.stack([w[0] for w in again]))
    assert_scopes_equal(scope, seq)


def test_eager_run_between_slabs_is_seen_by_the_next_slab():
    main, out, exe, scope, feeds = _bert_start(0.1)
    seq = copy_scope(scope)
    slab = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    exe.run_steps(main, feed=slab, fetch_list=[out["loss"]], scope=scope)
    exe.run(main, feed=feeds[0], fetch_list=[out["loss"]], scope=scope)
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=scope)
    for f in feeds + feeds[:1]:
        exe.run(main, feed=f, fetch_list=[out["loss"]], scope=seq)
    want = [exe.run(main, feed=f, fetch_list=[out["loss"]], scope=seq)[0]
            for f in feeds]
    assert np.array_equal(got[0], np.stack(want))
    assert_scopes_equal(scope, seq)
    # another scope through the same entry leaves the first one alone
    other = copy_scope(seq)
    snapshot = copy_scope(scope)
    exe.run_steps(main, feed=slab, fetch_list=[out["loss"]], scope=other)
    assert_scopes_equal(scope, snapshot)


def _jax_and_port(last_loss=False):
    jmain, jstart, jloss = mlp(JAX, last_loss)
    tmain, tstart, tloss = mlp(PORT, last_loss)
    jscope, tscope = carried(jstart, tstart)
    return (jmain, jloss, jfluid.Executor(), jscope), \
        (tmain, tloss, tfluid.Executor(tfluid.CPUPlace()), tscope)


def test_run_steps_matches_jax_run_steps():
    (jmain, jloss, jexe, jscope), (tmain, tloss, texe, tscope) = \
        _jax_and_port()
    for seed in range(2):
        slab = mlp_feeds(K, seed=seed)
        j = jexe.run_steps(jmain, feed=slab, fetch_list=[jloss],
                           scope=jscope)
        t = texe.run_steps(tmain, feed=slab, fetch_list=[tloss],
                           scope=tscope)
        np.testing.assert_allclose(t[0], np.asarray(j[0]), rtol=1e-5)
    for p in tmain.global_block().all_parameters():
        np.testing.assert_allclose(tscope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=1e-5, atol=1e-6)


def test_check_nan_inf_names_the_fused_step_as_jax():
    (jmain, jloss, jexe, jscope), (tmain, tloss, texe, tscope) = \
        _jax_and_port()
    slab = mlp_feeds(K, nan_at=(2,))
    with pytest.raises(jfluid.resilience.NonFiniteError) as je:
        jexe.run_steps(jmain, feed=slab, fetch_list=[jloss], scope=jscope,
                       check_nan_inf=True)
    with pytest.raises(NonFiniteError) as te:
        texe.run_steps(tmain, feed=slab, fetch_list=[tloss], scope=tscope,
                       check_nan_inf=True)
    assert f"fused step 2/{K} of program_" in str(te.value)
    assert te.value.var_name == je.value.var_name == \
        f"fetched output {tloss!r}"
    # every step ran and was committed: the state the bad step poisoned
    # (relu passes nan on in torch; XLA's max may not, so the JAX count
    # differs) is what the count covers, beside the loss
    w = tmain.global_block().all_parameters()[0].name
    assert not torch.isfinite(tscope.find_var(w)).all()
    assert te.value.count == 1 + sum(
        int((~torch.isfinite(v)).sum()) for n, v in tscope.items()
        if n != RNG_STATE_NAME and v.is_floating_point())
    # the single-step guard names the first offender
    (_, _, _, _), (tmain, tloss, texe, tscope) = _jax_and_port()
    with pytest.raises(NonFiniteError) as te:
        texe.run(tmain, feed=rows(mlp_feeds(1, nan_at=(0,)))[0],
                 fetch_list=[tloss], scope=tscope, check_nan_inf=True)
    assert te.value.var_name == tloss and te.value.count == 1
    assert "fetched output" in str(te.value)


@pytest.mark.parametrize("nan_at", [(1,), (0, 1, 2, 3)])
def test_skip_nonfinite_rolls_back_only_bad_steps(nan_at):
    (jmain, jloss, jexe, jscope), (tmain, tloss, texe, tscope) = \
        _jax_and_port(last_loss=True)
    assert tscope.find_var("last_loss") is None
    seq = copy_scope(tscope)
    slab = mlp_feeds(K, nan_at=nan_at)
    got = texe.run_steps(tmain, feed=slab, fetch_list=[tloss],
                         scope=tscope, skip_nonfinite_steps=True)
    want = [texe.run(tmain, feed=f, fetch_list=[tloss], scope=seq,
                     skip_nonfinite_steps=True)[0] for f in rows(slab)]
    assert np.array_equal(got[0], np.stack(want), equal_nan=True)
    assert_scopes_equal(tscope, seq)
    all_bad = len(nan_at) == K
    assert (tscope.find_var("last_loss") is None) == all_bad
    jexe.run_steps(jmain, feed=slab, fetch_list=[jloss], scope=jscope,
                   skip_nonfinite_steps=True)
    for n in tscope.keys():
        if n == RNG_STATE_NAME:
            continue
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert (jscope.find_var("last_loss") is None) == all_bad


BAD_FEEDS = {
    "scalar": dict(feed={"x": np.float32(1)}),
    "k_mismatch": dict(feed={"x": np.ones((3, 8, 32), np.float32),
                             "y": np.ones((2, 8, 1), np.float32)}),
    "steps_per_run": dict(feed={"x": np.ones((3, 8, 32), np.float32),
                                "y": np.ones((3, 8, 1), np.float32)},
                          steps_per_run=2),
    "empty_list": dict(feed=[]),
    "names_differ": dict(feed=[{"x": np.ones((8, 32), np.float32)},
                               {"y": np.ones((8, 1), np.float32)}]),
    "no_feed": dict(feed={}),
}


@pytest.mark.parametrize("case", sorted(BAD_FEEDS))
def test_feed_validation_messages_are_jax(case):
    (jmain, jloss, jexe, jscope), (tmain, tloss, texe, tscope) = \
        _jax_and_port()
    with pytest.raises(ValueError) as je:
        jexe.run_steps(jmain, fetch_list=[jloss], scope=jscope,
                       **BAD_FEEDS[case])
    with pytest.raises(ValueError) as te:
        texe.run_steps(tmain, fetch_list=[tloss], scope=tscope,
                       **BAD_FEEDS[case])
    assert str(te.value) == str(je.value)


def _dataset(tmp_path, main, n_samples, batch):
    rng = np.random.RandomState(3)
    lines = []
    for _ in range(n_samples):
        x = rng.randn(32).astype(np.float32)
        y = rng.randn(1).astype(np.float32)
        lines.append(f"x:{','.join(map(repr, x.tolist()))} "
                     f"y:{','.join(map(repr, y.tolist()))}")
    files = []
    for i in range(2):
        path = tmp_path / f"part-{i}.txt"
        path.write_text("\n".join(lines[i::2]) + "\n")
        files.append(str(path))
    ds = tfluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_filelist(files)
    ds.set_batch_size(batch)
    block = main.global_block()
    ds.set_use_var([block.var("x"), block.var("y")])
    return ds


@pytest.mark.parametrize("fetch_every_n", [1, 2])
def test_train_from_dataset_fused_equals_stepwise(tmp_path, capsys,
                                                  fetch_every_n):
    tmain, tstart, tloss = mlp(PORT)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(tstart, scope=scope)
    seq = copy_scope(scope)
    # 11 batches of 8 and a short 12th: slabs of 4, 4, then 3 and 1
    ds = _dataset(tmp_path, tmain, 8 * 11 + 3, 8)
    fused = exe.train_from_dataset(tmain, ds, scope=scope,
                                   fetch_list=[tloss], print_period=5,
                                   steps_per_run=4,
                                   fetch_every_n=fetch_every_n)
    step = exe.train_from_dataset(tmain, ds, scope=seq, fetch_list=[tloss],
                                  print_period=5, steps_per_run=1)
    assert_scopes_equal(scope, seq)
    assert fused[0].shape == (1,)          # the tail slab, stacked
    assert np.array_equal(fused[0][-1], step[0])
    printed = capsys.readouterr().out.splitlines()
    assert [l.split(":")[0] for l in printed] == \
        ["step 5", "step 10"] * 2
    assert printed[:2] == printed[2:]


# the port's own defaults: cuDNN deterministic convs cost bench_resnet50's
# step nothing measurable on the card, and make conv training repeatable
PORT_DEFAULTS = {"cudnn_deterministic": True}


@pytest.mark.parametrize("name", ["check_nan_inf", "steps_per_run",
                                  "fetch_every_n", "cudnn_deterministic"])
def test_training_loop_flags_default_as_jax(name):
    want = jfluid.get_flags(f"FLAGS_{name}")[f"FLAGS_{name}"]
    want = PORT_DEFAULTS.get(name, want)
    assert tfluid.get_flags(f"FLAGS_{name}") == {f"FLAGS_{name}": want}


def test_check_nan_inf_flag_turns_the_guard_on():
    (_, _, _, _), (tmain, tloss, texe, tscope) = _jax_and_port()
    feed = rows(mlp_feeds(1, nan_at=(0,)))[0]
    old = tfluid.get_flags("FLAGS_check_nan_inf")
    tfluid.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(NonFiniteError):
            texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        with pytest.raises(NonFiniteError):
            texe.run_steps(tmain, feed=mlp_feeds(2, nan_at=(1,)),
                           fetch_list=[tloss], scope=tscope)
    finally:
        tfluid.set_flags(old)
    # off again: the same feed runs (and commits) without a word
    texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)


def test_cudnn_deterministic_flag_holds_only_the_conv_calls(monkeypatch):
    """``FLAGS_cudnn_deterministic`` turns cuDNN's deterministic mode on
    around the conv ops' forward and backward calls only."""
    from paddle_tpu_torch.ops import nn_ops
    seen = []
    real = nn_ops.F.conv2d

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.deterministic)
        return real(*a, **k)
    monkeypatch.setattr(nn_ops.F, "conv2d", spy)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.data("img", [-1, 1, 8, 8], "float32")
        out = tfluid.layers.mean(tfluid.layers.conv2d(img, 2, 3))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"img": np.ones((1, 1, 8, 8), np.float32)}
    old = tfluid.get_flags("FLAGS_cudnn_deterministic")
    assert not torch.backends.cudnn.deterministic
    for on in (False, True):
        tfluid.set_flags({"FLAGS_cudnn_deterministic": on})
        try:
            exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        finally:
            tfluid.set_flags(old)
        assert seen[-1] is on
        assert not torch.backends.cudnn.deterministic
