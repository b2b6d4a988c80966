"""Wide&Deep CTR (``models.widedeep``) in the port against the JAX
package, on the CPU, at ``tests/test_models.py``'s small shape: dense 4,
6 slots, vocab 50, embed 8, hidden (32, 16), B32, Adam(1e-2).

- The main and startup programs equal the JAX package's
  (``to_dict()``: op types, attrs, var names and shapes), Adam plain and
  lazy; with ``table_dist_attr=("mp", None)`` too, every table and its
  Adam moments carrying the annotation as in the JAX package.
- ``params_from_jax`` carries the JAX startup's 20 parameters across
  bit for bit and raises on a missing or mis-shaped one.
- Three Adam steps on one batch from the JAX startup's values, plain
  (the sparse grads densified) and lazy: falling losses within rtol 1e-5
  of JAX's, every
  parameter and optimizer state within 1e-4 of its max |ref|; the
  pipeline leaves the 12 table updates per-param as JAX's does.
- ``Executor.run_steps`` over a slab of 3 batches is bitwise 3
  sequential ``Executor.run`` calls (losses and every scope tensor).
- ``clone(for_test=True)``'s predictions within 1e-5 of max |ref| of the
  JAX clone's on the trained scopes; ``save_inference_model`` of the
  port's trained model, read by both packages' predictors, gives
  predictions within 1e-5 of max |ref| of each other and of the clone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.framework import passes as jpasses
from paddle_tpu.models import widedeep as jwd

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.models import widedeep as twd

JAX_RNG = "@RNG_KEY@"
CFG = dict(dense_dim=4, num_slots=6, vocab_size=50, embed_dim=8,
           hidden_sizes=(32, 16))
B, STEPS = 32, 3


def build(fluid, wd, lazy, batch_size=B, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = wd.wide_deep(batch_size=batch_size, **CFG, **kw)
        fluid.optimizer.AdamOptimizer(1e-2, lazy_mode=lazy).minimize(
            out["loss"])
    return main, startup, out


def feeds(n):
    rng = np.random.default_rng(0)
    return [jwd.random_batch(B, dense_dim=4, num_slots=6, vocab_size=50,
                             rng=rng) for _ in range(n)]


def jax_dict(program, annotated=False):
    d = program.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            assert annotated or v["dist_attr"] is None
    return d


def arrays(jscope):
    return {n: np.array(v) for n, v in jscope.items() if n != JAX_RNG}


@pytest.fixture(scope="module")
def trained():
    """{lazy: run}: both packages' programs, STEPS Adam steps each from
    the JAX startup's values on one seeded batch, the losses and
    scopes."""
    runs = {}

    def get(lazy):
        if lazy in runs:
            return runs[lazy]
        jmain, jstart, jout = build(jfluid, jwd, lazy)
        tmain, tstart, tout = build(tfluid, twd, lazy)
        jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
        jscope, tscope = jfluid.Scope(), tfluid.Scope()
        jexe.run(jstart, scope=jscope)
        texe.run(tstart, scope=tscope)
        start = arrays(jscope)
        scope_from_arrays(tscope, start)
        jl, tl = [], []
        for f in feeds(1) * STEPS:
            jl.append(float(jexe.run(jmain, feed=f, fetch_list=[jout["loss"]],
                                     scope=jscope)[0]))
            tl.append(float(texe.run(tmain, feed=f, fetch_list=[tout["loss"]],
                                     scope=tscope)[0]))
        runs[lazy] = dict(jmain=jmain, jout=jout, jscope=jscope, jl=jl,
                          tmain=tmain, tout=tout, tscope=tscope, tl=tl,
                          texe=texe, start=start)
        return runs[lazy]
    return get


@pytest.mark.parametrize("lazy", [False, True])
def test_programs_equal_jax(lazy):
    jmain, jstart, jout = build(jfluid, jwd, lazy)
    tmain, tstart, tout = build(tfluid, twd, lazy)
    assert tmain.to_dict() == jax_dict(jmain)
    assert tstart.to_dict() == jax_dict(jstart)
    assert [v.name for v in tout["sparse"]] == [f"C{i}" for i in range(6)]
    adams = [op for op in tmain.global_block().ops if op.type == "adam"]
    assert len(adams) == 20 and all(op.attrs["lazy_mode"] == lazy
                                    for op in adams)
    # the sharded tables' program, annotations included
    jmain, jstart, _ = build(jfluid, jwd, lazy, table_dist_attr=("mp", None))
    tmain, tstart, _ = build(tfluid, twd, lazy, table_dist_attr=("mp", None))
    assert tmain.to_dict() == jax_dict(jmain, annotated=True)
    assert tstart.to_dict() == jax_dict(jstart, annotated=True)
    annotated = {n for n, v in tmain.to_dict()["blocks"][0]["vars"].items()
                 if v["dist_attr"]}
    for i in range(6):
        for t in (f"embedding_{i}.w", f"wide_embedding_{i}.w"):
            assert tuple(tmain.global_block().var(t).dist_attr) == \
                ("mp", None)
            assert any(n.startswith(t + "_moment1") for n in annotated), t


def test_params_from_jax_carries_the_startup_across(trained):
    start = trained(False)["start"]
    got = twd.params_from_jax(start, **CFG)
    shapes = twd.param_shapes(**CFG)
    assert len(got) == len(shapes) == 20
    for name, t in got.items():
        assert tuple(t.shape) == shapes[name] and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), start[name])
    assert not got["wide_embedding_0.w"].any()      # Constant(0.0)
    with pytest.raises(ValueError, match="missing"):
        twd.params_from_jax({n: a for n, a in start.items()
                             if n != "deep_out.w"}, **CFG)
    bad = dict(start, **{"wide_fc.b": np.zeros((2,), np.float32)})
    with pytest.raises(ValueError, match="wide_fc.b"):
        twd.params_from_jax(bad, **CFG)


@pytest.mark.parametrize("lazy", [False, True])
def test_adam_steps_match_jax(trained, lazy):
    run = trained(lazy)
    np.testing.assert_allclose(run["tl"], run["jl"], rtol=1e-5)
    assert run["tl"][-1] < run["tl"][0]
    names = [n for n in run["jscope"].keys() if n != JAX_RNG]
    assert len(names) == 20 * 5 + 1        # param, 2 moments, 2 pows; lr
    for n in names:
        a = np.asarray(run["jscope"].find_var(n), np.float64)
        b = run["tscope"].find_var(n).double().numpy()
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(a).max(), 1e-30), n
    if lazy:     # rows no batch touched: moments exactly zero
        seen = {int(i) for i in feeds(1)[0]["C3"][:, 0]}
        m1 = next(run["tscope"].find_var(n).numpy()
                  for n in run["tscope"].keys()
                  if n.startswith("embedding_3.w_moment1"))
        unseen = sorted(set(range(50)) - seen)
        assert unseen and not m1[unseen].any()
    fetch = [run["tout"]["loss"].name]
    topt = tpasses.optimize_program(run["tmain"], fetch)
    jopt = jpasses.optimize_program(run["jmain"], fetch)
    assert [op.type for op in topt.global_block().ops] == \
        [op.type for op in jopt.global_block().ops]
    per_param = [op.inputs["Param"][0] for op in topt.global_block().ops
                 if op.type == "adam"]
    assert sum("embedding_" in p for p in per_param) == 12


def test_run_steps_is_bitwise_sequential_runs(trained):
    run = trained(False)
    fs = feeds(STEPS)
    scopes = []
    for _ in range(2):
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(
            build(tfluid, twd, False)[1], scope=scope)
        scope_from_arrays(scope, run["start"])
        scopes.append(scope)
    exe = tfluid.Executor(tfluid.CPUPlace())
    loss = run["tout"]["loss"]
    seq = [exe.run(run["tmain"], feed=f, fetch_list=[loss],
                   scope=scopes[0])[0] for f in fs]
    slab = exe.run_steps(run["tmain"], feed=fs, fetch_list=[loss],
                         scope=scopes[1])[0]
    assert np.array_equal(slab, np.stack(seq))
    for n in scopes[0].keys():
        a, b = scopes[0].find_var(n), scopes[1].find_var(n)
        assert (a == b) if not isinstance(a, torch.Tensor) \
            else torch.equal(a, b), n


def test_predict_clone_and_saved_model_match_jax(trained, tmp_path):
    run = trained(False)
    feed = jwd.random_batch(B, dense_dim=4, num_slots=6, vocab_size=50,
                            rng=np.random.default_rng(5))
    jtest = run["jmain"].clone(for_test=True)
    ttest = run["tmain"].clone(for_test=True)
    jp, = jfluid.Executor().run(jtest, feed=feed, scope=run["jscope"],
                                fetch_list=[run["jout"]["predict"]])
    tp, = run["texe"].run(ttest, feed=feed, scope=run["tscope"],
                          fetch_list=[run["tout"]["predict"]])
    assert tp.shape == (B, 1) and ((tp > 0) & (tp < 1)).all()
    assert np.abs(tp - jp).max() <= 1e-5 * np.abs(jp).max()

    d = str(tmp_path)
    names = ["dense_input"] + [f"C{i}" for i in range(6)]
    tfluid.save_inference_model(d, names, [run["tout"]["predict"]],
                                run["texe"], main_program=ttest,
                                scope=run["tscope"])
    cfg = tinf.AnalysisConfig(d)
    cfg.disable_gpu()
    tpred = tinf.create_predictor(cfg)
    jpred = jfluid.inference.create_predictor(
        jfluid.inference.AnalysisConfig(d))
    assert tpred.get_input_names() == jpred.get_input_names() == names
    got, = tpred.run([feed[n] for n in names])
    ref, = jpred.run([feed[n] for n in names])
    assert got.shape == ref.shape == (B, 1)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(got - tp).max() <= 1e-5 * np.abs(tp).max()
