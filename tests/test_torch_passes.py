"""The port's program passes against the JAX package's, on the CPU.

The GPT tiny train program (1 layer, h32, B4 S16) is built on both sides
with plain Adam, with bf16 AMP at a static loss scale of 1.0 (how
``bench_gpt_long`` trains) and with dynamic loss scaling. Held equal:
``optimize_program``'s output ``to_dict()`` and the ``stats()`` rows
(ops before and after each pass, removed, merged and fused counts,
bytes). ``fused_adam`` is held bitwise equal to the per-param ``adam``
ops it replaces, with param-shaped and with scalar beta-pows, and the
fusion's byte cap splits buckets as the JAX pass does. Four Adam steps
run through the default pipeline in both packages (the counterpart of
``test_torch_train.py::test_four_adam_steps_match_jax``, which runs both
unoptimized), at that test's tolerances: losses rtol 1e-4, state atol
1e-4.

The session turns ``FLAGS_verify_passes`` on (tests/conftest.py), for
both packages, so each pipeline here also runs validated."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import passes as jpasses
from paddle_tpu.framework import unique_name as j_unique_name
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.framework.lowering import LowerCtx
from paddle_tpu_torch.framework.registry import get_op_def
from paddle_tpu_torch.models import gpt as tgpt

B, S = 4, 16
JAX_RNG = "@RNG_KEY@"
MODES = ("adam", "amp_static", "amp_dynamic")


def build(fluid, gpt, unique_name, mp, mode, batch=B, seq=S):
    cfg = gpt.GPTConfig.tiny()
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = gpt.gpt_pretrain(cfg, batch, seq)
        opt = fluid.optimizer.AdamOptimizer(1e-3)
        if mode == "amp_static":
            opt = mp.decorate(opt, init_loss_scaling=1.0,
                              use_dynamic_loss_scaling=False)
        elif mode == "amp_dynamic":
            opt = mp.decorate(opt)
        opt.minimize(out["loss"])
    return cfg, main, startup, out["loss"].name


def jax_build(mode, **kw):
    return build(jfluid, jgpt, j_unique_name, jmp, mode, **kw)


def port_build(mode, **kw):
    return build(tfluid, tgpt, tfluid.unique_name, tmp, mode, **kw)


def jax_dict(program):
    d = program.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            assert v["dist_attr"] is None
    return d


def stat_rows(stats):
    return [{k: v for k, v in r.items() if k not in ("ms", "verify_ms")}
            for r in stats["passes"]]


@pytest.mark.parametrize("mode", MODES)
def test_optimize_program_equals_jax(mode):
    _, jmain, _, jloss = jax_build(mode)
    _, tmain, _, tloss = port_build(mode)
    assert tmain.to_dict() == jax_dict(jmain)
    before = tmain.to_dict()
    jopt = jpasses.optimize_program(jmain, [jloss])
    jstats = jpasses.stats()
    topt = tpasses.optimize_program(tmain, [tloss])
    tstats = tpasses.stats()
    assert tmain.to_dict() == before          # the user's program stays
    assert topt is not tmain
    assert topt.to_dict() == jax_dict(jopt)
    assert stat_rows(tstats) == stat_rows(jstats)
    fused = [op for op in topt.global_block().ops
             if op.type == "fused_adam"]
    assert len(fused) == 1 and len(fused[0].input("Param")) == 16


def test_stats_rows_name_each_pass():
    _, tmain, _, tloss = port_build("amp_dynamic")
    tpasses.optimize_program(tmain, [tloss])
    rows = tpasses.stats()["passes"]
    assert [r["pass"] for r in rows] == list(tpasses.DEFAULT_PIPELINE)
    assert [r["detail"] for r in rows] == [
        {"removed_ops": 3}, {"merged_ops": 8},
        {"fused_buckets": 1, "fused_params": 16}]
    assert (rows[0]["ops_before"], rows[-1]["ops_after"]) == (382, 356)


@pytest.mark.parametrize("cap", [4096, 20000])
def test_bucket_cap_splits_as_jax(cap):
    """A byte cap smaller than the params splits the bucket; params
    larger than it stay plain ``adam`` ops, as in the JAX pass."""
    _, jmain, _, jloss = jax_build("adam")
    _, tmain, _, tloss = port_build("adam")
    jp = jmain.clone()
    tp = tmain.clone()
    jpasses.apply_passes(jp, [jpasses.get_pass(
        "fuse_optimizer", fetch_names=(jloss,), max_bucket_bytes=cap)])
    tpasses.apply_passes(tp, [tpasses.get_pass(
        "fuse_optimizer", fetch_names=(tloss,), max_bucket_bytes=cap)])
    assert tp.to_dict() == jax_dict(jp)
    types = [op.type for op in tp.global_block().ops]
    assert types.count("fused_adam") > 1 and "adam" in types


def test_unknown_pass_names_the_registry():
    with pytest.raises(tpasses.UnknownPassError, match="known passes"):
        tpasses.resolve_pipeline("dce,nope")
    with pytest.raises(tpasses.UnknownPassError):
        tpasses.get_pass("nope")
    assert tpasses.resolve_pipeline("fuse_optimizer,dce") == \
        ("dce", "fuse_optimizer")
    assert tpasses.resolve_pipeline("0") == ()
    assert set(tpasses.list_passes()) >= {"amp_bf16", "cse", "dce",
                                          "fuse_optimizer"}


def test_verify_passes_is_not_ported():
    """The flag that raised NotImplementedError while the verifier was
    missing now validates every pass of the pipeline."""
    _, tmain, _, tloss = port_build("adam")
    old = tfluid.get_flags("FLAGS_verify_passes")
    tfluid.set_flags({"FLAGS_verify_passes": True})
    try:
        opt = tpasses.optimize_program(tmain, [tloss])
    finally:
        tfluid.set_flags(old)
    st = tpasses.stats()
    assert st["verify_ms"] > 0
    assert all("verify_ms" in row for row in st["passes"])
    assert "fused_adam" in [op.type for op in opt.global_block().ops]


# -- fused_adam against the per-param adam ops --------------------------

def _adam_bucket(rng, shapes, pow_shape):
    """Inputs of a fused_adam bucket and of the per-param adam ops:
    random params, grads and moments, beta-pows of a few steps."""
    def t(shape, lo=None):
        a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(np.abs(a) if lo else a)
    ins = {"Param": [t(s) for s in shapes], "Grad": [t(s) for s in shapes],
           "Moment1": [t(s) for s in shapes],
           "Moment2": [t(s, lo=True) for s in shapes],
           "LearningRate": [torch.tensor(1e-3)]}
    for slot, beta in (("Beta1Pow", 0.9), ("Beta2Pow", 0.999)):
        ins[slot] = [torch.full(pow_shape(s), beta ** (i + 2),
                                dtype=torch.float32)
                     for i, s in enumerate(shapes)]
    return ins


@pytest.mark.parametrize("pow_mode", ["dense", "scalar"])
def test_fused_adam_is_bitwise_the_per_param_adam(pow_mode):
    rng = np.random.default_rng(7)
    shapes = [(128, 32), (32,), (3, 5, 7), (1,)]
    pow_shape = (lambda s: s) if pow_mode == "dense" else (lambda s: ())
    ins = _adam_bucket(rng, shapes, pow_shape)
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "lazy_mode": False}
    ctx = LowerCtx(None, None, {}, "cpu")
    fused = get_op_def("fused_adam").lower(ctx, ins, attrs)
    adam = get_op_def("adam").lower
    for i in range(len(shapes)):
        one = adam(ctx, {k: [v[i]] if len(v) > 1 else v
                         for k, v in ins.items()}, attrs)
        for slot, val in one.items():
            assert torch.equal(fused[slot][i], val), (pow_mode, i, slot)
    # inputs are never written in place
    again = _adam_bucket(np.random.default_rng(7), shapes, pow_shape)
    assert all(torch.equal(a, b) for k in ins
               for a, b in zip(ins[k], again[k]))


def test_pipeline_on_and_off_give_the_same_bits():
    """One step of the GPT tiny program with ``FLAGS_program_passes``
    "0" and "1" from copies of one scope: every persistable bitwise
    equal (fused_adam is the per-param update, dce and cse drop only
    dead or duplicate work)."""
    cfg, tmain, tstart, tloss = port_build("adam")
    exe = tfluid.Executor(tfluid.CPUPlace())
    s1, s2 = tfluid.Scope(), tfluid.Scope()
    exe.run(tstart, scope=s1)
    for n, v in s1.items():
        s2.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    feed = tgpt.random_batch(cfg, B, S, rng=np.random.default_rng(0))
    old = tfluid.get_flags("FLAGS_program_passes")
    try:
        tfluid.set_flags({"FLAGS_program_passes": "0"})
        l0 = exe.run(tmain, feed=feed, fetch_list=[tloss], scope=s1)
        tfluid.set_flags({"FLAGS_program_passes": "1"})
        l1 = exe.run(tmain, feed=feed, fetch_list=[tloss], scope=s2)
    finally:
        tfluid.set_flags(old)
    assert np.array_equal(l0[0], l1[0])
    names = [n for n, v in s1.items() if isinstance(v, torch.Tensor)]
    assert len(names) > 60
    for n in names:
        assert torch.equal(s1.find_var(n), s2.find_var(n)), n


def test_executor_memo_follows_program_version():
    cfg, tmain, tstart, tloss = port_build("adam")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(tstart, scope=scope)
    feed = tgpt.random_batch(cfg, B, S, rng=np.random.default_rng(0))
    exe.run(tmain, feed=feed, fetch_list=[tloss], scope=scope)
    exe.run(tmain, feed=feed, fetch_list=[tloss], scope=scope)
    keys = [k for k in exe._opt_cache if k[0] == tmain._uid]
    assert len(keys) == 1
    assert "fused_adam" not in {op.type for op in tmain.global_block().ops}
    tmain.global_block().ops[0].set_attr("note", 1)   # a new version
    exe.run(tmain, feed=feed, fetch_list=[tloss], scope=scope)
    assert len([k for k in exe._opt_cache if k[0] == tmain._uid]) == 2


def _carried_scopes(jprog, tprog):
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jfluid.Executor().run(jprog, scope=jscope)
    tfluid.Executor(tfluid.CPUPlace()).run(tprog, scope=tscope)
    scope_from_arrays(tscope, {n: np.asarray(v) for n, v in jscope.items()
                               if n != JAX_RNG})
    return jscope, tscope


def test_four_adam_steps_through_the_pipeline_match_jax():
    cfg, jmain, jstart, loss = jax_build("adam")
    _, tmain, tstart, tloss = port_build("adam")
    assert loss == tloss
    assert jfluid.get_flags("FLAGS_program_passes")[
        "FLAGS_program_passes"] == "1"
    assert tfluid.get_flags("FLAGS_program_passes")[
        "FLAGS_program_passes"] == "1"
    jscope, tscope = _carried_scopes(jstart, tstart)
    feed = jgpt.random_batch(cfg, B, S, rng=np.random.default_rng(0))
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    losses = []
    for step in range(4):
        jl, = jexe.run(jmain, feed=feed, fetch_list=[loss], scope=jscope)
        tl, = texe.run(tmain, feed=feed, fetch_list=[loss], scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"step {step}")
        losses.append(float(np.ravel(tl)[0]))
    assert abs(losses[0] - np.log(cfg.vocab_size)) < 1.0
    assert losses[-1] < losses[0]
    for n in (n for n in jscope.keys() if n != JAX_RNG):
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, err_msg=n)
