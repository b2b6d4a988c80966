"""The SGD / Momentum / AdamW family and the LR schedulers of the port
against the JAX package, on the CPU.

- ``sgd``, ``momentum`` (plain and Nesterov) and ``adamw`` lowerings on
  the same seeded inputs as the JAX ops (JAX's
  ``tests/test_ops_optimizer.py:15-41``), float32 within 1e-6.
- ``fused_sgd``, ``fused_momentum`` (plain and Nesterov) and
  ``fused_adamw`` bitwise equal to their per-param ops (the fused AdamW
  is held to the port's unfused ``adamw``: the JAX package's own fused
  AdamW fails its parity test), and, through the pass pipeline, one
  step of a small program with passes "0" and "1" from copies of one
  scope leaves every state tensor bitwise equal, the pipeline having
  fused the updates; the optimize programs equal the JAX package's.
- The verifier's ``persistable-write-dropped`` check catches a pass
  that drops an ``sgd`` op, in both packages (JAX's
  ``test_mutant_drops_optimizer_update``).
- Every LR schedule read back over 12 steps against the JAX program's
  values (rtol 1e-6), ``polynomial_decay`` with ``cycle`` on and off.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jfluid
from paddle_tpu.framework import lowering as jlowering
from paddle_tpu.framework import passes as jpasses
from paddle_tpu.framework import registry as jregistry

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.framework.analysis import ProgramVerifyError
from paddle_tpu_torch.framework.lowering import LowerCtx
from paddle_tpu_torch.framework.registry import get_op_def

JAX_RNG = "@RNG_KEY@"


def _jax_lower(op_type, ins, attrs):
    ctx = jlowering.LowerCtx(None, None, {}, jax.random.PRNGKey(0))
    out = jregistry.get_op_def(op_type).lower(
        ctx, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, attrs)
    return {k: np.asarray(v[0] if isinstance(v, list) else v)
            for k, v in out.items()}


def _port_lower(op_type, ins, attrs):
    out = get_op_def(op_type).lower(
        LowerCtx(None, None, {}, "cpu"),
        {k: [torch.from_numpy(np.array(a)) for a in v]
         for k, v in ins.items()}, attrs)
    return {k: (v[0] if isinstance(v, list) else v).numpy()
            for k, v in out.items()}


def _state(rng, shape, op_type):
    f = lambda: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    ins = {"Param": [f()], "Grad": [f()],
           "LearningRate": [np.array([0.01], np.float32)]}
    if op_type == "momentum":
        ins["Velocity"] = [f()]
    if op_type in ("adam", "adamw"):
        ins["Moment1"] = [f()]
        ins["Moment2"] = [np.abs(f())]
        ins["Beta1Pow"] = [np.array([0.9 ** 3], np.float32)]
        ins["Beta2Pow"] = [np.array([0.999 ** 3], np.float32)]
    return ins


OP_CASES = {
    "sgd": ("sgd", {}),
    "momentum": ("momentum", {"mu": 0.9, "use_nesterov": False}),
    "momentum_nesterov": ("momentum", {"mu": 0.9, "use_nesterov": True}),
    "adamw": ("adamw", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                        "coeff": 0.01}),
    "adamw_no_decay": ("adamw", {"beta1": 0.9, "beta2": 0.999,
                                 "epsilon": 1e-8, "coeff": 0.01,
                                 "with_decay": False}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_update_op_matches_jax(case):
    op_type, attrs = OP_CASES[case]
    ins = _state(np.random.default_rng(5), (4, 3), op_type)
    want = _jax_lower(op_type, ins, attrs)
    got = _port_lower(op_type, ins, attrs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=f"{case} {k}")
    if op_type == "sgd":
        p, g = ins["Param"][0], ins["Grad"][0]
        np.testing.assert_allclose(got["ParamOut"], p - 0.01 * g, rtol=1e-6)


SHAPES = [(128, 32), (32,), (3, 5, 7), (1,)]


def _bucket(op_type, pow_shape=None, seed=7):
    rng = np.random.default_rng(seed)
    per = [_state(rng, s, op_type) for s in SHAPES]
    ins = {k: [torch.from_numpy(p[k][0]) for p in per]
           for k in per[0] if k != "LearningRate"}
    ins["LearningRate"] = [torch.tensor(1e-2)]
    if pow_shape is not None:
        for k in ("Beta1Pow", "Beta2Pow"):
            ins[k] = [torch.full(pow_shape(s), float(b[0]))
                      for s, b in zip(SHAPES, ins[k])]
    return ins


FUSED_CASES = {
    "sgd": ("sgd", {}, None),
    "momentum": ("momentum", {"mu": 0.9, "use_nesterov": False}, None),
    "momentum_nesterov": ("momentum", {"mu": 0.9, "use_nesterov": True},
                          None),
    "adamw_dense_pows": ("adamw", OP_CASES["adamw"][1], lambda s: s),
    "adamw_scalar_pows": ("adamw", OP_CASES["adamw"][1], lambda s: ()),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_op_is_bitwise_the_per_param_op(case):
    op_type, attrs, pow_shape = FUSED_CASES[case]
    ins = _bucket(op_type, pow_shape)
    ctx = LowerCtx(None, None, {}, "cpu")
    fused = get_op_def("fused_" + op_type).lower(ctx, ins, attrs)
    per = get_op_def(op_type).lower
    for i in range(len(SHAPES)):
        one = per(ctx, {k: [v[i]] if len(v) > 1 else v
                        for k, v in ins.items()}, attrs)
        assert set(one) == set(fused)
        for slot, val in one.items():
            assert torch.equal(fused[slot][i], val), (case, i, slot)
    again = _bucket(op_type, pow_shape)        # no input written in place
    assert all(torch.equal(a, b) for k in ins for a, b in
               zip(ins[k], again[k]))


def _fc_program(fluid, opt_name, lr=None):
    """fc -> relu -> fc -> mean loss with ``opt_name``; ``lr`` a float or
    a scheduler built in the program."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [-1, 8], "float32")
        h = L.fc(x, 16, act="relu")
        loss = L.mean(L.fc(h, 4))
        rate = 0.05 if lr is None else lr()
        opt = {"sgd": lambda: fluid.optimizer.SGD(rate),
               "momentum": lambda: fluid.optimizer.Momentum(rate, 0.9),
               "nesterov": lambda: fluid.optimizer.Momentum(
                   rate, 0.9, use_nesterov=True),
               "adamw": lambda: fluid.optimizer.AdamW(
                   rate, weight_decay=0.02)}[opt_name]()
        opt.minimize(loss)
    return main, startup, loss


def _jax_dict(program):
    d = program.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            assert v.pop("dist_attr") is None
    return d


@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov", "adamw"])
def test_pipeline_fuses_updates_bitwise(opt):
    tmain, tstart, tloss = _fc_program(tfluid, opt)
    jmain, jstart, jloss = _fc_program(jfluid, opt)
    assert tmain.to_dict() == _jax_dict(jmain)
    topt = tpasses.optimize_program(tmain, fetch_names=[tloss.name])
    jopt = jpasses.optimize_program(jmain, fetch_names=[jloss.name])
    assert topt.to_dict() == _jax_dict(jopt)
    op_type = {"nesterov": "momentum"}.get(opt, opt)
    types = [op.type for op in topt.global_block().ops]
    assert types.count("fused_" + op_type) == 1 and op_type not in types

    exe = tfluid.Executor(tfluid.CPUPlace())
    s0, s1 = tfluid.Scope(), tfluid.Scope()
    exe.run(tstart, scope=s0)
    for n, v in s0.items():
        s1.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    feed = {"x": np.random.default_rng(1).standard_normal(
        (6, 8)).astype(np.float32)}
    old = tfluid.get_flags("FLAGS_program_passes")
    try:
        for scope, flag in ((s0, "0"), (s1, "1")):
            tfluid.set_flags({"FLAGS_program_passes": flag})
            for _ in range(2):
                exe.run(tmain, feed=feed, fetch_list=[tloss], scope=scope)
    finally:
        tfluid.set_flags(old)
    names = [n for n, v in s0.items() if isinstance(v, torch.Tensor)]
    assert len(names) >= 5
    for n in names:
        assert torch.equal(s0.find_var(n), s1.find_var(n)), (opt, n)


def test_verifier_catches_a_dropped_sgd_update():
    def run(fluid, passes, error):
        class BadFuse(passes.Pass):
            def apply(self, program):
                blk = program.global_block()
                del blk.ops[next(i for i, op in enumerate(blk.ops)
                                 if op.type == "sgd")]
        passes.register_pass("_mut_drop_sgd")(BadFuse)
        main, _, loss = _fc_program(fluid, "sgd")
        old = fluid.get_flags("FLAGS_verify_passes")
        fluid.set_flags({"FLAGS_verify_passes": True})
        try:
            with pytest.raises(error) as ei:
                passes.optimize_program(main, fetch_names=[loss.name],
                                        spec="_mut_drop_sgd")
        finally:
            fluid.set_flags(old)
            passes._PASSES.pop("_mut_drop_sgd", None)
        return ei.value
    from paddle_tpu.framework.analysis import \
        ProgramVerifyError as JProgramVerifyError
    jerr = run(jfluid, jpasses, JProgramVerifyError)
    terr = run(tfluid, tpasses, ProgramVerifyError)
    assert terr.code == jerr.code == "persistable-write-dropped"
    assert terr.pass_name == "_mut_drop_sgd"
    assert terr.var == jerr.var


# ------------------------------------------------------------- schedulers

SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 2, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 4, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 2, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 5, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(
        0.1, 5, 0.01, power=1.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 7], [1.0, 0.5, 0.1]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 5),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 4, 0.0, 0.1),
    "warmup_then_cosine": lambda L: L.linear_lr_warmup(
        L.cosine_decay(0.1, 3, 4), 5, 0.01, 0.1),
    "noam": lambda L: L.noam_decay(64, 4),
}


def _schedule_values(fluid, place, build, steps=12):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        lr = build(fluid.layers)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    vals = [float(np.ravel(exe.run(main, fetch_list=[lr], scope=scope)[0])
                  [0]) for _ in range(steps)]
    return vals, main


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    want, jmain = _schedule_values(jfluid, None, SCHEDULES[name])
    got, tmain = _schedule_values(tfluid, tfluid.CPUPlace(),
                                  SCHEDULES[name])
    assert tmain.to_dict() == _jax_dict(jmain)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert len(set(got)) > 1                    # it moves
    assert not tmain.clone(for_test=True).global_block().ops


def test_scheduler_drives_momentum():
    """A cosine schedule as the Momentum optimizer's LR: two steps equal
    the JAX package's (params from the same startup values)."""
    from paddle_tpu_torch.framework.executor import scope_from_arrays
    sched = lambda: tfluid.layers.cosine_decay(0.1, 1, 4)   # noqa: E731
    jsched = lambda: jfluid.layers.cosine_decay(0.1, 1, 4)  # noqa: E731
    tmain, tstart, tloss = _fc_program(tfluid, "momentum", sched)
    jmain, jstart, jloss = _fc_program(jfluid, "momentum", jsched)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    scope_from_arrays(tscope, {n: np.asarray(v) for n, v in jscope.items()
                               if n != JAX_RNG})
    feed = {"x": np.random.default_rng(2).standard_normal(
        (6, 8)).astype(np.float32)}
    for _ in range(3):
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        tl, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in jscope.keys():
        if n != JAX_RNG:
            np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                       np.asarray(jscope.find_var(n)),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
