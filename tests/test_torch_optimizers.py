"""The optimizers and the LR schedulers of the port against the JAX
package, on the CPU.

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
- The ten other update ops (``lars_momentum``, ``lamb`` with scalar and
  param-shaped beta-pows, ``adagrad``, ``decayed_adagrad``,
  ``adadelta``, ``adamax``, ``rmsprop`` plain and centered, ``ftrl``,
  ``dpsgd`` at sigma 0, ``dgc_sparsify`` before and after its ramp-up)
  against the JAX ops, one call within 1e-6 of max |ref|; JAX's
  ``test_ops_optimizer.py`` and ``test_op_matrix3.py::test_lamb_matrix``
  reference math; every new class (and DGC) over 3 steps of a 2-fc net
  from the JAX startup's state, program op for op, losses and scope
  within 1e-5 / 1e-6, accumulators marked ``is_optimizer_state``;
  ``dpsgd``'s noise by its distribution and its seeds; JAX
  ``test_extras.py``'s EMA, ModelAverage, Lookahead and DGC cases;
  ``fuse_optimizer`` leaving the new updates per parameter;
  ``PipelineOptimizer`` over a ``layers.Pipeline`` program; and every
  class driving a quadratic down (``test_optimizer_classes_converge``).
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
            assert v["dist_attr"] is None
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


# --------------------------------------------- the rest of the optimizers

def _new_state(rng, shape, op_type, pow_shape=(1,)):
    """Seeded inputs of one of the ten update ops the JAX package has
    beside the four above; ``pow_shape`` is the beta-pows' (LAMB's
    optimizer makes them param-shaped)."""
    f = lambda: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    pos = lambda: np.abs(f()) + 0.1                             # noqa: E731
    if op_type == "dgc_sparsify":
        return {"U": [f()], "Grad": [f()]}
    ins = {"Param": [f()], "Grad": [f()],
           "LearningRate": [np.array([0.02], np.float32)]}
    if op_type == "lars_momentum":
        ins["Velocity"] = [f()]
    if op_type == "lamb":
        ins.update(Moment1=[f()], Moment2=[pos()],
                   Beta1Pow=[np.full(pow_shape, 0.9 ** 3, np.float32)],
                   Beta2Pow=[np.full(pow_shape, 0.999 ** 3, np.float32)])
    if op_type in ("adagrad", "decayed_adagrad"):
        ins["Moment"] = [pos()]
    if op_type == "adadelta":
        del ins["LearningRate"]
        ins.update(AvgSquaredGrad=[pos()], AvgSquaredUpdate=[pos()])
    if op_type == "adamax":
        ins.update(Moment=[f()], InfNorm=[pos()],
                   Beta1Pow=[np.array([0.9 ** 3], np.float32)])
    if op_type == "rmsprop":
        ins.update(MeanSquare=[pos() + 1.0], MeanGrad=[f() * 0.1],
                   Moment=[f()])
    if op_type == "ftrl":
        ins.update(SquaredAccumulator=[pos()], LinearAccumulator=[f()])
    return ins


NEW_OP_CASES = {
    "lars_momentum": ("lars_momentum", {"mu": 0.9, "lars_coeff": 0.001,
                                        "lars_weight_decay": 5e-4}, None),
    "lamb": ("lamb", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                      "weight_decay": 0.01}, None),
    "lamb_param_shaped_pows": ("lamb", {"weight_decay": 0.01}, "param"),
    "adagrad": ("adagrad", {"epsilon": 1e-6}, None),
    "decayed_adagrad": ("decayed_adagrad", {"epsilon": 1e-6,
                                            "decay": 0.9}, None),
    "adadelta": ("adadelta", {"epsilon": 1e-6, "rho": 0.95}, None),
    "adamax": ("adamax", {"beta1": 0.9, "beta2": 0.999,
                          "epsilon": 1e-8}, None),
    "rmsprop": ("rmsprop", {"decay": 0.95, "epsilon": 1e-6,
                            "momentum": 0.9, "centered": False}, None),
    "rmsprop_centered": ("rmsprop", {"decay": 0.9, "epsilon": 1e-6,
                                     "momentum": 0.5, "centered": True},
                         None),
    "ftrl": ("ftrl", {"l1": 0.1, "l2": 0.05, "lr_power": -0.5}, None),
    "dpsgd_sigma0": ("dpsgd", {"clip": 0.5, "sigma": 0.0,
                               "__rng_seed__": 3}, None),
    "dgc_dense_before_rampup": ("dgc_sparsify", {
        "sparsity": 0.75, "momentum": 0.9, "rampup_begin_step": 3}, 2.0),
    "dgc_sparse_after_rampup": ("dgc_sparsify", {
        "sparsity": 0.75, "momentum": 0.9, "rampup_begin_step": 3}, 4.0),
}


@pytest.mark.parametrize("case", sorted(NEW_OP_CASES))
def test_new_update_op_matches_jax(case):
    """One call of each op on the same seeded inputs as the JAX op:
    every output within 1e-6 of its max |ref| (dpsgd at sigma 0 is the
    clipped SGD step)."""
    op_type, attrs, extra = NEW_OP_CASES[case]
    shape = (4, 6)
    ins = _new_state(np.random.default_rng(11), shape, op_type,
                     shape if extra == "param" else (1,))
    if op_type == "dgc_sparsify":
        ins["Step"] = [np.array([extra], np.float32)]
    want = _jax_lower(op_type, ins, attrs)
    got = _port_lower(op_type, ins, attrs)
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= 1e-6, f"{case} {k}: {err}"
    if op_type == "dgc_sparsify":
        u_new = 0.9 * ins["U"][0] + ins["Grad"][0]
        if extra <= 3:      # dense warm-up: everything goes, U is velocity
            assert np.array_equal(got["Out"], got["UOut"])
        else:               # the top quarter of |U| goes, the rest stays
            sent = got["Out"] != 0
            assert sent.sum() == u_new.size // 4
            assert np.abs(u_new[sent]).min() >= np.abs(u_new[~sent]).max()
            np.testing.assert_allclose(got["Out"] + got["UOut"], u_new,
                                       rtol=1e-6)


def _ref(case):
    """The numpy reference math of JAX's ``test_ops_optimizer.py``
    (``test_adagrad``, ``test_rmsprop``, ``test_lamb``) and
    ``test_op_matrix3.py::test_lamb_matrix``: (inputs, attrs, outputs,
    rtol, atol)."""
    r = np.random.default_rng(5)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    if case == "adagrad":
        p, g, mom = f(4), f(4), np.abs(f(4))
        mom_new = mom + g * g
        return ({"Param": [p], "Grad": [g], "Moment": [mom],
                 "LearningRate": [np.array([0.1], np.float32)]},
                {"epsilon": 1e-6},
                {"ParamOut": p - 0.1 * g / (np.sqrt(mom_new) + 1e-6),
                 "MomentOut": mom_new}, 1e-4, 0)
    if case == "rmsprop":
        p, g, ms, mom = f(4), f(4), np.abs(f(4)), f(4) * 0.1
        ms_new = 0.95 * ms + 0.05 * g * g
        mom_new = 0.9 * mom + 0.01 * g / np.sqrt(ms_new + 1e-6)
        return ({"Param": [p], "Grad": [g], "MeanSquare": [ms],
                 "MeanGrad": [np.zeros(4, np.float32)], "Moment": [mom],
                 "LearningRate": [np.array([0.01], np.float32)]},
                {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
                 "centered": False},
                {"ParamOut": p - mom_new, "MeanSquareOut": ms_new,
                 "MomentOut": mom_new}, 1e-4, 0)
    if case == "lamb":
        p, g = np.abs(f(6)) + 0.5, f(6)
        m1, m2 = np.zeros(6, np.float32), np.zeros(6, np.float32)
    else:
        p, g = f(3, 4), f(3, 4) * 0.1
        m1 = np.zeros((3, 4), np.float32) + 0.01
        m2 = np.zeros((3, 4), np.float32) + 0.02
    lr = 0.01 if case == "lamb" else 0.05
    b1p, b2p = np.array([0.9], np.float32), np.array([0.999], np.float32)
    m1n = 0.9 * m1 + 0.1 * g
    m2n = 0.999 * m2 + 0.001 * g * g
    rr = (m1n / (1 - b1p)) / (np.sqrt(m2n / (1 - b2p)) + 1e-6) + 0.01 * p
    trust = np.linalg.norm(p) / np.linalg.norm(rr)
    outs = {"ParamOut": p - lr * trust * rr}
    if case == "lamb_matrix":
        outs.update(Moment1Out=m1n, Moment2Out=m2n, Beta1PowOut=b1p * 0.9,
                    Beta2PowOut=b2p * 0.999)
    return ({"Param": [p], "Grad": [g], "Moment1": [m1], "Moment2": [m2],
             "Beta1Pow": [b1p], "Beta2Pow": [b2p],
             "LearningRate": [np.array([lr], np.float32)]},
            {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
             "weight_decay": 0.01}, outs,
            1e-3 if case == "lamb" else 1e-4, 1e-6 if case == "lamb"
            else 1e-5)


@pytest.mark.parametrize("case", ["adagrad", "rmsprop", "lamb",
                                  "lamb_matrix"])
def test_ops_match_the_jax_tests_reference_math(case):
    ins, attrs, outs, rtol, atol = _ref(case)
    op_type = "lamb" if case.startswith("lamb") else case
    got = _port_lower(op_type, ins, attrs)
    for k, v in outs.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=f"{case} {k}")


CLASS_CASES = {
    "LarsMomentum": lambda f: f.optimizer.LarsMomentum(0.1, 0.9),
    "Lamb": lambda f: f.optimizer.Lamb(0.01, lamb_weight_decay=0.05),
    "Adagrad": lambda f: f.optimizer.Adagrad(
        0.1, initial_accumulator_value=0.1),
    "DecayedAdagrad": lambda f: f.optimizer.DecayedAdagrad(0.1),
    "Adadelta": lambda f: f.optimizer.Adadelta(0.5),
    "Adamax": lambda f: f.optimizer.Adamax(0.01),
    "RMSProp": lambda f: f.optimizer.RMSProp(0.01, momentum=0.5,
                                             centered=True),
    "Ftrl": lambda f: f.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "Dpsgd_sigma0": lambda f: f.optimizer.Dpsgd(0.1, clip=0.5, sigma=0.0),
    "DGCMomentum": lambda f: f.optimizer.DGCMomentumOptimizer(
        0.1, 0.9, rampup_begin_step=1, sparsity=[0.5]),
}


def _fc_net(opt_fn):
    def fn(fluid):
        x = fluid.data("x", [-1, 6], "float32")
        y = fluid.data("y", [-1, 1], "int64")
        logits = fluid.layers.fc(fluid.layers.fc(x, 8, act="relu"), 3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        opt_fn(fluid).minimize(loss)
        return [loss]
    return fn


@pytest.mark.parametrize("name", sorted(CLASS_CASES))
def test_optimizer_class_three_steps_match_jax(name):
    """Each class over a 2-fc net from the JAX startup's state: the
    program equals JAX's, and 3 steps give JAX's losses and scope within
    1e-5 (rel) / 1e-6 (abs)."""
    from torch_pair import assert_pair, assert_scopes_close, run_pair
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((8, 6)).astype("float32"),
            "y": rng.integers(0, 3, (8, 1)).astype("int64")}
    out, scopes, mains = run_pair(_fc_net(CLASS_CASES[name]), feed, steps=3)
    assert mains["port"].to_dict() == _jax_dict(mains["jax"])
    assert_pair(out, what=name)
    assert_scopes_close(scopes, rtol=1e-5, atol=1e-6)
    gb = mains["port"].global_block()
    accs = [v for v in gb.vars.values()
            if getattr(v, "is_optimizer_state", False)]
    assert all(v.persistable for v in accs)
    if name == "Lamb":      # param-shaped beta-pows, as the JAX layout
        assert all(v.shape == gb.var(v.name.split("_beta")[0]).shape
                   for v in accs if "_beta" in v.name)


def test_dpsgd_noise_follows_its_distribution():
    """``dpsgd`` at sigma 1.5, clip 0.2 on a zero grad: the step is
    lr x noise, N(0, (sigma clip)^2) by its mean, deviation and tails;
    one seed draws the same noise twice, another draws other noise."""
    from paddle_tpu_torch.framework.lowering import LowerCtx
    n = 1 << 16
    p = np.zeros(n, np.float32)
    ins = {"Param": [p], "Grad": [np.zeros(n, np.float32)],
           "LearningRate": [np.array([0.5], np.float32)]}

    def draw(seed, rng_seed=3):
        out = get_op_def("dpsgd").lower(
            LowerCtx(None, None, {}, "cpu", run_seed=seed),
            {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()},
            {"clip": 0.2, "sigma": 1.5, "__rng_seed__": rng_seed})
        return -out["ParamOut"].numpy() / 0.5
    noise = draw(7)
    sd = 1.5 * 0.2
    assert abs(noise.mean()) < 4 * sd / np.sqrt(n)
    assert abs(noise.std() / sd - 1) < 0.02
    assert abs((np.abs(noise) > 2 * sd).mean() - 0.0455) < 0.005
    assert np.array_equal(draw(7), noise)
    assert not np.array_equal(draw(8), noise)
    assert not np.array_equal(draw(7, rng_seed=4), noise)


def _linear_program(fluid, opt=None, name=None, extra=None):
    """JAX ``test_extras.py``'s ``_linear_program``: fc(4 -> 1, no bias)
    under a squared error, SGD(0.1) unless ``opt``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8, 4], dtype="float32")
        y = fluid.layers.data("y", [8, 1], dtype="float32")
        attr = fluid.ParamAttr(name=name) if name else None
        pred = fluid.layers.fc(x, 1, bias_attr=False, param_attr=attr)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        (opt or fluid.optimizer.SGD(0.1)).minimize(loss)
        wrapped = extra(fluid) if extra else None
    return main, startup, loss, wrapped


def _extras_data():
    rng = np.random.default_rng(0)
    xv = rng.standard_normal((8, 4)).astype(np.float32)
    return xv, (xv @ np.array([[0.5], [-0.3], [0.2], [0.1]],
                              np.float32)).astype(np.float32)


def test_ema_apply_restore():
    """JAX's test_ema_apply_restore in the port: the bias-corrected EMA
    of the post-update weights swapped in and restored."""
    def ema(fluid):
        e = fluid.optimizer.ExponentialMovingAverage(0.5)
        e.update()
        return e
    main, startup, loss, e = _linear_program(tfluid, name="ema_w",
                                             extra=ema)
    xv, yv = _extras_data()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        history = []
        for _ in range(5):
            exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])
            history.append(scope.find_var("ema_w").numpy().copy())
        raw = scope.find_var("ema_w").numpy().copy()
        want = np.zeros_like(history[0])
        for h in history:
            want = 0.5 * want + 0.5 * h
        want = want / (1.0 - 0.5 ** len(history))
        with e.apply():
            applied = scope.find_var("ema_w").numpy().copy()
        restored = scope.find_var("ema_w").numpy().copy()
    np.testing.assert_allclose(applied, want, rtol=1e-5)
    np.testing.assert_array_equal(restored, raw)


def test_model_average_apply():
    main, startup, loss, ma = _linear_program(
        tfluid, name="ma_w",
        extra=lambda f: f.optimizer.ModelAverage(0.15))
    xv, yv = _extras_data()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        vals = []
        for _ in range(4):
            exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])
            vals.append(scope.find_var("ma_w").numpy().copy())
        with ma.apply():
            applied = scope.find_var("ma_w").numpy().copy()
        np.testing.assert_array_equal(scope.find_var("ma_w").numpy(),
                                      vals[-1])
    np.testing.assert_allclose(applied, np.mean(vals, axis=0), rtol=1e-5)


def test_lookahead_syncs_every_k():
    """k=1, alpha=0.5: one step leaves 0.5 w0 + 0.5 sgd_step(w0) (the
    slow weights start at the fast ones); k=3 still converges."""
    xv, yv = _extras_data()
    exe = tfluid.Executor(tfluid.CPUPlace())
    main_s, startup_s, loss_s, _ = _linear_program(tfluid)
    scope_s = tfluid.Scope()
    with tfluid.scope_guard(scope_s):
        exe.run(startup_s)
        wname = next(p.name for p in main_s.all_parameters())
        w0 = scope_s.find_var(wname).numpy().copy()
        exe.run(main_s, feed={"x": xv, "y": yv}, fetch_list=[loss_s])
        w1 = scope_s.find_var(wname).numpy().copy()
    opt = tfluid.optimizer.LookaheadOptimizer(tfluid.optimizer.SGD(0.1),
                                              alpha=0.5, k=1)
    main, startup, loss, _ = _linear_program(tfluid, opt=opt)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        wname2 = next(p.name for p in main.all_parameters()
                      if not p.name.startswith("lookahead"))
        np.testing.assert_allclose(scope.find_var(wname2).numpy(), w0,
                                   rtol=1e-6)
        exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])
        got = scope.find_var(wname2).numpy()
    np.testing.assert_allclose(got, 0.5 * w0 + 0.5 * w1, rtol=1e-5)
    opt3 = tfluid.optimizer.LookaheadOptimizer(tfluid.optimizer.SGD(0.1),
                                               alpha=0.5, k=3)
    main3, startup3, loss3, _ = _linear_program(tfluid, opt=opt3)
    scope3 = tfluid.Scope()
    with tfluid.scope_guard(scope3):
        exe.run(startup3)
        losses = [float(exe.run(main3, feed={"x": xv, "y": yv},
                                fetch_list=[loss3])[0])
                  for _ in range(9)]
    assert losses[-1] < losses[0], losses


def test_dgc_momentum_trains():
    opt = tfluid.optimizer.DGCMomentumOptimizer(
        learning_rate=0.05, momentum=0.9, sparsity=[0.7])
    main, startup, loss, _ = _linear_program(tfluid, opt=opt)
    xv, yv = _extras_data()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed={"x": xv, "y": yv},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(25)]
    assert losses[-1] < 0.5 * losses[0], losses[::6]


def test_pipeline_optimizer_raises_naming_its_item():
    """``PipelineOptimizer`` no longer raises: over a ``layers.Pipeline``
    of two fc-tanh stages (4 microbatches) it trains 3 Momentum steps op
    for op as the JAX package's does, from the JAX startup's state."""
    def build(fluid):
        layers = fluid.layers
        x = layers.data("x", [8, 4], dtype="float32")
        y = layers.data("y", [8, 1], dtype="float32")
        pipe = layers.Pipeline(num_stages=2, num_microbatches=4)
        with pipe.stage():
            h = pipe.stage_input(x)
            pipe.stage_output(layers.fc(h, 4, act="tanh"))
        pred = layers.fc(pipe(), 1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.Momentum(0.1, 0.9),
            num_microbatches=4).minimize(loss)
        return [loss]
    from torch_pair import rel_err, run_pair
    xv, yv = _extras_data()
    out, scopes, mains = run_pair(build, {"x": xv, "y": yv}, steps=3)
    np.testing.assert_allclose(np.ravel(out["port"]), np.ravel(out["jax"]),
                               rtol=1e-5, atol=1e-6)
    assert [op.type for op in mains["port"].global_block().ops] == \
        [op.type for op in mains["jax"].global_block().ops]
    for p in mains["jax"].all_parameters():
        assert rel_err(scopes["port"].find_var(p.name).numpy(),
                       np.array(scopes["jax"].find_var(p.name))) <= 1e-5


@pytest.mark.parametrize("name", ["Lamb", "LarsMomentum", "Adagrad",
                                  "RMSProp", "DGCMomentum"])
def test_fuse_optimizer_leaves_new_updates_per_param(name):
    """The pass pipeline fuses sgd/momentum/adam/adamw only (the JAX
    table): every other update op stays one per parameter, and the
    optimized program equals the JAX package's. DGC's updates are
    ``sgd`` ops and fuse, as in the JAX package."""
    progs = {}
    for key, fluid, passes in (("jax", jfluid, jpasses),
                               ("port", tfluid, tpasses)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = _fc_net(CLASS_CASES[name])(fluid)
        progs[key] = passes.optimize_program(main,
                                             fetch_names=[fetch[0].name])
    assert progs["port"].to_dict() == _jax_dict(progs["jax"])
    types = [op.type for op in progs["port"].global_block().ops]
    op_type = {"Lamb": "lamb", "LarsMomentum": "lars_momentum",
               "Adagrad": "adagrad", "RMSProp": "rmsprop",
               "DGCMomentum": "sgd"}[name]
    if op_type == "sgd":
        assert types.count("fused_sgd") == 1
        assert types.count("dgc_sparsify") == 4
    else:
        assert types.count(op_type) == 4
        assert not [t for t in types if t.startswith("fused_")]


CONVERGE = {
    "SGDOptimizer": lambda O: O.SGDOptimizer(0.1),
    "MomentumOptimizer": lambda O: O.MomentumOptimizer(0.05, momentum=0.9),
    "AdamOptimizer": lambda O: O.AdamOptimizer(0.1),
    "AdamWOptimizer": lambda O: O.AdamWOptimizer(0.1),
    "AdagradOptimizer": lambda O: O.AdagradOptimizer(0.3),
    "AdadeltaOptimizer": lambda O: O.AdadeltaOptimizer(1.0),
    "AdamaxOptimizer": lambda O: O.AdamaxOptimizer(0.1),
    "RMSPropOptimizer": lambda O: O.RMSPropOptimizer(0.05),
    "LambOptimizer": lambda O: O.LambOptimizer(0.1),
    "LarsMomentumOptimizer": lambda O: O.LarsMomentumOptimizer(
        0.01, momentum=0.9),
    "FtrlOptimizer": lambda O: O.FtrlOptimizer(0.5),
    "DecayedAdagradOptimizer": lambda O: O.DecayedAdagradOptimizer(0.3),
}


@pytest.mark.parametrize("name", sorted(CONVERGE))
def test_optimizer_class_converges(name):
    """JAX's test_ops_optimizer.py::test_optimizer_classes_converge in
    the port: each class drives a tiny quadratic lower in 10 steps."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4, 8], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.square(
            tfluid.layers.fc(x, 1)))
        CONVERGE[name](tfluid.optimizer).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    xv = np.ones((4, 8), np.float32)
    losses = [float(np.ravel(exe.run(main, feed={"x": xv},
                                     fetch_list=[loss], scope=scope)[0])[0])
              for _ in range(10)]
    assert losses[-1] < losses[0], f"{name}: {losses[0]} -> {losses[-1]}"
