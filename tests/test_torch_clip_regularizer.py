"""Gradient clipping, regularization and error clipping of the port
against the JAX package, on the CPU.

- For each clip (by value, by norm, by global norm), a parameter with
  ``need_clip=False``, L1 and L2 decay, a parameter's own regularizer
  over the optimizer's, and ``set_gradient_clip``: the program (ops,
  slots, attrs, ``op_role``, var names) equals the JAX package's, op for
  op, and 3 steps from the JAX startup's state give the JAX losses and
  scope within 1e-5 (rel) / 1e-6 (abs).
- ``ErrorClipByValue`` on a var clips its error signal as JAX's
  ``test_fluid_namespace.py::test_error_clip_by_value_clips_error_signal``
  asserts.
- Dygraph: a 1e-6 global-norm clip leaves the weight (JAX's
  ``test_dygraph.py::test_dygraph_grad_clip_and_regularization``); each
  clip, L1/L2 and a param ``regularizer`` over 3 eager steps, and eager
  LAMB, Adagrad and DecayedAdagrad, from the JAX Linear's weights,
  within 1e-5 of the JAX package's; a class without a dygraph path
  raises JAX's message.
- ``contrib.extend_with_decoupled_weight_decay(AdamOptimizer)``: the
  program equals JAX's and 3 steps match.
"""
import copy

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu import layers as jlayers
from paddle_tpu.dygraph import layers as jdylayers

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.dygraph import layers as tdylayers
from paddle_tpu_torch.models import layer_params_from_jax

from test_torch_bert import jax_dict
from torch_pair import assert_pair, assert_scopes_close, run_pair

CPU = tfluid.CPUPlace()
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _keep_init_streams():
    """Leave both packages' dygraph init streams as they were: the
    weights of a later test file in this worker process are drawn from
    them."""
    saved = [copy.deepcopy(m._init_rng) for m in (jdylayers, tdylayers)]
    yield
    jdylayers._init_rng, tdylayers._init_rng = saved
X = RNG.standard_normal((8, 6)).astype("float32")
Y = RNG.integers(0, 3, (8, 1)).astype("int64")


def _clip(f, kind):
    return {"value": lambda: f.clip.GradientClipByValue(0.05),
            "value_min": lambda: f.clip.GradientClipByValue(0.1, min=-0.02),
            "norm": lambda: f.clip.ClipGradByNorm(0.1),
            "global_norm": lambda: f.clip.GradientClipByGlobalNorm(0.2),
            None: lambda: None}[kind]()


CASES = {
    "clip_value": dict(clip="value"),
    "clip_value_min": dict(clip="value_min"),
    "clip_norm": dict(clip="norm"),
    "clip_global_norm": dict(clip="global_norm"),
    "need_clip_false": dict(clip="global_norm", no_clip_bias=True),
    "l2": dict(reg="l2"),
    "l1": dict(reg="l1"),
    "param_reg_over_optimizer": dict(reg="l2", param_reg=True),
    "clip_and_l2": dict(clip="global_norm", reg="l2"),
    "set_gradient_clip": dict(legacy="norm"),
}


def build(case):
    """A 2-fc softmax net under Momentum(0.1, 0.9) with ``case``'s clip
    and regularization."""
    def fn(fluid):
        x = fluid.data("x", [-1, 6], "float32")
        y = fluid.data("y", [-1, 1], "int64")
        battr = None
        if case.get("no_clip_bias"):
            battr = fluid.ParamAttr(name="b_noclip", need_clip=False)
        wattr = None
        if case.get("param_reg"):
            wattr = fluid.ParamAttr(
                name="w_reg", regularizer=fluid.regularizer.L1Decay(0.05))
        h = fluid.layers.fc(x, 8, act="relu", param_attr=wattr,
                            bias_attr=battr)
        logits = fluid.layers.fc(h, 3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        reg = {"l1": lambda: fluid.regularizer.L1Decay(1e-2),
               "l2": lambda: fluid.regularizer.L2DecayRegularizer(1e-2),
               None: lambda: None}[case.get("reg")]()
        if case.get("legacy"):
            fluid.clip.set_gradient_clip(_clip(fluid, case["legacy"]))
        try:
            fluid.optimizer.Momentum(
                0.1, 0.9, regularization=reg,
                grad_clip=_clip(fluid, case.get("clip"))).minimize(loss)
        finally:
            fluid.clip._clip_attr.clear()
        return [loss]
    return fn


@pytest.mark.parametrize("name", sorted(CASES))
def test_program_and_three_steps_match_jax(name):
    out, scopes, mains = run_pair(build(CASES[name]), {"x": X, "y": Y},
                                  steps=3)
    assert mains["port"].to_dict() == jax_dict(mains["jax"])
    types = [op.type for op in mains["port"].global_block().ops]
    case = CASES[name]
    want = {"value": "clip", "value_min": "clip", "norm": "clip_by_norm",
            "global_norm": "squared_l2_norm"}.get(
                case.get("clip") or case.get("legacy"))
    if want:
        assert want in types, types
    if case.get("reg") == "l1" or case.get("param_reg"):
        assert "sign" in types
    if case.get("no_clip_bias"):
        # three clipped grads: the hidden weight and the output fc's two
        assert types.count("squared_l2_norm") == 3
    assert_pair(out, what=name)
    assert_scopes_close(scopes, rtol=1e-5, atol=1e-6)


def test_error_clip_by_value_clips_error_signal():
    """JAX's test_error_clip_by_value_clips_error_signal in the port:
    the clip op appears and caps the error before the weight grad."""
    xv = np.random.default_rng(3).standard_normal((4, 3)).astype(np.float32)

    def run(with_clip):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.data("x", [4, 3], "float32")
            h = tlayers.fc(x, 3, bias_attr=False)
            if with_clip:
                main.global_block().var(h.name)._set_error_clip(
                    tfluid.clip.ErrorClipByValue(max=1e-4))
            loss = tlayers.reduce_sum(tlayers.scale(h, scale=100.0))
            ps = tfluid.append_backward(
                loss, callbacks=[tfluid.clip.error_clip_callback])
        exe = tfluid.Executor(CPU)
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        g, = exe.run(main, feed={"x": xv}, fetch_list=[ps[0][1].name],
                     scope=scope)
        return [op.type for op in main.global_block().ops], np.asarray(g)
    types, clipped = run(True)
    assert "clip" in types, types
    _, plain = run(False)
    assert np.abs(plain).max() > 1.0
    assert np.abs(clipped).max() <= 1e-4 * np.abs(xv).sum() + 1e-6
    with pytest.raises(TypeError):
        tfluid.Program().global_block().create_var(
            name="v")._set_error_clip(object())


def _guard(dy):
    return dy.guard(CPU) if dy is tdy else dy.guard()


def test_dygraph_grad_clip_and_regularization():
    """JAX's test_dygraph_grad_clip_and_regularization: a 1e-6 global
    norm leaves the weight where it was, in both packages."""
    for fluid, dy, layers in ((jfluid, jdy, jlayers),
                              (tfluid, tdy, tlayers)):
        with _guard(dy):
            lin = dy.Linear(4, 1, bias_attr=False)
            opt = fluid.optimizer.SGDOptimizer(
                1.0, parameter_list=lin.parameters(),
                grad_clip=fluid.clip.GradientClipByGlobalNorm(1e-6))
            w0 = lin.weight.numpy().copy()
            x = dy.to_variable(np.ones((2, 4), np.float32))
            loss = layers.reduce_sum(lin(x))
            loss.backward()
            opt.minimize(loss)
            assert np.abs(lin.weight.numpy() - w0).max() < 1e-5


EAGER = {
    "clip_value": lambda f, ps: f.optimizer.SGD(
        0.1, parameter_list=ps, grad_clip=f.clip.GradientClipByValue(0.02)),
    "clip_norm": lambda f, ps: f.optimizer.Momentum(
        0.1, 0.9, parameter_list=ps, grad_clip=f.clip.GradientClipByNorm(0.1)),
    "clip_global_norm_l2": lambda f, ps: f.optimizer.Adam(
        0.05, parameter_list=ps,
        grad_clip=f.clip.GradientClipByGlobalNorm(0.1),
        regularization=f.regularizer.L2Decay(1e-2)),
    "l1": lambda f, ps: f.optimizer.SGD(
        0.1, parameter_list=ps, regularization=f.regularizer.L1Decay(0.05)),
    "param_regularizer": "param",
    "lamb": lambda f, ps: f.optimizer.Lamb(0.05, parameter_list=ps),
    "lamb_clip": lambda f, ps: f.optimizer.LambOptimizer(
        0.05, lamb_weight_decay=0.1, parameter_list=ps,
        grad_clip=f.clip.GradientClipByGlobalNorm(0.5)),
    "adagrad": lambda f, ps: f.optimizer.Adagrad(0.1, parameter_list=ps),
    "decayed_adagrad": lambda f, ps: f.optimizer.DecayedAdagrad(
        0.1, decay=0.9, parameter_list=ps),
}


@pytest.mark.parametrize("name", sorted(EAGER))
def test_eager_clip_regularizer_and_optimizers_match_jax(name):
    """3 eager steps from the JAX Linear's weights: losses and weights
    within 1e-5 of the JAX package's."""
    state = {}
    xv = np.random.default_rng(5).standard_normal((6, 4)).astype("float32")
    got = {}
    for key, (fluid, dy, layers) in (("jax", (jfluid, jdy, jlayers)),
                                     ("port", (tfluid, tdy, tlayers))):
        with _guard(dy):
            wattr = None
            if EAGER[name] == "param":
                wattr = fluid.ParamAttr(
                    regularizer=fluid.regularizer.L2Decay(0.5))
            lin = dy.Linear(4, 3, param_attr=wattr)
            if dy is jdy:
                state.update(lin.state_dict())
            else:
                layer_params_from_jax(lin, state)
            if EAGER[name] == "param":
                opt = fluid.optimizer.SGD(
                    0.1, parameter_list=lin.parameters(),
                    regularization=fluid.regularizer.L1Decay(0.05))
            else:
                opt = EAGER[name](fluid, lin.parameters())
            losses = []
            for _ in range(3):
                loss = layers.mean(layers.square(lin(dy.to_variable(xv))))
                loss.backward()
                opt.minimize(loss)
                opt.clear_gradients()
                losses.append(float(loss.numpy().reshape(-1)[0]))
            got[key] = (losses, lin.weight.numpy(), lin.bias.numpy())
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("opt", ["LarsMomentum", "Adamax", "Dpsgd",
                                 "DGCMomentumOptimizer"])
def test_no_dygraph_path_raises_as_jax(opt):
    for fluid, dy, layers in ((jfluid, jdy, jlayers),
                              (tfluid, tdy, tlayers)):
        with _guard(dy):
            lin = dy.Linear(2, 1)
            cls = getattr(fluid.optimizer, opt)
            o = cls(0.1, 0.9, parameter_list=lin.parameters()) \
                if opt in ("LarsMomentum", "DGCMomentumOptimizer") \
                else cls(0.1, parameter_list=lin.parameters())
            layers.reduce_sum(lin(dy.to_variable(
                np.ones((1, 2), np.float32)))).backward()
            with pytest.raises(NotImplementedError,
                               match="has no dygraph update path yet"):
                o.minimize(None)


def test_decoupled_weight_decay_matches_jax():
    def fn(fluid):
        x = fluid.data("x", [-1, 6], "float32")
        y = fluid.data("y", [-1, 1], "int64")
        logits = fluid.layers.fc(fluid.layers.fc(x, 8, act="relu"), 3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        cls = fluid.contrib.extend_with_decoupled_weight_decay(
            fluid.optimizer.AdamOptimizer)
        assert cls.__name__ == "AdamOptimizerWithDecoupledWeightDecay"
        cls(0.1, learning_rate=0.01).minimize(loss)
        return [loss]
    out, scopes, mains = run_pair(fn, {"x": X, "y": Y}, steps=3)
    assert mains["port"].to_dict() == jax_dict(mains["jax"])
    assert [o.type for o in mains["port"].global_block().ops].count(
        "assign") == 4
    assert_pair(out, what="decoupled weight decay")
    assert_scopes_close(scopes, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError):
        tfluid.contrib.extend_with_decoupled_weight_decay(object)
