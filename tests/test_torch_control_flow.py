"""Control flow in the port against the JAX package, on the CPU: the
cases of ``tests/test_control_flow.py`` (While, cond, Switch,
StaticRNN, DynamicRNN, tensor arrays, ``gradients()``), the program
verifier's sub-block cases of ``tests/test_program_verify.py`` (``:84``
op writes, ``:210`` sub-block scope, ``:364`` a write reordered past a
loop that reads it, ``:646`` a cyclic sub-block) and the DynamicRNN
LoD-machinery case of ``tests/test_passes_dynrnn.py``, with its custom
pass.

Each program is built in both packages and run on the same seeded
inputs, the port's scope holding the JAX startup's values
(``tests/torch_pair.py``): forward values within 1e-5 of max |ref|,
grads within 1e-4, parameters after 3 Adam steps within rtol 1e-5, atol
1e-5; each case also keeps the JAX test's own checks. The capture
refusals of the unbounded While and of cond need the card
(``chip_smoke.py``'s ``control_flow`` phase)."""
import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import analysis
from paddle_tpu_torch.framework.analysis import (ProgramVerifyError,
                                                 collect_diagnostics,
                                                 verify_program)
from paddle_tpu_torch.framework.passes import (Pass, apply_passes,
                                               optimize_program,
                                               register_pass)

from torch_pair import (GRAD_TOL, assert_close, assert_pair,
                        assert_scopes_close, op_pair, run_pair)


def _while_sum(fluid):
    L = fluid.layers
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 10)
    acc = L.fill_constant([1], "float32", 0.0)
    cond_v = L.less_than(i, n)
    w = L.While(cond_v)
    with w.block():
        L.assign(L.elementwise_add(acc, L.cast(i, "float32")), acc)
        L.increment(i, value=1)
        L.less_than(i, n, cond=cond_v)
    return [acc, i]


def test_while_sums_to_ten():
    out, _, mains = run_pair(_while_sum)
    assert_pair(out)
    assert float(out["port"][0][0][0]) == sum(range(10))
    assert int(out["port"][0][1][0]) == 10
    w = next(op for op in mains["port"].global_block().ops
             if op.type == "while")
    assert w.attrs["max_trip_count"] == 10 and w.attrs["max_trip_count_auto"]


@pytest.mark.parametrize("flag,expected", [(1.0, 30.0), (-1.0, 8.0)])
def test_cond_branches(flag, expected):
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [1], dtype="float32")
        pred = L.greater_than(x, L.fill_constant([1], "float32", 0.0))
        a = L.fill_constant([1], "float32", 10.0)
        return [L.cond(pred, lambda: L.scale(a, 3.0),
                       lambda: L.scale(a, 0.8))]

    out, _, _ = run_pair(build, {"x": np.array([flag], np.float32)})
    assert_pair(out)
    assert float(out["port"][0][0][0]) == expected


@pytest.mark.parametrize("sign,want", [(1.0, 2.0), (-1.0, -3.0)])
def test_cond_gradient_flows(sign, want):
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [4], dtype="float32", stop_gradient=False)
        pred = L.greater_than(L.reduce_sum(x),
                              L.fill_constant([], "float32", 0.0))
        out = L.cond(pred, lambda: L.scale(x, 2.0),
                     lambda: L.scale(x, -3.0))
        return fluid.gradients(L.reduce_sum(out), [x])

    xv = sign * np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    out, _, _ = run_pair(build, {"x": xv})
    assert_pair(out, {0: GRAD_TOL})
    np.testing.assert_allclose(out["port"][0][0], np.full(4, want))


def _switch_lr(fluid):
    L = fluid.layers
    step = L.data("step", [1], dtype="float32")
    lr = L.fill_constant([1], "float32", 0.0)
    b1 = L.fill_constant([1], "float32", 100.0)
    b2 = L.fill_constant([1], "float32", 1000.0)
    with L.Switch() as switch:
        with switch.case(L.less_than(step, b1)):
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
        with switch.case(L.less_than(step, b2)):
            L.assign(L.fill_constant([1], "float32", 0.01), lr)
        with switch.default():
            L.assign(L.fill_constant([1], "float32", 0.001), lr)
    return [lr]


@pytest.mark.parametrize("sv,expected", [(50, 0.1), (500, 0.01),
                                         (5000, 0.001)])
def test_switch_lr_schedule(sv, expected):
    out, _, _ = run_pair(_switch_lr, {"step": np.array([sv], np.float32)})
    assert_pair(out)
    np.testing.assert_allclose(float(out["port"][0][0][0]), expected,
                               rtol=1e-6)


def test_static_rnn_cumsum():
    T, B, D = 5, 2, 3

    def build(fluid):
        L = fluid.layers
        x = L.data("x", [T, B, D], dtype="float32")
        h0 = L.fill_constant([B, D], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(init=h0)
            h = L.elementwise_add(x_t, h_prev)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        return [rnn()]

    xv = np.random.default_rng(0).standard_normal((T, B, D)).astype(
        np.float32)
    out, _, _ = run_pair(build, {"x": xv})
    assert_pair(out)
    np.testing.assert_allclose(out["port"][0][0], np.cumsum(xv, axis=0),
                               rtol=1e-5, atol=1e-6)


def test_static_rnn_trains():
    """3 Adam steps in both packages: losses and every parameter and
    Adam slot match; then the port's loss halves by step 30, as the JAX
    test asks of its own."""
    T, B, D, H = 4, 3, 5, 6
    rng = np.random.default_rng(1)
    feed = {"x": rng.standard_normal((T, B, D)).astype(np.float32),
            "y": rng.standard_normal((B, 1)).astype(np.float32)}
    prog = {}

    def build(fluid):
        L = fluid.layers
        x = L.data("x", [T, B, D], dtype="float32")
        y = L.data("y", [B, 1], dtype="float32")
        h0 = L.fill_constant([B, H], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(init=h0)
            h = L.fc(L.concat([x_t, h_prev], axis=1), H, act="tanh")
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        last = L.reshape(L.slice(rnn(), axes=[0], starts=[T - 1],
                                 ends=[T]), [B, H])
        loss = L.mean(L.square_error_cost(L.fc(last, 1), y))
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
        prog["loss"] = loss
        return [loss]

    out, scopes, mains = run_pair(build, feed, steps=3)
    assert_pair(out)
    assert_scopes_close(scopes)
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = [float(x[0]) for x in out["port"]] + [
        float(exe.run(mains["port"], feed=feed, fetch_list=[prog["loss"]],
                      scope=scopes["port"])[0]) for _ in range(27)]
    assert losses[-1] < losses[0] * 0.5, losses[::10]


def test_tensor_array_write_read():
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [2, 3], dtype="float32")
        i0 = L.fill_constant([1], "int64", 0)
        i1 = L.fill_constant([1], "int64", 1)
        arr = L.array_write(x, i0)
        L.array_write(L.scale(x, 2.0), i1, array=arr)
        return [L.array_length(arr), L.array_read(arr, i1)]

    xv = np.ones((2, 3), np.float32)
    out, _, _ = run_pair(build, {"x": xv})
    assert_pair(out)
    assert int(out["port"][0][0][0]) == 2
    np.testing.assert_allclose(out["port"][0][1], xv * 2.0)


def test_switch_default_only():
    def build(fluid):
        L = fluid.layers
        lr = L.fill_constant([1], "float32", 0.0)
        with L.Switch() as switch:
            with switch.default():
                L.assign(L.fill_constant([1], "float32", 9.0), lr)
        return [lr]

    out, _, _ = run_pair(build)
    assert_pair(out)
    assert float(out["port"][0][0][0]) == 9.0


def test_while_rejects_array_write():
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        x = L.fill_constant([2], "float32", 1.0)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with pytest.raises(ValueError, match="StaticRNN"):
            with w.block():
                L.array_write(x, L.fill_constant([1], "int64", 0))
                L.increment(i)
                L.less_than(i, n, cond=cond_v)


def test_branch_exception_restores_block():
    def build(fluid):
        L = fluid.layers
        x = L.fill_constant([1], "float32", 1.0)
        pred = L.greater_than(x, L.fill_constant([1], "float32", 0.0))
        with pytest.raises(ZeroDivisionError):
            L.cond(pred, lambda: 1 / 0, lambda: x)
        assert fluid.default_main_program().current_block().idx == 0
        return [L.scale(x, 2.0)]

    out, _, _ = run_pair(build)
    assert_pair(out)
    assert float(out["port"][0][0][0]) == 2.0


def test_while_differentiable_with_max_trip_count():
    n_iters = 4

    def build(fluid):
        L = fluid.layers
        x = L.data("x", [3], dtype="float32", stop_gradient=False)
        w = L.data("w", [3], dtype="float32", stop_gradient=False)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", n_iters)
        acc = L.assign(x)
        cond_v = L.less_than(i, n)
        loop = L.While(cond_v, max_trip_count=8)
        with loop.block():
            L.assign(L.elementwise_mul(acc, w), acc)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond_v)
        return [acc] + fluid.gradients(L.reduce_sum(acc), [x, w])

    xv = np.array([1.0, 2.0, 3.0], np.float32)
    wv = np.array([1.5, 0.5, 1.1], np.float32)
    out, _, _ = run_pair(build, {"x": xv, "w": wv})
    assert_pair(out, {1: GRAD_TOL, 2: GRAD_TOL})
    acc, gx, gw = out["port"][0]
    np.testing.assert_allclose(acc, xv * wv ** n_iters, rtol=1e-5)
    np.testing.assert_allclose(gx, wv ** n_iters, rtol=1e-5)
    np.testing.assert_allclose(gw, n_iters * xv * wv ** (n_iters - 1),
                               rtol=1e-5)


def test_while_auto_bound_differentiates():
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [3], dtype="float32", stop_gradient=False)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 4)
        acc = L.assign(x)
        cond_v = L.less_than(i, n)
        loop = L.While(cond_v)
        with loop.block():
            L.assign(L.scale(acc, 2.0), acc)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond_v)
        return [acc] + fluid.gradients(L.reduce_sum(acc), [x])

    xv = np.array([1.0, 2.0, 3.0], np.float32)
    out, _, mains = run_pair(build, {"x": xv})
    assert_pair(out, {1: GRAD_TOL})
    w_op = next(op for op in mains["port"].global_block().ops
                if op.type == "while")
    assert w_op.attrs.get("max_trip_count") == 4, w_op.attrs
    np.testing.assert_allclose(out["port"][0][0], xv * 16.0, rtol=1e-5)
    np.testing.assert_allclose(out["port"][0][1], np.full(3, 16.0),
                               rtol=1e-5)


@pytest.mark.parametrize("fluid", [jfluid, tfluid], ids=["jax", "port"])
def test_while_data_dependent_grad_raises(fluid):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data("x", [3], dtype="float32", stop_gradient=False)
        hundred = L.fill_constant([1], "float32", 100.0)
        acc = L.assign(x)
        cond_v = L.less_than(L.reduce_sum(acc), hundred)
        loop = L.While(cond_v)
        with loop.block():
            L.assign(L.scale(acc, 2.0), acc)
            L.less_than(L.reduce_sum(acc), hundred, cond=cond_v)
        with pytest.raises(ValueError, match="max_trip_count"):
            fluid.gradients(L.reduce_sum(acc), [x])


def test_unbounded_while_runs_on_the_host_predicate():
    """The data-dependent loop forward: doubling [1, 2, 3] until the sum
    reaches 100 takes 5 trips, both packages."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [3], dtype="float32")
        hundred = L.fill_constant([1], "float32", 100.0)
        acc = L.assign(x)
        cond_v = L.less_than(L.reduce_sum(acc), hundred)
        loop = L.While(cond_v)
        with loop.block():
            L.assign(L.scale(acc, 2.0), acc)
            L.less_than(L.reduce_sum(acc), hundred, cond=cond_v)
        return [acc]

    out, _, mains = run_pair(build,
                             {"x": np.array([1.0, 2.0, 3.0], np.float32)})
    assert_pair(out)
    np.testing.assert_allclose(out["port"][0][0], [32.0, 64.0, 96.0])
    w_op = next(op for op in mains["port"].global_block().ops
                if op.type == "while")
    assert "max_trip_count" not in w_op.attrs


def test_rebound_name_no_double_count():
    def build(fluid):
        L = fluid.layers
        a = L.data("a", [4], dtype="float32", stop_gradient=False)
        b = L.data("b", [4], dtype="float32", stop_gradient=False)
        c = L.data("c", [4], dtype="float32", stop_gradient=False)
        t = L.elementwise_add(a, b)
        fluid.default_main_program().global_block().append_op(
            type="elementwise_mul", inputs={"X": [t], "Y": [c]},
            outputs={"Out": [t]}, infer_shape=False)
        return fluid.gradients(L.reduce_sum(t), [a, c])

    rng = np.random.default_rng(0)
    av, bv, cv = (rng.standard_normal(4).astype(np.float32)
                  for _ in range(3))
    out, _, _ = run_pair(build, {"a": av, "b": bv, "c": cv})
    assert_pair(out, {0: GRAD_TOL, 1: GRAD_TOL})
    np.testing.assert_allclose(out["port"][0][0], cv, rtol=1e-6)
    np.testing.assert_allclose(out["port"][0][1], av + bv, rtol=1e-5)


def test_gradients_multiple_targets_and_cotangents():
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [4], dtype="float32", stop_gradient=False)
        y1, y2 = L.scale(x, 2.0), L.scale(x, -1.0)
        s1 = L.data("s1", [4], dtype="float32")
        s2 = L.data("s2", [4], dtype="float32")
        return fluid.gradients([y1, y2], [x], target_gradients=[s1, s2])

    rng = np.random.default_rng(1)
    xv, s1v, s2v = (rng.standard_normal(4).astype(np.float32)
                    for _ in range(3))
    out, _, _ = run_pair(build, {"x": xv, "s1": s1v, "s2": s2v})
    assert_pair(out, {0: GRAD_TOL})
    np.testing.assert_allclose(out["port"][0][0], 2.0 * s1v - s2v,
                               rtol=1e-5)


def test_gradients_of_intermediate_var_with_nondiff_producer():
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [4], dtype="float32")
        h = L.scale(x, 2.0)
        (gh,) = fluid.gradients(L.reduce_sum(L.elementwise_mul(h, h)), [h])
        assert gh is not None
        return [gh]

    xv = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    out, _, _ = run_pair(build, {"x": xv})
    assert_pair(out, {0: GRAD_TOL})
    np.testing.assert_allclose(out["port"][0][0], 2 * (2 * xv), rtol=1e-6)


def _nested_mutated_bound(fluid, with_grad):
    L = fluid.layers
    x = L.data("x", [3], dtype="float32", stop_gradient=False)
    oi = L.fill_constant([1], "int64", 0)
    on = L.fill_constant([1], "int64", 3)
    n = L.fill_constant([1], "int64", 2)       # inner bound (mutated!)
    acc = L.assign(x)
    ocond = L.less_than(oi, on)
    outer = L.While(ocond)
    with outer.block():
        i = L.fill_constant([1], "int64", 0)
        icond = L.less_than(i, n)
        inner = L.While(icond)
        with inner.block():
            L.assign(L.scale(acc, 2.0), acc)
            L.increment(i, value=1)
            L.less_than(i, n, cond=icond)
        L.increment(n, value=1)                # bound grows each pass
        L.increment(oi, value=1)
        L.less_than(oi, on, cond=ocond)
    if with_grad:
        return fluid.gradients(L.reduce_sum(acc), [x])
    return [acc]


def test_while_auto_bound_mutated_forward_falls_back():
    out, _, _ = run_pair(lambda f: _nested_mutated_bound(f, False),
                         {"x": np.ones(3, np.float32)})
    assert_pair(out)
    # inner trips per outer pass: 2, 3, 4 doublings -> x * 2^9
    np.testing.assert_allclose(out["port"][0][0], np.full(3, 512.0))


def test_while_auto_bound_mutated_grad_raises():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        g = _nested_mutated_bound(tfluid, True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="no longer valid"):
        exe.run(main, feed={"x": np.ones(3, np.float32)}, fetch_list=g,
                scope=scope)


def test_dynamic_rnn_masked_dense():
    B, T, D, H = 3, 5, 4, 6
    lengths_np = np.array([5, 2, 4], np.int64)
    xv = np.random.default_rng(9).standard_normal((B, T, D)).astype(
        np.float32)

    def build(fluid):
        L = fluid.layers
        x = L.data("x", [B, T, D], dtype="float32", stop_gradient=False)
        lens = L.data("lens", [B], dtype="int64")
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lengths=lens)
            h = drnn.memory(shape=[H], value=0.0)
            nh = L.fc(L.concat([x_t, h], axis=1), H, act="tanh",
                      param_attr=fluid.ParamAttr(name="drnn.w"),
                      bias_attr=fluid.ParamAttr(name="drnn.b"))
            drnn.update_memory(h, nh)
            drnn.output(nh)
        out = drnn()
        return [out] + fluid.gradients(L.reduce_sum(out), [x])

    out, scopes, _ = run_pair(build, {"x": xv, "lens": lengths_np})
    assert_pair(out, {1: GRAD_TOL})
    ov, gv = out["port"][0]
    w = scopes["port"].find_var("drnn.w").numpy()
    b = scopes["port"].find_var("drnn.b").numpy()
    for r in range(B):
        h = np.zeros(H, np.float32)
        for t in range(T):
            if t < lengths_np[r]:
                h = np.tanh(np.concatenate([xv[r, t], h]) @ w + b)
                np.testing.assert_allclose(ov[r, t], h, rtol=1e-4,
                                           atol=1e-5)
            else:
                np.testing.assert_allclose(ov[r, t], 0.0, atol=1e-6)
    assert np.all(gv[1, 2:] == 0.0), gv[1]
    assert np.any(gv[0, 4] != 0.0)


def test_dynamic_rnn_rank3_memory_and_second_lengths_raise():
    B, T, D = 2, 3, 4

    def build(fluid):
        L = fluid.layers
        x = L.data("x", [B, T, D], dtype="float32")
        lens = L.data("lens", [B], dtype="int64")
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lengths=lens)
            m = drnn.memory(shape=[2, 3], value=0.5)
            nm = L.elementwise_add(m, L.reshape(
                L.fc(x_t, 6, param_attr=fluid.ParamAttr(name="r3.w"),
                     bias_attr=False), [-1, 2, 3]))
            drnn.update_memory(m, nm)
            drnn.output(nm)
        return [drnn()]

    out, _, _ = run_pair(build, {"x": np.ones((B, T, D), np.float32),
                                 "lens": np.array([3, 1], np.int64)})
    assert_pair(out)
    ov = out["port"][0][0]
    assert ov.shape == (B, T, 2, 3)
    assert np.all(ov[1, 1:] == 0.0) and np.any(ov[1, 0] != 0.0)
    L = tfluid.layers
    main2, startup2 = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main2, startup2):
        x2 = L.data("x2", [B, T, D], dtype="float32")
        l1 = L.data("l1", [B], dtype="int64")
        l2 = L.data("l2", [B], dtype="int64")
        drnn2 = L.DynamicRNN()
        with pytest.raises(ValueError, match="lengths"):
            with drnn2.block():
                drnn2.step_input(x2, lengths=l1)
                drnn2.step_input(x2, lengths=l2)


def test_multi_block_program_round_trips_across_packages():
    """A program with While, cond and StaticRNN sub-blocks crosses
    ``to_dict``/``from_dict`` both ways and runs the same after."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [3, 2, 4], dtype="float32")
        h0 = L.fill_constant([2, 4], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(init=h0)
            h = L.elementwise_add(x_t, h_prev)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        s = L.reduce_sum(rnn())
        pred = L.greater_than(s, L.fill_constant([1], "float32", 0.0))
        return [L.cond(pred, lambda: L.scale(s, 2.0),
                       lambda: L.scale(s, -1.0))] + _while_sum(fluid)

    xv = np.random.default_rng(2).standard_normal((3, 2, 4)).astype(
        np.float32)
    out, _, mains = run_pair(build, {"x": xv})
    assert_pair(out)
    from paddle_tpu.framework.core import Program as JProgram
    from paddle_tpu_torch.framework.core import Program as TProgram
    tdict = mains["port"].to_dict()
    assert len(tdict["blocks"]) == 5
    jd = JProgram.from_dict(tdict).to_dict()
    for blk in jd["blocks"]:
        for v in blk["vars"].values():
            assert v.pop("dist_attr") is None
    assert jd == tdict
    back = TProgram.from_dict(mains["jax"].to_dict())
    assert [b.parent_idx for b in back.blocks] == \
        [b.parent_idx for b in mains["jax"].blocks]
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = exe.run(back, feed={"x": xv}, fetch_list=[
        mains["port"].global_block().ops[-1].output_arg_names[0]])
    assert_close(got[0], out["jax"][0][1], 0, "round-tripped while")


# ---- the program verifier's sub-block cases (test_program_verify.py)

def _counter_loop(body=None):
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            if body is not None:
                body(L)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond_v)
    return main, i


def test_op_writes_is_sub_block_aware():
    acc = {}

    def body(L):
        L.assign(L.scale(acc["v"], scale=2.0), acc["v"])

    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        acc["v"] = L.fill_constant([1], "float32", 0.0)
    with tfluid.program_guard(main, startup):
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            body(L)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond_v)
    while_op = next(op for op in main.global_block().ops
                    if analysis.has_sub_block(op))
    writes = analysis.op_writes(main, while_op)
    assert acc["v"].name in writes and i.name in writes
    assert acc["v"].name in analysis.op_reads(main, while_op)


def test_checker_sub_block_scope():
    main, i = _counter_loop()
    bad = main.clone()
    sub_idx = next(op.attrs["sub_block"] for op in bad.global_block().ops
                   if analysis.has_sub_block(op))
    sop = bad.blocks[sub_idx].ops[0]
    sop.inputs[list(sop.inputs)[0]] = ["__nowhere__"]
    with pytest.raises(ProgramVerifyError) as ei:
        verify_program(bad, fetch_names=[i.name])
    assert ei.value.code == "sub-block-scope"
    bad2 = main.clone()
    wop = next(op for op in bad2.global_block().ops
               if analysis.has_sub_block(op))
    wop.attrs["sub_block"] = 99
    with pytest.raises(ProgramVerifyError) as ei:
        verify_program(bad2, fetch_names=[i.name])
    assert ei.value.code == "sub-block-scope"


def test_mutant_fusion_reorders_past_sub_block_reader():
    @register_pass("_torch_mut_reorder")
    class BadReorder(Pass):
        def apply(self, program):
            blk = program.global_block()
            idx = next(k for k, op in enumerate(blk.ops)
                       if op.type == "assign"
                       and "rp_param" in op.output_arg_names)
            blk.ops.append(blk.ops.pop(idx))   # move write past the loop

    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        p = L.create_global_var([1], 1.0, "float32", persistable=True,
                                name="rp_param")
        L.assign(L.fill_constant([1], "float32", 0.5), output=p)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        acc = L.fill_constant([1], "float32", 0.0)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            L.assign(L.elementwise_add(acc, p), acc)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond_v)
    tfluid.set_flags({"FLAGS_program_passes": "_torch_mut_reorder"})
    try:
        with pytest.raises(ProgramVerifyError) as ei:
            optimize_program(main, [acc.name])
    finally:
        tfluid.set_flags({"FLAGS_program_passes": "1"})
    assert ei.value.code == "reordered-past-observer"
    assert ei.value.var == "rp_param"


def test_cyclic_sub_block_reports_instead_of_recursing():
    main, i = _counter_loop()
    wop = next(op for op in main.global_block().ops
               if analysis.has_sub_block(op))
    wop.attrs["sub_block"] = 0          # self-cycle
    diags = collect_diagnostics(main, fetch_names=[i.name])
    assert "sub-block-scope" in {d.code for d in diags}, diags
    assert isinstance(analysis.op_writes(main, wop), set)
    assert isinstance(analysis.op_reads(main, wop), set)
    assert isinstance(analysis.live_op_ids(main, [i.name]), set)


def test_passes_keep_a_loop_and_its_feeders():
    """dce and cse over a program whose loop body reads outer values:
    what the body reads stays, and the run equals the JAX package's."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [4], dtype="float32")
        scale = L.scale(x, 3.0)
        dead = L.scale(x, 5.0)                 # noqa: F841 (dce drops it)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        acc = L.fill_constant([4], "float32", 0.0)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            L.assign(L.elementwise_add(acc, scale), acc)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond_v)
        return [acc]

    xv = np.arange(4, dtype=np.float32)
    out, _, mains = run_pair(build, {"x": xv})
    assert_pair(out)
    np.testing.assert_allclose(out["port"][0][0], 9.0 * xv)
    acc = mains["port"].global_block().ops[-1].output_arg_names[0]
    opt = optimize_program(mains["port"], [acc])
    kinds = [op.type for op in opt.global_block().ops]
    assert kinds.count("scale") == 1 and "while" in kinds


# ---- DynamicRNN's LoD machinery and a custom pass (test_passes_dynrnn.py)

def test_pass_registry_and_custom_pass():
    @register_pass("_torch_scale_doubler")
    class ScaleDoubler(Pass):
        def apply(self, program):
            for blk in program.blocks:
                for op in blk.ops:
                    if op.type == "scale":
                        op.attrs["scale"] = float(
                            op.attrs.get("scale", 1.0)) * 2.0

    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = L.data("x", [3], dtype="float32")
        y = L.scale(x, scale=3.0)
    apply_passes(main, ["_torch_scale_doubler"])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": np.ones(3, np.float32)}, fetch_list=[y])
    np.testing.assert_allclose(got, np.full(3, 6.0))


def test_lod_rank_table_and_friends():
    lengths = np.array([3, 5, 5, 2], np.int64)
    to, _ = op_pair("lod_rank_table", {"Length": lengths}, {},
                    {"Index": ((4,), "int64"), "Length": ((4,), "int64")})
    # descending by length, stable among equals (rows 1, 2 tie)
    np.testing.assert_array_equal(to["Index"], [1, 2, 0, 3])
    np.testing.assert_array_equal(to["Length"], [5, 5, 3, 2])
    to, _ = op_pair("max_sequence_len", {"Length": lengths}, {},
                    {"Out": ((1,), "int64")})
    assert to["Out"][0] == 5
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    to, _ = op_pair("reorder_lod_tensor_by_rank",
                    {"X": x, "RankTable": np.array([1, 2, 0, 3], np.int64)},
                    {}, {"Out": ((4, 2), "float32")})
    np.testing.assert_allclose(to["Out"], x[[1, 2, 0, 3]])
    to, _ = op_pair("rnn_memory_helper", {"X": x}, {},
                    {"Out": ((4, 2), "float32")}, grad_slots=("X",))
    np.testing.assert_allclose(to["Out"], x)


def test_chip_smoke_switch_schedule_is_the_jax_packages():
    """chip_smoke's ``control_flow`` phase holds the card's Switch
    schedule to constants: they are what the JAX package's ``run``
    gives, as float32."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for step, want in cs.SWITCH_LR_SCHEDULE:
        out, _, _ = run_pair(_switch_lr,
                             {"step": np.array([step], np.float32)})
        assert float(out["jax"][0][0][0]) == want
        assert float(out["port"][0][0][0]) == want


def test_dropout_in_a_step_body_draws_one_mask():
    """A dropout inside a StaticRNN step draws the same mask at every
    step in both packages: the JAX scan body is traced once with one
    key, and the port seeds each call from (run seed, op seed). The
    masks differ between the packages (RNG is not portable); a captured
    step keeps the property (chip_smoke's control_flow phase)."""
    T, B, D = 4, 3, 8

    def build(fluid):
        L = fluid.layers
        x = L.data("x", [T, B, D], dtype="float32")
        rnn = L.StaticRNN()
        with rnn.step():
            rnn.step_output(L.dropout(rnn.step_input(x), 0.5))
        return [rnn()]

    out, _, _ = run_pair(build, {"x": np.ones((T, B, D), np.float32)},
                         steps=2)
    for pkg in ("jax", "port"):
        for (o,) in out[pkg]:
            assert np.all(o == o[:1]), pkg
            assert 0 < np.count_nonzero(o[0]) < B * D, pkg
    # a new run draws a new mask
    assert not np.array_equal(out["port"][0][0], out["port"][1][0])


def test_persistable_written_in_a_loop_body_is_state():
    """A persistable var the While body writes is scope state
    (``analyze_block_io`` walks the sub-block): each run starts from the
    last run's value, in ``run`` and in a ``run_steps`` slab, as in the
    JAX package."""
    def build(fluid):
        L = fluid.layers
        total = L.create_global_var([1], 0.0, "float32", persistable=True,
                                    name="loop_total")
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        cond_v = L.less_than(i, n)
        w = L.While(cond_v)
        with w.block():
            L.assign(L.elementwise_add(
                total, L.fill_constant([1], "float32", 2.0)), total)
            L.increment(i, value=1)
            L.less_than(i, n, cond=cond_v)
        return [total]

    out, scopes, mains = run_pair(build, steps=2)
    assert_pair(out)
    assert [float(o[0][0]) for o in out["port"]] == [6.0, 12.0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run_steps(mains["port"], feed={"unused": np.zeros((2, 1),
                                                          np.float32)},
                  fetch_list=["loop_total"], scope=scopes["port"])
    assert float(scopes["port"].find_var("loop_total")[0]) == 24.0
