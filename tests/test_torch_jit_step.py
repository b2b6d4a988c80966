"""The port's ``dygraph.jit_step`` on the CPU, against its eager steps and
the JAX package's ``jit_step``.

On the CPU an entry runs the captured body eagerly over its static
tensors (the GPU replays it as one CUDA graph; ``chip_smoke.py`` holds a
replay bitwise to an eager step there), so these cases check the
protocol the graph rests on: discovery of the step's external state,
the static binding and copy-back, the staged ``to_variable`` data, one
cache entry per signature and the copy-in of a value rebound between
calls. Losses at rtol 2e-4 / atol 1e-6, as ``tests/test_dygraph.py``'s
``test_jit_step_matches_eager``."""
import copy

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph import layers as jdylayers

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch.dygraph import layers as tdylayers
from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
from paddle_tpu_torch.models import layer_params_from_jax

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _keep_init_streams():
    """Leave both packages' dygraph init streams as they were: the
    weights of a later test file in this worker process are drawn from
    them."""
    saved = [copy.deepcopy(m._init_rng) for m in (jdylayers, tdylayers)]
    yield
    jdylayers._init_rng, tdylayers._init_rng = saved
rng = np.random.default_rng(7)
X = rng.standard_normal((8, 6)).astype("float32")
Y = (rng.standard_normal((8, 3)) * 0.1).astype("float32")


def _step_fn(fluid, model, opt):
    def step(x, y):
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(model(x), y)))
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        return loss
    return step


def _losses(step, dy, n=5):
    return [float(step(dy.to_variable(X), dy.to_variable(Y)).numpy()
                  .reshape(-1)[0]) for _ in range(n)]


def _jax_linear():
    with jdy.guard():
        return jdy.Linear(6, 3).state_dict()


def test_jit_step_matches_eager():
    state = _jax_linear()
    with tdy.guard(CPU):
        m1, m2 = tdy.Linear(6, 3), tdy.Linear(6, 3)
        layer_params_from_jax(m1, state)
        layer_params_from_jax(m2, state)
        o1 = tfluid.optimizer.Adam(0.05, parameter_list=m1.parameters())
        o2 = tfluid.optimizer.Adam(0.05, parameter_list=m2.parameters())
        eager = _losses(_step_fn(tfluid, m1, o1), tdy)
        compiled = tdy.jit_step(_step_fn(tfluid, m2, o2))
        comp = _losses(compiled, tdy)
        np.testing.assert_allclose(comp, eager, rtol=2e-4, atol=1e-6)
        for a, b in zip(m2.parameters(), m1.parameters()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)
        # every slot of Adam's state is the entry's static tensor
        cache = compiled._compiled_step._cache
        assert len(cache) == 1
        entry = next(iter(cache.values()))
        assert len(entry._binding) == 8
        for (o, pn, slot), st in zip(entry._binding, entry._opt_static):
            assert o._eager_state[pn][slot] is st
        compiled(tdy.to_variable(X), tdy.to_variable(Y))
        assert next(iter(cache.values())) is entry


def test_jit_step_matches_jax_jit_step():
    state = _jax_linear()
    with jdy.guard():
        jm = jdy.Linear(6, 3)
        jm.set_dict(state)
        jo = jfluid.optimizer.Adam(0.05, parameter_list=jm.parameters())
        ref = _losses(jdy.jit_step(_step_fn(jfluid, jm, jo)), jdy)
        jw = jm.state_dict()
    with tdy.guard(CPU):
        tm = tdy.Linear(6, 3)
        layer_params_from_jax(tm, state)
        to = tfluid.optimizer.Adam(0.05, parameter_list=tm.parameters())
        got = _losses(tdy.jit_step(_step_fn(tfluid, tm, to)), tdy)
        tw = tm.state_dict()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=1e-4, atol=1e-6)


def test_jit_step_multiple_signatures():
    with tdy.guard(CPU):
        m = tdy.Linear(4, 2)
        o = tfluid.optimizer.SGD(0.1, parameter_list=m.parameters())

        @tdy.jit_step
        def step(x):
            loss = tfluid.layers.mean(m(x))
            loss.backward()
            o.minimize(loss)
            m.clear_gradients()
            return loss

        r = np.random.default_rng(1)
        for b in (4, 4, 4, 6, 6, 6, 4):
            loss = step(tdy.to_variable(
                r.standard_normal((b, 4)).astype("float32")))
            assert np.isfinite(float(loss.numpy().reshape(-1)[0]))
        assert len(step._compiled_step._cache) == 2


def _pos_step(m, o, const):
    @tdy.jit_step
    def step(x):
        x = tfluid.layers.elementwise_add(x, tdy.to_variable(const()))
        loss = tfluid.layers.mean(m(x))
        loss.backward()
        o.minimize(loss)
        m.clear_gradients()
        return loss
    return step


def test_jit_step_warmup_small_capture_big():
    """Warm up at one signature, capture at another; a ``to_variable``
    constant inside the step (the Transformer's positional encoding)
    takes the tensor staged for it."""
    pos = np.arange(12, dtype=np.float32).reshape(1, 12)
    r = np.random.default_rng(2)
    with tdy.guard(CPU):
        m = tdy.Linear(12, 3)
        o = tfluid.optimizer.SGD(0.05, parameter_list=m.parameters())
        step = _pos_step(m, o, lambda: pos)
        step(tdy.to_variable(r.standard_normal((2, 12)).astype("float32")))
        for _ in range(3):
            loss = step(tdy.to_variable(
                r.standard_normal((16, 12)).astype("float32")))
            assert np.isfinite(float(loss.numpy().reshape(-1)[0]))
        entry = next(iter(step._compiled_step._cache.values()))
        assert len(entry._staged) == 1
        np.testing.assert_array_equal(entry._staged[0][0], pos)


def test_jit_step_host_data_must_match_the_staged():
    """Host data that differs from what was staged before capture raises
    GraphCaptureError: it would be a host-to-device copy inside the
    graph."""
    calls = []

    def const():
        calls.append(1)
        return np.full((1, 4), float(len(calls)), np.float32)

    with tdy.guard(CPU):
        m = tdy.Linear(4, 2)
        o = tfluid.optimizer.SGD(0.05, parameter_list=m.parameters())
        step = _pos_step(m, o, const)
        x = tdy.to_variable(np.ones((3, 4), np.float32))
        step(x)                                 # eager warm-up
        with pytest.raises(GraphCaptureError, match="differs"):
            step(x)                             # discovery, then the body
        assert np.isfinite(m.weight.numpy()).all()


def test_jit_step_copies_in_rebound_values():
    """A parameter rebound between calls (set_dict) is copied into the
    entry's static tensor before the next step: the step reads it."""
    state = _jax_linear()
    with tdy.guard(CPU):
        m1, m2 = tdy.Linear(6, 3), tdy.Linear(6, 3)
        layer_params_from_jax(m1, state)
        layer_params_from_jax(m2, state)
        o1 = tfluid.optimizer.SGD(0.1, parameter_list=m1.parameters())
        o2 = tfluid.optimizer.SGD(0.1, parameter_list=m2.parameters())
        eager = _step_fn(tfluid, m1, o1)
        compiled = tdy.jit_step(_step_fn(tfluid, m2, o2))
        _losses(eager, tdy, 3)
        _losses(compiled, tdy, 3)
        m1.set_dict(state)
        m2.set_dict(state)
        a, b = _losses(eager, tdy, 2), _losses(compiled, tdy, 2)
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-6)
        entry = next(iter(compiled._compiled_step._cache.values()))
        assert all(any(p.value is st for st in entry._static)
                   for p in m2.parameters())


def test_jit_step_replay_protocol_equals_eager_with_dropout():
    """``CompiledStep.eager`` from the same state and tracer key as a
    compiled call gives the same loss and parameters, bit for bit, with
    dropout on (on the GPU the call is a graph replay)."""
    xv = np.random.default_rng(4).standard_normal((16, 8)).astype("float32")
    with tdy.guard(CPU):
        m = tdy.Linear(8, 8)
        o = tfluid.optimizer.Adam(0.01, parameter_list=m.parameters())

        @tdy.jit_step
        def step(x):
            h = tfluid.layers.dropout(
                m(x), 0.1, dropout_implementation="upscale_in_train")
            loss = tfluid.layers.mean(tfluid.layers.square(h))
            loss.backward()
            o.minimize(loss)
            m.clear_gradients()
            return loss

        x = tdy.to_variable(xv)
        step(x)
        step(x)
        tracer = tdy.base._current_tracer()
        params = [p.value.clone() for p in m.parameters()]
        states = {pn: {s: t.clone() for s, t in st.items()}
                  for pn, st in o._eager_state.items()}
        key = tracer._key
        got = step(x).numpy()
        after = [p.numpy() for p in m.parameters()]
        for p, v in zip(m.parameters(), params):
            p.value = v
        o._eager_state = states
        tracer._key = key
        ref = step._compiled_step.eager(x).numpy()
        np.testing.assert_array_equal(got, ref)
        for a, p in zip(after, m.parameters()):
            np.testing.assert_array_equal(a, p.numpy())
