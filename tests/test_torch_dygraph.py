"""The port's imperative mode (``paddle_tpu_torch.dygraph``) against the
JAX package's, on the CPU (``guard(CPUPlace())``, fp32).

The cases of ``tests/test_dygraph.py`` (but the LSTM/GRU, grad-clip and
jit cases): the same numpy inputs and the same weights (a JAX Layer's
``state_dict`` carried by ``models.layer_params_from_jax``) go through
both packages; grads, outputs and losses agree within 1e-5 (rel) unless
a case says otherwise. Also: a dygraph grad equals the port's static
``append_backward`` grad bitwise; ``save_dygraph`` files load across
the packages both ways; the ten LR schedulers give the JAX package's
rates; layers that create parameters, ``guard()`` without a GPU and the
unported classes raise, and an optimizer takes a ``grad_clip``."""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu import layers as jlayers
from paddle_tpu.dygraph import layers as jdylayers

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.dygraph import layers as tdylayers
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
PKGS = {"jax": (jfluid, jdy, jlayers), "torch": (tfluid, tdy, tlayers)}


def _guard(dy):
    return dy.guard(CPU) if dy is tdy else dy.guard()


def _both(fn):
    """fn(fluid, dygraph, layers) under each package's guard."""
    out = {}
    for name, (fluid, dy, layers) in PKGS.items():
        with _guard(dy):
            out[name] = fn(fluid, dy, layers)
    return out


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def test_eager_arithmetic_and_backward():
    def run(fluid, dy, layers):
        x = dy.to_variable(np.array([1.0, 2.0, 3.0], np.float32))
        x.stop_gradient = False
        y = x * x + 2.0 * x - x / 4.0
        layers.reduce_sum(y).backward()
        return y.numpy(), x.gradient()

    got = _both(run)
    _close(got["torch"][0], got["jax"][0])
    _close(got["torch"][1], got["jax"][1])
    _close(got["torch"][1], 2 * np.array([1, 2, 3]) + 2 - 0.25)


def test_backward_accumulates():
    def run(fluid, dy, layers):
        x = dy.to_variable(np.ones(3, np.float32))
        x.stop_gradient = False
        layers.reduce_sum(x * 2.0).backward()
        layers.reduce_sum(x * 3.0).backward()
        g = x.gradient()
        x.clear_gradient()
        return g, x.gradient()

    got = _both(run)
    _close(got["torch"][0], np.full(3, 5.0))
    _close(got["torch"][0], got["jax"][0])
    assert got["torch"][1] is None


def test_no_grad_all_forms():
    with tdy.guard(CPU):
        x = tdy.to_variable(np.ones(2, np.float32))
        x.stop_gradient = False
        with tdy.no_grad():
            y = x * 2.0
        assert y.stop_gradient

        @tdy.no_grad
        def f1(v):
            return v * 2.0

        @tdy.no_grad()
        def f2(v):
            return v * 3.0

        assert f1(x).stop_gradient and f2(x).stop_gradient
        np.testing.assert_array_equal(f2(x).numpy(), [3.0, 3.0])
        assert not (x * 2.0).stop_gradient
        assert not tdy.base._current_tracer().tape[-1].outs["Out"][0] \
            .stop_gradient


def test_grad_api_and_grad_outputs():
    def run(fluid, dy, layers):
        x = dy.to_variable(np.array([2.0, 3.0], np.float32))
        x.stop_gradient = False
        (g3,) = dy.grad(x * x * x, x)
        untouched = x.gradient()
        y = x * x
        (gw,) = dy.grad(y, x, grad_outputs=[np.array([3.0, 5.0],
                                                     np.float32)])
        return g3.numpy(), untouched, gw.numpy()

    got = _both(run)
    _close(got["torch"][0], [12.0, 27.0])
    assert got["torch"][1] is None
    _close(got["torch"][2], 2 * np.array([2.0, 3.0]) * [3.0, 5.0])
    for a, b in zip(got["torch"], got["jax"]):
        if a is not None:
            _close(a, b)


def test_double_backward_polynomial():
    def run(fluid, dy, layers):
        xv = np.array([1.0, 2.0, 3.0], np.float32)
        x = dy.to_variable(xv)
        x.stop_gradient = False
        s = layers.reduce_sum(x * x * x)
        (g1,) = dy.grad(s, [x], create_graph=True)
        (g2,) = dy.grad(layers.reduce_sum(g1), [x])
        x4 = dy.to_variable(np.array([2.0], np.float32))
        x4.stop_gradient = False
        s4 = layers.reduce_sum(x4 * x4 * x4 * x4)
        (h1,) = dy.grad(s4, [x4], create_graph=True)
        (h2,) = dy.grad(layers.reduce_sum(h1), [x4], create_graph=True)
        (h3,) = dy.grad(layers.reduce_sum(h2), [x4])
        return g1.numpy(), g2.numpy(), h3.numpy()

    got = _both(run)
    xv = np.array([1.0, 2.0, 3.0])
    _close(got["torch"][0], 3 * xv ** 2)
    _close(got["torch"][1], 6 * xv)
    _close(got["torch"][2], [48.0])
    for a, b in zip(got["torch"], got["jax"]):
        _close(a, b)


def test_gradient_penalty_reaches_weights():
    """Backward through a gradient reaches the Linear's weights, through
    elementwise_pow too (its exponent branch stays out of the graph)."""
    jdylayers.set_init_seed(5)
    with jdy.guard():
        jlin = jdy.Linear(3, 1)
        state = jlin.state_dict()

    def run(fluid, dy, layers):
        lin = dy.Linear(3, 1)
        if dy is tdy:
            layer_params_from_jax(lin, state)
        else:
            lin.set_dict(state)
        x = dy.to_variable(np.array([[1., 2., 3.]], np.float32))
        x.stop_gradient = False
        out = layers.reduce_sum(lin(x) ** 2.0)
        (gx,) = dy.grad(out, [x], create_graph=True)
        layers.reduce_sum(gx * gx).backward()
        return lin.weight.gradient(), lin.bias.gradient()

    got = _both(run)
    wv, bv = state[next(k for k in state if "w" in k)].ravel(), \
        float(state[next(k for k in state if "b" in k)].reshape(()))
    xv = np.array([1., 2., 3.])
    a = wv @ xv + bv
    ref = 8 * a * (wv @ wv) * xv + 8 * a * a * wv
    _close(got["torch"][0].ravel(), ref, rtol=1e-4)
    _close(got["torch"][0], got["jax"][0])
    _close(got["torch"][1], got["jax"][1])


def test_create_graph_respects_no_grad_vars_and_seed():
    def run(fluid, dy, layers):
        x = dy.to_variable(np.array([1.0, 4.0], np.float32))
        x.stop_gradient = False
        w = dy.to_variable(np.array([0.5, 2.0], np.float32))
        w.stop_gradient = False
        y = x * x * w
        seed = dy.to_variable(np.array([2.0, 0.5], np.float32))
        (g,) = dy.grad(y, [x], grad_outputs=[seed], create_graph=True,
                       no_grad_vars=[w])
        (g2,) = dy.grad(layers.reduce_sum(g), [x])
        assert not w.stop_gradient
        return g.numpy(), g2.numpy()

    got = _both(run)
    _close(got["torch"][0], 2 * np.array([1.0, 4.0]) * [0.5, 2.0]
           * [2.0, 0.5])
    _close(got["torch"][1], 2 * np.array([0.5, 2.0]) * [2.0, 0.5])
    for a, b in zip(got["torch"], got["jax"]):
        _close(a, b)


@pytest.mark.parametrize("case", ["alone", "read_after"])
def test_inplace_op_no_grad_double_count(case):
    """An in-place op whose output VarBase is its input: the out-grad is
    consumed by the op's grad, not counted again."""
    def run(fluid, dy, layers):
        x = dy.to_variable(np.array([2.0], np.float32))
        x.stop_gradient = False
        y = layers.increment(x)
        (y if case == "alone" else y * y).backward()
        return x.gradient()

    got = _both(run)
    _close(got["torch"], [1.0] if case == "alone" else [6.0])
    _close(got["torch"], got["jax"])


def test_inplace_mutation_does_not_corrupt_earlier_grad():
    """A read before a later in-place write uses the value it read (the
    tape keeps the input tensors of each op)."""
    def run(fluid, dy, layers):
        x = dy.to_variable(np.array([3.0], np.float32))
        x.stop_gradient = False
        w = x * x
        layers.increment(x)
        (w + x).backward()
        return x.gradient()

    got = _both(run)
    _close(got["torch"], [7.0])
    _close(got["torch"], got["jax"])


def test_linear_layer_matches_numpy_and_jax():
    jdylayers.set_init_seed(1)
    tdylayers.set_init_seed(1)
    xv = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)

    def run(fluid, dy, layers):
        lin = dy.Linear(4, 3)
        out = lin(dy.to_variable(xv))
        return out.numpy(), lin.weight.numpy(), lin.bias.numpy()

    got = _both(run)
    out, w, b = got["torch"]
    np.testing.assert_array_equal(w, got["jax"][1])   # the same init
    _close(out, xv @ w + b)
    _close(out, got["jax"][0])


def test_batchnorm_train_vs_eval():
    xv = np.random.default_rng(1).standard_normal(
        (8, 3, 4, 4)).astype(np.float32) * 3 + 1

    def run(fluid, dy, layers):
        bn = dy.BatchNorm(3)
        x = dy.to_variable(xv)
        bn.train()
        y1 = bn(x)
        bn.eval()
        y2 = bn(x)
        return y1.numpy(), y2.numpy(), bn._mean.numpy(), \
            bn._variance.numpy()

    got = _both(run)
    assert abs(float(np.mean(got["torch"][0]))) < 0.1
    assert abs(float(np.mean(got["torch"][1]))) > 0.1
    for a, b in zip(got["torch"], got["jax"]):
        _close(a, b, atol=1e-5)


def test_embedding_and_layernorm():
    jdylayers.set_init_seed(2)
    tdylayers.set_init_seed(2)
    ids = np.array([[1, 2], [3, 4]], np.int64)

    def run(fluid, dy, layers):
        emb = dy.Embedding([10, 6])
        ln = dy.LayerNorm(6)
        out = ln(emb(dy.to_variable(ids)))
        layers.reduce_sum(out * out).backward()
        return out.numpy(), emb.weight.gradient(), ln.weight.gradient()

    got = _both(run)
    assert got["torch"][0].shape == (2, 2, 6)
    _close(np.mean(got["torch"][0], -1), np.zeros((2, 2)), atol=1e-5)
    for a, b in zip(got["torch"], got["jax"]):
        _close(a, b, atol=1e-5)


def test_trainable_false_param_frozen():
    def run(fluid, dy, layers):
        lin = dy.Linear(3, 2, param_attr=fluid.ParamAttr(trainable=False))
        w0 = lin.weight.numpy().copy()
        opt = fluid.optimizer.SGDOptimizer(0.5,
                                           parameter_list=lin.parameters())
        loss = layers.reduce_sum(lin(dy.to_variable(np.ones((2, 3),
                                                            np.float32))))
        loss.backward()
        opt.minimize(loss)
        return w0, lin.weight.numpy(), lin.bias.numpy()

    got = _both(run)
    w0, w1, b1 = got["torch"]
    np.testing.assert_array_equal(w1, w0)
    _close(b1, np.full(2, -1.0))
    _close(b1, got["jax"][2])


def _bn_net(dy, layers):
    class Net(dy.Layer):
        def __init__(self):
            super().__init__()
            self.bn = dy.BatchNorm(4)
            self.fc = dy.Linear(4, 2)

        def forward(self, x):
            return self.fc(layers.reshape(self.bn(x), [-1, 4]))

    return Net()


def test_nested_batchnorm_state_dict_roundtrip():
    xv = np.random.default_rng(0).standard_normal(
        (8, 4, 1, 1)).astype(np.float32) * 2 + 3
    with tdy.guard(CPU):
        net = _bn_net(tdy, tlayers)
        net(tdy.to_variable(xv))            # moves the running stats
        state = net.state_dict()
        assert "bn._mean" in state and "bn._variance" in state
        assert abs(state["bn._mean"].mean()) > 1e-3
        net2 = _bn_net(tdy, tlayers)
        net2.set_dict(state)
        for k, v in net2.state_dict().items():
            np.testing.assert_array_equal(v, state[k])
    with jdy.guard():                        # the JAX net's names
        jnet = _bn_net(jdy, jlayers)
        jnet(jdy.to_variable(xv))
        jstate = jnet.state_dict()
    assert sorted(jstate) == sorted(state)
    for k in state:
        _close(state[k], jstate[k], atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_dygraph_loads_across_packages(tmp_path, writer):
    path = str(tmp_path / "model")
    reader = "torch" if writer == "jax" else "jax"
    _, wdy, wlayers = PKGS[writer]
    _, rdy, rlayers = PKGS[reader]
    with _guard(wdy):
        net = _bn_net(wdy, wlayers)
        net(wdy.to_variable(np.ones((4, 4, 1, 1), np.float32)))
        state = net.state_dict()
        wdy.save_dygraph(state, path)
    with _guard(rdy):
        params, opt = rdy.load_dygraph(path)
        assert opt is None
        net2 = _bn_net(rdy, rlayers)
        net2.set_dict(params)
        got = net2.state_dict()
    assert sorted(got) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])


def test_optimizer_state_roundtrip(tmp_path):
    path = str(tmp_path / "opt")
    with tdy.guard(CPU):
        lin = tdy.Linear(3, 2)
        opt = tfluid.optimizer.Adam(0.1, parameter_list=lin.parameters())
        loss = tlayers.reduce_sum(lin(tdy.to_variable(np.ones((2, 3),
                                                              np.float32))))
        loss.backward()
        opt.minimize(loss)
        state = opt.state_dict()
        tdy.save_dygraph(state, path)
        params, opt_state = tdy.load_dygraph(path)
        assert params is None
        opt2 = tfluid.optimizer.Adam(0.1, parameter_list=lin.parameters())
        opt2.set_state_dict(opt_state)
        got = opt2.state_dict()
    keys = sorted(k for k in state if "." in k)
    assert keys == sorted(k for k in got if "." in k) and len(keys) == 8
    for k in keys:
        np.testing.assert_array_equal(got[k], state[k])


def test_functional_layers_work_eagerly():
    xv = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)

    def run(fluid, dy, layers):
        x = dy.to_variable(xv)
        s = layers.softmax(x)
        c = layers.concat([x, x], axis=1)
        t = layers.transpose(x, [1, 0])
        return s.numpy(), c.shape, t.shape

    got = _both(run)
    _close(np.sum(got["torch"][0], -1), np.ones(3))
    _close(got["torch"][0], got["jax"][0])
    assert got["torch"][1] == (3, 8) and got["torch"][2] == (4, 3)


def test_convnet_trains_like_jax():
    """Conv2D + BatchNorm + Pool2D + Linear, 4 Adam steps from the JAX
    net's weights: the port's losses follow the JAX package's."""
    rng = np.random.default_rng(0)
    xv = rng.standard_normal((8, 1, 8, 8)).astype(np.float32)
    yv = rng.integers(0, 10, (8, 1)).astype(np.int64)

    def net_of(dy, layers):
        class Net(dy.Layer):
            def __init__(self):
                super().__init__()
                self.conv = dy.Conv2D(1, 4, 3, padding=1)
                self.bn = dy.BatchNorm(4)
                self.pool = dy.Pool2D(2, "max", 2)
                self.fc = dy.Linear(4 * 4 * 4, 10)

            def forward(self, x):
                h = layers.relu(self.bn(self.conv(x)))
                return self.fc(layers.reshape(self.pool(h), [-1, 64]))

        return Net()

    state = {}

    def run(fluid, dy, layers):
        net = net_of(dy, layers)
        if dy is jdy:
            state.update(net.state_dict())
        else:
            layer_params_from_jax(net, state)
        opt = fluid.optimizer.AdamOptimizer(1e-2,
                                            parameter_list=net.parameters())
        losses = []
        for _ in range(4):
            loss = layers.mean(layers.softmax_with_cross_entropy(
                net(dy.to_variable(xv)), dy.to_variable(yv)))
            loss.backward()
            opt.minimize(loss)
            net.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]))
        return losses

    got = _both(run)
    _close(got["torch"], got["jax"], rtol=1e-4)
    assert got["torch"][-1] < got["torch"][0]


def test_dygraph_grad_equals_static_grad_bitwise():
    """Linear -> relu -> Linear -> mean(square): each dygraph param grad is
    the port's static append_backward grad bit for bit (the tape replays
    the same registered grad lowerings)."""
    xv = np.random.default_rng(3).standard_normal((8, 6)).astype(np.float32)
    with tdy.guard(CPU):
        l1, l2 = tdy.Linear(6, 5, act="relu"), tdy.Linear(5, 3)
        loss = tlayers.mean(tlayers.square(l2(l1(tdy.to_variable(xv)))))
        loss.backward()
        params = {"w1": l1.weight, "b1": l1.bias, "w2": l2.weight,
                  "b2": l2.bias}
        dy_grads = {n: p.gradient() for n, p in params.items()}
        values = {n: p.numpy() for n, p in params.items()}
        dy_loss = loss.numpy()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [8, 6], "float32")
        h = tfluid.layers.fc(x, 5, act="relu",
                             param_attr=tfluid.ParamAttr(name="w1"),
                             bias_attr=tfluid.ParamAttr(name="b1"))
        o = tfluid.layers.fc(h, 3, param_attr=tfluid.ParamAttr(name="w2"),
                             bias_attr=tfluid.ParamAttr(name="b2"))
        sloss = tfluid.layers.mean(tfluid.layers.square(o))
        pgs = tfluid.append_backward(sloss)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for n, v in values.items():
        scope.set(n, torch.from_numpy(v.copy()))
    got = exe.run(main, feed={"x": xv},
                  fetch_list=[sloss] + [g for _, g in pgs], scope=scope)
    np.testing.assert_array_equal(got[0], dy_loss)
    assert [p.name for p, _ in pgs] == ["w1", "b1", "w2", "b2"]
    for (p, _), g in zip(pgs, got[1:]):
        np.testing.assert_array_equal(g, dy_grads[p.name])


def test_parameter_creating_layers_and_grad_clip_raise():
    """``fc`` and complex data raise in dygraph mode; a ``grad_clip``
    is taken and applied by the eager minimize (JAX's
    ``test_dygraph_grad_clip_and_regularization``: a 1e-6 global norm
    leaves the weight where it was)."""
    with tdy.guard(CPU):
        x = tdy.to_variable(np.ones((3, 4), np.float32))
        with pytest.raises(RuntimeError, match="cannot run in dygraph"):
            tlayers.fc(x, 8)
        lin = tdy.Linear(4, 1, bias_attr=False)
        opt = tfluid.optimizer.SGDOptimizer(
            1.0, parameter_list=lin.parameters(),
            grad_clip=tfluid.clip.GradientClipByGlobalNorm(1e-6))
        w0 = lin.weight.numpy().copy()
        tlayers.reduce_sum(lin(tdy.to_variable(
            np.ones((2, 4), np.float32)))).backward()
        opt.minimize(None)
        assert 0 < np.abs(lin.weight.numpy() - w0).max() < 1e-5
        with pytest.raises(NotImplementedError):
            tdy.to_variable(np.ones(2, np.complex64))


def test_guard_without_gpu_raises(monkeypatch):
    """guard() (place None) is the GPU and raises without one: nothing
    drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tdy.guard():
            pass
    assert not tdy.enabled()


@pytest.mark.parametrize("name", [
    "LSTMCell", "GRUCell", "Conv2DTranspose", "GroupNorm", "PRelu",
    "SpectralNorm", "Conv3D", "Conv3DTranspose", "InstanceNorm",
    "BilinearTensorProduct", "GRUUnit", "NCE", "TreeConv",
    "TracedLayer", "declarative", "ProgramTranslator"])
def test_unported_entry_points_raise(name):
    with tdy.guard(CPU):
        with pytest.raises(NotImplementedError):
            getattr(tdy, name)(4)


SCHEDULES = {
    "PiecewiseDecay": (([3, 6], [1.0, 0.5, 0.1]), {}),
    "NaturalExpDecay": ((0.1, 5, 0.5), {"staircase": True}),
    "ExponentialDecay": ((0.1, 5, 0.5), {}),
    "InverseTimeDecay": ((0.1, 5, 0.5), {}),
    "PolynomialDecay": ((0.1, 6), {"cycle": True}),
    "CosineDecay": ((0.1, 2, 4), {}),
    "NoamDecay": ((64, 4), {}),
    "LinearLrWarmup": ((0.1, 4, 0.0, 0.1), {}),
    "LearningRateDecay": None,
    "ReduceLROnPlateau": ((0.1,), {"patience": 1}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedulers_match_jax(name):
    if SCHEDULES[name] is None:       # the base class: step() is abstract
        with pytest.raises(NotImplementedError):
            getattr(tdy, name)()()
        return
    args, kw = SCHEDULES[name]
    j, t = getattr(jdy, name)(*args, **kw), getattr(tdy, name)(*args, **kw)
    if name == "ReduceLROnPlateau":
        got, ref = [], []
        for m in (3.0, 3.0, 3.0, 2.0, 2.0, 2.0, 2.0):
            j.step(m)
            t.step(m)
            got.append(t())
            ref.append(j())
        assert min(got) < 0.1
    else:
        got = [t() for _ in range(12)]
        ref = [j() for _ in range(12)]
    assert got == ref
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("opt_name", ["SGD", "Momentum", "Adam", "AdamW"])
def test_eager_optimizers_match_jax(opt_name):
    """3 eager steps of each ported optimizer (Adam with a NoamDecay
    schedule, a callable learning rate) from the JAX Linear's weights."""
    state = {}
    xv = np.random.default_rng(5).standard_normal((6, 4)).astype("float32")

    def make(fluid, dy, params):
        if opt_name == "SGD":
            return fluid.optimizer.SGD(0.1, parameter_list=params)
        if opt_name == "Momentum":
            return fluid.optimizer.Momentum(0.1, 0.9, use_nesterov=True,
                                            parameter_list=params)
        if opt_name == "Adam":
            return fluid.optimizer.Adam(dy.NoamDecay(16, 2),
                                        parameter_list=params)
        return fluid.optimizer.AdamW(0.05, weight_decay=0.1,
                                     parameter_list=params)

    def run(fluid, dy, layers):
        lin = dy.Linear(4, 3)
        if dy is jdy:
            state.update(lin.state_dict())
        else:
            layer_params_from_jax(lin, state)
        opt = make(fluid, dy, lin.parameters())
        losses = []
        for _ in range(3):
            loss = layers.mean(layers.square(lin(dy.to_variable(xv))))
            loss.backward()
            opt.minimize(loss)
            opt.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]))
        assert lin.weight.gradient() is None
        return losses, lin.weight.numpy(), lin.bias.numpy()

    got = _both(run)
    for a, b in zip(got["torch"], got["jax"]):
        _close(a, b, rtol=1e-5, atol=1e-7)


def test_layer_containers_hooks_and_modes():
    with tdy.guard(CPU):
        seq = tdy.Sequential(tdy.Linear(4, 3), ("act", tdy.Dropout(0.5)),
                             tdy.Linear(3, 2))
        assert len(seq) == 3 and isinstance(seq["act"], tdy.Dropout)
        assert len(seq.parameters()) == 4
        ll = tdy.LayerList([tdy.Linear(2, 2) for _ in range(2)])
        ll.append(tdy.Linear(2, 1))
        assert len(ll) == 3 and len(ll.parameters()) == 6
        pl = tdy.ParameterList([ll[0].weight, ll[1].weight])
        assert len(pl) == 2 and pl[1] is ll[1].weight
        seq.eval()
        assert not seq["act"].training
        x = tdy.to_variable(np.ones((5, 4), np.float32))
        np.testing.assert_array_equal(seq(x).numpy(), seq(x).numpy())
        seq.train()
        assert all(s.training for s in seq.sublayers())

        seen = []
        pre = seq.register_forward_pre_hook(
            lambda layer, inputs: seen.append("pre"))
        post = seq.register_forward_post_hook(
            lambda layer, inputs, out: out * 0.0)
        out = seq(x)
        assert seen == ["pre"] and not out.numpy().any()
        pre.remove()
        post.remove()
        seq.eval()
        assert seq(x).numpy().any() and seen == ["pre"]
        seq.clear_gradients()
        assert all(p.gradient() is None for p in seq.parameters())


def test_enable_disable_dygraph():
    assert not tdy.enabled()
    tdy.enable_dygraph(CPU)
    try:
        assert tdy.enabled() and tdy.in_dygraph_mode()
        v = tdy.to_variable(np.arange(3, dtype=np.float32))
        assert v.value.device.type == "cpu" and v.dtype == "float32"
    finally:
        tdy.disable_dygraph()
    assert not tdy.enabled()
