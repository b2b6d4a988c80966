"""LeNet-5 (MNIST) training in the port against the JAX package, on the
CPU, and the port's initializers.

``build_lenet_train`` with Adam (lr 0.001) and with SGD (lr 0.01) in
both packages: the same main and startup programs (``to_dict()``; the
``fc`` weight takes the global default Xavier initializer, the conv
filters their layer's normal), then from the JAX startup's values three
steps on the synthetic digits of ``tests/test_mnist_lenet.py`` (B64,
``img`` declared ``[-1, 1, 28, 28]``) give the same losses and
accuracies (rtol 1e-4) and every param and optimizer state within 1e-4
of its max |ref|. Startup values cannot match JAX's ``threefry`` bit for
bit, so ``uniform_random``, ``XavierInitializer`` and ``MSRAInitializer``
(uniform and normal) are held by distribution: bounds, mean and spread
of a seeded draw."""
import math

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import lenet as jlenet

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import initializer as tinit
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.models import lenet as tlenet

JAX_RNG = "@RNG_KEY@"
LRS = {"adam": 0.001, "sgd": 0.01}


def synthetic_mnist(n, seed=0):
    """Separable synthetic digits: class k lights up a distinct patch."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=(n, 1)).astype("int64")
    imgs = rng.randn(n, 1, 28, 28).astype("float32") * 0.1
    for i, k in enumerate(labels[:, 0]):
        r, c = divmod(int(k), 5)
        imgs[i, 0, r * 10:r * 10 + 8, c * 5:c * 5 + 4] += 1.0
    return imgs, labels


def build(fluid, lenet, opt):
    with fluid.unique_name.guard():
        return lenet.build_lenet_train(lr=LRS[opt], optimizer=opt)


def jax_dict(program):
    d = program.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            assert v.pop("dist_attr") is None
    return d


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_programs_equal_jax(opt):
    jmain, jstart, jfeeds, jfetch = build(jfluid, jlenet, opt)
    tmain, tstart, tfeeds, tfetch = build(tfluid, tlenet, opt)
    assert tfeeds == jfeeds
    assert [v.name for v in tfetch] == [v.name for v in jfetch]
    assert tmain.to_dict() == jax_dict(jmain)
    assert tstart.to_dict() == jax_dict(jstart)
    fc_w = next(op for op in tstart.global_block().ops
                if op.output("Out") == ["fc_0.w_0"])
    limit = math.sqrt(6.0 / (800 + 10))
    assert fc_w.type == "uniform_random"
    assert fc_w.attrs["min"] == pytest.approx(-limit)
    assert fc_w.attrs["max"] == pytest.approx(limit)
    assert tmain.global_block().var("img").shape == (-1, 1, 28, 28)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_three_steps_match_jax(opt):
    jmain, jstart, _, jfetch = build(jfluid, jlenet, opt)
    tmain, tstart, _, tfetch = build(tfluid, tlenet, opt)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    scope_from_arrays(tscope, {n: np.asarray(v) for n, v in jscope.items()
                               if n != JAX_RNG})
    imgs, labels = synthetic_mnist(192)
    losses = []
    for it in range(3):
        feed = {"img": imgs[it * 64:(it + 1) * 64],
                "label": labels[it * 64:(it + 1) * 64]}
        jl, ja = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=jscope)
        tl, ta = texe.run(tmain, feed=feed, fetch_list=tfetch, scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"step {it}")
        np.testing.assert_allclose(ta, ja, rtol=1e-4)
        losses.append(float(tl))
    assert all(np.isfinite(losses))
    names = [n for n in jscope.keys() if n != JAX_RNG]
    assert len(names) == (7 if opt == "sgd" else 31)
    for n in names:
        a = np.asarray(jscope.find_var(n), np.float64)
        b = tscope.find_var(n).double().numpy()
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(a).max(), 1e-30), n


def _draw(init, shape, seed=3):
    """One startup run of ``init`` over a parameter of ``shape``."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        p = main.global_block().create_parameter(
            name="p", shape=shape, dtype="float32")
        init(p)
    startup.random_seed = seed
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    return scope.find_var("p").double().numpy()


CONV = (64, 32, 3, 3)            # fan in 288, fan out 576
INITS = {
    "uniform": (tinit.Uniform(-0.3, 0.7), "uniform", (-0.3, 0.7)),
    "xavier_uniform": (tinit.Xavier(), "uniform",
                       (-math.sqrt(6 / 864), math.sqrt(6 / 864))),
    "xavier_normal": (tinit.Xavier(uniform=False), "normal",
                      (0.0, math.sqrt(2 / 864))),
    "msra_uniform": (tinit.MSRA(), "uniform",
                     (-math.sqrt(6 / 288), math.sqrt(6 / 288))),
    "msra_normal": (tinit.MSRA(uniform=False), "normal",
                    (0.0, math.sqrt(2 / 288))),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_distributions(name):
    init, kind, (a, b) = INITS[name]
    x = _draw(init, CONV)
    n = x.size
    if kind == "uniform":
        assert a <= x.min() and x.max() < b
        mean, std = (a + b) / 2, (b - a) / math.sqrt(12)
    else:
        mean, std = a, b
    # the sample mean within 5 standard errors, the std within 5%
    assert abs(x.mean() - mean) < 5 * std / math.sqrt(n)
    assert x.std() == pytest.approx(std, rel=5e-2)
    assert not np.array_equal(x, _draw(init, CONV, seed=4))
    assert np.array_equal(x, _draw(init, CONV, seed=3))


def test_default_weight_initializer_is_xavier():
    assert isinstance(tinit._global_weight_initializer(),
                      tinit.XavierInitializer)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [-1, 16], "float32")
        tfluid.layers.fc(x, 8)
    ops = startup.global_block().ops
    assert [op.type for op in ops] == ["uniform_random", "fill_constant"]
    assert ops[0].attrs["max"] == pytest.approx(math.sqrt(6 / 24))
