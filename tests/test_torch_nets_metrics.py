"""The port's ``nets`` (two SGD steps of each net), the Bilinear and
NumpyArray initializers, the random layers and ``fluid.metrics``,
against the JAX package on the CPU: the nets and initializers through
``torch_pair.run_pair`` (fetches within 1e-5 of max |ref|), the random
layers by shape and range, the metrics against the JAX classes on the
same numpy batches."""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import metrics as jmetrics

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import metrics as tmetrics

from test_torch_layers_surface import FEED_IMG, SEQ, _img
from torch_pair import assert_pair, run_pair


def _sgd(f, loss):
    f.optimizer.SGD(0.05).minimize(loss)
    return [loss]


NETS = {
    "simple_img_conv_pool": (lambda f: _sgd(f, f.layers.mean(
        f.nets.simple_img_conv_pool(_img(f), 4, 3, 2, 2, act="relu")))),
    "img_conv_group": (lambda f: _sgd(f, f.layers.mean(
        f.nets.img_conv_group(_img(f), [4, 4], 2, conv_act="relu",
                              conv_with_batchnorm=True, pool_stride=2)))),
    "sequence_conv_pool": (lambda f: _sgd(f, f.layers.mean(
        f.nets.sequence_conv_pool(
            f.layers.data("seq", [3, 5, 8], "float32"), 6, 3,
            length=f.layers.data("len", [3], "int64"))))),
    "glu_sdpa": (lambda f: _sgd(f, f.layers.mean(
        f.nets.scaled_dot_product_attention(
            *[f.nets.glu(f.layers.fc(
                f.layers.data("seq", [3, 5, 8], "float32"), 16,
                num_flatten_dims=2), dim=-1)] * 3, num_heads=2)))),
}
NET_FEED = dict(FEED_IMG, seq=SEQ, len=np.array([5, 3, 1], np.int64))


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_trains_as_jax(name):
    out, _, _ = run_pair(NETS[name], NET_FEED, steps=2)
    assert_pair(out, what=name)


def test_initializers_match_jax():
    def build(f):
        I = f.initializer
        w = f.layers.create_parameter(
            [2, 3, 4, 4], "float32", name="bil",
            default_initializer=I.Bilinear())
        a = f.layers.create_parameter(
            [2, 3], "float32", name="arr",
            default_initializer=I.NumpyArrayInitializer(
                np.arange(6, dtype=np.float32).reshape(2, 3)))
        return [f.layers.scale(w, 1.0), f.layers.scale(a, 1.0)]
    out, _, _ = run_pair(build)
    assert_pair(out, what="initializers")


@pytest.mark.parametrize("layer,kw", [
    ("uniform_random", dict(shape=[50, 40], min=2.0, max=3.0)),
    ("gaussian_random", dict(shape=[50, 40], mean=1.0, std=0.5)),
    ("uniform_random_batch_size_like", dict(shape=[-1, 40], min=-1.0,
                                            max=0.0)),
    ("gaussian_random_batch_size_like", dict(shape=[-1, 40], std=2.0))])
def test_random_layers_shape_and_range(layer, kw):
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            fn = getattr(fluid.layers, layer)
            if layer.endswith("batch_size_like"):
                v = fn(fluid.layers.data("r", [50, 2], "float32"), **kw)
            else:
                v = fn(**kw)
        exe = fluid.Executor() if fluid is jfluid else fluid.Executor(
            fluid.CPUPlace())
        got, = exe.run(main, feed={"r": np.zeros((50, 2), np.float32)},
                       fetch_list=[v])
        got = np.asarray(got)
        assert got.shape == (50, 40)
        if "min" in kw:
            assert kw["min"] <= got.min() and got.max() < kw["max"]
        else:
            assert abs(got.std() - kw["std"]) < 0.1 * kw["std"]


# ---- fluid.metrics --------------------------------------------------------

def _metric_runs(mod):
    rng = np.random.default_rng(7)
    preds = [rng.random((16, 1)) for _ in range(3)]
    labels = [(rng.random((16, 1)) < 0.5).astype(np.int64)
              for _ in range(3)]
    out = {}
    for name, cls in (("precision", mod.Precision), ("recall", mod.Recall)):
        m = cls()
        for p, lab in zip(preds, labels):
            m.update(p, lab)
        out[name] = m.eval()
    comp = mod.CompositeMetric()
    comp.add_metric(mod.Precision())
    comp.add_metric(mod.Recall())
    for p, lab in zip(preds, labels):
        comp.update(p, lab)
    out["composite"] = comp.eval()
    acc = mod.Accuracy()
    for v, w in ((0.5, 10), (np.float32(0.8), 6)):
        acc.update(v, w)
    out["accuracy"] = acc.eval()
    ck = mod.ChunkEvaluator()
    for counts in ((5, 6, 4), (np.array([2]), np.array([3]),
                               np.array([1]))):
        ck.update(*counts)
    out["chunk"] = ck.eval()
    ed = mod.EditDistance()
    ed.update(np.array([0.0, 2.0, 1.0]), 3)
    ed.update(np.array([3.0]), 1)
    out["edit"] = ed.eval()
    auc = mod.Auc(num_thresholds=63)
    for p, lab in zip(preds, labels):
        auc.update(np.concatenate([1 - p, p], 1), lab)
    out["auc"] = auc.eval()
    auc.reset()
    out["auc_reset"] = auc.eval()
    acc.reset()
    out["acc_reset"] = (acc.value, acc.weight)
    return out


def test_metrics_match_jax():
    j, t = _metric_runs(jmetrics), _metric_runs(tmetrics)
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_allclose(np.asarray(t[k], np.float64),
                                   np.asarray(j[k], np.float64),
                                   rtol=1e-12, err_msg=k)


def test_metrics_raise_as_jax():
    for mod in (jmetrics, tmetrics):
        with pytest.raises(ValueError, match="no data"):
            mod.Accuracy().eval()
        with pytest.raises(ValueError, match="numpy"):
            mod.Precision().update([1, 0], np.array([1, 0]))
    with pytest.raises(NotImplementedError, match="item 10"):
        tmetrics.DetectionMAP(None, None, None, class_num=3)


# ---- the top-level fluid names --------------------------------------------

TOP = ["nets", "metrics", "tensor", "embedding", "one_hot", "backward",
       "Variable", "Parameter", "Block", "Operator", "VarBase",
       "in_dygraph_mode", "enable_dygraph", "disable_dygraph", "name_scope",
       "grad_var_name", "convert_dtype", "switch_main_program",
       "switch_startup_program", "register_op", "register_grad_lower",
       "require_version", "is_compiled_with_cuda", "device_count",
       "CUDAPinnedPlace", "cuda_pinned_places", "NonFiniteError",
       "CheckpointCorruptError", "EnforceNotMet", "OpRole", "passes",
       "learning_rate_decay"]


def test_top_level_names_behave_as_jax():
    for name in TOP:
        assert hasattr(jfluid, name) and hasattr(tfluid, name), name
    for f in (jfluid, tfluid):
        assert f.grad_var_name("w") == "w@GRAD"
        assert f.convert_dtype("float") == "float32"
        assert repr(f.CUDAPinnedPlace()) == "CUDAPinnedPlace"
        assert len(f.cuda_pinned_places(3)) == 3
        assert issubclass(f.NonFiniteError, f.EnforceNotMet)
        f.require_version("0.0.1")
        with pytest.raises(Exception, match="lower than"):
            f.require_version("99.0")
        assert not f.in_dygraph_mode()
        f.enable_dygraph(f.CPUPlace())
        assert f.in_dygraph_mode()
        f.disable_dygraph()
        assert not f.in_dygraph_mode()
        main = f.Program()
        with f.program_guard(main, f.Program()), f.unique_name.guard(), \
                f.name_scope("enc"):
            v = f.layers.fc(f.layers.data("x", [2, 3], "float32"), 4)
        assert v.name.startswith("enc/")
        assert isinstance(main.global_block(), f.Block)
        assert isinstance(main.global_block().ops[0], f.Operator)
        assert all(isinstance(p, f.Parameter) for p in main.all_parameters())
        assert isinstance(v, f.Variable)
        old = f.switch_main_program(main)
        assert f.default_main_program() is main
        f.switch_main_program(old)
    assert isinstance(tfluid.is_compiled_with_cuda(), bool)
    assert isinstance(tfluid.device_count(), int)
    assert tfluid.register_op is \
        tfluid.framework.registry.register_op
