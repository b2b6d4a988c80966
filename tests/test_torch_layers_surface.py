"""Every layer that the port's core layer surface adds
(``layers.tensor``, ``layers.nn``, ``layers.math``, ``layers.loss``, the
top-level ``fluid.one_hot``/``fluid.embedding``/``fluid.tensor``)
through ``torch_pair.run_pair``: one program built by both packages,
run from the JAX startup's values, fetches within 1e-5 of max |ref|
(integers exactly). ``test_torch_nets_metrics.py`` holds the nets, the
initializers, the random layers and ``fluid.metrics``."""
import numpy as np
import pytest

from torch_pair import assert_pair, run_pair

RNG = np.random.default_rng(4)
X = RNG.standard_normal((4, 6)).astype(np.float32)
IMG = RNG.standard_normal((2, 3, 8, 8)).astype(np.float32)
IDS = np.array([[1], [3], [0], [2]], np.int64)
SEQ = RNG.standard_normal((3, 5, 8)).astype(np.float32)


def _x(f, shape=(4, 6), name="x", dtype="float32"):
    return f.layers.data(name, list(shape), dtype)


def _img(f):
    return f.layers.data("img", [2, 3, 8, 8], "float32")


FEED_X = {"x": X}
FEED_IMG = {"img": IMG}

# name -> (build(fluid) -> fetch list, feed)
LAYERS = {
    # layers.tensor
    "zeros_ones": (lambda f: [f.layers.zeros([2, 3], "float32"),
                              f.layers.ones([3], "int32")], {}),
    "zeros_like": (lambda f: [f.layers.zeros_like(_x(f))], FEED_X),
    "create_tensor": (lambda f: [f.layers.assign(
        _x(f), f.layers.create_tensor("float32"))], FEED_X),
    "shape": (lambda f: [f.layers.shape(_x(f))], FEED_X),
    "split": (lambda f: f.layers.split(_x(f), 3, dim=1)
              + f.layers.split(_x(f), [1, 3], dim=0), FEED_X),
    "one_hot": (lambda f: [f.layers.one_hot(_x(f, (4, 1), "ids", "int64"),
                                            5)], {"ids": IDS}),
    "range_arange": (lambda f: [f.layers.range(0, 7, 2, "int32"),
                                f.layers.arange(5, dtype="float32")], {}),
    "linspace": (lambda f: [f.layers.linspace(-1.0, 2.0, 7)], {}),
    "diag_tril_triu": (lambda f: [
        f.layers.diag(f.layers.reduce_sum(_x(f), dim=[1])),
        f.layers.tril(_x(f), 1), f.layers.triu(_x(f), -1)], FEED_X),
    "argsort_argmin": (lambda f: list(f.layers.argsort(_x(f), axis=1,
                                                       descending=True))
                       + [f.layers.argmin(_x(f), axis=1)], FEED_X),
    "cumsum": (lambda f: [f.layers.cumsum(_x(f), axis=0)], FEED_X),
    "gather_nd_scatter": (lambda f: [
        f.layers.gather_nd(_x(f), f.layers.assign(
            np.array([[1, 2], [3, 0]], np.int64))),
        f.layers.scatter(_x(f), f.layers.assign(np.array([2, 0], np.int64)),
                         f.layers.assign(np.ones((2, 6), np.float32)))],
        FEED_X),
    "unstack": (lambda f: f.layers.unstack(_x(f), axis=0), FEED_X),
    "fill_constant_batch_size_like": (lambda f: [
        f.layers.fill_constant_batch_size_like(_x(f), [-1, 3], "float32",
                                               1.5)], FEED_X),
    # layers.nn: activations
    "activations": (lambda f: [
        f.layers.gelu(_x(f)), f.layers.gelu(_x(f), approximate=True),
        f.layers.elu(_x(f), 0.7), f.layers.leaky_relu(_x(f), 0.1),
        f.layers.relu6(_x(f) * 4), f.layers.selu(_x(f)),
        f.layers.softplus(_x(f)), f.layers.softsign(_x(f)),
        f.layers.swish(_x(f), 1.5), f.layers.hard_sigmoid(_x(f)),
        f.layers.hard_swish(_x(f) * 3), f.layers.logsigmoid(_x(f)),
        f.layers.brelu(_x(f), -0.5, 0.5), f.layers.stanh(_x(f)),
        f.layers.erf(_x(f)), f.layers.sin(_x(f)), f.layers.round(_x(f))],
        FEED_X),
    "maxout": (lambda f: [f.layers.maxout(
        f.layers.data("m", [2, 4, 3, 3], "float32"), 2)],
               {"m": RNG.standard_normal((2, 4, 3, 3)).astype(np.float32)}),
    "l2_normalize_label_smooth": (lambda f: [
        f.layers.l2_normalize(_x(f), axis=1),
        f.layers.label_smooth(f.layers.softmax(_x(f)), epsilon=0.2)],
        FEED_X),
    "pad_reverse_slice_expand": (lambda f: [
        f.layers.pad(_x(f), [1, 0, 0, 2], 0.5),
        f.layers.reverse(_x(f), [0, 1]),
        f.layers.strided_slice(_x(f), [1], [5], [0], [-2]),
        f.layers.expand_as(f.layers.data("s", [1, 6], "float32"), _x(f))],
        dict(FEED_X, s=X[:1])),
    "image_layers": (lambda f: [
        f.layers.pad2d(_img(f), [1, 0, 2, 1], mode="reflect"),
        f.layers.image_resize(_img(f), [5, 11]),
        f.layers.resize_bilinear(_img(f), scale=0.5),
        f.layers.resize_nearest(_img(f), [12, 3]),
        f.layers.image_resize_short(f.layers.slice(
            _img(f), [3], [0], [6]), 4),
        f.layers.pixel_shuffle(f.layers.data("p", [1, 8, 2, 3],
                                             "float32"), 2),
        f.layers.space_to_depth(_img(f), 2),
        f.layers.unfold(_img(f), 3, strides=2, paddings=1)],
        dict(FEED_IMG, p=RNG.standard_normal((1, 8, 2, 3)).astype(
            np.float32))),
    "resize_trilinear": (lambda f: [f.layers.resize_trilinear(
        f.layers.data("v", [1, 2, 3, 4, 5], "float32"), [4, 6, 3])],
        {"v": RNG.standard_normal((1, 2, 3, 4, 5)).astype(np.float32)}),
    "mul_bmm": (lambda f: [
        f.layers.mul(_x(f), f.layers.assign(np.ones((6, 2), np.float32))),
        f.layers.bmm(f.layers.data("a", [2, 3, 4], "float32"),
                     f.layers.data("b", [2, 4, 5], "float32"))],
        dict(FEED_X, a=RNG.standard_normal((2, 3, 4)).astype(np.float32),
             b=RNG.standard_normal((2, 4, 5)).astype(np.float32))),
    "auc": (lambda f: [f.layers.auc(
        f.layers.softmax(_x(f, (4, 2))), _x(f, (4, 1), "l", "int64"),
        num_thresholds=31)[0]],
        {"x": X[:, :2], "l": np.array([[1], [0], [1], [0]], np.int64)}),
    # layers.math
    "math": (lambda f: [
        f.layers.reduce_prod(_x(f), dim=[1]),
        f.layers.reduce_all(f.layers.greater_than(
            _x(f), f.layers.fill_constant([1], "float32", -1.0)), dim=[0]),
        f.layers.reduce_any(f.layers.greater_than(
            _x(f), f.layers.fill_constant([1], "float32", 1.0))),
        f.layers.elementwise_floordiv(
            _x(f, (3,), "i", "int32"), _x(f, (3,), "j", "int32")),
        f.layers.elementwise_mod(
            _x(f, (3,), "i", "int32"), _x(f, (3,), "j", "int32")),
        f.layers.logical_xor(
            f.layers.greater_than(_x(f), f.layers.fill_constant(
                [1], "float32", 0.0)),
            f.layers.less_than(_x(f), f.layers.fill_constant(
                [1], "float32", 0.5))),
        f.layers.sum([_x(f), _x(f)])],
        dict(FEED_X, i=np.array([7, -7, 5], np.int32),
             j=np.array([2, 3, -3], np.int32))),
    # layers.loss
    "losses": (lambda f: [
        f.layers.mse_loss(_x(f), _x(f, name="y")),
        f.layers.huber_loss(_x(f), _x(f, name="y"), 0.5),
        f.layers.smooth_l1(_x(f), _x(f, name="y"), sigma=2.0),
        f.layers.log_loss(f.layers.sigmoid(_x(f, (4, 1))),
                          f.layers.data("t", [4, 1], "float32")),
        f.layers.kldiv_loss(f.layers.log_softmax(_x(f)),
                            f.layers.softmax(_x(f, name="y")),
                            reduction="batchmean")],
        dict(FEED_X, y=RNG.standard_normal((4, 6)).astype(np.float32),
             t=np.array([[1], [0], [0], [1]], np.float32))),
    # top level
    "fluid_one_hot_embedding": (lambda f: [
        f.one_hot(_x(f, (4, 1), "ids", "int64"), 4),
        f.embedding(_x(f, (4, 1), "ids", "int64"), size=[5, 3])],
        {"ids": IDS}),
    "fluid_tensor": (lambda f: [
        f.tensor.add(_x(f), _x(f)), f.tensor.prod(_x(f), dim=[0]),
        f.tensor.max(_x(f)), f.tensor.linspace(0.0, 1.0, 3)], FEED_X),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    build, feed = LAYERS[name]
    out, _, _ = run_pair(build, feed)
    assert_pair(out, what=name)
