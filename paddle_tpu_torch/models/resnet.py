"""ResNet family (a trimmed copy of ``paddle_tpu/models/resnet.py``;
BASELINE config 2, ``bench.py``'s ``bench_resnet50``): the classic fluid
image-classification ResNet, conv_bn stacks and bottleneck (50/101/152)
or basic (18/34) blocks, built on the layers API, so it runs the
``conv2d``, ``batch_norm`` and ``pool2d`` lowerings. The program is op
for op the one the JAX package builds.

Conv filters start from ``MSRA(uniform=False)`` (a normal of std
sqrt(2 / fan_in)), batch-norm scales from ones and offsets from zeros,
the moving mean and variance from zeros and ones, and the classifier
from ``Uniform(-1/sqrt(C), 1/sqrt(C))`` over its C input channels.
"""
import math

import numpy as np
import torch

from .. import layers
from ..framework import initializer as I
from ..layers import math as M
from ..layers import tensor as T
from ..param_attr import ParamAttr
from .params import pick_params

DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}
BASE_FILTERS = (64, 128, 256, 512)
BN_SUFFIXES = ("_bn_scale", "_bn_offset", "_bn_mean", "_bn_variance")


def conv_bn_layer(x, num_filters, filter_size, stride=1, groups=1, act=None,
                  name=None, is_test=False):
    conv = layers.conv2d(
        x, num_filters, filter_size, stride=stride,
        padding=(filter_size - 1) // 2, groups=groups,
        param_attr=ParamAttr(name=name + "_weights",
                             initializer=I.MSRAInitializer(uniform=False)),
        bias_attr=False, name=name)
    return layers.batch_norm(
        conv, act=act, is_test=is_test,
        param_attr=ParamAttr(name=name + "_bn_scale",
                             initializer=I.Constant(1.0)),
        bias_attr=ParamAttr(name=name + "_bn_offset",
                            initializer=I.Constant(0.0)),
        moving_mean_name=name + "_bn_mean",
        moving_variance_name=name + "_bn_variance")


def shortcut(x, ch_out, stride, name, is_test=False):
    ch_in = x.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(x, ch_out, 1, stride, name=name,
                             is_test=is_test)
    return x


def bottleneck_block(x, num_filters, stride, name, is_test=False):
    conv0 = conv_bn_layer(x, num_filters, 1, act="relu",
                          name=name + "_branch2a", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          name=name + "_branch2b", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1,
                          name=name + "_branch2c", is_test=is_test)
    short = shortcut(x, num_filters * 4, stride, name=name + "_branch1",
                     is_test=is_test)
    return layers.relu(M.elementwise_add(short, conv2))


def basic_block(x, num_filters, stride, name, is_test=False):
    conv0 = conv_bn_layer(x, num_filters, 3, stride=stride, act="relu",
                          name=name + "_branch2a", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3,
                          name=name + "_branch2b", is_test=is_test)
    short = shortcut(x, num_filters, stride, name=name + "_branch1",
                     is_test=is_test)
    return layers.relu(M.elementwise_add(short, conv1))


def _blocks(depth):
    """(block name, filters, stride) of every residual block."""
    _, counts = DEPTH_CFG[depth]
    for stage, count in enumerate(counts):
        for blk in range(count):
            yield (f"res{stage + 2}{chr(ord('a') + blk)}",
                   BASE_FILTERS[stage], 2 if stage > 0 and blk == 0 else 1)


def resnet(x, depth=50, class_dim=1000, is_test=False):
    """x: [N, 3, H, W] -> logits [N, class_dim]."""
    block_fn = bottleneck_block if DEPTH_CFG[depth][0] == "bottleneck" \
        else basic_block
    h = conv_bn_layer(x, 64, 7, stride=2, act="relu", name="conv1",
                      is_test=is_test)
    h = layers.pool2d(h, pool_size=3, pool_type="max", pool_stride=2,
                      pool_padding=1)
    for name, filters, stride in _blocks(depth):
        h = block_fn(h, filters, stride=stride, name=name, is_test=is_test)
    h = layers.pool2d(h, pool_type="avg", global_pooling=True)
    h = layers.flatten(h, axis=1)
    stdv = 1.0 / np.sqrt(h.shape[1])
    return layers.fc(
        h, class_dim,
        param_attr=ParamAttr(name="fc_0.w_0",
                             initializer=I.Uniform(-stdv, stdv)),
        bias_attr=ParamAttr(name="fc_0.b_0", initializer=I.Constant(0.0)))


def resnet_train_program(depth=50, class_dim=1000, image_shape=(3, 224, 224),
                         batch_size=32):
    """The classification training graph: feeds ``image`` and ``label``
    -> ``loss`` (mean softmax cross-entropy), ``acc`` (top-1) and
    ``logits``; the caller adds the optimizer."""
    img = T.data("image", [batch_size, *image_shape], dtype="float32")
    label = T.data("label", [batch_size, 1], dtype="int64")
    logits = resnet(img, depth=depth, class_dim=class_dim)
    loss = M.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return {"image": img, "label": label, "loss": loss, "acc": acc,
            "logits": logits}


# --------------------------------------------------------------- parameters

def param_shapes(depth=50, class_dim=1000, in_channels=3):
    """``{name: shape}`` of :func:`resnet`'s parameters and batch-norm
    state: each conv's ``<name>_weights`` and its batch norm's scale,
    offset, moving mean and variance, and ``fc_0``."""
    shapes = {}

    def conv_bn(name, cin, cout, k):
        shapes[name + "_weights"] = (cout, cin, k, k)
        for suffix in BN_SUFFIXES:
            shapes[name + suffix] = (cout,)

    bottleneck = DEPTH_CFG[depth][0] == "bottleneck"
    conv_bn("conv1", in_channels, 64, 7)
    cin = 64
    for name, nf, stride in _blocks(depth):
        if bottleneck:
            conv_bn(name + "_branch2a", cin, nf, 1)
            conv_bn(name + "_branch2b", nf, nf, 3)
            conv_bn(name + "_branch2c", nf, nf * 4, 1)
            cout = nf * 4
        else:
            conv_bn(name + "_branch2a", cin, nf, 3)
            conv_bn(name + "_branch2b", nf, nf, 3)
            cout = nf
        if cin != cout or stride != 1:
            conv_bn(name + "_branch1", cin, cout, 1)
        cin = cout
    shapes["fc_0.w_0"] = (cin, class_dim)
    shapes["fc_0.b_0"] = (class_dim,)
    return shapes


def params_from_jax(arrays, depth=50, class_dim=1000):
    """``{JAX scope name: array}`` -> ``{name: float32 CPU tensor}`` for
    the names of :func:`param_shapes` (other scope state, such as the
    optimizer's, is left out); raises on a missing or mis-shaped
    name."""
    return pick_params(arrays, param_shapes(depth, class_dim),
                       f"ResNet-{depth}")


def init_params(depth=50, class_dim=1000, seed=0):
    """Seeded random parameters with the startup program's initializers
    (see the module note). Float32 CPU tensors."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, shape in param_shapes(depth, class_dim).items():
        if name.endswith("_weights"):
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            t = torch.randn(shape, generator=gen) * std
        elif name == "fc_0.w_0":
            stdv = 1.0 / math.sqrt(shape[0])
            t = torch.rand(shape, generator=gen) * (2 * stdv) - stdv
        elif name.endswith(("_bn_scale", "_bn_variance")):
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        out[name] = t
    return out
