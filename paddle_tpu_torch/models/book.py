"""The Fluid book's programs (``tests/test_book.py``'s, and chapter 3's
``vgg16_bn_drop`` at the book's width), built through ``layers`` and
``nets`` as the book builds them. Each builder takes the ``fluid``
namespace to build with: the port's, or any package with the same
surface (its tests build the same programs with the JAX package's to
hold the two against each other)."""
import numpy as np


def vgg16_bn_drop(fluid, B, hw, classes):
    """The Fluid book's chapter-3 VGG (``vgg16_bn_drop`` of
    ``test_image_classification.py``) built through ``nets``: (loss,
    feeds)."""
    L, nets = fluid.layers, fluid.nets
    img = L.data("image", [B, 3, hw, hw], "float32")
    label = L.data("label", [B, 1], "int64")

    def conv_block(x, num_filter, groups, dropouts):
        return nets.img_conv_group(
            x, [num_filter] * groups, pool_size=2, pool_stride=2,
            conv_filter_size=3, conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    x = conv_block(img, 64, 2, [0.3, 0])
    x = conv_block(x, 128, 2, [0.4, 0])
    x = conv_block(x, 256, 3, [0.4, 0.4, 0])
    x = conv_block(x, 512, 3, [0.4, 0.4, 0])
    x = conv_block(x, 512, 3, [0.4, 0.4, 0])
    x = L.dropout(x, dropout_prob=0.5)
    x = L.batch_norm(L.fc(x, 512), act="relu")
    x = L.dropout(x, dropout_prob=0.5)
    x = L.fc(x, 512)
    predict = L.fc(x, classes, act="softmax")
    loss = L.mean(L.cross_entropy(predict, label))
    return loss, [img, label]


def _fit_a_line(f):
    L = f.layers
    x = L.data("x", [-1, 13], dtype="float32")
    y = L.data("y", [-1, 1], dtype="float32")
    loss = L.mean(L.square_error_cost(L.fc(x, 1), y))
    f.optimizer.SGD(0.05).minimize(loss)
    return [loss]


def _word2vec_skipgram(f, V=40, E=8, B=32):
    L = f.layers
    c = L.data("c", [B, 1], dtype="int64")
    t = L.data("t", [B, 1], dtype="int64")
    emb = L.reshape(L.embedding(c, size=[V, E]), [B, E])
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(emb, V), t))
    f.optimizer.Adam(0.1).minimize(loss)
    return [loss]


def _word2vec_ngram(f, N=5, V=2073, H=32):
    L = f.layers
    ctx = [L.data(f"w{i}", [-1, 1], dtype="int64") for i in range(N - 1)]
    nxt = L.data("next", [-1, 1], dtype="int64")
    embs = [L.embedding(c, size=[V, H], param_attr=f.ParamAttr(name="emb"))
            for c in ctx]
    hidden = L.fc(L.concat([L.reshape(e, [-1, H]) for e in embs], axis=1),
                  64, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(hidden, V), nxt))
    f.optimizer.Adam(5e-3).minimize(loss)
    return [loss]


def _recommender_two_tower(f, U=30, I=40, E=8, B=16):
    L = f.layers
    u = L.data("u", [B, 1], dtype="int64")
    i = L.data("i", [B, 1], dtype="int64")
    r = L.data("r", [B, 1], dtype="float32")
    ue = L.fc(L.reshape(L.embedding(u, size=[U, E]), [B, E]), E,
              act="relu")
    ie = L.fc(L.reshape(L.embedding(i, size=[I, E]), [B, E]), E,
              act="relu")
    sim = L.reduce_sum(L.elementwise_mul(ue, ie), dim=[1], keep_dim=True)
    loss = L.mean(L.square_error_cost(sim, r))
    f.optimizer.Adam(0.05).minimize(loss)
    return [loss]


def _recognize_digits_conv(f):
    L = f.layers
    img = L.data("img", [-1, 1, 28, 28], dtype="float32")
    label = L.data("label", [-1, 1], dtype="int64")
    c1 = f.nets.simple_img_conv_pool(img, 8, 5, pool_size=2, pool_stride=2,
                                     act="relu")
    c2 = f.nets.simple_img_conv_pool(c1, 16, 5, pool_size=2, pool_stride=2,
                                     act="relu")
    logits = L.fc(c2, 10, act=None)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(L.softmax(logits), label)
    f.optimizer.Adam(2e-3).minimize(loss)
    return [loss, acc]


def _image_classification_vgg(f):
    L = f.layers
    img = L.data("img", [-1, 3, 32, 32], dtype="float32")
    label = L.data("label", [-1, 1], dtype="int64")
    g1 = f.nets.img_conv_group(img, [8, 8], pool_size=2, pool_stride=2,
                               conv_act="relu", conv_with_batchnorm=True)
    g2 = f.nets.img_conv_group(g1, [16, 16], pool_size=2, pool_stride=2,
                               conv_act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(g2, 10), label))
    f.optimizer.Adam(2e-3).minimize(loss)
    return [loss]


def _glu_and_sdpa_nets(f):
    L = f.layers
    xin = L.data("x", [4, 8, 16], dtype="float32")
    yin = L.data("y", [4, 8, 16], dtype="float32")
    g = f.nets.glu(L.fc(xin, 32, num_flatten_dims=2), dim=-1)
    att = f.nets.scaled_dot_product_attention(g, g, g, num_heads=4)
    loss = L.mean(L.square_error_cost(att, yin))
    f.optimizer.Adam(0.02).minimize(loss)
    return [loss]


# the seven tests/test_book.py programs the core layers make buildable,
# built as those tests build them: name -> build(fluid) -> [loss, ...]
# (either package's fluid)
BOOK_BUILDS = {
    "fit_a_line": _fit_a_line,
    "word2vec_skipgram": _word2vec_skipgram,
    "word2vec_ngram": _word2vec_ngram,
    "recommender_two_tower": _recommender_two_tower,
    "recognize_digits_conv": _recognize_digits_conv,
    "image_classification_vgg": _image_classification_vgg,
    "glu_and_sdpa_nets": _glu_and_sdpa_nets,
}


def book_feeds():
    """Seeded feeds of ``BOOK_BUILDS``' programs, of the shapes those
    tests read from the dataset readers."""
    rng = np.random.default_rng(81)
    center = rng.integers(0, 40, (32, 1)).astype(np.int64)
    users = rng.integers(0, 30, (16, 1)).astype(np.int64)
    items = rng.integers(0, 40, (16, 1)).astype(np.int64)
    grams = rng.integers(0, 2073, (512, 5)).astype(np.int64)
    x13 = rng.standard_normal((64, 13)).astype(np.float32)
    return {
        "fit_a_line": {"x": x13, "y": (x13 @ rng.standard_normal(
            (13, 1))).astype(np.float32)},
        "word2vec_skipgram": {"c": center, "t": (center + 1) % 40},
        "word2vec_ngram": dict({f"w{i}": grams[:, i:i + 1]
                                for i in range(4)}, next=grams[:, 4:]),
        "recommender_two_tower": {
            "u": users, "i": items,
            "r": ((users * 7 + items * 3) % 5 / 5.0).astype(np.float32)},
        "recognize_digits_conv": {
            "img": rng.standard_normal((64, 1, 28, 28)).astype(np.float32),
            "label": rng.integers(0, 10, (64, 1)).astype(np.int64)},
        "image_classification_vgg": {
            "img": rng.standard_normal((32, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 10, (32, 1)).astype(np.int64)},
        "glu_and_sdpa_nets": {
            "x": rng.standard_normal((4, 8, 16)).astype(np.float32),
            "y": (rng.standard_normal((4, 8, 16)) * 0.1).astype(
                np.float32)},
    }
