"""Wide&Deep CTR model (a trimmed copy of ``paddle_tpu/models/widedeep.py``;
BASELINE config 4, ``bench.py``'s ``bench_widedeep``): a Criteo-style
click-through-rate model over dense features and sparse slot ids. The
program is op for op the one the JAX package builds.

Each slot id indexes two ``is_sparse`` embedding tables: a deep one
(``embedding_{i}.w``, ``[vocab, embed_dim]``) feeding an MLP of
``hidden_sizes`` with the dense features, and a wide one
(``wide_embedding_{i}.w``, ``[vocab, 1]``) summed with a linear layer
over the dense features. The tables' grads are ``SelectedRows``
(``framework.selected_rows``): the optimizer moves the touched rows
(``sgd``, lazy ``adam``) or densifies them (``adam``, ``momentum``).

The deep tables start from ``Uniform(-1/sqrt(vocab), 1/sqrt(vocab))``,
the wide tables from zeros, the MLP weights from ``Normal(0,
1/sqrt(h))`` of their width, the two output weights from ``Normal(0,
0.01)``, every bias from zeros.
"""
import numpy as np

from .. import layers
from ..framework import initializer as I
from ..layers import math as M
from ..layers import tensor as T
from ..param_attr import ParamAttr
from .params import pick_params


def wide_deep(dense_dim=13, num_slots=26, vocab_size=10000,
              embed_dim=16, hidden_sizes=(400, 400, 400), batch_size=-1,
              table_dist_attr=None):
    """Feeds and forward of the CTR model. Returns dict(dense=,
    sparse=[vars], label=, predict=, loss=). ``table_dist_attr`` (tables
    sharded over a device mesh) is not ported."""
    if table_dist_attr is not None:
        raise NotImplementedError("paddle_tpu_torch: sharded embedding "
                                  "tables (table_dist_attr) are not "
                                  "ported")
    dense = T.data("dense_input", [batch_size, dense_dim], dtype="float32")
    sparse = [T.data(f"C{i}", [batch_size, 1], dtype="int64")
              for i in range(num_slots)]
    label = T.data("label", [batch_size, 1], dtype="int64")

    embs = []
    for i, slot in enumerate(sparse):
        emb = layers.embedding(
            slot, size=[vocab_size, embed_dim], is_sparse=True,
            param_attr=ParamAttr(
                name=f"embedding_{i}.w",
                initializer=I.Uniform(-1.0 / np.sqrt(vocab_size),
                                      1.0 / np.sqrt(vocab_size))))
        embs.append(layers.reshape(emb, [-1, embed_dim]))
    deep = layers.concat(embs + [dense], axis=1)
    for j, h in enumerate(hidden_sizes):
        deep = layers.fc(
            deep, h, act="relu",
            param_attr=ParamAttr(name=f"deep_fc_{j}.w",
                                 initializer=I.Normal(0, 1.0 / np.sqrt(h))),
            bias_attr=ParamAttr(name=f"deep_fc_{j}.b",
                                initializer=I.Constant(0.0)))

    wide_embs = []
    for i, slot in enumerate(sparse):
        w = layers.embedding(
            slot, size=[vocab_size, 1], is_sparse=True,
            param_attr=ParamAttr(name=f"wide_embedding_{i}.w",
                                 initializer=I.Constant(0.0)))
        wide_embs.append(layers.reshape(w, [-1, 1]))
    wide = layers.fc(
        dense, 1,
        param_attr=ParamAttr(name="wide_fc.w",
                             initializer=I.Normal(0, 0.01)),
        bias_attr=ParamAttr(name="wide_fc.b",
                            initializer=I.Constant(0.0)))
    wide = M.sums([wide] + wide_embs)

    logits = M.elementwise_add(
        layers.fc(deep, 1,
                  param_attr=ParamAttr(name="deep_out.w",
                                       initializer=I.Normal(0, 0.01)),
                  bias_attr=ParamAttr(name="deep_out.b",
                                      initializer=I.Constant(0.0))),
        wide)
    predict = layers.sigmoid(logits)
    loss = M.mean(layers.sigmoid_cross_entropy_with_logits(
        logits, T.cast(label, "float32")))
    return {"dense": dense, "sparse": sparse, "label": label,
            "predict": predict, "loss": loss}


def random_batch(batch_size, dense_dim=13, num_slots=26, vocab_size=10000,
                 rng=None):
    """A seeded batch: normal dense features, uniform slot ids, and a
    click label that is slot 0's id parity (learnable)."""
    rng = rng or np.random.default_rng(0)
    feed = {"dense_input": rng.standard_normal(
        (batch_size, dense_dim)).astype(np.float32)}
    for i in range(num_slots):
        feed[f"C{i}"] = rng.integers(0, vocab_size,
                                     (batch_size, 1)).astype(np.int64)
    feed["label"] = (feed["C0"] % 2).astype(np.int64)
    return feed


def param_shapes(dense_dim=13, num_slots=26, vocab_size=10000,
                 embed_dim=16, hidden_sizes=(400, 400, 400)):
    """{parameter name: shape} of :func:`wide_deep`'s program."""
    shapes = {}
    for i in range(num_slots):
        shapes[f"embedding_{i}.w"] = (vocab_size, embed_dim)
    width = num_slots * embed_dim + dense_dim
    for j, h in enumerate(hidden_sizes):
        shapes[f"deep_fc_{j}.w"] = (width, h)
        shapes[f"deep_fc_{j}.b"] = (h,)
        width = h
    for i in range(num_slots):
        shapes[f"wide_embedding_{i}.w"] = (vocab_size, 1)
    shapes["wide_fc.w"] = (dense_dim, 1)
    shapes["wide_fc.b"] = (1,)
    shapes["deep_out.w"] = (width, 1)
    shapes["deep_out.b"] = (1,)
    return shapes


def params_from_jax(arrays, **config):
    """``{JAX scope name: array}`` -> ``{name: float32 CPU tensor}`` for
    the names of :func:`param_shapes` (``config``: its arguments; other
    scope state, such as the optimizer's, is left out); raises on a
    missing or mis-shaped name."""
    return pick_params(arrays, param_shapes(**config), "Wide&Deep")


__all__ = ["param_shapes", "params_from_jax", "random_batch", "wide_deep"]
