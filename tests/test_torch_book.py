"""The Fluid book programs of ``tests/test_book.py`` that the port's core
layer surface makes buildable, built with the port's ``layers``/``nets``
by ``paddle_tpu_torch.models.book.BOOK_BUILDS`` (as those tests build
them) and trained 3 steps from the JAX startup's values (``torch_pair.run_pair``): every
step's loss (and the digits model's accuracy) within 1e-5 of max |ref|
of the JAX package's. The data come from the JAX package's synthetic
dataset readers (``paddle_tpu.dataset``), the image batches cut to 16
rows. This file holds the four without a conv; ``test_torch_book_nets.py``
the three built from ``nets``."""
import numpy as np
import pytest

from paddle_tpu_torch.models.book import BOOK_BUILDS
from torch_pair import assert_pair, run_pair


def _batch(reader, n, fields):
    rows = []
    for sample in reader():
        rows.append(sample)
        if len(rows) == n:
            break
    return {name: np.stack([np.asarray(r[i]) for r in rows]).astype(
        np.asarray(rows[0][i]).dtype) for i, name in enumerate(fields)}


def _images(reader, shape):
    feed = _batch(reader, 16, ["img", "label"])
    return {"img": feed["img"].reshape((-1,) + shape),
            "label": feed["label"].reshape(-1, 1).astype(np.int64)}


def feed_of(name):
    """The model's feed as its ``tests/test_book.py`` case reads it."""
    from paddle_tpu.dataset import cifar, imikolov, mnist, uci_housing
    if name == "fit_a_line":
        return _batch(uci_housing.train(), 64, ["x", "y"])
    if name == "word2vec_skipgram":
        center = np.random.default_rng(1).integers(0, 40, (32, 1)).astype(
            np.int64)
        return {"c": center, "t": (center + 1) % 40}
    if name == "word2vec_ngram":
        grams = []
        for g in imikolov.train(n=5)():
            grams.append(g)
            if len(grams) >= 512:
                break
        grams = np.asarray(grams, np.int64)
        return dict({f"w{i}": grams[:, i:i + 1] for i in range(4)},
                    next=grams[:, -1:])
    if name == "recommender_two_tower":
        rng = np.random.default_rng(2)
        users = rng.integers(0, 30, (16, 1)).astype(np.int64)
        items = rng.integers(0, 40, (16, 1)).astype(np.int64)
        return {"u": users, "i": items,
                "r": ((users * 7 + items * 3) % 5 / 5.0).astype(np.float32)}
    if name == "recognize_digits_conv":
        return _images(mnist.train(), (1, 28, 28))
    if name == "image_classification_vgg":
        return _images(cifar.train10(), (3, 32, 32))
    rng = np.random.default_rng(5)
    return {"x": rng.standard_normal((4, 8, 16)).astype(np.float32),
            "y": (rng.standard_normal((4, 8, 16)) * 0.1).astype(np.float32)}


def trains_as_jax(name):
    out, _, _ = run_pair(BOOK_BUILDS[name], feed_of(name), steps=3)
    assert_pair(out, what=name)
    losses = [float(np.asarray(s[0]).reshape(-1)[0]) for s in out["port"]]
    assert np.isfinite(losses).all(), losses


@pytest.mark.parametrize("name", ["fit_a_line", "word2vec_skipgram",
                                  "word2vec_ngram",
                                  "recommender_two_tower"])
def test_book_model_trains_as_jax(name):
    trains_as_jax(name)
