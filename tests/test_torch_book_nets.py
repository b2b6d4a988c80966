"""The three Fluid book programs of ``tests/test_book.py`` built from the
port's ``nets`` (``recognize_digits_conv``, ``image_classification_vgg``,
``glu_and_sdpa_nets``), 3 steps against the JAX package from one
startup, as ``test_torch_book.py`` runs the other four."""
import pytest

from test_torch_book import trains_as_jax


@pytest.mark.parametrize("name", ["recognize_digits_conv",
                                  "image_classification_vgg",
                                  "glu_and_sdpa_nets"])
def test_book_nets_model_trains_as_jax(name):
    trains_as_jax(name)
