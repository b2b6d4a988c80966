"""Models of the port: GPT (training and generation) and BERT
(pretraining, ``models.bert``)."""
from . import bert
from .generation import GPTGenerator, length_bucket
from .gpt import GPT, GPTConfig, init_params, param_shapes, params_from_jax

__all__ = ["GPT", "GPTConfig", "GPTGenerator", "bert", "init_params",
           "length_bucket", "param_shapes", "params_from_jax"]
