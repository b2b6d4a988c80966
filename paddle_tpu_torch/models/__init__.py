"""Models of the port."""
from .generation import GPTGenerator, length_bucket
from .gpt import GPT, GPTConfig, init_params, param_shapes, params_from_jax

__all__ = ["GPT", "GPTConfig", "GPTGenerator", "init_params",
           "length_bucket", "param_shapes", "params_from_jax"]
