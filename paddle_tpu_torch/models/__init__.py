"""Models of the port: GPT (training and generation), BERT
(pretraining, ``models.bert``), ResNet (``models.resnet``) and LeNet
(``models.lenet``)."""
from . import bert, lenet, resnet
from .generation import GPTGenerator, length_bucket
from .gpt import GPT, GPTConfig, init_params, param_shapes, params_from_jax

__all__ = ["GPT", "GPTConfig", "GPTGenerator", "bert", "init_params",
           "length_bucket", "lenet", "param_shapes", "params_from_jax",
           "resnet"]
