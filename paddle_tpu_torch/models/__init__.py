"""Models of the port: GPT (training and generation), BERT
(pretraining, ``models.bert``), ResNet (``models.resnet``), LeNet
(``models.lenet``) and Wide&Deep (``models.widedeep``)."""
from . import bert, lenet, resnet, widedeep
from .generation import GPTGenerator, length_bucket
from .gpt import GPT, GPTConfig, init_params, param_shapes, params_from_jax

__all__ = ["GPT", "GPTConfig", "GPTGenerator", "bert", "init_params",
           "length_bucket", "lenet", "param_shapes", "params_from_jax",
           "resnet", "widedeep"]
