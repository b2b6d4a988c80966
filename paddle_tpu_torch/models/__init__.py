"""Models of the port: GPT (training and generation), BERT
(pretraining, ``models.bert``; dygraph, ``models.bert_dygraph``), ResNet
(``models.resnet``), LeNet (``models.lenet``), Wide&Deep
(``models.widedeep``) and the dygraph Transformer
(``models.transformer``)."""
from . import bert, bert_dygraph, lenet, resnet, transformer, widedeep
from .generation import GPTGenerator, length_bucket
from .gpt import GPT, GPTConfig, init_params, param_shapes, params_from_jax
from .params import layer_params_from_jax

__all__ = ["GPT", "GPTConfig", "GPTGenerator", "bert", "bert_dygraph",
           "init_params", "layer_params_from_jax", "length_bucket", "lenet",
           "param_shapes", "params_from_jax", "resnet", "transformer",
           "widedeep"]
