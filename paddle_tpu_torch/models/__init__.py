"""Models of the port: GPT (training and generation), BERT
(pretraining, ``models.bert``; dygraph, ``models.bert_dygraph``), ResNet
(``models.resnet``), LeNet (``models.lenet``), Wide&Deep
(``models.widedeep``), the dygraph Transformer (``models.transformer``)
and the GRU seq2seq (``models.seq2seq``)."""
from . import (bert, bert_dygraph, lenet, resnet, seq2seq,  # noqa: F401
               transformer, widedeep)
from .generation import GPTGenerator, length_bucket
from .gpt import GPT, GPTConfig, init_params, param_shapes, params_from_jax
from .params import layer_params_from_jax

__all__ = ["GPT", "GPTConfig", "GPTGenerator", "bert", "bert_dygraph",
           "init_params", "layer_params_from_jax", "length_bucket", "lenet",
           "param_shapes", "params_from_jax", "resnet", "seq2seq",
           "transformer", "widedeep"]
