"""Models of the port: GPT (training and generation), BERT
(pretraining, ``models.bert``; dygraph, ``models.bert_dygraph``), ResNet
(``models.resnet``), LeNet (``models.lenet``), Wide&Deep
(``models.widedeep``), the dygraph Transformer (``models.transformer``),
the GRU seq2seq (``models.seq2seq``) and the Fluid book's programs
(``models.book``)."""
from . import (bert, bert_dygraph, book, lenet, resnet,  # noqa: F401
               seq2seq, transformer, widedeep)
from .generation import GPTGenerator, length_bucket
from .gpt import GPT, GPTConfig, init_params, param_shapes, params_from_jax
from .params import layer_params_from_jax

__all__ = ["GPT", "GPTConfig", "GPTGenerator", "bert", "bert_dygraph",
           "book", "init_params", "layer_params_from_jax", "length_bucket", "lenet",
           "param_shapes", "params_from_jax", "resnet", "seq2seq",
           "transformer", "widedeep"]
