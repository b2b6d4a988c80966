"""Ops of the port: the registered op lowerings of the Program IR
(importing this package registers them) and the decode ops as plain
functions on tensors."""
from . import (activation_ops, attention_ops, math_ops,  # noqa: F401
               metric_ops, nn_ops, optimizer_ops, tensor_ops)
from .decode_ops import (kv_cache_write, kv_cached_attention,
                         paged_kv_cache_write, row_gather, sample_tokens)

__all__ = ["kv_cache_write", "kv_cached_attention", "paged_kv_cache_write",
           "row_gather", "sample_tokens"]
