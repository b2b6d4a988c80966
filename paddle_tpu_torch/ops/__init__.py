"""Ops of the port as plain functions on tensors."""
from .decode_ops import (kv_cache_write, kv_cached_attention,
                         paged_kv_cache_write, row_gather, sample_tokens)

__all__ = ["kv_cache_write", "kv_cached_attention", "paged_kv_cache_write",
           "row_gather", "sample_tokens"]
