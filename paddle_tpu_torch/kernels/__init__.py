"""Hand-written CUDA kernels of the port (built on first use, see
``_build``) beside their plain PyTorch versions."""
from .flash_attention import (FlashAttention, flash_attention,
                              flash_attention_bwd, flash_attention_bwd_dkv,
                              flash_attention_bwd_dq,
                              flash_attention_bwd_ref,
                              flash_attention_bwd_single,
                              flash_attention_fwd, flash_attention_ref,
                              flash_attention_train)
from .paged_attention import (dequantize_kv, paged_attention,
                              paged_attention_gather, paged_attention_ref,
                              quantize_kv)

# the wrappers that count their kernel launches (``launches``; the flash
# wrappers also ``bf16_launches``)
COUNTED = (flash_attention_fwd, flash_attention_bwd_single,
           flash_attention_bwd_dq, flash_attention_bwd_dkv, paged_attention)

__all__ = ["COUNTED", "FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_bwd_ref", "flash_attention_bwd_single",
           "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_train", "paged_attention",
           "paged_attention_gather", "paged_attention_ref",
           "quantize_kv", "dequantize_kv"]
