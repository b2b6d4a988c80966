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
                              paged_attention_ref, quantize_kv)

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_bwd_ref", "flash_attention_bwd_single",
           "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_train", "paged_attention", "paged_attention_ref",
           "quantize_kv", "dequantize_kv"]
