"""Hand-written CUDA kernels of the port (built on first use, see
``_build``) beside their plain PyTorch versions."""
from .flash_attention import (flash_attention, flash_attention_fwd,
                              flash_attention_ref)
from .paged_attention import (dequantize_kv, paged_attention,
                              paged_attention_ref, quantize_kv)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "paged_attention", "paged_attention_ref", "quantize_kv",
           "dequantize_kv"]
