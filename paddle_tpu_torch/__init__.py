"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for an NVIDIA
H100.

This slice carries GPT generation serving: the KV-cached GPT
(``models.GPT``), offline generation (``models.GPTGenerator``) over a
dense or block-paged KV cache, and the continuous-batching generation
server (``serving.InferenceServer`` / ``serving.Client``). The two
attention kernels of that path are CUDA C++ for sm_90a, built with nvcc
on first use: flash-attention forward (prefill) and paged decode
attention. Entry points take ``device=None`` (the GPU) and raise without
one; pass ``device="cpu"`` for the plain PyTorch versions.

The package imports torch, numpy and the standard library only — never
JAX and never ``paddle_tpu``.
"""
from . import flags, kernels, ops
from .device import resolve_device
from .models import (GPT, GPTConfig, GPTGenerator, init_params, param_shapes,
                     params_from_jax)
from .serving import (Client, GenerationEngine, InferenceServer, KVBlockPool,
                      ServingStats)

__all__ = ["Client", "GPT", "GPTConfig", "GPTGenerator", "GenerationEngine",
           "InferenceServer", "KVBlockPool", "ServingStats", "flags",
           "init_params", "kernels", "ops", "param_shapes",
           "params_from_jax", "resolve_device"]
