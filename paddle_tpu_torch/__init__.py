"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for an NVIDIA
H100.

Two slices are ported:

- GPT causal training through the Fluid surface, used as
  ``import paddle_tpu_torch as fluid``: ``fluid.Program``,
  ``fluid.layers``, ``fluid.optimizer.AdamOptimizer(lr).minimize(loss)``
  (``append_backward`` + Adam ops), bf16 mixed precision
  (``fluid.contrib.mixed_precision.decorate``) and
  ``fluid.Executor().run``, which runs the program through the default
  pass pipeline (``framework.passes``: dce, cse, fuse_optimizer) and
  interprets it op by op on torch tensors (``models.gpt.gpt_pretrain``
  builds the program).
- GPT generation serving: the KV-cached GPT (``models.GPT``), offline
  generation (``models.GPTGenerator``) over a dense or block-paged KV
  cache, and the continuous-batching server (``serving.InferenceServer``
  / ``serving.Client``).

Attention runs on hand-written CUDA kernels for sm_90a, built with nvcc
on first use: flash-attention forward and backward, and paged decode
attention. Entry points take ``place``/``device`` None (the GPU) and
raise without one; pass ``fluid.CPUPlace()`` / ``device="cpu"`` for the
plain PyTorch versions.

The package imports torch, numpy and the standard library only — never
JAX and never ``paddle_tpu``.
"""
from . import flags, kernels, ops
from . import contrib, framework, layers, optimizer
from .flags import get_flags, set_flags
from .device import resolve_device
from .framework import (CPUPlace, CUDAPlace, Executor, Program, Scope,
                        append_backward, default_main_program,
                        default_startup_program, global_scope, gradients,
                        program_guard, scope_guard, unique_name)
from .layers import data
from .models import (GPT, GPTConfig, GPTGenerator, init_params, param_shapes,
                     params_from_jax)
from .param_attr import ParamAttr
from .serving import (Client, GenerationEngine, InferenceServer, KVBlockPool,
                      ServingStats)

__all__ = ["CPUPlace", "CUDAPlace", "Client", "Executor", "GPT",
           "GPTConfig", "GPTGenerator", "GenerationEngine",
           "InferenceServer", "KVBlockPool", "ParamAttr", "Program", "Scope",
           "ServingStats", "append_backward", "contrib", "data",
           "default_main_program", "default_startup_program", "flags",
           "framework", "get_flags", "global_scope", "gradients",
           "init_params", "kernels", "layers", "ops", "optimizer",
           "param_shapes", "params_from_jax", "program_guard",
           "resolve_device", "scope_guard", "set_flags", "unique_name"]
