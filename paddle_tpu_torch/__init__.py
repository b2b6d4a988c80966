"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, for an NVIDIA
H100.

Ported so far:

- Training through the Fluid surface, used as ``import paddle_tpu_torch
  as fluid``: ``fluid.Program``, ``fluid.layers``, the optimizers
  (``minimize`` = ``append_backward`` + clip + regularization + update
  ops), the LR schedulers, bf16 mixed
  precision (``fluid.contrib.mixed_precision.decorate``) and
  ``fluid.Executor().run``, which runs the program through the default
  pass pipeline (``framework.passes``: dce, cse, fuse_optimizer; the
  program verifier under ``FLAGS_verify_passes``) and interprets it op
  by op on torch tensors. The models: GPT (``models.gpt.gpt_pretrain``),
  BERT (``models.bert.bert_pretrain``), ResNet
  (``models.resnet.resnet_train_program``) and LeNet
  (``models.lenet.build_lenet_train``).
- The training loop: ``Executor.run_steps`` (K steps as replays of one
  captured CUDA graph), the non-finite guard (``check_nan_inf``,
  ``skip_nonfinite_steps``), ``Executor.train_from_dataset`` over the
  ``dataio`` datasets (``fluid.DatasetFactory``), and the
  ``RecomputeOptimizer`` and ``GradientMergeOptimizer`` wrappers.
- Persistence (``io``: ``save``/``load``, ``save_params``,
  ``save_persistables``, ``save_inference_model`` and their loads), in
  the JAX package's on-disk format, so either package reads what the
  other writes; exact training resume (``io.save_checkpoint`` /
  ``load_checkpoint``, ``io.CheckpointSaver``,
  ``train.TrainCheckpoint``).
- The optimizer stack: gradient clipping (``fluid.clip``),
  regularizers (``fluid.regularizer``, ``ParamAttr(regularizer=,
  need_clip=)``), every optimizer of the JAX package (LARS, LAMB,
  Adagrad, DecayedAdagrad, Adadelta, Adamax, RMSProp, FTRL, DP-SGD
  beside SGD, Momentum, Adam and AdamW), ``ExponentialMovingAverage``,
  ``ModelAverage``, ``LookaheadOptimizer``, ``DGCMomentumOptimizer``,
  error clipping and ``contrib.extend_with_decoupled_weight_decay``.
- Inference: ``inference.AnalysisPredictor`` over a saved model, and
  ``serving.InferenceServer(model_dir)``, which micro-batches requests
  across clients into padded batches and runs each bucket as a captured
  CUDA graph (``framework.cuda_graph``).
- The imperative mode (``fluid.dygraph``): ``guard``, ``VarBase``
  with tape autograd through the registered grad lowerings, ``Layer``
  and its ``nn`` classes, eager ``minimize``, ``save_dygraph`` /
  ``load_dygraph``, and ``jit_step``, a whole taped training step as
  one CUDA graph; the dygraph Transformer (``models.transformer``) and
  BERT (``models.bert_dygraph``).
- GPT generation serving: the KV-cached GPT (``models.GPT``), offline
  generation (``models.GPTGenerator``) over a dense or block-paged KV
  cache, and the continuous-batching server (``InferenceServer(
  generator=...)`` / ``serving.Client``).
- Control flow and the sequence models: ``layers.While``, ``cond``,
  ``Switch``, ``StaticRNN``, ``DynamicRNN`` and the tensor arrays (ops
  over sub-blocks, run by the same op-by-op interpreter), the
  masked-dense sequence ops and layers, the RNN ops (``lstm``, ``gru``,
  ...), the RNN cell/decoder API (``layers.rnn``, ``dynamic_decode``,
  ``BeamSearchDecoder``), beam search, the host LoD containers
  (``fluid.LoDTensor``) and the GRU seq2seq (``models.seq2seq``).

Attention runs on hand-written CUDA kernels for sm_90a, built with nvcc
on first use: flash-attention forward and backward, and paged decode
attention; convolutions and GEMMs run in cuDNN and cuBLAS through torch,
as the JAX package leaves them to XLA. Entry points take
``place``/``device`` None (the GPU) and raise without one; pass
``fluid.CPUPlace()`` / ``device="cpu"`` for the plain PyTorch versions.

The package imports torch, numpy and the standard library only — never
JAX and never ``paddle_tpu``.
"""
from . import flags, kernels, ops
from . import contrib, framework, layers, optimizer
from .flags import get_flags, set_flags
from .device import resolve_device
from .framework import initializer
from .framework import (CPUPlace, CUDAPlace, Executor, Program, Scope,
                        append_backward, default_main_program,
                        default_startup_program, global_scope, gradients,
                        program_guard, scope_guard, unique_name)
from .layers import data
from .lod import (LoDTensor, LoDTensorArray, Tensor, create_lod_tensor,
                  create_random_int_lodtensor)
from .models import (GPT, GPTConfig, GPTGenerator, init_params, param_shapes,
                     params_from_jax)
from .param_attr import ParamAttr
from .serving import (Client, GenerationEngine, InferenceServer, KVBlockPool,
                      ServingStats)
from . import dataio, dygraph, inference, io
from . import clip, regularizer, resilience, train
from .dataio import DatasetFactory
from .io import (CheckpointSaver, load, load_checkpoint,
                 load_inference_model, load_params, load_persistables, save,
                 save_checkpoint, save_inference_model, save_params,
                 save_persistables)

dataset = dataio

__all__ = ["CPUPlace", "CUDAPlace", "CheckpointSaver", "Client",
           "DatasetFactory", "Executor",
           "GPT", "LoDTensor", "LoDTensorArray", "Tensor",
           "create_lod_tensor", "create_random_int_lodtensor",
           "GPTConfig", "GPTGenerator", "GenerationEngine",
           "InferenceServer", "KVBlockPool", "ParamAttr", "Program", "Scope",
           "ServingStats", "append_backward", "clip", "contrib", "data",
           "dataio",
           "dataset",
           "default_main_program", "default_startup_program", "dygraph",
           "flags",
           "framework", "get_flags", "global_scope", "gradients",
           "inference", "init_params", "initializer", "io", "kernels",
           "layers", "load", "load_checkpoint",
           "load_inference_model", "load_params", "load_persistables",
           "ops", "optimizer", "param_shapes", "params_from_jax",
           "program_guard", "regularizer", "resilience", "resolve_device",
           "save", "save_checkpoint", "save_inference_model", "save_params",
           "save_persistables", "scope_guard", "set_flags", "train",
           "unique_name"]
