#!/usr/bin/env python3
"""Where a training step's time goes in the PyTorch/CUDA port, on one
GPU.

    python3 tools/profile_torch_train.py
        [--model gpt|bert|bert_flagship|resnet50] [--batch N] [--seq S]
        [--layers 12] [--steps 3] [--amp]

``--model gpt`` (default B8 S2048) builds ``gpt_pretrain`` at
GPTConfig.base() widths + ``AdamOptimizer(1e-4).minimize``; ``--model
bert`` (default B16 S2048, 64 masked positions a row) builds
``bert_pretrain`` at BertConfig.base() widths with flash attention +
``AdamOptimizer(noam_decay(768, 10000, 200.0))``: the repository's
``bench.py`` ``bench_gpt_long`` and ``bench_bert_long``. ``--model
bert_flagship`` is bench.py's ``main()``: the same BERT at B64 S128
(``--seq`` ignored), 20 masked positions a row, einsum attention with
dropout and, under ``--amp``, softmax on the AMP white list. All are
``--layers`` deep with seeded random weights and dropout 0.1; ``--amp``
wraps Adam in bf16 mixed precision at a static loss scale of 1.0, as
those benches train. ``--model resnet50`` is bench.py's
``bench_resnet50``: ``resnet_train_program`` (ResNet-50, 1000 classes,
3x224x224, default B128) + ``Momentum(0.1, 0.9)``, fed a two-batch
seeded pool on the device; ``--amp`` adds batch_norm to the AMP white
list, as that bench does (``--seq``, ``--layers`` ignored). The executor runs the program through the default
pass pipeline (``FLAGS_program_passes``). It runs the startup program
and one warm-up step, times ``--steps`` steps
with the host clock (each ends in a fetch, which synchronizes), runs
``--steps`` more with a pair of CUDA events around every op of the
program, and ``--steps`` more under ``torch.profiler``. Prints one JSON
line: wall ms per step, device kernel time per step (sum of CUDA kernel
durations in the trace), the device's idle share, kernel launches per
step, device kernel time per step by kind of kernel (cuDNN's layout
transposes ``nchwToNhwc``/``nhwcToNchw`` on their own line, convolutions
(cuDNN's fprop, dgrad and wgrad kernels), batch norm, GEMMs, the flash
kernels, dtype casts and copies, the optimizer's multi-tensor kernels,
other elementwise and reductions), the device span per step by op type
(from each op's first to its
last kernel on the stream, so a ``*_grad`` op's forward recompute and
the backward kernels autograd launches from its own thread both count),
and the kernels that take the most device time. Exits non-zero without a
CUDA device.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernel_times(prof, torch):
    """{kernel name: (total device us, count)} over the trace."""
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        if us is None:
            us = e.cuda_time
        tot, n = out.get(e.name, (0.0, 0))
        out[e.name] = (tot + float(us), n + 1)
    return out


# kind of a CUDA kernel, by the first pattern its name contains
KINDS = (("layout_transpose", ("nchwToNhwc", "nhwcToNchw")),
         ("conv", ("fprop", "dgrad", "wgrad", "convolve", "conv2d",
                   "implicit_gemm")),
         ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
         ("gemm", ("gemm", "xmma", "nvjet", "cutlass")),
         ("flash", ("flash_",)),
         ("cast_copy", ("copy_kernel", "copy_")),
         ("optimizer", ("multi_tensor_apply",)),
         ("reduce_softmax", ("reduce_kernel", "SoftMax", "softmax")),
         ("elementwise", ("elementwise", "vectorized")))


def _kind(name):
    for kind, pats in KINDS:
        if any(p in name for p in pats):
            return kind
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("gpt", "bert", "bert_flagship",
                                        "resnet50"), default="gpt")
    ap.add_argument("--batch", type=int,
                    help="default 8 (gpt), 16 (bert), 64 (bert_flagship), "
                         "128 (resnet50)")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--amp", action="store_true",
                    help="bf16 mixed precision, static loss scale 1.0")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import lowering
    from paddle_tpu_torch.models import bert, gpt, resnet
    S = args.seq
    rng = np.random.default_rng(0)
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), \
            fluid.program_guard(main_prog, startup):
        if args.model == "resnet50":
            B, S = args.batch or 128, 224
            out = resnet.resnet_train_program(depth=50, batch_size=B)
            cfg = None
            opt = fluid.optimizer.Momentum(0.1, 0.9)
            feeds = [{"image": torch.from_numpy(rng.standard_normal(
                          (B, 3, S, S)).astype(np.float32)).cuda(),
                      "label": torch.from_numpy(rng.integers(
                          0, 1000, (B, 1)).astype(np.int64)).cuda()}
                     for _ in range(2)]
        elif args.model == "gpt":
            B = args.batch or 8
            cfg = gpt.GPTConfig.base()
            cfg.num_layers = args.layers
            out = gpt.gpt_pretrain(cfg, B, S)
            opt = fluid.optimizer.AdamOptimizer(1e-4)
            feed = gpt.random_batch(cfg, B, S, rng=rng)
        else:
            flagship = args.model == "bert_flagship"
            B, S, P = (args.batch or 64, 128, 20) if flagship \
                else (args.batch or 16, S, 64)
            cfg = bert.BertConfig.base()
            cfg.num_layers = args.layers
            cfg.attn_mechanism = None if flagship else "flash"
            cfg.max_position = max(S, cfg.max_position)
            out = bert.bert_pretrain(cfg, B, S, P)
            opt = fluid.optimizer.AdamOptimizer(
                fluid.layers.noam_decay(cfg.hidden_size, 10000, 200.0))
            feed = bert.random_batch(cfg, B, S, P, rng=rng)
        if args.model != "resnet50":
            feeds = [feed]
        if args.amp:
            mp = fluid.contrib.mixed_precision
            white = {"bert_flagship": {"softmax"},
                     "resnet50": {"batch_norm"}}.get(args.model, set())
            opt = mp.decorate(
                opt, amp_lists=mp.AutoMixedPrecisionLists(
                    custom_white_list=white),
                init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        opt.minimize(out["loss"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def run(n):
        for i in range(n):
            exe.run(main_prog, feed=feeds[i % len(feeds)],
                    fetch_list=[out["loss"]], scope=scope)

    run(1)                                           # warm
    t0 = time.perf_counter()
    run(args.steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    plain_run_op = lowering.run_op
    spans = []

    def timed_run_op(ctx, op):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        plain_run_op(ctx, op)
        b.record()
        spans.append((op.type, a, b))

    lowering.run_op = timed_run_op
    try:
        run(args.steps)
    finally:
        lowering.run_op = plain_run_op
    torch.cuda.synchronize()
    by_op = {}
    for typ, a, b in spans:
        ms, n = by_op.get(typ, (0.0, 0))
        by_op[typ] = (ms + a.elapsed_time(b) / args.steps,
                      n + 1 / args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(args.steps)
        torch.cuda.synchronize()
    kt = _kernel_times(prof, torch)
    busy_ms = sum(t for t, _ in kt.values()) / 1e3 / args.steps
    launches = sum(n for _, n in kt.values()) / args.steps
    top = sorted(kt.items(), key=lambda kv: -kv[1][0])[:12]
    by_kind = {}
    for n, (t, c) in kt.items():
        ms, calls = by_kind.get(_kind(n), (0.0, 0))
        by_kind[_kind(n)] = (ms + t / 1e3 / args.steps,
                             calls + c / args.steps)
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    print(json.dumps({
        "model": args.model, "batch": B, "seq": S,
        "layers": cfg.num_layers if cfg is not None else 50,
        "amp": args.amp,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "program_passes": fluid.get_flags("FLAGS_program_passes")[
            "FLAGS_program_passes"],
        "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": busy_ms if kt else None,
        "device_idle_share": 1 - busy_ms / wall_ms if kt else None,
        "kernel_launches_per_step": launches,
        "kernel_ms_per_step_by_kind": {
            k: {"ms": ms, "launches": n} for k, (ms, n) in
            sorted(by_kind.items(), key=lambda kv: -kv[1][0])},
        "device_span_ms_per_step_by_op": {
            k: {"ms": ms, "ops": n} for k, (ms, n) in
            sorted(by_op.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": n[:90], "ms_per_step":
                         t / 1e3 / args.steps, "calls_per_step":
                         c / args.steps} for n, (t, c) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
