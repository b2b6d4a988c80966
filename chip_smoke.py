#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--parent TREE]

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; exits non-zero without a CUDA device.
2. Builds the port's CUDA kernels from paddle_tpu_torch/kernels/csrc/
   (one nvcc per source, all started together) and prints each kernel's
   registers, stack and spills from ``-Xptxas -v`` (a spill in any K5
   instantiation fails the run) and, where the toolkit has
   ``cuobjdump``, the tensor-core (HMMA) instructions and bulk copies
   (UBLKCP) in each kernel's SASS.
3. Kernel phases: each kernel against its plain PyTorch version on the
   card at the main paths' shapes, with the tolerance stated; prints one
   JSON line per phase with the error, the kernel's, the plain version's
   and (where one exists) a single PyTorch call's time, and the bound
   (bytes or operations of this input over the card's peak). K1 (flash
   forward) at the serving shapes. K5 (paged decode) at B8 H12 D64 bs16
   nblk128 with pos spread over 0..2047 (float32, bf16 and int8 pools),
   at B1 pos 32767, B64 with short rows, H6 D128 and H24 D32, block sizes
   32 and 128, and edge rows (pos -1, a last slot on a split boundary and
   one past it; also a bf16 q), each timed warm (one call replayed) and
   cold (a graph walking 12 pool sets, as a decode step walks its
   layers); also at B8 H2 D16 (GPTConfig.tiny()'s head dim); then its
   determinism (two calls, a row alone, a wider table: the same bits).
   With ``--parent`` (another checkout, e.g. a git archive of the parent
   commit) that tree's paged kernel is built and called through that
   tree's own wrapper and timed beside the port's at every K5 phase, in
   the order parent, new, new, parent; and that tree's K2 is called and
   timed beside the port's in the K2 determinism phase. K2 (combined
   backward) at B8 H12 S1024 D64 causal and K3/K4 (dq; dk, dv) at S2048
   causal, on the strided q/k/v views the model makes, plus a non-causal
   + bias and a bf16 case each; K1 and K2 also at the tiling's edges
   (head dim 128 and a ragged S = 1000, float32 and bf16, causal; K1
   non-causal + bias at D = 128), K3 and K4 at head dim 128 and a ragged
   S = 2000 (both types, causal; non-causal + bias at D = 128). K1 and
   K2 at B4 H8 S1024 and K3/K4 at causal S2048 at head dims 80 and 96
   (D128's tile plan), both types. K2 determinism: two calls at the main
   S1024 shape (float32, bf16) give the same dq, dk, dv bits. Bounds
   take float32 at 165 TFLOP/s (3xTF32). One ``bwd_pair`` line per
   (S, type) at S2048 and S4096 causal times K3 then K4 back to back
   beside K2 off its route and SDPA's backward, and holds the pair's
   outputs against K2's. K1 and K2 at bench_bert_long's attention (B16
   H12 S2048 D64, non-causal, a key bias masking each row's padded tail,
   both types), each beside SDPA with the same mask, and a non-causal
   ``bwd_pair`` line there.
4. The main paths at GPTConfig.base() widths, seeded random weights, each
   with every kernel launch count zeroed just before it and read just
   after; each path's kernels must have launched:
   - serving: offline greedy generate (dense and paged), teacher-forced
     paged (kernel) vs dense (plain) decode logits, then an
     InferenceServer with 8 decode slots answering 16 requests from 8
     concurrent wire clients, each reply equal to offline greedy generate
     (K1, K5; K5 once per layer of every paged decode step); then
     GPTConfig.tiny() (head dim 16) through one paged generate;
   - training through the Fluid surface (gpt_pretrain + AdamOptimizer +
     Executor, which runs the default pass pipeline: dce, cse,
     fuse_optimizer), dropout 0.1, 5 Adam steps at lr 1e-4 on one seeded
     batch, all 12 layers: fp32 B8 S2048 (K1, K3, K4) and B8 S1024 (K1,
     K2), and bf16 AMP at B8 S2048 (Adam wrapped by
     contrib.mixed_precision.decorate at a static loss scale of 1.0, as
     bench.py's bench_gpt_long trains; K1, K3 and K4 must launch with
     bf16 inputs); finite losses, step 0 within 1.0 of ln(32000), step 4
     below step 0; ms/step, tokens/s, TFLOP/s, peak memory and the
     adam / fused_adam ops a step runs.
   - BERT-base pretraining through the Fluid surface (bert_pretrain +
     AdamOptimizer(noam_decay(768, 10000, 200.0)) wrapped by
     contrib.mixed_precision.decorate at a static loss scale of 1.0),
     bench.py's two BERT trainers, 5 steps each on one seeded batch:
     bert_long (bench_bert_long: B16 S2048, 64 masked positions a row,
     flash attention; K1 and K2 launch once per layer and step, all
     bf16) and the flagship (main(): B64 S128 P20, einsum attention with
     dropout, softmax on the AMP white list; no kernel launches);
     finite losses, step 0 within 1.0 of ln(30522) + ln(2), each step's
     learning rate read back equal to noam_decay's; ms/step, samples/s,
     tokens/s, TFLOP/s against bench.py's _bert_train_flops_per_sample,
     peak memory. Then __graft_entry__.entry()'s evaluation (B8 S128
     through clone(for_test=True)) and one bert_long step with
     FLAGS_verify_passes on (the program verified, every pass
     validated; prints the verification's ms).
5. Gradient check at GPT-base width, 2 layers, S1024 and S2048: every
   param@GRAD of one step through the kernels against the same program
   cloned with the flash_attention op's impl set to "xla" (the plain
   composite), within 1e-3 of its max |grad| (fp32) and 2e-2 (bf16
   AMP). Pipeline A/B at 2 layers, B8 S1024 fp32: one step with
   FLAGS_program_passes "0" and one with "1" from copies of one scope
   leave every param, moment and beta-pow bitwise equal. Dynamic loss
   scaling at 2 layers, 3 steps: finite losses, the loss scale and its
   counters read back. BERT-base width, 2 layers, B8 S2048, flash, bf16
   AMP, dropout 0: every param@GRAD against the composite's within 2e-2,
   and 5 steps at a constant lr 1e-4 whose loss falls.
6. Image classification through the Fluid surface (convolutions in
   cuDNN, GEMMs in cuBLAS: no kernel of the port runs, as the JAX
   package computes them outside Pallas), each path driven with the
   launch counts zeroed and read:
   - resnet50_train: bench.py's bench_resnet50 program, ResNet-50 at
     full depth and width, class_dim 1000, B128 3x224x224,
     Momentum(0.1, 0.9) under bf16 AMP with batch_norm white-listed at a
     static loss scale of 1.0, 5 steps over a two-batch seeded pool on
     the device: finite losses, step 0 within 1.0 of ln(1000); all 53
     conv outputs and 53 batch_norm Y bf16 (declared and on the device);
     every moving mean and variance float32 and moved off (0, 1) in step
     0; fused_momentum in place of the 161 momentum ops; ms/step (median
     of steps 1-4), images/s, TFLOP/s (2 x the conv and fc multiply-adds
     x 3, from the program's shapes) and peak memory;
   - resnet50_eval: clone(for_test=True) of the fp32 program at B128
     over the trained scope, loss and acc finite and repeatable, its
     logits other than a train-mode forward's (it reads the moving
     statistics);
   - cudnn_deterministic_ab: bench_resnet50's step with
     FLAGS_cudnn_deterministic off and on in turns (off, on, on, off,
     twice): device ms (torch.profiler) and wall ms each; one step from
     two copies of one scope under each setting (bitwise or not); two
     eager LeNet runs (B512, 16 steps) under each, bitwise under the
     flag (the port's default);
   - resnet18_tiny_trains: JAX's test_resnet18_tiny_trains (ResNet-18,
     class_dim 4, 32x32, B8, Momentum(0.01, 0.9), 12 steps): last loss
     below 0.7 x the first;
   - resnet_grads: ResNet-18 32x32 B8 fp32, every param@GRAD with the
     bespoke conv2d_grad and batch_norm_grad against the generic vjp over
     the same lowerings, within 1e-3 of its max |grad| (cuDNN's TF32
     setting printed);
   - lenet_train: build_lenet_train() with Adam (lr 0.001) and SGD (lr
     0.01) at B512, 32 Executor.run steps each over synthetic digits:
     steps/s, samples/s, finite and falling losses;
   - fused_optimizers: fused_sgd, fused_momentum (plain and Nesterov)
     and fused_adamw over ResNet-50's 161 parameter shapes, bitwise
     their per-param ops, each timed beside the 161 per-param ops.
7. Saved-model persistence and serving (``io``, ``inference``,
   ``InferenceServer(model_dir)``), each path driven with the launch
   counts zeroed and read:
   - io_roundtrip: ResNet-50 at full width, ``save_persistables`` then
     ``load_persistables`` into a fresh scope (every tensor the same
     bits), ``save_inference_model`` then an ``AnalysisPredictor`` over
     the directory (logits at B8 the eval clone's bits), a bf16 tensor
     through ``save_vars``/``load_vars`` (bitwise), one flipped byte in
     a ``.npy`` (``CheckpointCorruptError`` naming the file); save and
     load ms and bytes;
   - serve_resnet50 (ResNet-50, 1000 classes, 3x224x224, fp32; cuDNN,
     no kernel of the port) and serve_bert_base (BertConfig.base() with
     flash attention, S128, fp32: the encoder at is_test, the [CLS] row
     through pooled_fc and next_sent_fc + softmax; K1 once per layer of
     every executed batch): the program saved with its seeded startup,
     then under bench.py bench_serving's traffic, for request batches
     rb of 1, 8 and 32, a fresh server (max_batch_size 64,
     batch_timeout_ms 2.0, warmed at the buckets of rb and 8 rb)
     answering 8 concurrent wire clients x 8 requests. Every reply
     within 1e-4 of max |ref| of ``AnalysisPredictor.run`` on that
     request alone; at rb 1 a mean batch size above 1 and a cache hit;
     per rb requests/s, samples/s, p50/p99 ms, mean batch size and
     occupancy; per bucket one padded batch's graph replay bit for bit
     an eager run of it, eager ms against replay ms (events) and the
     graph's bytes; peak memory. BERT: K1 12 launches per executed
     batch by the counters, and a profiled replay runs 12 of K1's
     kernel;
   - K1 at the served shape (B32 H12 S128 D64 f32, non-causal, padded
     tail key bias) against its plain version and SDPA;
   - capture_refuses_host_sync: a program whose op calls ``.item()``
     raises ``GraphCaptureError`` naming the op (no eager fallback), and
     the allocator still releases cached memory after it.
8. The training loop (``Executor.run_steps``: K steps as replays of one
   captured CUDA graph; the non-finite guard; ``train_from_dataset``),
   each path driven with the launch counts zeroed and read, each line
   naming the card and its power limit:
   - bert_long_recompute: BERT-base at bench_bert_long's shape (B16
     S2048 P64, flash, bf16 AMP) as ``__graft_entry__`` builds it, noam
     Adam under RecomputeOptimizer with the 12 layer checkpoints: 4
     eager steps and a run_steps slab of 4 from copies of one scope,
     losses, LR and scope bitwise; the program without recompute, one
     slab: its losses, and both slabs' peak memory (recompute must peak
     lower); K1 24 and K2 12 launches a step with recompute, 12 and 12
     without, eager and per replay; wall and device ms a step, idle
     share, tokens/s, TFLOP/s;
   - capture_names_flash_grad: a 1-layer step whose flash grad op is
     made to call ``.item()``: run_steps raises GraphCaptureError naming
     flash_attention_grad and leaves the scope as it was; unpatched, the
     step captures (K2's wrapper makes no host sync);
   - flagship_steps: bench.py main()'s flagship (B64 S128, einsum,
     dropout 0.1): 8 eager steps against a run_steps slab of 8, losses
     and scope bitwise (a replay draws its eager step's dropout masks);
     wall and device ms a step both ways, idle share;
   - train_loop_lenet: bench.py's bench_train_loop (LeNet B512, K 1, 8,
     32, equal step counts): steps/s each, losses bitwise K=1's under
     FLAGS_cudnn_deterministic; whether two eager runs without it agree
     is recorded;
   - nonfinite_steps: the bert_long_recompute program at 2 layers, an
     8-step slab with a NaN in step 3's input_mask: check_nan_inf raises
     NonFiniteError naming fused step 3; skip_nonfinite_steps rolls back
     step 3 only, the scope bitwise a sequential run(skip) over the feeds;
   - train_from_dataset: LeNet over a QueueDataset the phase writes, 3
     slabs of 8 and a tail of 5 batches: steps_per_run 8 ends bitwise
     where steps_per_run 1 ends (FLAGS_cudnn_deterministic on).
9. Wide&Deep CTR (bench.py's bench_widedeep: B4096, dense 13, 26 slots
   over a vocab of 10000, embed 16, MLP 400x3, Adam 1e-3) with
   SelectedRows embedding grads, seeded random weights, each path driven
   with the launch counts zeroed and read (no kernel of the port may
   launch: the JAX package's sparse updates are XLA scatters):
   - widedeep_train: 8 eager steps against a run_steps slab of 8 from
     copies of one scope (losses and scope bitwise, no
     GraphCaptureError), a second slab from a third copy (the tables
     bitwise run to run); falling losses from near ln 2; the 52 table
     updates left per-param by fuse_optimizer; wall and device ms a step
     both ways, idle share, samples/s, peak memory, op counts;
   - widedeep_lazy_adam: the same with Adam(lazy_mode=True): the slab
     captures (no host sync) and is bitwise its eager steps; untouched
     rows keep their params and zero moments; the lazy adam op on one
     table with the batch's duplicate ids against the plain dense Adam
     of the touched rows (float64), within 1e-5 of max |ref|;
   - widedeep_serve: the trained model's predict program saved and
     served by InferenceServer(model_dir) at request batches 1 and 32
     (8 wire clients x 8 requests), replies within 1e-4 of max |ref| of
     AnalysisPredictor.run, each bucket's replay bitwise its eager run.
10. The imperative mode (``fluid.dygraph``), each path driven with the
    launch counts zeroed and read (no kernel of the port may launch: the
    JAX models compute attention as matmul + softmax and einsum); these
    run first among the main paths, after the kernel phases. Every
    ``launches_<path>`` line carries the device memory still allocated
    and reserved after the path (garbage collected, cache emptied):
    - dygraph_transformer: bench.py's bench_dygraph_transformer, the
      dygraph Transformer-base (d_model 512, 8 heads, d_inner 2048, 6+6
      layers, dropout 0.1, vocab 8000, max_len 64), Adam 1e-4, a pool of
      4 seeded batches of B256 src 32 tgt 32 on the device, the bench's
      step (backward, minimize, clear_gradients) under dygraph.jit_step:
      an eager warm-up on 8 rows, 4 eager steps at B256 (wall ms, the
      median of steps 1-3; device ms and kernel launches of one), the
      capture at B256 (seconds, graph pool bytes) and 20 timed replays
      (ms/step, samples/s, target tokens/s, TFLOP/s from the shapes),
      device ms and launches of one replay, idle shares, peaks, the
      first and last loss; every loss finite, and one replay from a
      copied state equal to one eager step from the same state and
      tracer key bitwise (loss, every parameter, every Adam slot, dropout
      on);
    - dygraph_bert_ab: tools/bench_dygraph_ab.py, BertPretrainDy(base)
      by jit_step against the static bert_pretrain by run_steps (K 8),
      fp32 B64 S128 P20, Adam 1e-4: ms/step, device ms and launches a
      step each, their ratio, the eager dygraph step's ms;
    - dygraph_capture_refusals: a jit_step step that copies host data to
      the device without to_variable, one that reads a value back and
      one whose to_variable data change each raise GraphCaptureError at
      the capturing call, with no eager pass instead and every
      parameter and Adam slot unchanged.
11. Prints the {"kernels": [...]} line (K1-K5), then as the last line
    {"ok": true, "device": {...}}.

Any failed phase exits non-zero and prints no result line.
"""
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
# float32: 495 TF32 / 3, the least time a product held to float32 accuracy
# can take on this card (3xTF32: three TF32 products per float32 product)
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12}

FA_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu"
PA_SOURCE = "paddle_tpu_torch/kernels/csrc/paged_attention.cu"
FA_REPLACES = "paddle_tpu/kernels/flash_attention.py:298"
PA_REPLACES = "paddle_tpu/kernels/paged_attention.py:219"
BWD_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu"
# wrapper name -> (TPU kernel's pallas_call site, outputs, score-sized
# products the function needs: s, dp and dq; s, dp, dk and dv; all five)
BWD_KERNELS = {
    "flash_attention_bwd_single": ("paddle_tpu/kernels/flash_attention.py:482",
                                   ("dq", "dk", "dv"), 5),
    "flash_attention_bwd_dq": ("paddle_tpu/kernels/flash_attention.py:514",
                               ("dq",), 3),
    "flash_attention_bwd_dkv": ("paddle_tpu/kernels/flash_attention.py:542",
                                ("dk", "dv"), 4),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters):
    """Device time of one call of ``fn``: captured once into a CUDA graph
    and replayed ``iters`` times between two events (the host's launch
    overhead stays out of the number)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_name(mangled):
    """``flash_bwd_k2_kernel<float,128,80>`` from a mangled template
    kernel name: its last ``<length><name>I<args>E`` component."""
    import re
    best = mangled
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        start, n = m.end(), int(m.group(1))
        name = mangled[start:start + n]
        if name.endswith("kernel") and mangled[start + n:start + n + 1] == "I":
            best = f"{name}<{_template_args(mangled[start + n + 1:])}>"
    return best


def _template_args(s):
    """``float,int8,64`` from a mangled argument list (``faLi64E...``),
    read up to the ``E`` that closes it: f float, a int8,
    13__nv_bfloat16 bf16, S<n>_ a repeat of the last named type (bf16 is
    the only one), Li<n>E an int."""
    import re
    out, named = [], "?"
    for tok in re.findall(r"13__nv_bfloat16|Li\d+E|S\d*_|.", s):
        if tok == "E":
            break
        if tok.startswith("Li"):
            out.append(tok[2:-1])
        elif tok.startswith("S"):
            out.append(named)
        else:
            out.append({"f": "float", "a": "int8",
                        "13__nv_bfloat16": "bf16"}.get(tok, tok))
            named = out[-1] if tok.startswith("13") else named
    return ",".join(out)


def sass_report(nvcc, lib_path):
    """Tensor-core instructions (HMMA opcodes) and bulk copies (UBLKCP,
    ``cp.async.bulk``) in each kernel of a built library, counted in
    ``cuobjdump -sass`` from ``nvcc``'s toolkit; None where the toolkit
    has no cuobjdump."""
    import re
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    rows, cur = [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = {"entry": _kernel_name(m.group(1)), "hmma": {},
                   "bulk_copy": {}}
            rows.append(cur)
            continue
        m = re.search(r"\b(HMMA\.[\w.]+|UBLKCP[\w.]*)", line)
        if m and cur is not None:
            key = "hmma" if m.group(1).startswith("HMMA") else "bulk_copy"
            cur[key][m.group(1)] = cur[key].get(m.group(1), 0) + 1
    return {"phase": "sass", "library": os.path.basename(lib_path),
            "kernels": rows}


def ptxas_report(name, out):
    """Registers, spills and stack of each kernel entry from the
    ``-Xptxas -v`` build output of library ``name``."""
    import re
    rows, cur = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": _kernel_name(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return {"phase": "ptxas", "library": name, "kernels": rows}


# ------------------------------------------------------------ kernel phases

def attention_inputs(torch, B, H, S, D, dtype, with_bias, seed, packed):
    """Seeded q, k, v, bias (or None) and a generator on the card.
    ``packed``: q/k/v are the strided views the model hands the kernels
    (one ``[B, S, 3*H*D]`` qkv projection, split, viewed as ``[B, S, H,
    D]`` and transposed to ``[B, H, S, D]``, as ``models/gpt.py`` and
    ``models/bert.py`` do); else contiguous tensors. ``with_bias`` True
    masks a random quarter of the keys; "padded" masks each row's padded
    tail (a row keeps its first S/2..S keys), as BERT's ``input_mask``
    becomes ``(mask - 1) * 10000``."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        h = H * D
        qkv = torch.randn(B, S, 3 * h, device="cuda", generator=g).to(dt)
        q, k, v = (t.view(B, S, H, D).transpose(1, 2)
                   for t in qkv.split(h, dim=-1))
    else:
        q, k, v = (torch.randn(B, H, S, D, device="cuda",
                               generator=g).to(dt) for _ in range(3))
    bias = None
    if with_bias == "padded":
        lens = torch.randint(S // 2, S + 1, (B, 1, 1, 1), device="cuda",
                             generator=g)
        keep = torch.arange(S, device="cuda") < lens
        bias = torch.where(keep, 0.0, -1e4).float()
    elif with_bias:
        keep = torch.rand(B, 1, 1, S, device="cuda", generator=g) > 0.25
        bias = torch.where(keep, 0.0, -1e4).float()
    return q, k, v, bias, g


def flash_phase(torch, fa, B, H, S, D, dtype, causal, with_bias, seed,
                packed):
    F = torch.nn.functional
    q, k, v, bias, _ = attention_inputs(torch, B, H, S, D, dtype, with_bias,
                                        seed, packed)
    out, lse = fa.flash_attention_fwd(q, k, v, bias=bias, causal=causal)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, bias=bias,
                                          causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    ok = err <= tol and lse_err <= 1e-3 and bool(torch.isfinite(out).all())
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, bias=bias, causal=causal), 20)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_ref(
        q, k, v, bias=bias, causal=causal), 5)
    mask = None if bias is None else bias.to(q.dtype)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal), 20)
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 4.0 * B * H * pairs * D
    elem = q.element_size()
    nbytes = 4 * B * H * S * D * elem + B * H * S * 4 \
        + (B * S * 4 if with_bias else 0)
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    rec = {"phase": "flash_attention_fwd", "B": B, "H": H, "S": S, "D": D,
           "dtype": dtype, "causal": causal, "bias": with_bias,
           "layout": "packed qkv views" if packed else "contiguous",
           "max_abs_err": err, "lse2_max_abs_err": lse_err, "atol": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": ops / ms / 1e9, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain "
                             f"version: {rec}")
    return rec


def paged_inputs(torch, pa, B, H, D, bs, nblk, pos, kv_dtype, seed, sets,
                 q_dtype="float32"):
    """Seeded q [B,H,1,D], block tables [B,nblk] (a random permutation of
    the pool's blocks, trash block 0 past each row's allocation), pos [B]
    and ``sets`` distinct k/v pool sets of one layout (as a decoder's
    layers hold them); returns a list of ``(q, k, v, tables, pos, k_scale,
    v_scale)`` per set and the live slots."""
    import numpy as np
    pos = np.asarray(pos, np.int32)
    nb = [min(int(p) // bs + 1, nblk) if p >= 0 else 0 for p in pos]
    N = sum(nb) + 1
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, nblk), np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    used = 0
    for b, n in enumerate(nb):
        tables[b, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, 1, D, device="cuda", generator=g).to(
        getattr(torch, q_dtype))
    t = torch.from_numpy(tables).cuda()
    p = torch.from_numpy(pos).cuda()
    out = []
    for _ in range(sets):
        kf = torch.randn(N, H, bs, D, device="cuda", generator=g)
        vf = torch.randn(N, H, bs, D, device="cuda", generator=g)
        if kv_dtype == "int8":
            (kp, ks), (vp, vs) = pa.quantize_kv(kf), pa.quantize_kv(vf)
        else:
            dt = getattr(torch, kv_dtype)
            kp, vp, ks, vs = kf.to(dt), vf.to(dt), None, None
        out.append((q, kp, vp, t, p, ks, vs))
    return out, live_slots(pos, bs, nblk)


def live_slots(pos, bs, nblk):
    """Key slots the rows can see: sum of pos + 1, within the table."""
    import numpy as np
    return int(np.clip(np.asarray(pos, np.int64) + 1, 0, nblk * bs).sum())


def parent_paged(tree):
    """The paged decode wrapper of another checkout ``tree`` (e.g. a git
    archive of the parent commit), imported from there as the module
    ``parent_kernels.paged_attention``: it builds that tree's kernel into
    that tree's build directory and is called as ``paged_attention``.
    Only the kernel modules are loaded, not the tree's package (whose
    custom ops would clash with the port's)."""
    import importlib
    import types
    pkg = types.ModuleType("parent_kernels")
    pkg.__path__ = [os.path.join(tree, "paddle_tpu_torch", "kernels")]
    sys.modules[pkg.__name__] = pkg
    return importlib.import_module("parent_kernels.paged_attention")


def parent_flash():
    """The flash-attention wrappers of the tree :func:`parent_paged`
    loaded: that tree's module registers the same torch custom op as the
    port's, so the registration is skipped while it is imported (only
    its kernel wrappers are called, never its autograd path)."""
    import importlib
    import torch
    real = torch.library.custom_op
    torch.library.custom_op = lambda *a, **k: (lambda fn: fn)
    try:
        return importlib.import_module("parent_kernels.flash_attention")
    finally:
        torch.library.custom_op = real


# pool sets a cold timing walks, as GPT-base's decoder walks its layers
# (more where their live bytes would not exceed twice the L2)
COLD_SETS = 12
L2_BYTES = 50e6


def cold_sets(live, H, D, kv_dtype):
    elem = {"float32": 4, "bfloat16": 2, "int8": 1}[kv_dtype]
    return max(COLD_SETS, int(2 * L2_BYTES // (2 * live * H * D * elem)) + 1)


def paged_phase(torch, pa, name, B, H, D, bs, nblk, pos, kv_dtype, seed,
                parent=None, q_dtype="float32"):
    """K5 against its plain version on one input, timed warm (one call
    replayed in a CUDA graph) and cold (a graph that walks ``cold_sets``
    distinct pool sets, more than 2x the L2's live bytes, as a decode step
    walks its layers). Rows with nothing visible (pos < 0) must be 0, as
    the TPU kernel gives them (the gather composite averages there).
    Limit: max |kernel - ref| <= 1e-4 and <= 1e-4 of max |ref| (both read
    the same stored values in float32); a bfloat16 q gives a bfloat16
    output, held to 1e-2 of max |ref| (its rounding). ``parent``: another
    tree's paged module (:func:`parent_paged`), checked and timed beside
    the port's kernel in the order parent, new, new, parent where its
    wrapper takes the input."""
    nsets = cold_sets(live_slots(pos, bs, nblk), H, D, kv_dtype)
    sets, live = paged_inputs(torch, pa, B, H, D, bs, nblk, pos, kv_dtype,
                              seed, nsets, q_dtype)
    q, kp, vp, t, p, ks, vs = sets[0]
    kern = pa.paged_attention

    def run(fn, s=sets[0]):
        return fn(*s[:5], s[5], s[6])

    out = run(kern)
    ref = pa.paged_attention_ref(q, kp, vp, t, p, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    dead = (p < 0)[:, None, None, None]
    ref = torch.where(dead, torch.zeros_like(ref), ref).float()
    err = (out.float() - ref).abs().max().item()
    max_ref = ref.abs().max().item()
    tol = 1e-2 * max_ref if q_dtype == "bfloat16" \
        else 1e-4 * min(1.0, max_ref)
    ok = err <= tol and bool(torch.isfinite(out).all()) \
        and bool((out.float() * dead == 0).all())
    perr = refused = None
    if parent is not None:
        try:
            perr = (run(parent.paged_attention).float() - ref).abs().max() \
                .item()
            ok = ok and perr <= tol
        except ValueError as e:          # its wrapper refuses this input
            refused = str(e)
    parent_ok = perr is not None
    nbytes = 2 * live * H * D * kp.element_size() \
        + (2 * live * H * 4 if ks is not None else 0) \
        + 2 * B * H * D * q.element_size() + B * nblk * 4 + B * 4
    cold_live = nsets * 2 * live * H * D * kp.element_size()

    def warm(fn):
        return time_ms(torch, lambda: run(fn), 50)

    def cold(fn):
        def walk():
            for s in sets:
                run(fn, s)
        return time_ms(torch, walk, 10) / len(sets)

    rec = {"phase": "paged_attention", "case": name, "B": B, "H": H, "D": D,
           "block_size": bs, "nblk": nblk, "q_dtype": q_dtype,
           "kv_dtype": kv_dtype, "live_slots": live,
           "splits": pa.split_plan(bs, nblk), "cold_sets": nsets}
    if B <= 8:
        rec["pos"] = [int(x) for x in pos]
    if parent_ok:
        old = parent.paged_attention
        w = [warm(old), warm(kern), warm(kern), warm(old)]
        c = [cold(old), cold(kern), cold(kern), cold(old)]
        rec.update(ms=(w[1] + w[2]) / 2, cold_ms=(c[1] + c[2]) / 2,
                   parent_ms=(w[0] + w[3]) / 2,
                   parent_cold_ms=(c[0] + c[3]) / 2, warm_pccp=w,
                   cold_pccp=c, parent_max_abs_err=perr)
    else:
        rec.update(ms=warm(kern), cold_ms=cold(kern),
                   parent_ms=None, parent_cold_ms=None)
        if refused:
            rec["parent_refused"] = refused
    bound_ms, bound_by = bound(nbytes, 4.0 * live * H * D, "float32")
    rec.update(max_abs_err=err, max_abs_ref=max_ref, limit=tol,
               plain_ms=time_ms(torch, lambda: pa.paged_attention_ref(
                   q, kp, vp, t, p, k_scale=ks, v_scale=vs), 10),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               cold_live_bytes_over_l2=cold_live / L2_BYTES,
               gbytes_per_s=nbytes / rec["ms"] / 1e6,
               cold_gbytes_per_s=nbytes / rec["cold_ms"] / 1e6, ok=ok)
    emit(rec)
    if not ok:
        raise AssertionError(f"paged_attention disagrees with its plain "
                             f"version: {rec}")
    return rec


def paged_determinism(torch, pa, kv_dtype, seed):
    """Two calls give the same bits, and each row of the main shape
    decoded alone (B = 1), and with its table padded 37 entries wider,
    gives the bits it gets in the batch: a split's boundaries depend on
    the block index alone."""
    import numpy as np
    pos = np.linspace(0, 2047, 8).round().astype(np.int32)
    (s,), _ = paged_inputs(torch, pa, 8, 12, 64, 16, 128, pos, kv_dtype,
                           seed, 1)
    q, kp, vp, t, p, ks, vs = s
    a = pa.paged_attention(q, kp, vp, t, p, k_scale=ks, v_scale=vs)
    b = pa.paged_attention(q, kp, vp, t, p, k_scale=ks, v_scale=vs)
    repeat = bool(torch.equal(a, b))
    alone = wide = True
    for r in range(len(pos)):
        sl = slice(r, r + 1)
        one = pa.paged_attention(q[sl], kp, vp, t[sl], p[sl], k_scale=ks,
                                 v_scale=vs)
        tw = torch.cat([t[sl], torch.zeros(1, 37, dtype=t.dtype,
                                           device=t.device)], 1)
        padded = pa.paged_attention(q[sl], kp, vp, tw, p[sl], k_scale=ks,
                                    v_scale=vs)
        alone = alone and bool(torch.equal(one, a[sl]))
        wide = wide and bool(torch.equal(padded, a[sl]))
    rec = {"phase": "paged_determinism", "kv_dtype": kv_dtype,
           "repeat_bitwise": repeat, "row_alone_bitwise": alone,
           "wider_table_bitwise": wide, "ok": repeat and alone and wide}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"paged_attention is not deterministic: {rec}")
    return rec


def paged_phases(torch, pa, parent):
    """Every K5 phase; returns the main shape's float32 record (the
    kernels line). Main shape: B8 H12 D64 bs16 nblk128, pos spread over
    0..2047 (the decode shape of chip_smoke's serving rows at full
    context)."""
    import numpy as np
    main_pos = np.linspace(0, 2047, 8).round().astype(np.int32)
    main = None
    for kv in ("float32", "bfloat16", "int8"):
        rec = paged_phase(torch, pa, "main", 8, 12, 64, 16, 128, main_pos,
                          kv, 3, parent)
        main = main or rec
    for kv in ("float32", "bfloat16", "int8"):
        paged_phase(torch, pa, "B1_pos32767", 1, 12, 64, 16, 2048, [32767],
                    kv, 4, parent)
        torch.cuda.empty_cache()
    short = np.random.default_rng(5).integers(0, 512, 64).astype(np.int32)
    paged_phase(torch, pa, "B64_short", 64, 12, 64, 16, 128, short,
                "float32", 5, parent)
    for H, D in ((6, 128), (24, 32)):
        for kv in ("float32", "int8"):
            paged_phase(torch, pa, f"H{H}_D{D}", 8, H, D, 16, 128, main_pos,
                        kv, 6, parent)
    # GPTConfig.tiny()'s head dim (its serving path decodes through here)
    for kv in ("float32", "bfloat16", "int8"):
        paged_phase(torch, pa, "H2_D16", 8, 2, 16, 16, 128, main_pos, kv,
                    12, parent)
    for bs in (32, 128):
        for kv in ("float32", "int8"):
            paged_phase(torch, pa, f"bs{bs}", 8, 12, 64, bs, 2048 // bs,
                        main_pos, kv, 7, parent)
    # a row with nothing visible; rows whose last live slot ends a split,
    # and one slot past it
    span = pa.split_plan(16, 128)[0] * 16
    edge = [-1, 0, span - 1, span, 2 * span - 1, 2 * span, 2047, 1000]
    for kv in ("float32", "bfloat16", "int8"):
        paged_phase(torch, pa, "edges", 8, 12, 64, 16, 128, edge, kv, 8,
                    parent)
    paged_phase(torch, pa, "edges", 8, 12, 64, 16, 128, edge, "bfloat16",
                9, parent, q_dtype="bfloat16")
    # a block size that is no multiple of 4 (an int8 block's scales are
    # then no whole 16-byte vector)
    span = pa.split_plan(6, 341)[0] * 6
    edge6 = [-1, 0, span - 1, span, 2 * span - 1, 2 * span, 2045, 1000]
    for kv in ("float32", "int8"):
        paged_phase(torch, pa, "edges_bs6", 8, 12, 64, 6, 341, edge6, kv, 11,
                    parent)
    for kv in ("float32", "bfloat16", "int8"):
        paged_determinism(torch, pa, kv, 10)
    torch.cuda.empty_cache()
    return main


# ------------------------------------------------------------- end to end

def end_to_end(torch, np, cfg, device=None, max_len=2048, lo=64, hi=1024,
               new=32):
    """The main path at ``cfg``; prompts of ``lo``..``hi`` tokens and
    ``new`` new tokens each. Returns the number of paged decode steps
    taken."""
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import (Client, InferenceServer,
                                          KVBlockPool, ServingStats)
    t0 = time.perf_counter()
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
    paged_steps = [0]
    step_paged = gen.run_decode_paged

    def counted_step(*a, **k):
        paged_steps[0] += 1
        return step_paged(*a, **k)
    gen.run_decode_paged = counted_step
    print(f"model: GPT {cfg.num_layers} layers h{cfg.hidden_size} "
          f"vocab {cfg.vocab_size}, params on {gen.device} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(0)
    lens = np.linspace(lo, hi, 8).round().astype(int)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    res = {}

    for paged in (False, True):
        gen.stats = None
        gen.generate(prompts[:1], max_new_tokens=2, paged=paged)   # warm
        gen.stats = stats = ServingStats()
        t0 = time.perf_counter()
        outs = gen.generate(prompts, max_new_tokens=new, paged=paged)
        wall = time.perf_counter() - t0
        gen.stats = None
        for o in outs:
            if o.shape != (new,) or o.min() < 0 or o.max() >= cfg.vocab_size:
                raise AssertionError(f"bad generate output {o}")
        key = "paged" if paged else "dense"
        res[key] = outs
        emit({"phase": f"generate_{key}", "rows": len(prompts),
              "prompt_lens": lens.tolist(), "new_tokens": new,
              "wall_s": wall, "prefill_ms": stats.hist["prefill"]
              .snapshot()["mean_ms"],
              "decode_ms_per_step": stats.hist["decode"]
              .snapshot()["mean_ms"],
              "tokens_per_s": len(prompts) * new / wall})
    agree = float(np.mean([(a == b).mean()
                           for a, b in zip(res["dense"], res["paged"])]))
    print(f"greedy agreement dense vs paged: {agree:.4f}", flush=True)

    # teacher forcing: the same prefill into both caches, then the dense
    # greedy tokens fed to both decode steps
    tokens, pos_ids, last = gen._pack_prompts(prompts)
    bb, s = tokens.shape
    logits, ks, vs = gen.run_prefill(tokens, pos_ids, last)
    cache_k, cache_v = gen.new_dense_caches(bb)
    for c, x in zip(cache_k + cache_v, ks + vs):
        c[:, :, :s] = x
    pool = KVBlockPool(slots=bb, num_layers=cfg.num_layers,
                       num_heads=cfg.num_heads, d_head=cfg.d_head,
                       max_seq_len=gen.max_len, dtype="fp32",
                       device=gen.device)
    for r, n in enumerate(lens):
        pool.alloc(r, int(n))
    pool.scatter_prefill(list(range(bb)), ks, vs, s)
    del ks, vs
    pos = lens.astype(np.int32).copy()
    feed = np.stack(res["dense"], 1)                    # [new, rows]
    worst = 0.0
    for step in range(new - 1):
        tok = feed[step]
        for r in range(bb):
            pool.ensure(r, int(pos[r]))
        dense = gen.run_decode(tok, pos, cache_k, cache_v)
        paged = gen.run_decode_paged(tok, pos, pool)
        if not (torch.isfinite(dense).all() and torch.isfinite(paged).all()):
            raise AssertionError("non-finite decode logits")
        worst = max(worst, (dense - paged).abs().max().item())
        pos += 1
    emit({"phase": "teacher_forced_decode", "steps": new - 1,
          "max_abs_logit_diff_paged_vs_dense": worst, "atol": 1e-3})
    if worst > 1e-3:
        raise AssertionError(f"paged decode logits differ from dense by "
                             f"{worst}")
    del cache_k, cache_v, pool

    # the server: 16 requests from 8 concurrent clients through 8 slots
    lens2 = rng.integers(lo, hi + 1, 8)
    prompts16 = prompts + [rng.integers(1, cfg.vocab_size, n).astype(
        np.int32) for n in lens2]
    want = gen.generate(prompts16[:8], max_new_tokens=new, paged=True) \
        + gen.generate(prompts16[8:], max_new_tokens=new, paged=True)
    server = InferenceServer(generator=gen, decode_slots=8,
                             paged=True).start()
    got, errors = {}, []

    def client(idxs):
        try:
            with Client(server.endpoint, timeout=600) as c:
                for i in idxs:
                    got[i] = c.generate(prompts16[i], new)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=((i, i + 8),))
                   for i in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"server clients failed: {errors}")
        st = server.stats()
    finally:
        server.stop()
    mismatched = [i for i in range(16)
                  if not np.array_equal(got.get(i), want[i])]
    emit({"phase": "server", "requests": 16, "clients": 8, "slots": 8,
          "wall_s": wall, "tokens_per_s": 16 * new / wall,
          "requests_completed": st["requests_completed"],
          "kvpool_blocks_in_use": st["kvpool_blocks_in_use"],
          "decode_steps": st["decode_steps"],
          "token_p50_ms": st["token_p50_ms"],
          "mismatched_vs_offline": mismatched})
    if mismatched or st["requests_completed"] != 16 \
            or st["kvpool_blocks_in_use"] != 0:
        raise AssertionError(f"server replies differ from offline greedy "
                             f"generate for requests {mismatched}")
    return {"paged_decode_steps": paged_steps[0]}


def event_ms(torch, fn, iters):
    """Device time of one call of ``fn`` between two events over
    ``iters`` back-to-back calls, after one warm-up call (for calls of a
    millisecond or more, where the host's launch overhead is hidden)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bwd_phase(torch, fa, name, B, H, S, D, dtype, causal, with_bias, seed,
              packed):
    """One backward kernel (``name``: its wrapper) against
    ``flash_attention_bwd_ref`` on the same inputs; the forward's out and
    lse2 come from K1. Limit: max |kernel - ref| per output within 1e-4
    (float32) or 2e-2 (bf16) of that output's max |ref|. The library time
    is the backward of ``scaled_dot_product_attention`` alone (autograd
    through one retained forward)."""
    F = torch.nn.functional
    replaces, outs, products = BWD_KERNELS[name]
    q, k, v, bias, g = attention_inputs(torch, B, H, S, D, dtype, with_bias,
                                        seed, packed)
    scale = D ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, causal)
    dout = torch.randn(B, H, S, D, device="cuda", generator=g).to(q.dtype)
    args = (q, k, v, bias, scale, causal, out, lse, dout)
    kern = getattr(fa, name)
    got = kern(*args)
    got = (got,) if len(outs) == 1 else got
    ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(*args)))
    torch.cuda.synchronize()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    errs, rel = {}, {}
    for o, t in zip(outs, got):
        r = ref[o].float()
        errs[o] = (t.float() - r).abs().max().item()
        rel[o] = errs[o] / r.abs().max().item()
    ok = max(rel.values()) <= tol and all(bool(torch.isfinite(t).all())
                                          for t in got)
    del got, ref
    ms = event_ms(torch, lambda: kern(*args), 10)
    plain_ms = event_ms(torch, lambda: fa.flash_attention_bwd_ref(*args), 3)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    mask = None if bias is None else bias.to(q.dtype)
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        is_causal=causal)
    lib_ms = event_ms(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, lv), dout, retain_graph=True), 10)
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 2.0 * products * B * H * pairs * D
    nbytes = (4 + len(outs)) * B * H * S * D * q.element_size() \
        + 2 * B * H * S * 4 + (B * S * 4 if with_bias else 0)
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    rec = {"phase": name, "replaces": replaces, "B": B, "H": H, "S": S,
           "D": D, "dtype": dtype, "causal": causal, "bias": with_bias,
           "layout": "packed qkv views" if packed else "contiguous",
           "max_abs_err": max(errs.values()), "abs_err": errs,
           "err_over_max_ref": rel, "limit_over_max_ref": tol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "tflops": ops / ms / 1e9, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rec}")
    return rec


def bwd_pair_phase(torch, fa, B, H, S, D, dtype, seed, causal=True,
                   with_bias=False):
    """The K3 + K4 route against its yardsticks on one input (the model's
    strided views; causal, or non-causal with a key bias): K3 then K4
    back to back as one timed call, K2 on the same input, and the
    backward of ``scaled_dot_product_attention`` with the same mask (the
    one library call that computes dq, dk and dv). The pair's outputs are
    held against K2's (two independent kernels; limit as in
    ``bwd_phase``), so no S x S plain backward is materialized."""
    F = torch.nn.functional
    q, k, v, bias, g = attention_inputs(torch, B, H, S, D, dtype, with_bias,
                                        seed, True)
    scale = D ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, causal)
    dout = torch.randn(B, H, S, D, device="cuda", generator=g).to(q.dtype)
    args = (q, k, v, bias, scale, causal, out, lse, dout)

    def pair():
        return (fa.flash_attention_bwd_dq(*args),
                *fa.flash_attention_bwd_dkv(*args))

    got, want = pair(), fa.flash_attention_bwd_single(*args)
    torch.cuda.synchronize()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    rel = {o: ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
           for o, a, b in zip(("dq", "dk", "dv"), got, want)}
    ok = max(rel.values()) <= tol and all(bool(torch.isfinite(t).all())
                                          for t in got)
    del got, want
    k3_ms = event_ms(torch, lambda: fa.flash_attention_bwd_dq(*args), 10)
    k4_ms = event_ms(torch, lambda: fa.flash_attention_bwd_dkv(*args), 10)
    ms = event_ms(torch, pair, 10)
    k2_ms = event_ms(torch, lambda: fa.flash_attention_bwd_single(*args), 10)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    mask = None if bias is None else bias.to(q.dtype)
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        is_causal=causal)
    lib_ms = event_ms(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, lv), dout, retain_graph=True), 10)
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = 7 * B * H * S * D * q.element_size() + 2 * B * H * S * 4 \
        + (B * S * 4 if bias is not None else 0)
    # the pair does 7 score-sized products (K3: 3, K4: 4), K2 5
    bound_ms, bound_by = bound(nbytes, 14.0 * B * H * pairs * D, dtype)
    k2_bound_ms = bound(nbytes, 10.0 * B * H * pairs * D, dtype)[0]
    rec = {"phase": "bwd_pair", "B": B, "H": H, "S": S, "D": D,
           "dtype": dtype, "causal": causal, "bias": with_bias,
           "layout": "packed qkv views",
           "err_over_max_k2": rel, "limit_over_max_ref": tol,
           "k3_ms": k3_ms, "k4_ms": k4_ms, "ms": ms, "k2_ms": k2_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms,
           "k2_bound_ms": k2_bound_ms, "bound_by": bound_by,
           "single_pass_route": fa.single_pass_backward(S, causal),
           "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"K3 + K4 disagree with K2: {rec}")
    return rec


def k2_determinism(torch, fa, dtype, parent_fa=None, seed=1031):
    """K2 called twice on the main S1024 input (B8 H12 D64 causal, the
    model's strided views) gives the same dq, dk and dv bits: its k
    tiles add their dq shares in a fixed order. With ``parent_fa``
    (another tree's wrappers, :func:`parent_flash`) that tree's K2 is
    called twice too (recorded, not held) and both are timed in the
    order parent, new, new, parent."""
    q, k, v, _, g = attention_inputs(torch, 8, 12, 1024, 64, dtype, False,
                                     seed, True)
    scale = 64 ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, None, scale, True)
    dout = torch.randn(8, 12, 1024, 64, device="cuda", generator=g).to(
        q.dtype)
    args = (q, k, v, None, scale, True, out, lse, dout)

    def same_bits(kern):
        a, b = kern(*args), kern(*args)
        return {o: bool(torch.equal(x, y))
                for o, x, y in zip(("dq", "dk", "dv"), a, b)}

    rec = {"phase": "k2_determinism", "B": 8, "H": 12, "S": 1024, "D": 64,
           "dtype": dtype, "causal": True,
           "bitwise": same_bits(fa.flash_attention_bwd_single)}
    new = fa.flash_attention_bwd_single
    if parent_fa is not None:
        old = parent_fa.flash_attention_bwd_single
        rec["parent_bitwise"] = same_bits(old)
        t = [event_ms(torch, lambda f=f: f(*args), 10)
             for f in (old, new, new, old)]
        rec.update(ms=(t[1] + t[2]) / 2, parent_ms=(t[0] + t[3]) / 2,
                   pccp_ms=t)
    else:
        rec["ms"] = event_ms(torch, lambda: new(*args), 10)
    rec["ok"] = all(rec["bitwise"].values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"K2 is not deterministic: {rec}")
    return rec


# ----------------------------------------------------- training (Fluid)

def gpt_train_flops_per_sample(cfg, seq_len):
    """Analytic matmul FLOPs per sample of one training step: forward x3
    for forward + backward, causal attention counting the live half of
    the score square (the formula of the repository's bench.py
    ``_gpt_train_flops_per_sample``)."""
    h, L, ffn, V = (cfg.hidden_size, cfg.num_layers, cfg.ffn_size,
                    cfg.vocab_size)
    per_layer = (4 * 2 * seq_len * h * h + 2 * 2 * seq_len * h * ffn
                 + 2 * seq_len * seq_len * h)
    return 3 * (L * per_layer + 2 * seq_len * h * V)


def build_train(cfg, B, S, amp=None):
    """``gpt_pretrain`` + ``AdamOptimizer(1e-4).minimize``; ``amp``
    "static" wraps Adam in bf16 mixed precision at a static loss scale of
    1.0 (bench.py's ``bench_gpt_long``), "dynamic" with dynamic loss
    scaling (``decorate``'s defaults). Returns (main, startup, loss,
    params_grads, optimizer)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = gpt.gpt_pretrain(cfg, B, S)
        opt = fluid.optimizer.AdamOptimizer(1e-4)
        if amp is not None:
            kw = {"static": dict(init_loss_scaling=1.0,
                                 use_dynamic_loss_scaling=False),
                  "dynamic": {}}[amp]
            opt = fluid.contrib.mixed_precision.decorate(opt, **kw)
        _, params_grads = opt.minimize(out["loss"])
    return main, startup, out["loss"], params_grads, opt


UPDATE_OPS = ("sgd", "momentum", "adam", "adamw")


def optimizer_ops(exe, program, fetch_names):
    """{op type: count} of the optimizer update ops (per-param and
    fused) in the program the executor runs for ``program`` (the pass
    pipeline's output)."""
    ops = exe._optimize(program, fetch_names).global_block().ops
    types = UPDATE_OPS + tuple("fused_" + t for t in UPDATE_OPS)
    counts = {t: sum(op.type == t for op in ops) for t in types}
    return {t: n for t, n in counts.items() if n}


def train_phase(torch, np, cfg, B, S, steps, place=None, seed=0, amp=None):
    """``steps`` Adam steps of ``gpt_pretrain`` through the Fluid surface
    on one seeded batch; ``place`` None is the GPU (a CPUPlace rehearses
    the path at a tiny size); ``amp`` as in :func:`build_train`. Returns
    the phase record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup, loss, _, _ = build_train(cfg, B, S, amp)
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, wall = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        wall.append((time.perf_counter() - t0) * 1e3)  # fetch syncs
        losses.append(float(np.ravel(lv)[0]))
    step_ms = float(np.median(wall[1:])) if steps > 1 else wall[0]
    flops = gpt_train_flops_per_sample(cfg, S) * B
    name = f"train_gpt_B{B}_S{S}" + ("" if amp is None else f"_amp_bf16")
    rec = {"phase": name, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "dropout": cfg.dropout, "amp": amp, "steps": steps,
           "program_passes": fluid.get_flags("FLAGS_program_passes")[
               "FLAGS_program_passes"],
           "optimizer_ops_per_step": optimizer_ops(exe, main, [loss.name]),
           "losses": losses, "step_ms": wall,
           "median_step_ms_after_first": step_ms,
           "tokens_per_s": B * S / step_ms * 1e3,
           "analytic_flops_per_step": flops,
           "achieved_tflops": flops / step_ms / 1e9,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None),
           "ln_vocab": float(np.log(cfg.vocab_size))}
    bad = [x for x in losses if not np.isfinite(x)]
    if bad or abs(losses[0] - np.log(cfg.vocab_size)) > 1.0 \
            or not losses[-1] < losses[0]:
        emit(rec)
        raise AssertionError(f"GPT training losses are off: {losses}")
    return rec


def copied_scope(torch, fluid, scope):
    new = fluid.Scope()
    for n, v in scope.items():
        new.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return new


def grad_check(torch, np, cfg, B, S, place=None, seed=1, amp=None):
    """Every param@GRAD of one ``gpt_pretrain`` step through the kernels
    against the plain composite (:func:`grads_vs_composite`); limit 1e-3
    of each grad's max |value|, 2e-2 under bf16 AMP (``amp``
    "static")."""
    from paddle_tpu_torch.models import gpt
    main, startup, _, params_grads, _ = build_train(cfg, B, S, amp)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    name = f"grad_check_B{B}_S{S}" + ("" if amp is None else "_amp_bf16")
    return grads_vs_composite(torch, np, name, cfg, main, startup,
                              params_grads, feed, place,
                              1e-3 if amp is None else 2e-2)


def grads_vs_composite(torch, np, name, cfg, main, startup, params_grads,
                       feed, place, limit):
    """Every param@GRAD of one step of ``main`` through the kernels
    against the same program cloned with the flash_attention op's impl
    set to "xla" (the plain composite), from copies of one startup scope
    (so dropout draws the same masks); each within ``limit`` of its max
    |value|."""
    import paddle_tpu_torch as fluid
    plain = main.clone()
    for op in plain.global_block().ops:
        if op.type == "flash_attention":
            op.attrs["impl"] = "xla"
        elif op.type == "flash_attention_grad":
            op.attrs["__fwd_op__"]["attrs"]["impl"] = "xla"
    exe = fluid.Executor(place)
    s1 = fluid.Scope()
    exe.run(startup, scope=s1)
    s2 = copied_scope(torch, fluid, s1)
    names = [g.name for _, g in params_grads]
    kern = exe.run(main, feed=feed, fetch_list=names, scope=s1)
    ref = exe.run(plain, feed=feed, fetch_list=names, scope=s2)
    worst, worst_name = 0.0, None
    for n, a, b in zip(names, kern, ref):
        a, b = a.astype(np.float32), b.astype(np.float32)
        r = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) \
            if np.isfinite(a).all() else float("inf")
        if r >= worst:
            worst, worst_name = r, n
    rec = {"phase": name, "layers": cfg.num_layers, "grads": len(names),
           "worst_err_over_max_grad": worst, "worst_grad": worst_name,
           "limit": limit}
    emit(rec)
    if not worst <= limit:
        raise AssertionError(f"kernel grads differ from the plain "
                             f"composite's: {rec}")
    return rec


def pipeline_ab(torch, np, cfg, B, S, place=None, seed=2):
    """One step with FLAGS_program_passes "0" and one with "1" (dce, cse,
    fuse_optimizer) from copies of one startup scope: every param,
    moment and beta-pow bitwise equal (fused_adam is the per-param adam
    update), the loss too. Prints the pipeline's ``stats()``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import passes
    from paddle_tpu_torch.models import gpt
    main, startup, loss, _, _ = build_train(cfg, B, S)
    exe = fluid.Executor(place)
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    s1 = copied_scope(torch, fluid, s0)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    old = fluid.get_flags("FLAGS_program_passes")
    try:
        fluid.set_flags({"FLAGS_program_passes": "0"})
        l0, = exe.run(main, feed=feed, fetch_list=[loss], scope=s0)
        fluid.set_flags({"FLAGS_program_passes": "1"})
        l1, = exe.run(main, feed=feed, fetch_list=[loss], scope=s1)
        stats = passes.stats()
        ops = optimizer_ops(exe, main, [loss.name])
    finally:
        fluid.set_flags(old)
    names = [n for n, v in s0.items() if isinstance(v, torch.Tensor)]
    differ = [n for n in names
              if not torch.equal(s0.find_var(n), s1.find_var(n))]
    rec = {"phase": f"pipeline_ab_B{B}_S{S}", "layers": cfg.num_layers,
           "state_tensors": len(names), "differ": differ,
           "loss_bitwise": bool(np.array_equal(l0, l1)),
           "optimizer_ops_with_pipeline": ops,
           "pass_stats": [{k: r[k] for k in ("pass", "ops_before",
                                              "ops_after", "detail")}
                          for r in stats["passes"]],
           "pass_total_ms": stats["total_ms"]}
    rec["ok"] = not differ and rec["loss_bitwise"] and ops["fused_adam"] > 0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the pass pipeline changed the step: {rec}")
    return rec


def dynamic_scaling(torch, np, cfg, B, S, steps, place=None, seed=3):
    """``steps`` bf16 AMP steps with dynamic loss scaling (initial scale
    2^15, scale doubles after 1000 clean steps): finite, falling losses;
    no overflow, so the scale stays 2^15, the good counter counts the
    steps and the bad one stays 0."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup, loss, _, opt = build_train(cfg, B, S, "dynamic")
    state = [opt.get_loss_scaling(), opt._num_good_steps,
             opt._num_bad_steps]
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    losses = []
    for _ in range(steps):
        lv, scale, good, bad = exe.run(main, feed=feed,
                                       fetch_list=[loss] + state,
                                       scope=scope)
        losses.append(float(np.ravel(lv)[0]))
    rec = {"phase": f"dynamic_loss_scaling_B{B}_S{S}",
           "layers": cfg.num_layers, "losses": losses,
           "loss_scaling": float(scale[0]), "num_good_steps": float(good[0]),
           "num_bad_steps": float(bad[0])}
    rec["ok"] = (all(np.isfinite(losses)) and losses[-1] < losses[0]
                 and rec["loss_scaling"] == 2.0 ** 15
                 and rec["num_good_steps"] == steps
                 and rec["num_bad_steps"] == 0)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"dynamic loss scaling is off: {rec}")
    return rec


def tiny_generate(torch, np, device=None):
    """GPTConfig.tiny() (head dim 16) through one paged and one dense
    greedy generate: tokens in range, the same length. K5 runs at D16."""
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    cfg = GPTConfig.tiny()
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=64,
                       device=device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 30)]
    paged = gen.generate(prompts, max_new_tokens=12, paged=True)
    dense = gen.generate(prompts, max_new_tokens=12, paged=False)
    ok = all(o.shape == (12,) and o.min() >= 0 and o.max() < cfg.vocab_size
             for o in paged + dense)
    agree = float(np.mean([(a == b).mean() for a, b in zip(paged, dense)]))
    rec = {"phase": "generate_tiny_paged", "d_head": cfg.d_head,
           "rows": len(prompts), "new_tokens": 12,
           "greedy_agreement_dense_vs_paged": agree, "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"tiny paged generate is off: {rec}")
    return rec


# ------------------------------------------------------ BERT (Fluid)

# bench.py's two BERT-base trainers: bench_bert_long (flash attention,
# default AMP lists) and main(), the flagship (einsum attention with
# dropout, softmax on the AMP white list; B64 is the batch main() picks
# for a GPU)
BERT_LONG = {"name": "bert_long", "B": 16, "S": 2048, "P": 64,
             "mech": "flash", "white": ()}
BERT_FLAGSHIP = {"name": "bert_flagship", "B": 64, "S": 128, "P": 20,
                 "mech": None, "white": ("softmax",)}


def bert_train_flops_per_sample(cfg, seq_len, max_preds):
    """Analytic matmul FLOPs per sample of one BERT pretraining step,
    forward x3 for forward + backward (the formula of the repository's
    bench.py ``_bert_train_flops_per_sample``)."""
    h, L, ffn = cfg.hidden_size, cfg.num_layers, cfg.ffn_size
    v = cfg.vocab_size
    per_layer = (4 * 2 * seq_len * h * h + 2 * 2 * seq_len * h * ffn
                 + 2 * 2 * seq_len * seq_len * h)
    heads = 2 * max_preds * h * h + 2 * max_preds * h * v + 2 * h * h
    return 3 * (L * per_layer + heads)


def noam_lr(np, step, d_model, warmup=10000, scale=200.0):
    """The learning rate ``noam_decay(d_model, warmup, scale)`` gives at
    ``step``, in the program's float32 operations and order: scale *
    d_model^-0.5 * min(rsqrt(step), step * warmup^-1.5). Below step
    ``warmup`` the min is the linear term, so the value is exact IEEE
    float32 arithmetic (rsqrt's rounding does not enter)."""
    f = np.float32
    n = f(step)
    return f(scale * d_model ** -0.5) * min(f(1) / np.sqrt(n),
                                            n * f(warmup ** -1.5))


def bert_config(layers=None, mech=None, dropout=None, max_position=None):
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig.base()
    cfg.attn_mechanism = mech
    if layers is not None:
        cfg.num_layers = layers
    if dropout is not None:
        cfg.hidden_dropout = cfg.attn_dropout = dropout
    if max_position is not None:
        cfg.max_position = max_position
    return cfg


def build_bert(cfg, B, S, P, white=(), lr=None):
    """``bert_pretrain`` + ``AdamOptimizer`` at ``noam_decay(768, 10000,
    200.0)`` (or a constant ``lr``), wrapped by ``mp.decorate`` at a
    static loss scale of 1.0 with ``white`` on the AMP white list, as
    bench.py trains. Returns (main, startup, outputs, lr var or value,
    params_grads)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    mp = fluid.contrib.mixed_precision
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        if lr is None:
            lr = fluid.layers.noam_decay(cfg.hidden_size, 10000, 200.0)
        opt = mp.decorate(
            fluid.optimizer.AdamOptimizer(lr),
            amp_lists=mp.AutoMixedPrecisionLists(
                custom_white_list=set(white)),
            init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(out["loss"])
    return main, startup, out, lr, params_grads


def bert_train_phase(torch, np, run, steps, layers=None, place=None,
                     seed=0):
    """``steps`` steps of one of bench.py's BERT-base trainers (``run``:
    :data:`BERT_LONG` or :data:`BERT_FLAGSHIP`) through the Fluid surface
    on one seeded batch: finite losses, step 0 within 1.0 of ln(vocab) +
    ln(2) (the MLM and NSP losses of a random model), and each step's
    learning rate read back equal to :func:`noam_lr`. ``layers`` cuts the
    depth (a CPU rehearsal). Returns the phase record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    B, S, P = run["B"], run["S"], run["P"]
    cfg = bert_config(layers, run["mech"],
                      max_position=max(S, 512))
    main, startup, out, lr, _ = build_bert(cfg, B, S, P, run["white"])
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.random_batch(cfg, B, S, P, rng=np.random.default_rng(seed))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, lrs, accs, wall = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lv, acc, lrv = exe.run(main, feed=feed, fetch_list=[
            out["loss"], out["nsp_acc"], lr], scope=scope)
        wall.append((time.perf_counter() - t0) * 1e3)  # fetch syncs
        losses.append(float(np.ravel(lv)[0]))
        accs.append(float(np.ravel(acc)[0]))
        lrs.append(np.float32(np.ravel(lrv)[0]))
    step_ms = float(np.median(wall[1:])) if steps > 1 else wall[0]
    flops = bert_train_flops_per_sample(cfg, S, P) * B
    want_lr = [noam_lr(np, i + 1, cfg.hidden_size) for i in range(steps)]
    start = float(np.log(cfg.vocab_size) + np.log(2))
    rec = {"phase": f"train_{run['name']}_amp_bf16", "B": B, "S": S,
           "P": P, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "vocab": cfg.vocab_size, "attention": run["mech"] or "einsum",
           "amp_white_extra": list(run["white"]),
           "dropout": cfg.hidden_dropout, "steps": steps,
           "losses": losses, "nsp_acc": accs,
           "lr": [float(x) for x in lrs],
           "lr_noam": [float(x) for x in want_lr],
           "lr_equal": [bool(a == b) for a, b in zip(lrs, want_lr)],
           "step_ms": wall, "median_step_ms_after_first": step_ms,
           "samples_per_s": B / step_ms * 1e3,
           "tokens_per_s": B * S / step_ms * 1e3,
           "analytic_flops_per_step": flops,
           "achieved_tflops": flops / step_ms / 1e9,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if cuda else None),
           "ln_vocab_plus_ln2": start}
    bad = [x for x in losses if not np.isfinite(x)]
    if bad or abs(losses[0] - start) > 1.0 or not all(rec["lr_equal"]):
        emit(rec)
        raise AssertionError(f"BERT training is off: losses {losses}, "
                             f"lr {rec['lr']} vs {rec['lr_noam']}")
    return rec


def bert_verified_step(torch, np, layers=None, place=None, seed=4):
    """One ``bert_long`` step with FLAGS_verify_passes on: the executor
    verifies the program and validates each pass of the pipeline; raises
    nothing. Prints the verification's and the pipeline's ms."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import passes
    from paddle_tpu_torch.models import bert
    run = BERT_LONG
    cfg = bert_config(layers, run["mech"], max_position=run["S"])
    main, startup, out, _, _ = build_bert(cfg, run["B"], run["S"],
                                          run["P"])
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.random_batch(cfg, run["B"], run["S"], run["P"],
                             rng=np.random.default_rng(seed))
    old = fluid.get_flags("FLAGS_verify_passes")
    fluid.set_flags({"FLAGS_verify_passes": True})
    try:
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=feed, fetch_list=[out["loss"]],
                      scope=scope)
        wall = (time.perf_counter() - t0) * 1e3
        st = passes.stats()
    finally:
        fluid.set_flags(old)
    rec = {"phase": "bert_verified_step", "layers": cfg.num_layers,
           "ops": len(main.global_block().ops),
           "verify_ms": exe.verify_ms, "pipeline_verify_ms": st["verify_ms"],
           "pass_total_ms": st["total_ms"], "step_ms": wall,
           "loss": float(np.ravel(lv)[0])}
    rec["ok"] = bool(np.isfinite(rec["loss"])) and exe.verify_ms > 0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the verified BERT step is off: {rec}")
    return rec


def eval_bert_entry(torch, np, layers=None, place=None, seed=5):
    """``__graft_entry__.entry()``'s evaluation: BERT-base at B8 S128 P20
    through ``main.clone(for_test=True)`` (fp32, dropout as is_test): a
    finite loss, the same on a second run."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    cfg = bert_config(layers)
    B, S, P = 8, 128, 20
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
    test = main.clone(for_test=True)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.random_batch(cfg, B, S, P, rng=np.random.default_rng(seed))
    runs = [float(np.ravel(exe.run(test, feed=feed,
                                   fetch_list=[out["loss"]],
                                   scope=scope)[0])[0]) for _ in range(2)]
    rec = {"phase": "eval_bert_entry", "B": B, "S": S, "P": P,
           "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "losses": runs}
    rec["ok"] = bool(np.isfinite(runs[0])) and runs[0] == runs[1]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"BERT evaluation is off: {rec}")
    return rec


def bert_small(torch, np, place=None, layers=2, B=8, S=2048, P=64):
    """BERT-base width, ``layers`` deep, flash, dropout 0, bf16 AMP:
    ``bert_grad_check`` (every param@GRAD through the kernels against the
    composite, within 2e-2 of its max |grad|, as GPT's AMP check) and
    ``bert_falls`` (5 steps at a constant lr 1e-4: step 4 below step 0;
    the bench's noam warmup, 7e-6 to 3.6e-5 over 5 steps, moves the loss
    less than the dropout noise would)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    cfg = bert_config(layers, "flash", dropout=0.0, max_position=S)
    feed = bert.random_batch(cfg, B, S, P, rng=np.random.default_rng(6))
    main, startup, _, _, params_grads = build_bert(cfg, B, S, P)
    grads_vs_composite(torch, np, f"bert_grad_check_B{B}_S{S}_amp_bf16",
                       cfg, main, startup, params_grads, feed, place, 2e-2)
    main, startup, out, _, _ = build_bert(cfg, B, S, P, lr=1e-4)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(np.ravel(exe.run(main, feed=feed,
                                     fetch_list=[out["loss"]],
                                     scope=scope)[0])[0])
              for _ in range(5)]
    rec = {"phase": "bert_falls", "layers": layers, "B": B, "S": S,
           "lr": 1e-4, "losses": losses}
    rec["ok"] = all(np.isfinite(losses)) and losses[-1] < losses[0]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"BERT's loss does not fall: {rec}")
    return rec


# ------------------------------------ image classification (ResNet, LeNet)

RESNET50 = {"depth": 50, "classes": 1000, "B": 128, "hw": 224}


def build_resnet(depth, classes, B, hw, lr=0.1, amp=False):
    """``resnet_train_program`` + ``Momentum(lr, 0.9)``; ``amp`` wraps it
    as bench.py's ``bench_resnet50`` does (bf16, batch_norm on the AMP
    white list, static loss scale 1.0). Returns (main, startup,
    outputs, params_grads)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    mp = fluid.contrib.mixed_precision
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = resnet.resnet_train_program(depth=depth, class_dim=classes,
                                          image_shape=(3, hw, hw),
                                          batch_size=B)
        opt = fluid.optimizer.Momentum(lr, 0.9)
        if amp:
            opt = mp.decorate(opt, amp_lists=mp.AutoMixedPrecisionLists(
                custom_white_list={"batch_norm"}), init_loss_scaling=1.0,
                use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(out["loss"])
    return main, startup, out, params_grads


def conv_fc_flops_per_step(program):
    """Analytic FLOPs of one training step from the program's ``conv2d``
    and ``mul`` (fc) shapes: 2 x multiply-adds of the forward, x3 for
    the forward and the backward's two products."""
    block = program.global_block()
    macs = 0
    for op in block.ops:
        if op.type == "conv2d":
            o = block.var(op.output("Output")[0]).shape
            w = block.var(op.input("Filter")[0]).shape
            macs += o[0] * o[1] * o[2] * o[3] * w[1] * w[2] * w[3]
        elif op.type == "mul":
            x = block.var(op.input("X")[0]).shape
            w = block.var(op.input("Y")[0]).shape
            macs += x[0] * w[0] * w[1]
    return 2 * macs * 3


def image_pool(torch, np, B, hw, classes, device, seed=0):
    """The two-batch seeded feed pool of bench.py's ``_device_pool``
    (normal images, uniform labels), staged on ``device``."""
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.standard_normal(
                (B, 3, hw, hw)).astype(np.float32)).to(device),
             "label": torch.from_numpy(rng.integers(
                 0, classes, (B, 1)).astype(np.int64)).to(device)}
            for _ in range(2)]


def resnet_train_phase(torch, np, run=RESNET50, steps=5, place=None,
                       seed=0):
    """``bench_resnet50``'s program (Momentum(0.1, 0.9), bf16 AMP with
    batch_norm white-listed) for ``steps`` steps over the two-batch
    pool: finite losses, the first within 1.0 of ln(classes); every
    conv2d output and batch_norm Y bf16 (in the program and, in one more
    step that fetches them, on the device); the moving mean and variance
    moved off (0, 1) in step 0 and float32; the pipeline's fused_momentum
    in place of the per-param updates. Returns (record, main, scope,
    executor)."""
    import paddle_tpu_torch as fluid
    main, startup, out, _ = build_resnet(run["depth"], run["classes"],
                                         run["B"], run["hw"], amp=True)
    block = main.global_block()
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pool = image_pool(torch, np, run["B"], run["hw"], run["classes"],
                      exe.device, seed)
    stats = [v.name for v in block.vars.values()
             if v.name.endswith(("_bn_mean", "_bn_variance"))]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, wall, moved = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=pool[i % 2], fetch_list=[out["loss"]],
                      scope=scope)
        wall.append((time.perf_counter() - t0) * 1e3)  # fetch syncs
        losses.append(float(np.ravel(lv)[0]))
        if i == 0:
            moved = {
                "float32": all(scope.find_var(n).dtype == torch.float32
                               for n in stats),
                "changed": sum(not torch.equal(
                    scope.find_var(n), torch.zeros_like(scope.find_var(n))
                    if n.endswith("_mean") else
                    torch.ones_like(scope.find_var(n))) for n in stats),
                "of": len(stats)}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    outs = [op.output("Output" if op.type == "conv2d" else "Y")[0]
            for op in block.ops if op.type in ("conv2d", "batch_norm")]
    declared = {block.var(n).dtype for n in outs}
    vals = exe.run(main, feed=pool[0], fetch_list=outs, scope=scope,
                   return_numpy=False)
    on_device = {str(v.dtype) for v in vals}
    del vals
    step_ms = float(np.median(wall[1:])) if steps > 1 else wall[0]
    flops = conv_fc_flops_per_step(main)
    start = float(np.log(run["classes"]))
    rec = {"phase": f"resnet{run['depth']}_train",
           "B": run["B"], "image": run["hw"], "classes": run["classes"],
           "optimizer": "Momentum(0.1, 0.9)",
           "amp": "bf16, batch_norm white-listed, static loss scale 1.0",
           "steps": steps, "losses": losses, "step_ms": wall,
           "median_step_ms_after_first": step_ms,
           "images_per_s": run["B"] / step_ms * 1e3,
           "analytic_flops_per_step": flops,
           "analytic_flops_per_image": flops / run["B"],
           "achieved_tflops": flops / step_ms / 1e9, "peak_mem_gb": peak,
           "conv_ops": sum(op.type == "conv2d" for op in block.ops),
           "conv_and_bn_outputs": len(outs),
           "declared_dtypes": sorted(declared),
           "device_dtypes": sorted(on_device),
           "moving_stats_after_step0": moved,
           "optimizer_ops_per_step": optimizer_ops(exe, main,
                                                   [out["loss"].name]),
           "ln_classes": start}
    ok = (all(np.isfinite(losses)) and abs(losses[0] - start) <= 1.0
          and declared == {"bfloat16"} and on_device == {"torch.bfloat16"}
          and moved["float32"] and moved["changed"] == moved["of"]
          and "momentum" not in rec["optimizer_ops_per_step"]
          and rec["optimizer_ops_per_step"].get("fused_momentum", 0) >= 1)
    if not ok:
        emit(rec)
        raise AssertionError(f"ResNet training is off: {rec}")
    return rec, scope, exe


def resnet_eval_phase(torch, np, scope, exe, run=RESNET50, seed=7):
    """``clone(for_test=True)`` of the fp32 ResNet program at the run's
    batch, over the trained scope, fetching loss and acc (and logits):
    finite, the same on a second (timed) run, and other logits than a
    train-mode forward (batch statistics) on the same batch gives."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = resnet.resnet_train_program(
            depth=run["depth"], class_dim=run["classes"],
            image_shape=(3, run["hw"], run["hw"]), batch_size=run["B"])
    test = main.clone(for_test=True)
    feed = image_pool(torch, np, run["B"], run["hw"], run["classes"],
                      exe.device, seed)[0]
    fetch = [out["loss"], out["acc"], out["logits"]]
    loss, acc, logits = exe.run(test, feed=feed, fetch_list=fetch,
                                scope=scope)
    t0 = time.perf_counter()            # the second run: warm
    again, _, _ = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
    ms = (time.perf_counter() - t0) * 1e3
    train_logits, = exe.run(main, feed=feed, fetch_list=[out["logits"]],
                            scope=scope)
    diff = float(np.abs(train_logits - logits).max())
    rec = {"phase": f"resnet{run['depth']}_eval", "B": run["B"],
           "dtype": "float32", "loss": float(np.ravel(loss)[0]),
           "acc": float(np.ravel(acc)[0]), "warm_ms": ms,
           "batch_norm_is_test": all(op.attrs["is_test"] for op in
                                     test.global_block().ops
                                     if op.type == "batch_norm"),
           "max_abs_logit_diff_vs_train_forward": diff,
           "max_abs_logit": float(np.abs(logits).max())}
    rec["ok"] = (bool(np.isfinite(rec["loss"]))
                 and float(np.ravel(again)[0]) == rec["loss"]
                 and rec["batch_norm_is_test"]
                 and diff > 1e-3 * rec["max_abs_logit"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"ResNet evaluation is off: {rec}")
    return rec


def tiny_feed(torch, np, device, seed=0):
    """JAX's ``test_resnet18_tiny_trains`` batch (B8 32x32, 4 classes):
    normal images with a class-dependent offset on one channel."""
    rng = np.random.default_rng(seed)
    xv = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    yv = rng.integers(0, 4, (8, 1)).astype(np.int64)
    for i in range(8):
        xv[i, yv[i, 0] % 3] += 1.5
    return {"image": torch.from_numpy(xv).to(device),
            "label": torch.from_numpy(yv).to(device)}


def resnet18_tiny_trains(torch, np, place=None, steps=12):
    """JAX's ``test_resnet18_tiny_trains``: ResNet-18, class_dim 4,
    32x32, B8, ``MomentumOptimizer(0.01, 0.9)``, fp32, 12 steps on one
    batch: the last loss below 0.7 x the first."""
    import paddle_tpu_torch as fluid
    main, startup, out, _ = build_resnet(18, 4, 8, 32, lr=0.01)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = tiny_feed(torch, np, exe.device)
    losses = [float(np.ravel(exe.run(main, feed=feed,
                                     fetch_list=[out["loss"]],
                                     scope=scope)[0])[0])
              for _ in range(steps)]
    rec = {"phase": "resnet18_tiny_trains", "losses": losses,
           "limit": "last < 0.7 x first"}
    rec["ok"] = all(np.isfinite(losses)) and losses[-1] < 0.7 * losses[0]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"ResNet-18 does not train: {rec}")
    return rec


def resnet_grads(torch, np, place=None, limit=1e-3):
    """ResNet-18 at 32x32 B8 fp32: every param@GRAD with the bespoke
    ``conv2d_grad`` and ``batch_norm_grad`` against the generic vjp over
    the same lowerings (the bespoke grads switched off), each within
    ``limit`` of the generic grad's max |value|. cuDNN's TF32 setting
    (torch's default, not changed here) is in the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.registry import OPS
    from paddle_tpu_torch.models import resnet
    prog, start = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, start):
        o = resnet.resnet_train_program(depth=18, class_dim=4,
                                        image_shape=(3, 32, 32),
                                        batch_size=8)
        params_grads = fluid.append_backward(o["loss"])
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(start, scope=scope)
    feed = tiny_feed(torch, np, exe.device, seed=1)
    names = [g.name for _, g in params_grads]
    state = {n: v.clone() for n, v in scope.items()
             if isinstance(v, torch.Tensor)}
    bespoke = exe.run(prog, feed=feed, fetch_list=names, scope=scope)
    for n, v in state.items():          # the moving statistics moved
        scope.set(n, v)
    saved = {t: OPS[t].custom_grad_lower for t in ("conv2d", "batch_norm")}
    try:
        for t in saved:
            OPS[t].custom_grad_lower = None
        generic = exe.run(prog.clone(), feed=feed, fetch_list=names,
                          scope=scope)
    finally:
        for t, fn in saved.items():
            OPS[t].custom_grad_lower = fn
    errs = {n: float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                 1e-30)
            for n, a, b in zip(names, bespoke, generic)}
    worst = max(errs, key=errs.get)
    rec = {"phase": "resnet_grads", "model": "ResNet-18 32x32 B8 fp32",
           "grads": len(names), "worst": worst, "worst_err": errs[worst],
           "limit": limit,
           "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}
    rec["ok"] = errs[worst] <= limit
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the bespoke grads disagree: {rec}")
    return rec


def synthetic_digits(np, n, seed=0):
    """Separable 28x28 digits (the JAX package's LeNet test data): class
    k lights up a distinct patch."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=(n, 1)).astype("int64")
    imgs = rng.randn(n, 1, 28, 28).astype("float32") * 0.1
    for i, k in enumerate(labels[:, 0]):
        r, c = divmod(int(k), 5)
        imgs[i, 0, r * 10:r * 10 + 8, c * 5:c * 5 + 4] += 1.0
    return imgs, labels


def lenet_train(torch, np, optimizer, lr, place=None, B=512, steps=32):
    """``build_lenet_train`` (``optimizer`` "adam" or "sgd") at
    bench_train_loop's on-card batch, ``steps`` ``Executor.run`` steps
    over a two-batch pool of synthetic digits on the device: steps/s,
    samples/s; finite losses, the last two below the first two."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet_train(lr=lr,
                                                      optimizer=optimizer)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    imgs, labels = synthetic_digits(np, 2 * B)
    pool = [{"img": torch.from_numpy(imgs[i * B:(i + 1) * B]).to(exe.device),
             "label": torch.from_numpy(labels[i * B:(i + 1) * B]).to(
                 exe.device)} for i in range(2)]
    exe.run(main, feed=pool[1], fetch_list=[fetches[0]], scope=scope)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        lv, = exe.run(main, feed=pool[i % 2], fetch_list=[fetches[0]],
                      scope=scope, return_numpy=False)
        losses.append(lv)
    losses = [float(v) for v in losses]         # one sync at the end
    sec = time.perf_counter() - t0
    rec = {"phase": f"lenet_train_{optimizer}", "B": B, "lr": lr,
           "steps": steps, "steps_per_s": steps / sec,
           "samples_per_s": steps * B / sec, "losses": losses,
           "optimizer_ops_per_step": optimizer_ops(exe, main,
                                                   [fetches[0].name])}
    rec["ok"] = (all(np.isfinite(losses))
                 and sum(losses[-2:]) < sum(losses[:2]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"LeNet does not train: {rec}")
    return rec


def fused_optimizers(torch, np, device=None, seed=0):
    """One step of ``fused_sgd``, ``fused_momentum`` (plain and Nesterov)
    and ``fused_adamw`` over ResNet-50's 161 parameter shapes on the
    device, each output held bitwise to its per-param op's; the fused
    bucket and the 161 per-param ops timed (CUDA events)."""
    from paddle_tpu_torch.framework.lowering import LowerCtx
    from paddle_tpu_torch.framework.registry import get_op_def
    from paddle_tpu_torch.models import resnet
    device = device or "cuda"
    shapes = [s for n, s in resnet.param_shapes(50, 1000).items()
              if not n.endswith(("_bn_mean", "_bn_variance"))]
    gen = torch.Generator(device=device).manual_seed(seed)

    def t(shape, lo=False):
        x = torch.randn(shape, generator=gen, device=device)
        return x.abs() if lo else x

    ctx = LowerCtx(None, None, {}, device)
    cases = {"sgd": ("sgd", {}),
             "momentum": ("momentum", {"mu": 0.9, "use_nesterov": False}),
             "momentum_nesterov": ("momentum", {"mu": 0.9,
                                                "use_nesterov": True}),
             "adamw": ("adamw", {"beta1": 0.9, "beta2": 0.999,
                                 "epsilon": 1e-8, "coeff": 0.01})}
    recs = []
    for case, (op, attrs) in cases.items():
        ins = {"Param": [t(s) for s in shapes],
               "Grad": [t(s) for s in shapes],
               "LearningRate": [torch.tensor(0.1, device=device)]}
        if op == "momentum":
            ins["Velocity"] = [t(s) for s in shapes]
        if op == "adamw":
            ins["Moment1"] = [t(s) for s in shapes]
            ins["Moment2"] = [t(s, lo=True) for s in shapes]
            ins["Beta1Pow"] = [torch.tensor(0.9 ** 3, device=device)
                               for _ in shapes]
            ins["Beta2Pow"] = [torch.tensor(0.999 ** 3, device=device)
                               for _ in shapes]
        fused_fn = get_op_def("fused_" + op).lower
        per_fn = get_op_def(op).lower

        def per_param():
            return [per_fn(ctx, {k: [v[i]] if len(v) > 1 else v
                                 for k, v in ins.items()}, attrs)
                    for i in range(len(shapes))]

        fused = fused_fn(ctx, ins, attrs)
        per = per_param()
        same = all(torch.equal(fused[slot][i], one[slot])
                   for i, one in enumerate(per) for slot in one)
        rec = {"phase": f"fused_optimizers_{case}", "params": len(shapes),
               "elements": sum(math.prod(s) for s in shapes),
               "bitwise_equal": bool(same)}
        if device != "cpu":
            rec["fused_ms"] = event_ms(torch, lambda: fused_fn(ctx, ins,
                                                               attrs), 5)
            rec["per_param_ms"] = event_ms(torch, per_param, 5)
        emit(rec)
        recs.append(rec)
        if not same:
            raise AssertionError(f"fused_{op} differs from {op}: {rec}")
    return recs



# ------------------------------------------------- saved-model serving

SERVE_DIR = os.path.join(ROOT, "build", "chip_smoke_models")
# bench.py bench_serving's traffic: a fresh server per request batch
# size, max_batch_size 64, batch_timeout_ms 2.0, warmup of the buckets
# (rb, 8 rb), 8 concurrent wire clients
SERVE_TRAFFIC = {"request_batches": (1, 8, 32), "clients": 8,
                 "requests_per_client": 8, "max_batch_size": 64,
                 "batch_timeout_ms": 2.0}
K1_KERNEL = "flash_fwd_kernel"


def resnet50_serving_program(classes=1000, hw=224, depth=50):
    """serve_resnet50's program: ``resnet_train_program(depth=50,
    class_dim=1000, batch_size=-1)`` with its seeded startup; the saved
    model serves ``logits`` from ``image``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = resnet.resnet_train_program(depth=depth, class_dim=classes,
                                          image_shape=(3, hw, hw),
                                          batch_size=-1)
    return main, startup, ["image"], [out["logits"]]


def bert_serving_program(cfg=None, S=128):
    """serve_bert_base's program: ``BertConfig.base()`` with flash
    attention, feeds ``src_ids``, ``sent_ids``, ``pos_ids`` and
    ``input_mask`` of ``[-1, S]``, the encoder at ``is_test=True``, the
    [CLS] row through ``pooled_fc`` (tanh) and ``next_sent_fc`` with
    softmax under bert_pretrain's parameter names; serves ``pooled``
    ``[B, 768]`` and the next-sentence probabilities ``[B, 2]``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    cfg = cfg or bert.BertConfig.base()
    cfg.attn_mechanism = "flash"
    main, startup = fluid.Program(), fluid.Program()
    names = ["src_ids", "sent_ids", "pos_ids", "input_mask"]
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src, sent, pos, mask = (
            fluid.data(n, [-1, S], "float32" if n == "input_mask"
                       else "int32") for n in names)
        enc, _ = bert.bert_encoder(cfg, src, sent, pos, mask, is_test=True)
        cls = fluid.layers.reshape(fluid.layers.slice(
            enc, axes=[1], starts=[0], ends=[1]), [-1, cfg.hidden_size])
        pooled = fluid.layers.fc(cls, cfg.hidden_size,
                                 param_attr=bert._param(cfg, "pooled_fc.w_0"),
                                 bias_attr=bert._zero("pooled_fc.b_0"),
                                 act="tanh")
        probs = fluid.layers.softmax(fluid.layers.fc(
            pooled, 2, param_attr=bert._param(cfg, "next_sent_fc.w_0"),
            bias_attr=bert._zero("next_sent_fc.b_0")))
    return main, startup, names, [pooled, probs]


def image_request(np, rows, rng, hw=224):
    return {"image": rng.standard_normal((rows, 3, hw, hw))
            .astype(np.float32)}


def bert_request(np, rows, rng, S=128, vocab=30522):
    """Seeded token ids, segment ids, positions and a mask whose padded
    tail covers a random part of each row."""
    lens = rng.integers(S // 4, S + 1, (rows, 1))
    return {"src_ids": rng.integers(0, vocab, (rows, S), dtype=np.int32),
            "sent_ids": (np.arange(S) >= lens // 2).astype(np.int32),
            "pos_ids": np.broadcast_to(np.arange(S, dtype=np.int32),
                                       (rows, S)).copy(),
            "input_mask": (np.arange(S) < lens).astype(np.float32)}


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def io_roundtrip(torch, np, place=None, B=8, **model):
    """Persistence at ResNet-50's full width (``model`` shrinks it for a
    CPU rehearsal): ``save_persistables`` then ``load_persistables`` into
    a fresh scope gives the same bits; ``save_inference_model`` then an
    ``AnalysisPredictor`` over the saved directory gives the eval
    clone's logits bit for bit at B8; a bf16 tensor round-trips bitwise;
    one flipped byte in a ``.npy`` raises ``CheckpointCorruptError``
    naming the file. Prints the save and load ms and the bytes."""
    import shutil
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.resilience import CheckpointCorruptError
    root = os.path.join(SERVE_DIR, "io_roundtrip")
    shutil.rmtree(root, ignore_errors=True)
    pdir, mdir, bdir = (os.path.join(root, n)
                        for n in ("persistables", "model", "bf16"))
    main, startup, feeds, targets = resnet50_serving_program(**model)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    dev = exe.device
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    rec = {"phase": "io_roundtrip", "model": "resnet50" if not model
           else f"resnet{model.get('depth', 50)}"}
    t0 = time.perf_counter()
    fluid.save_persistables(exe, pdir, main_program=main, scope=scope)
    rec["save_persistables_ms"] = (time.perf_counter() - t0) * 1e3
    rec["persistables_bytes"] = dir_bytes(pdir)
    fresh = fluid.Scope()
    t0 = time.perf_counter()
    fluid.load_persistables(exe, pdir, main_program=main, scope=fresh)
    sync()
    rec["load_persistables_ms"] = (time.perf_counter() - t0) * 1e3
    names = [v.name for v in main.list_vars() if v.persistable]
    rec["vars"] = len(names)
    rec["persistables_bitwise"] = all(
        fresh.find_var(n).device == scope.find_var(n).device
        and torch.equal(fresh.find_var(n), scope.find_var(n))
        for n in names)

    t0 = time.perf_counter()
    fluid.save_inference_model(mdir, feeds, targets, exe,
                               main_program=main, scope=scope)
    rec["save_inference_model_ms"] = (time.perf_counter() - t0) * 1e3
    rec["model_bytes"] = dir_bytes(mdir)
    cfg = inference.AnalysisConfig(mdir)
    if dev.type == "cpu":
        cfg.disable_gpu()
    t0 = time.perf_counter()
    pred = inference.create_predictor(cfg)
    sync()
    rec["load_inference_model_ms"] = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(11)
    hw = model.get("hw", 224)
    feed = image_request(np, B, rng, hw)
    logits, = pred.run([feed["image"]])
    test = main.clone(for_test=True)
    feed["label"] = np.zeros((B, 1), np.int64)
    ref, = exe.run(test, feed=feed, fetch_list=targets, scope=scope)
    rec["predictor_logits_bitwise"] = bool(np.array_equal(logits, ref))
    rec["logits_shape"] = list(logits.shape)

    bits = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, (64, 768),
                                         dtype=np.int16))
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80          # no NaN/inf
    prog = fluid.Program()
    prog.global_block().create_var(name="w_bf16", shape=[64, 768],
                                   dtype="bfloat16", persistable=True)
    bscope = fluid.Scope()
    bscope.set("w_bf16", bits.view(torch.bfloat16).to(dev))
    fluid.io.save_vars(exe, bdir, main_program=prog, scope=bscope,
                       predicate=fluid.io.is_persistable)
    back = fluid.Scope()
    fluid.io.load_vars(exe, bdir, main_program=prog, scope=back,
                       predicate=fluid.io.is_persistable)
    got = back.find_var("w_bf16")
    rec["bf16_bitwise"] = got.dtype == torch.bfloat16 and torch.equal(
        got.view(torch.int16).cpu(), bits)

    victim = os.path.join(pdir, "fc_0.w_0.npy")
    with open(victim, "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 0xFF]))
    try:
        fluid.load_persistables(exe, pdir, main_program=main,
                                scope=fluid.Scope())
        rec["corrupt_raised"] = None
    except CheckpointCorruptError as e:
        rec["corrupt_raised"] = os.path.basename(e.path or "")
    shutil.rmtree(root, ignore_errors=True)
    rec["ok"] = (rec["persistables_bitwise"]
                 and rec["predictor_logits_bitwise"] and rec["bf16_bitwise"]
                 and rec["corrupt_raised"] == "fc_0.w_0.npy")
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"io round trip failed: {rec}")
    return rec


def serve_traffic(torch, np, name, build, request, place=None,
                  traffic=SERVE_TRAFFIC, scope=None):
    """The saved model under bench_serving's traffic: save the program
    (over ``scope``, a trained model's, or else its seeded startup's),
    then for each request batch size rb a fresh
    ``InferenceServer(model_dir)`` warmed at the buckets of (rb, 8 rb)
    answers ``clients`` concurrent wire clients, each sending
    ``requests_per_client`` requests of its own rb rows. Returns what
    :func:`check_served` needs; the servers are stopped, their engines
    (and captured graphs) kept."""
    import shutil
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    d = os.path.join(SERVE_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    main, startup, feeds, targets = build()
    exe = fluid.Executor(place)
    if scope is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
    fluid.save_inference_model(d, feeds, targets, exe, main_program=main,
                               scope=scope)
    del scope
    cuda = exe.device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = {"name": name, "dir": d, "feeds": feeds, "runs": {}}
    for rb in traffic["request_batches"]:
        server = serving.InferenceServer(
            d, place=place, max_batch_size=traffic["max_batch_size"],
            batch_timeout_ms=traffic["batch_timeout_ms"], queue_depth=1024)
        t0 = time.perf_counter()
        server.start(warmup_batch_sizes=(rb, 8 * rb))
        warm_s = time.perf_counter() - t0
        rng = np.random.default_rng(rb)
        sent = [request(np, rb, rng) for _ in range(traffic["clients"])]
        replies, lat, errors = {}, [], []

        def client(i):
            try:
                with serving.Client(server.endpoint, timeout=600) as c:
                    for j in range(traffic["requests_per_client"]):
                        t = time.perf_counter()
                        replies[(i, j)] = c.infer(sent[i])
                        lat.append(time.perf_counter() - t)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(traffic["clients"])]
        try:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            st = server.stats()
        finally:
            server.stop()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"serve_{name} rb {rb}: clients failed: "
                                 f"{errors}")
        n = len(replies)
        lat_ms = np.sort(np.array(lat)) * 1e3
        out["runs"][rb] = {
            "engine": server.engine, "sent": sent, "replies": replies,
            "record": {
                "request_batch": rb, "requests": n, "wall_s": wall,
                "warmup_s": warm_s, "requests_per_s": n / wall,
                "samples_per_s": n * rb / wall,
                "p50_ms": float(np.percentile(lat_ms, 50)),
                "p99_ms": float(np.percentile(lat_ms, 99)),
                "server_total_p50_ms": st["total_p50_ms"],
                "server_total_p99_ms": st["total_p99_ms"],
                "execute_mean_ms": st["execute_mean_ms"],
                "queue_mean_ms": st["queue_mean_ms"],
                "mean_batch_size": st["mean_batch_size"],
                "batch_occupancy": st["batch_occupancy"],
                "batches": st["batches"], "compiles": st["compiles"],
                "compile_mean_ms": st["compile_mean_ms"],
                "cache_hits": st["cache_hits"],
                "cache_misses": st["cache_misses"],
                "requests_completed": st["requests_completed"],
                "requests_failed": st["requests_failed"]}}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def check_served(torch, np, served, launches, k1_per_batch, place=None,
                 tol=1e-4):
    """What serve_traffic's run must show: every reply within ``tol`` of
    max |ref| of ``AnalysisPredictor.run`` on that request alone; at
    rb 1 a mean batch size above 1 and a cache hit; per bucket, the
    graph replay of one padded batch equal bit for bit to an eager run
    of it, with eager and replay ms (events) and the graph's bytes; K1
    launched ``k1_per_batch`` times per executed batch by the counters
    (each capture's eager pass runs the program once too) and, where it
    should launch, in one profiled replay."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import Request
    cfg = inference.AnalysisConfig(served["dir"])
    if place is not None and not hasattr(place, "device_id"):
        cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    feeds = served["feeds"]
    failures, rows, buckets = [], [], []
    executions = 0
    for rb, run in served["runs"].items():
        rec = dict(run["record"])
        worst = 0.0
        for i, sent in enumerate(run["sent"]):
            ref = pred.run([sent[n] for n in feeds])
            for (ci, _), outs in run["replies"].items():
                if ci != i:
                    continue
                for g, r in zip(outs, ref):
                    if g.shape != r.shape or not np.isfinite(g).all():
                        failures.append(f"rb {rb}: reply shape "
                                        f"{g.shape} != {r.shape}")
                    worst = max(worst, float(np.abs(g - r).max())
                                / max(float(np.abs(r).max()), 1e-30))
        rec["max_rel_err_vs_predictor"] = worst
        rec["tol"] = tol
        if worst > tol:
            failures.append(f"rb {rb}: replies {worst} of max |ref| from "
                            f"the predictor")
        if rb == 1 and not (rec["mean_batch_size"] > 1
                            and rec["cache_hits"] >= 1):
            failures.append(f"rb 1: mean batch {rec['mean_batch_size']}, "
                            f"cache hits {rec['cache_hits']}")
        executions += rec["batches"] + rec["compiles"]
        rows.append(rec)
        engine = run["engine"]
        for sig, entry in engine.cache.items():
            bucket = dict((n, s) for n, s, _ in sig)[feeds[0]][0]
            k = max(bucket // rb, 1)
            reqs = [Request(run["sent"][i % len(run["sent"])])
                    for i in range(k)]
            feed, nrows, _ = engine.pad_batch(reqs)
            replay = entry.run(feed)
            eager = entry.eager(feed)
            row = {"request_batch": rb, "bucket": bucket, "rows": nrows,
                   "bitwise": all(np.array_equal(a, b)
                                  for a, b in zip(replay, eager)),
                   "graph_bytes": entry.nbytes}
            if entry.graph is not None:
                row["eager_ms"] = event_ms(
                    torch, lambda e=entry: e._run_ops(e._bufs), 3)
                row["replay_ms"] = event_ms(torch, entry.graph.replay, 10)
                row["replay_speedup"] = row["eager_ms"] / row["replay_ms"]
            if not row["bitwise"]:
                failures.append(f"rb {rb} bucket {bucket}: replay differs "
                                f"from an eager run")
            buckets.append(row)
    k1 = launches["flash_attention_fwd"]
    rec = {"phase": f"serve_{served['name']}", "runs": rows,
           "buckets": buckets, "k1_launches": k1,
           "executions": executions,
           "k1_per_execution": k1 / max(executions, 1),
           "peak_bytes": served.get("peak_bytes")}
    if k1 != k1_per_batch * executions:
        failures.append(f"K1 launched {k1} times in {executions} executed "
                        f"batches, not {k1_per_batch} each")
    if k1_per_batch and served["runs"]:
        run = next(iter(served["runs"].values()))
        entry = next(iter(run["engine"].cache.values()))
        if entry.graph is not None:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                entry.graph.replay()
                torch.cuda.synchronize()
            kernels = {e.key: e.count for e in prof.key_averages()}
            k1_seen = sum(c for n, c in kernels.items() if K1_KERNEL in n)
            rec["profiled_replay"] = {"kernels": len(kernels),
                                      "k1_launches": k1_seen}
            if k1_seen != k1_per_batch:
                failures.append(f"a profiled replay ran {k1_seen} "
                                f"{K1_KERNEL} launches, not {k1_per_batch}")
    rec["ok"] = not failures
    emit(rec)
    for run in served["runs"].values():
        run.clear()
    if failures:
        raise AssertionError(f"serve_{served['name']}: {failures}")
    return rec


def capture_refuses_host_sync(torch, np):
    """A program whose op syncs the host (``.item()``) cannot be
    captured: ``CapturedProgram`` raises ``GraphCaptureError`` naming the
    op, and nothing runs it eagerly instead; after it, 1 GiB allocated
    and freed on a side stream leaves no reserved memory behind
    ``empty_cache``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.cuda_graph import (CapturedProgram,
                                                       GraphCaptureError)
    from paddle_tpu_torch.framework.registry import OPS, register_op
    if "chip_smoke_host_sync" not in OPS:
        @register_op("chip_smoke_host_sync", infer_shape=False)
        def _host_sync(ctx, ins, attrs):
            x = ins["X"][0]
            return {"Out": x * float(x.sum().item())}
    prog = fluid.Program()
    blk = prog.global_block()
    blk.create_var(name="x", shape=[-1, 4], dtype="float32", is_data=True)
    blk.create_var(name="y", shape=[-1, 4], dtype="float32")
    blk.append_op(type="relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                  infer_shape=False)
    blk.create_var(name="out", shape=[-1, 4], dtype="float32")
    blk.append_op(type="chip_smoke_host_sync", inputs={"X": ["y"]},
                  outputs={"Out": ["out"]}, infer_shape=False)
    feed = {"x": np.ones((2, 4), np.float32)}
    rec = {"phase": "capture_refuses_host_sync"}
    try:
        CapturedProgram(prog, feed, ["out"], fluid.Scope(), "cuda")
        rec["raised"] = None
    except GraphCaptureError as e:
        rec.update(raised=type(e).__name__, op_type=e.op_type,
                   op_index=e.op_index, message=str(e)[:300])
    # the card still works after the refused capture, and the caching
    # allocator still frees what it caches (an invalidated capture that
    # was never ended leaves it counting a capture underway: empty_cache
    # then frees nothing, and every later path's memory stays reserved)
    t = torch.ones(4, device="cuda")
    rec["after"] = float((t * 2).sum().item())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    with torch.cuda.stream(torch.cuda.Stream()):
        big = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec["reserved_gb_left_of_1gib"] = \
        (torch.cuda.memory_reserved() - base) / 1e9
    rec["ok"] = rec["raised"] == "GraphCaptureError" \
        and rec["op_type"] == "chip_smoke_host_sync" and \
        rec["after"] == 8.0 and rec["reserved_gb_left_of_1gib"] < 0.1
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"a host-syncing op was captured or fell "
                             f"back: {rec}")
    return rec


# --------------------------- the training loop (run_steps, guard, dataset)

CARD = {"card": None}     # the nvidia-smi line, set by main()


def scope_diff(torch, a, b):
    """Names whose values differ (bitwise) between two scopes."""
    out = sorted(set(a.keys()) ^ set(b.keys()))
    for n in set(a.keys()) & set(b.keys()):
        va, vb = a.find_var(n), b.find_var(n)
        if isinstance(va, torch.Tensor):
            if va.shape != vb.shape or va.dtype != vb.dtype or \
                    not torch.equal(va, vb.to(va.device)):
                out.append(n)
        elif va != vb:
            out.append(n)
    return out


def profiled_launches(torch, fn):
    """(device ms, kernel launches) of one call of ``fn`` from
    torch.profiler: the CUDA kernels in its trace (a graph replay's
    included; copies and sets add to the time, not the count)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, kernels = 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "device_time", None)
        us += float(e.cuda_time if t is None else t)
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
    return us / 1e3, kernels


def profiled_ms(torch, fn):
    """Device time (ms) of one call of ``fn`` from torch.profiler (see
    :func:`profiled_launches`); None when the trace holds no device
    time."""
    return profiled_launches(torch, fn)[0] or None


def build_bert_graft(cfg, B, S, P, recompute, white=()):
    """BERT pretraining as ``__graft_entry__._build(with_opt=True)``
    composes it: ``bert_pretrain`` + ``AdamOptimizer(noam_decay(h, 100,
    learning_rate=1.0))`` under ``RecomputeOptimizer`` with the layer
    outputs as checkpoints (``recompute`` False leaves it out), wrapped
    by ``mp.decorate`` (bf16 AMP at a static loss scale of 1.0, as
    bench.py's bench_bert_long trains). Returns (main, startup, outputs,
    lr var)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    mp = fluid.contrib.mixed_precision
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        lr = fluid.layers.noam_decay(cfg.hidden_size, 100, learning_rate=1.0)
        opt = fluid.optimizer.AdamOptimizer(learning_rate=lr)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(out["checkpoints"])
        mp.decorate(opt, amp_lists=mp.AutoMixedPrecisionLists(
            custom_white_list=set(white)), init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(out["loss"])
    return main, startup, out, lr


def _stack(np, feeds):
    return {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}


def _captured(exe):
    """The executor's newest captured step (``CapturedStep``)."""
    return list(exe._graphs.values())[-1]


def _sync(torch, exe):
    if exe.device.type == "cuda":
        torch.cuda.synchronize()


def bert_long_recompute(torch, np, fa, place=None, layers=None, B=16,
                        S=2048, P=64, K=4, seed=11):
    """The slice's path: BERT-base at bench_bert_long's shape (B16 S2048
    P64, flash, bf16 AMP) as ``__graft_entry__`` builds it, noam Adam
    under ``RecomputeOptimizer`` with the 12 layer checkpoints, from one
    seeded startup:

    (a) K eager ``Executor.run`` steps and one ``run_steps`` slab of K
        from copies of that scope: losses, the noam LR and the final
        scope bitwise; (b) the program without recompute, one slab from
        another copy: its losses beside (a)'s, and the peak memory of
        each slab (``max_memory_allocated`` over the first slab, the
        warm-up pass and the capture included, less what was allocated
        before it; and the graph pool's bytes); (c) K1 and K2 launches a
        step, eager and per replay: 24 and 12 with recompute, 12 and 12
        without; (d) wall ms a step eager and by ``run_steps`` (a second
        slab), device ms a step (torch.profiler), the idle share, tokens/s
        and TFLOP/s (bench.py's formula: the recomputed forward is not
        useful work) and the LR read back against noam_decay's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    cfg = bert_config(layers, "flash", max_position=max(S, 512))
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    k1, k2 = fa.flash_attention_fwd, fa.flash_attention_bwd_single
    rng = np.random.default_rng(seed)
    feeds = [bert.random_batch(cfg, B, S, P, rng=rng) for _ in range(K)]
    slab = _stack(np, feeds)
    rec = {"phase": "bert_long_recompute", **CARD, "B": B, "S": S, "P": P,
           "K": K, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "attention": "flash", "amp": "bf16", "lr": "noam_decay(h, 100, 1.0)"}
    failures = []
    scope0 = None
    runs = {}
    for rc in (False, True):
        main, startup, out, lr = build_bert_graft(cfg, B, S, P, rc)
        if scope0 is None:
            scope0 = fluid.Scope()
            exe.run(startup, scope=scope0)
        fetch = [out["loss"], lr]
        key = "recompute" if rc else "no_recompute"
        r = runs[key] = {}
        sB = copied_scope(torch, fluid, scope0)
        _sync(torch, exe)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        before = (k1.launches, k2.launches)
        t0 = time.perf_counter()
        got = exe.run_steps(main, feed=slab, fetch_list=fetch, scope=sB)
        r["first_slab_s"] = time.perf_counter() - t0
        entry = _captured(exe)
        if cuda:
            r["peak_gb_over_first_slab"] = \
                (torch.cuda.max_memory_allocated() - base) / 1e9
            r["graph_pool_gb"] = entry.nbytes / 1e9
        warm = {w.__name__: n for (w, a), n in
                entry.warmup_launches.items() if a == "launches"}
        rep = {w.__name__: n for (w, a), n in
               entry.replay_launches.items() if a == "launches"}
        r["k1_per_step_slab"] = (k1.launches - before[0]
                                 - warm.get(k1.__name__, 0)) / K
        r["k2_per_step_slab"] = (k2.launches - before[1]
                                 - warm.get(k2.__name__, 0)) / K
        r["replay_launches"] = rep
        r["losses"] = [float(x) for x in got[0]]
        r["lr"] = [float(x) for x in np.ravel(got[1])]
        if rc:
            # (a) K eager steps from another copy of the same scope
            sA = copied_scope(torch, fluid, scope0)
            before = (k1.launches, k2.launches)
            eager, wall = [], []
            for f in feeds:
                t0 = time.perf_counter()
                eager.append(exe.run(main, feed=f, fetch_list=fetch,
                                     scope=sA))
                wall.append((time.perf_counter() - t0) * 1e3)
            r["k1_per_step_eager"] = (k1.launches - before[0]) / K
            r["k2_per_step_eager"] = (k2.launches - before[1]) / K
            r["eager_losses"] = [float(e[0]) for e in eager]
            r["losses_bitwise_eager"] = bool(np.array_equal(
                got[0], np.stack([e[0] for e in eager]))) and bool(
                np.array_equal(got[1], np.stack([e[1] for e in eager])))
            diff = scope_diff(torch, sA, sB)
            r["scope_bitwise_eager"] = not diff
            r["scope_diff"] = diff[:8]
            r["eager_ms_per_step"] = wall
            if not (r["losses_bitwise_eager"] and not diff):
                failures.append(f"run_steps is not its eager steps: "
                                f"{r['losses']} vs {r['eager_losses']}, "
                                f"scope diff {diff[:8]}")
            want = [noam_lr(np, i + 1, cfg.hidden_size, 100, 1.0)
                    for i in range(K)]
            r["lr_noam"] = [float(x) for x in want]
            if [np.float32(x) for x in r["lr"]] != want:
                failures.append(f"noam LR {r['lr']} != {r['lr_noam']}")
            # (d) a second slab (the captured step replayed), timed, then
            # profiled; one eager step profiled
            t0 = time.perf_counter()
            exe.run_steps(main, feed=slab, fetch_list=fetch, scope=sB)
            r["run_steps_ms_per_step"] = \
                (time.perf_counter() - t0) * 1e3 / K
            r["eager_ms_per_step_median"] = float(np.median(wall[1:])) \
                if K > 1 else wall[0]
            if cuda:
                r["device_ms_per_step_run_steps"] = profiled_ms(
                    torch, lambda: exe.run_steps(main, feed=slab,
                                                 fetch_list=fetch,
                                                 scope=sB)) / K
                r["device_ms_per_step_eager"] = profiled_ms(
                    torch, lambda: exe.run(main, feed=feeds[0],
                                           fetch_list=fetch, scope=sA))
                for how in ("run_steps", "eager"):
                    wall_ms = r["run_steps_ms_per_step"] \
                        if how == "run_steps" \
                        else r["eager_ms_per_step_median"]
                    r[f"idle_share_{how}"] = \
                        1 - r[f"device_ms_per_step_{how}"] / wall_ms
            flops = bert_train_flops_per_sample(cfg, S, P) * B
            ms = r["run_steps_ms_per_step"]
            r["tokens_per_s_run_steps"] = B * S / ms * 1e3
            r["tflops_run_steps"] = flops / ms / 1e9
            r["tokens_per_s_eager"] = \
                B * S / r["eager_ms_per_step_median"] * 1e3
            r["analytic_flops_per_step"] = flops
            del sA
        exe.close()
        del sB, got
        _sync(torch, exe)
        if cuda:
            torch.cuda.empty_cache()
    a, b = runs["recompute"], runs["no_recompute"]
    rec.update(runs)
    rec["losses_bitwise_with_without_recompute"] = a["losses"] == b["losses"]
    L = cfg.num_layers
    want = {"recompute": (2 * L, L), "no_recompute": (L, L)}
    for key, (w1, w2) in want.items() if cuda else ():
        r = runs[key]
        got = (r["k1_per_step_slab"], r["k2_per_step_slab"])
        if got != (w1, w2) or (key == "recompute" and (
                r["k1_per_step_eager"], r["k2_per_step_eager"]) != (w1, w2)):
            failures.append(f"{key}: K1/K2 a step {got} (eager "
                            f"{r.get('k1_per_step_eager')}, "
                            f"{r.get('k2_per_step_eager')}), not {(w1, w2)}")
    if cuda and not a["peak_gb_over_first_slab"] < \
            b["peak_gb_over_first_slab"]:
        failures.append(f"recompute peaks at {a['peak_gb_over_first_slab']}"
                        f" GB, no lower than {b['peak_gb_over_first_slab']}")
    if not all(np.isfinite(a["losses"])):
        failures.append(f"non-finite losses {a['losses']}")
    rec["ok"] = not failures
    emit(rec)
    if failures:
        raise AssertionError(f"bert_long_recompute: {failures}")
    return rec


def capture_names_flash_grad(torch, np, B=2, S=256, P=4):
    """A training step whose flash grad op syncs the host (``.item()``
    slipped into its backward call) cannot be captured: ``run_steps``
    raises ``GraphCaptureError`` naming ``flash_attention_grad``, nothing
    runs the slab eagerly instead, and the scope keeps its state. The
    unpatched step then captures: K2's wrapper itself makes no host
    sync and no allocation outside the graph pool."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention_ops
    cfg = bert_config(1, "flash", max_position=512)
    main, startup, out, _ = build_bert_graft(cfg, B, S, P, True)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    before = copied_scope(torch, fluid, scope)
    rng = np.random.default_rng(15)
    slab = _stack(np, [bert.random_batch(cfg, B, S, P, rng=rng)
                       for _ in range(2)])
    real = attention_ops.flash_attention_bwd

    def syncing(q, *a):
        float(q.float().sum().item())
        return real(q, *a)
    rec = {"phase": "capture_names_flash_grad", **CARD, "raised": None}
    attention_ops.flash_attention_bwd = syncing
    try:
        exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                      scope=scope)
    except GraphCaptureError as e:
        rec.update(raised=type(e).__name__, op_type=e.op_type,
                   message=str(e)[:300])
    finally:
        attention_ops.flash_attention_bwd = real
    rec["scope_untouched"] = not scope_diff(torch, scope, before)
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=scope)[0]
    rec["then_captures"] = bool(np.isfinite(got).all())
    rec["ok"] = (rec["raised"] == "GraphCaptureError"
                 and rec["op_type"] == "flash_attention_grad"
                 and rec["scope_untouched"] and rec["then_captures"])
    exe.close()
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"capture_names_flash_grad: {rec}")
    return rec


def flagship_steps(torch, np, place=None, layers=None, K=8, seed=12):
    """bench.py main()'s flagship (BERT-base B64 S128 P20, einsum
    attention, BERT's dropout 0.1, bf16 AMP with softmax white-listed,
    noam Adam): K eager steps against one ``run_steps`` slab of K from
    copies of one scope: losses and scope bitwise (each replay draws its
    eager step's dropout masks); wall and device ms a step both ways, and
    the idle share."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    run = BERT_FLAGSHIP
    B, S, P = run["B"], run["S"], run["P"]
    cfg = bert_config(layers, run["mech"], max_position=512)
    main, startup, out, lr, _ = build_bert(cfg, B, S, P, run["white"])
    exe = fluid.Executor(place)
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    rng = np.random.default_rng(seed)
    feeds = [bert.random_batch(cfg, B, S, P, rng=rng) for _ in range(K)]
    slab = _stack(np, feeds)
    sA = copied_scope(torch, fluid, scope0)
    sB = copied_scope(torch, fluid, scope0)
    eager, wall = [], []
    for f in feeds:
        t0 = time.perf_counter()
        eager.append(exe.run(main, feed=f, fetch_list=[out["loss"]],
                             scope=sA)[0])
        wall.append((time.perf_counter() - t0) * 1e3)
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=sB)[0]
    diff = scope_diff(torch, sA, sB)
    rec = {"phase": "flagship_steps", **CARD, "B": B, "S": S, "P": P,
           "K": K, "layers": cfg.num_layers, "dropout": cfg.hidden_dropout,
           "attention": "einsum", "amp": "bf16",
           "eager_losses": [float(x) for x in eager],
           "run_steps_losses": [float(x) for x in got],
           "losses_bitwise": bool(np.array_equal(got, np.stack(eager))),
           "scope_bitwise": not diff, "scope_diff": diff[:8],
           "eager_ms_per_step": wall,
           "eager_ms_per_step_median": float(np.median(wall[1:]))}
    t0 = time.perf_counter()
    exe.run_steps(main, feed=slab, fetch_list=[out["loss"]], scope=sB)
    rec["run_steps_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / K
    if exe.device.type == "cuda":
        rec["device_ms_per_step_run_steps"] = profiled_ms(
            torch, lambda: exe.run_steps(main, feed=slab,
                                         fetch_list=[out["loss"]],
                                         scope=sB)) / K
        rec["device_ms_per_step_eager"] = profiled_ms(
            torch, lambda: exe.run(main, feed=feeds[0],
                                   fetch_list=[out["loss"]], scope=sA))
        rec["idle_share_eager"] = 1 - rec["device_ms_per_step_eager"] / \
            rec["eager_ms_per_step_median"]
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
        rec["graph_pool_gb"] = _captured(exe).nbytes / 1e9
        rec["stochastic_call_sites"] = len(_captured(exe)._sites)
    rec["samples_per_s_run_steps"] = B / rec["run_steps_ms_per_step"] * 1e3
    rec["ok"] = rec["losses_bitwise"] and not diff and \
        bool(np.isfinite(got).all())
    exe.close()
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"flagship_steps: run_steps is not its eager "
                             f"steps: {rec}")
    return rec


def train_loop_lenet(torch, np, place=None, B=512, warm=32, steps=128):
    """bench.py's bench_train_loop on the port: ``build_lenet_train()``
    (Adam 0.001) at B512 over a two-batch seeded pool staged on the
    device (step i takes batch i % 2), K in {1, 8, 32}: K=1 is one
    ``Executor.run`` a step, K > 1 one ``run_steps`` slab of K; equal
    step counts (``warm`` steps, then ``steps`` timed). Steps/s and
    samples/s for each K; the losses of every K bitwise K=1's, under
    ``FLAGS_cudnn_deterministic`` (the port's default). With
    the flag turned off, two eager runs of
    ``warm`` steps are compared and the verdict recorded (cuDNN's
    default wgrad and dgrad may sum in another order from call to
    call)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet_train()
    pool = lenet_pool(np, B)
    with deterministic_convs(fluid, False):
        runs = [eager_losses(torch, np, fluid, place, main, startup,
                             fetches[0].name, pool, warm) for _ in range(2)]
    with deterministic_convs(fluid):
        rec = _train_loop_lenet(torch, np, place, B, warm, steps)
    rec["eager_runs_bitwise_without_flag"] = bool(
        np.array_equal(runs[0], runs[1]))
    emit(rec)
    return rec


def lenet_pool(np, B):
    rng = np.random.default_rng(0)
    return [{"img": rng.standard_normal((B, 1, 28, 28)).astype(np.float32),
             "label": rng.integers(0, 10, (B, 1)).astype(np.int64)}
            for _ in range(2)]


def eager_losses(torch, np, fluid, place, main, startup, loss, pool, n):
    """``n`` eager LeNet steps from a fresh startup (step i takes batch
    i % 2): the losses."""
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rows = [{k: torch.from_numpy(v).to(exe.device) for k, v in b.items()}
            for b in pool]
    out = [exe.run(main, feed=rows[i % 2], fetch_list=[loss], scope=scope,
                   return_numpy=False)[0].reshape(1) for i in range(n)]
    return torch.cat(out).float().cpu().numpy()


class deterministic_convs:
    """``FLAGS_cudnn_deterministic`` set to ``on`` inside, as it was
    after."""

    def __init__(self, fluid, on=True):
        self.fluid = fluid
        self.on = on

    def __enter__(self):
        self.old = self.fluid.get_flags("FLAGS_cudnn_deterministic")
        self.fluid.set_flags({"FLAGS_cudnn_deterministic": self.on})

    def __exit__(self, *exc):
        self.fluid.set_flags(self.old)


def _train_loop_lenet(torch, np, place, B, warm, steps):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet_train()
    loss = fetches[0].name
    pool = lenet_pool(np, B)
    per_k, losses = {}, {}
    for k in (1, 8, 32):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        staged = {n: torch.from_numpy(np.stack(
            [pool[j % 2][n] for j in range(k)])).to(exe.device)
            for n in pool[0]}
        rows = [{n: torch.from_numpy(v).to(exe.device)
                 for n, v in b.items()} for b in pool]

        def one(k=k, exe=exe, scope=scope, staged=staged, rows=rows, i=[0]):
            if k == 1:
                out = exe.run(main, feed=rows[i[0] % 2], fetch_list=[loss],
                              scope=scope, return_numpy=False)
                i[0] += 1
                return out[0].reshape(1)
            return exe.run_steps(main, feed=staged, fetch_list=[loss],
                                 scope=scope, return_numpy=False)[0]
        outs = [one() for _ in range(warm // k)]
        _sync(torch, exe)
        t0 = time.perf_counter()
        outs += [one() for _ in range(steps // k)]
        lv = torch.cat(outs).float().cpu().numpy()      # the one sync
        sec = time.perf_counter() - t0
        losses[k] = lv
        per_k[str(k)] = {"steps_per_s": steps / sec,
                         "samples_per_s": steps * B / sec}
        exe.close()
    base = per_k["1"]["steps_per_s"]
    for row in per_k.values():
        row["speedup_vs_k1"] = row["steps_per_s"] / base
    rec = {"phase": "train_loop_lenet", **CARD, "B": B,
           "cudnn_deterministic": True, "warm_steps": warm,
           "timed_steps": steps, "k": per_k,
           "losses_bitwise_k1": {str(k): bool(np.array_equal(losses[k],
                                                             losses[1]))
                                 for k in (8, 32)},
           "first_last_loss": [float(losses[1][0]), float(losses[1][-1])]}
    rec["ok"] = all(rec["losses_bitwise_k1"].values()) and \
        bool(np.isfinite(losses[1]).all())
    if not rec["ok"]:
        emit(rec)
        raise AssertionError(f"train_loop_lenet: {rec}")
    return rec


def nonfinite_steps(torch, np, place=None, layers=2, B=16, S=2048, P=64,
                    K=8, bad=3, seed=13):
    """The slice's BERT program (:func:`build_bert_graft`, recompute) at
    ``layers`` deep: a K-step slab with a NaN in step ``bad``'s
    ``input_mask`` (the only float feed). ``check_nan_inf`` raises
    ``NonFiniteError`` naming fused step ``bad``; ``skip_nonfinite_steps``
    rolls back that step only: the scope bitwise a sequential
    ``run(skip_nonfinite_steps=True)`` over the same K feeds."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.resilience import NonFiniteError
    cfg = bert_config(layers, "flash", max_position=max(S, 512))
    main, startup, out, lr = build_bert_graft(cfg, B, S, P, True)
    exe = fluid.Executor(place)
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    rng = np.random.default_rng(seed)
    feeds = [bert.random_batch(cfg, B, S, P, rng=rng) for _ in range(K)]
    feeds[bad]["input_mask"] = feeds[bad]["input_mask"].copy()
    feeds[bad]["input_mask"][0, 0] = np.nan
    slab = _stack(np, feeds)
    rec = {"phase": "nonfinite_steps", **CARD, "B": B, "S": S, "P": P,
           "K": K, "layers": cfg.num_layers, "bad_step": bad}
    try:
        exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                      scope=copied_scope(torch, fluid, scope0),
                      check_nan_inf=True)
        rec["raised"] = None
    except NonFiniteError as e:
        rec.update(raised=type(e).__name__, message=str(e)[:300],
                   var_name=e.var_name, count=e.count)
    sA = copied_scope(torch, fluid, scope0)
    sB = copied_scope(torch, fluid, scope0)
    seq = [exe.run(main, feed=f, fetch_list=[out["loss"]], scope=sA,
                   skip_nonfinite_steps=True)[0] for f in feeds]
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=sB, skip_nonfinite_steps=True)[0]
    diff = scope_diff(torch, sA, sB)
    rec.update(losses=[float(x) for x in got],
               losses_bitwise=bool(np.array_equal(got, np.stack(seq),
                                                  equal_nan=True)),
               scope_bitwise=not diff, scope_diff=diff[:8],
               nonfinite_steps=[int(i) for i in np.flatnonzero(
                   ~np.isfinite(got))])
    rec["ok"] = (rec["raised"] == "NonFiniteError"
                 and f"fused step {bad}/{K} " in rec["message"]
                 and rec["losses_bitwise"] and not diff
                 and rec["nonfinite_steps"] == [bad])
    exe.close()
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"nonfinite_steps: {rec}")
    return rec


def train_from_dataset_phase(torch, np, place=None, B=64, K=8, slabs=3,
                             tail=5, seed=14):
    """``Executor.train_from_dataset`` over a ``QueueDataset`` of seeded
    LeNet samples that the phase writes to a temp dir (``slabs`` x K
    batches of B, then ``tail`` more): ``steps_per_run=K`` (run_steps
    slabs, the short tail slab through ``run``) against
    ``steps_per_run=1`` from copies of one scope: the end state and the
    last loss bitwise (under ``FLAGS_cudnn_deterministic``)."""
    import paddle_tpu_torch as fluid
    with deterministic_convs(fluid):
        return _train_from_dataset(torch, np, place, B, K, slabs, tail,
                                   seed)


def _train_from_dataset(torch, np, place, B, K, slabs, tail, seed):
    import shutil
    import tempfile
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet_train()
    exe = fluid.Executor(place)
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    n = (slabs * K + tail) * B
    imgs, labels = synthetic_digits(np, n, seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dataset_")
    try:
        paths = []
        for part in range(2):
            path = os.path.join(tmp, f"part-{part}.txt")
            with open(path, "w") as f:
                for i in range(part, n, 2):
                    f.write("img:" + ",".join(
                        f"{v:.5f}" for v in imgs[i].ravel())
                        + f" label:{int(labels[i, 0])}\n")
            paths.append(path)

        def parse(line):
            g = dict(t.split(":", 1) for t in line.split())
            return (np.array(g["img"].split(","), np.float32).reshape(
                1, 28, 28), np.array([int(g["label"])], np.int64))
        ds = fluid.DatasetFactory().create_dataset("QueueDataset")
        ds.set_filelist(paths)
        ds.set_batch_size(B)
        block = main.global_block()
        ds.set_use_var([block.var("img"), block.var("label")])
        ds.set_line_parser(parse)
        sA = copied_scope(torch, fluid, scope0)
        sB = copied_scope(torch, fluid, scope0)
        t0 = time.perf_counter()
        fused = exe.train_from_dataset(main, ds, scope=sA,
                                       fetch_list=[fetches[0]],
                                       print_period=0, steps_per_run=K)
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step = exe.train_from_dataset(main, ds, scope=sB,
                                      fetch_list=[fetches[0]],
                                      print_period=0, steps_per_run=1)
        step_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = scope_diff(torch, sA, sB)
    rec = {"phase": "train_from_dataset", **CARD, "B": B,
           "cudnn_deterministic": True,
           "steps_per_run": K, "batches": slabs * K + tail,
           "fused_s": fused_s, "stepwise_s": step_s,
           "last_loss": float(step[0]),
           "last_loss_bitwise": bool(np.array_equal(fused[0][-1], step[0])),
           "scope_bitwise": not diff, "scope_diff": diff[:8]}
    rec["ok"] = rec["last_loss_bitwise"] and not diff
    exe.close()
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"train_from_dataset: {rec}")
    return rec


# ---------------------------------------------------------------------------
# Wide&Deep CTR (bench.py's bench_widedeep) with SelectedRows grads, and
# the FLAGS_cudnn_deterministic A/B
# ---------------------------------------------------------------------------

WIDEDEEP = {"B": 4096, "dense_dim": 13, "num_slots": 26,
            "vocab_size": 10000, "embed_dim": 16,
            "hidden_sizes": (400, 400, 400), "lr": 1e-3}


def widedeep_model_kw(cfg):
    return {k: cfg[k] for k in ("dense_dim", "num_slots", "vocab_size",
                                "embed_dim", "hidden_sizes")}


def widedeep_program(cfg, lazy=False):
    """bench_widedeep's program: ``wide_deep(batch_size=B)`` +
    ``Adam(lr)`` (``lazy_mode`` as given). Returns (main, startup,
    outputs)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import widedeep
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = widedeep.wide_deep(batch_size=cfg["B"],
                                 **widedeep_model_kw(cfg))
        fluid.optimizer.Adam(cfg["lr"], lazy_mode=lazy).minimize(
            out["loss"])
    return main, startup, out


def widedeep_pool(torch, np, cfg, device, seed=0):
    """bench_widedeep's two-batch seeded pool (``random_batch`` from one
    ``default_rng(seed)``), staged on ``device``."""
    from paddle_tpu_torch.models import widedeep
    rng = np.random.default_rng(seed)
    pool = [widedeep.random_batch(cfg["B"], cfg["dense_dim"],
                                  cfg["num_slots"], cfg["vocab_size"],
                                  rng=rng) for _ in range(2)]
    return [{n: torch.from_numpy(a).to(device) for n, a in b.items()}
            for b in pool]


def widedeep_slab(torch, pool, K):
    """K steps over the pool (step i takes batch i % 2), stacked."""
    return {n: torch.stack([pool[i % 2][n] for i in range(K)])
            for n in pool[0]}


def _peak_from(torch, cuda, base):
    return (torch.cuda.max_memory_allocated() - base) / 1e9 if cuda \
        else None


def _peak_base(torch, cuda):
    if not cuda:
        return None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def widedeep_train(torch, np, place=None, cfg=WIDEDEEP, K=8):
    """bench_widedeep on the port: Wide&Deep (B4096, dense 13, 26 slots
    over a vocab of 10000, embed 16, MLP 400x3) with Adam(1e-3), non-lazy
    (the 52 tables' SelectedRows grads densified in their per-param adam
    ops), over the two-batch pool, from copies of one seeded startup:
    K eager ``Executor.run`` steps against one ``run_steps`` slab of K
    (losses and scope bitwise, no ``GraphCaptureError``), and a second
    slab of K from a third copy (tables bitwise run to run); the losses
    finite, the first near ln 2, step K-2 below step 0 (the same batch);
    wall and device ms a step both ways, the idle share, samples/s, the
    peak memory over the eager steps and over the first slab, the op
    count of the program as built and as the pass pipeline leaves it,
    and the adam ops left per-param (one per table). Returns (record,
    the trained scope)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework import passes
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    main, startup, out = widedeep_program(cfg)
    loss = out["loss"]
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    pool = widedeep_pool(torch, np, cfg, exe.device)
    slab = widedeep_slab(torch, pool, K)
    B = cfg["B"]
    sA, sB, sC = (copied_scope(torch, fluid, scope0) for _ in range(3))
    del scope0
    failures = []
    base = _peak_base(torch, cuda)
    eager, wall = [], []
    for i in range(K):
        t0 = time.perf_counter()
        eager.append(exe.run(main, feed=pool[i % 2], fetch_list=[loss],
                             scope=sA)[0])
        wall.append((time.perf_counter() - t0) * 1e3)
    peak_eager = _peak_from(torch, cuda, base)
    base = _peak_base(torch, cuda)
    try:
        t0 = time.perf_counter()
        got = exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)[0]
        first_slab_s = time.perf_counter() - t0
    except GraphCaptureError as e:
        raise AssertionError(f"widedeep_train: the step did not capture: "
                             f"{e}") from e
    peak_slab = _peak_from(torch, cuda, base)
    again = exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sC)[0]
    diff = scope_diff(torch, sA, sB)
    tables = [n for n in sB.keys() if "embedding_" in n and
              n.endswith(".w")]
    run_to_run = [n for n in scope_diff(torch, sB, sC) if n in tables]
    opt = passes.optimize_program(main, [loss.name])
    upd = optimizer_ops(exe, main, [loss.name])
    ln2 = float(np.log(2.0))
    rec = {"phase": "widedeep_train", **CARD, "B": B,
           **widedeep_model_kw(cfg), "optimizer": f"Adam({cfg['lr']})",
           "K": K, "eager_losses": [float(x) for x in eager],
           "run_steps_losses": [float(x) for x in got],
           "losses_bitwise": bool(np.array_equal(got, np.stack(eager))),
           "scope_bitwise": not diff, "scope_diff": diff[:8],
           "tables": len(tables),
           "tables_bitwise_run_to_run": not run_to_run
           and bool(np.array_equal(got, again)),
           "ops_as_built": len(main.global_block().ops),
           "ops_after_passes": len(opt.global_block().ops),
           "optimizer_ops_per_step": upd,
           "adam_unfused": upd.get("adam", 0),
           "eager_ms_per_step": wall,
           "eager_ms_per_step_median": float(np.median(wall[1:])),
           "first_slab_s": first_slab_s,
           "peak_gb_eager": peak_eager, "peak_gb_over_first_slab": peak_slab}
    t0 = time.perf_counter()
    exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)
    rec["run_steps_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / K
    if cuda:
        rec["device_ms_per_step_run_steps"] = profiled_ms(
            torch, lambda: exe.run_steps(main, feed=slab, fetch_list=[loss],
                                         scope=sB)) / K
        rec["device_ms_per_step_eager"] = profiled_ms(
            torch, lambda: exe.run(main, feed=pool[0], fetch_list=[loss],
                                   scope=sA))
        rec["idle_share_eager"] = 1 - rec["device_ms_per_step_eager"] / \
            rec["eager_ms_per_step_median"]
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
        rec["graph_pool_gb"] = _captured(exe).nbytes / 1e9
    rec["samples_per_s_eager"] = B / rec["eager_ms_per_step_median"] * 1e3
    rec["samples_per_s_run_steps"] = B / rec["run_steps_ms_per_step"] * 1e3
    losses = rec["eager_losses"]
    if not (rec["losses_bitwise"] and not diff):
        failures.append(f"run_steps is not its eager steps: scope diff "
                        f"{diff[:8]}")
    if not rec["tables_bitwise_run_to_run"]:
        failures.append(f"two slabs from one start differ: {run_to_run[:8]}")
    if rec["adam_unfused"] != 2 * cfg["num_slots"] or \
            rec["tables"] != 2 * cfg["num_slots"]:
        failures.append(f"{rec['adam_unfused']} adam ops per-param for "
                        f"{rec['tables']} tables")
    if not (all(np.isfinite(losses)) and abs(losses[0] - ln2) < 0.1
            and losses[K - 2] < losses[0]):
        failures.append(f"losses {losses}")
    rec["ok"] = not failures
    exe.close()
    del sA, sC
    emit(rec)
    if failures:
        raise AssertionError(f"widedeep_train: {failures}")
    return rec, sB


def plain_lazy_adam(torch, p, m1, m2, rows, values, lr, b1p, b2p,
                    b1=0.9, b2=0.999, eps=1e-8):
    """The plain version of lazy Adam over one table, in float64: the
    sparse grad summed into a dense one (``index_add_``), the dense Adam
    update, then only the rows the grad names kept (the others as
    they were)."""
    d = torch.float64
    g = torch.zeros(p.shape, dtype=d, device=p.device).index_add_(
        0, rows, values.to(d))
    m1n = b1 * m1.to(d) + (1 - b1) * g
    m2n = b2 * m2.to(d) + (1 - b2) * g * g
    lr_t = lr * math.sqrt(1 - b2p) / (1 - b1p)
    pn = p.to(d) - lr_t * m1n / (torch.sqrt(m2n) + eps)
    hit = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    hit[rows] = True
    keep = lambda new, old: torch.where(hit[:, None], new,  # noqa: E731
                                        old.to(d))
    return keep(pn, p), keep(m1n, m1), keep(m2n, m2)


def widedeep_lazy_adam(torch, np, place=None, cfg=WIDEDEEP, K=8, seed=3,
                       tol=1e-5):
    """bench_widedeep's shape with ``lazy_mode=True``: a ``run_steps``
    slab of K captures (no host sync in the sort and row updates of
    ``selected_rows.coalesce``) and is bitwise K eager steps; every
    table's rows no batch of the pool touched keep their param bits and
    moments exactly zero, and the touched rows moved. Then the lazy
    ``adam`` op on one trained table with the pool's duplicate ids and a
    seeded grad against :func:`plain_lazy_adam` (param and moments within
    ``tol`` of max |ref|, float32); wall and device ms a step by
    ``run_steps``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    from paddle_tpu_torch.framework.lowering import LowerCtx
    from paddle_tpu_torch.framework.registry import get_op_def
    from paddle_tpu_torch.framework.selected_rows import SelectedRows
    main, startup, out = widedeep_program(cfg, lazy=True)
    loss = out["loss"]
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    pool = widedeep_pool(torch, np, cfg, exe.device)
    slab = widedeep_slab(torch, pool, K)
    sA, sB = (copied_scope(torch, fluid, scope0) for _ in range(2))
    failures = []
    try:
        got = exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)[0]
    except GraphCaptureError as e:
        raise AssertionError(f"widedeep_lazy_adam: the lazy step did not "
                             f"capture: {e}") from e
    eager = [exe.run(main, feed=pool[i % 2], fetch_list=[loss],
                     scope=sA)[0] for i in range(K)]
    diff = scope_diff(torch, sA, sB)
    untouched_nonzero, moved, rows_untouched = [], 0, 0
    for i in range(cfg["num_slots"]):
        hit = torch.zeros(cfg["vocab_size"], dtype=torch.bool,
                          device=exe.device)
        for b in pool:
            hit[b[f"C{i}"].reshape(-1)] = True
        cold = ~hit
        rows_untouched += int(cold.sum())
        for t in (f"embedding_{i}.w", f"wide_embedding_{i}.w"):
            m1 = sB.find_var(f"{t}_moment1_0")
            m2 = sB.find_var(f"{t}_moment2_0")
            same = torch.equal(sB.find_var(t)[cold], scope0.find_var(t)[cold])
            if m1[cold].any() or m2[cold].any() or not same:
                untouched_nonzero.append(t)
            moved += int(bool(m1[hit].any()))
    # the lazy adam op on one table, duplicate ids, against the plain one
    name = "embedding_0.w"
    p, m1, m2 = (sB.find_var(n) for n in
                 (name, f"{name}_moment1_0", f"{name}_moment2_0"))
    rows = pool[0]["C0"].reshape(-1)
    gen = torch.Generator(device=exe.device).manual_seed(seed)
    values = torch.randn((rows.shape[0], cfg["embed_dim"]), generator=gen,
                         device=exe.device)
    b1p, b2p = 0.9 ** (K + 1), 0.999 ** (K + 1)
    full = lambda v: torch.full((1,), v, dtype=torch.float32,  # noqa: E731
                                device=exe.device)
    outs = get_op_def("adam").lower(
        LowerCtx(None, None, {}, exe.device),
        {"Param": [p], "Grad": [SelectedRows(rows, values)],
         "LearningRate": [full(cfg["lr"])], "Moment1": [m1],
         "Moment2": [m2], "Beta1Pow": [full(b1p)], "Beta2Pow": [full(b2p)]},
        {"lazy_mode": True})
    ref = plain_lazy_adam(torch, p, m1, m2, rows, values, cfg["lr"],
                          float(np.float32(b1p)), float(np.float32(b2p)))
    errs = {}
    for key, r in zip(("ParamOut", "Moment1Out", "Moment2Out"), ref):
        errs[key] = float((outs[key].double() - r).abs().max()
                          / r.abs().max().clamp_min(1e-30))
    dup = rows.shape[0] - int(torch.unique(rows).shape[0])
    rec = {"phase": "widedeep_lazy_adam", **CARD, "B": cfg["B"],
           **widedeep_model_kw(cfg), "K": K, "lazy_mode": True,
           "run_steps_losses": [float(x) for x in got],
           "losses_bitwise_eager": bool(np.array_equal(got,
                                                       np.stack(eager))),
           "scope_bitwise_eager": not diff, "scope_diff": diff[:8],
           "untouched_rows": rows_untouched,
           "tables_with_untouched_rows_changed": untouched_nonzero,
           "tables_whose_touched_moments_moved": moved,
           "op_check_table": name, "op_check_duplicate_ids": dup,
           "op_check_rel_err": errs, "tol": tol}
    t0 = time.perf_counter()
    exe.run_steps(main, feed=slab, fetch_list=[loss], scope=sB)
    rec["run_steps_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / K
    if cuda:
        rec["device_ms_per_step_run_steps"] = profiled_ms(
            torch, lambda: exe.run_steps(main, feed=slab, fetch_list=[loss],
                                         scope=sB)) / K
        rec["idle_share_run_steps"] = \
            1 - rec["device_ms_per_step_run_steps"] / \
            rec["run_steps_ms_per_step"]
    rec["samples_per_s_run_steps"] = \
        cfg["B"] / rec["run_steps_ms_per_step"] * 1e3
    if not (rec["losses_bitwise_eager"] and not diff):
        failures.append(f"run_steps is not its eager steps: {diff[:8]}")
    if untouched_nonzero or moved != 2 * cfg["num_slots"] \
            or not rows_untouched:
        failures.append(f"untouched rows changed in {untouched_nonzero[:4]}"
                        f", {moved} tables moved, {rows_untouched} untouched")
    if max(errs.values()) > tol or not dup:
        failures.append(f"lazy adam vs plain: {errs} ({dup} duplicates)")
    if not np.isfinite(got).all():
        failures.append(f"losses {rec['run_steps_losses']}")
    rec["ok"] = not failures
    exe.close()
    emit(rec)
    if failures:
        raise AssertionError(f"widedeep_lazy_adam: {failures}")
    return rec


def widedeep_serving_program(cfg=WIDEDEEP):
    """widedeep_serve's program: ``wide_deep(batch_size=-1)`` under the
    trained program's parameter names, ``clone(for_test=True)``; serves
    ``predict`` (the click probability) from ``dense_input`` and the
    slot ids."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import widedeep
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = widedeep.wide_deep(batch_size=-1, **widedeep_model_kw(cfg))
    names = ["dense_input"] + [f"C{i}" for i in range(cfg["num_slots"])]
    return main.clone(for_test=True), startup, names, [out["predict"]]


def widedeep_request(np, rows, rng, cfg=WIDEDEEP):
    req = {"dense_input": rng.standard_normal(
        (rows, cfg["dense_dim"])).astype(np.float32)}
    for i in range(cfg["num_slots"]):
        req[f"C{i}"] = rng.integers(0, cfg["vocab_size"],
                                    (rows, 1)).astype(np.int64)
    return req


def cudnn_deterministic_ab(torch, np, place=None, run=RESNET50, reps=2,
                           lenet_B=512, lenet_steps=16):
    """Queue 3's fault 3: what ``FLAGS_cudnn_deterministic`` costs and
    buys. bench_resnet50's step (B128 bf16 AMP, Momentum) with the flag
    off and on, in turns (off, on, on, off) x ``reps`` after a warm-up
    of each: device ms a step (torch.profiler) and wall ms; one step from
    two copies of one scope with the flag on and off (every state tensor
    bitwise, or not); two eager LeNet runs of ``lenet_steps`` steps
    under each setting, their losses bitwise or not (bitwise under the
    flag, as train_loop_lenet finds, or the phase fails)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_lenet_train
    main, startup, out, _ = build_resnet(run["depth"], run["classes"],
                                         run["B"], run["hw"], amp=True)
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pool = image_pool(torch, np, run["B"], run["hw"], run["classes"],
                      exe.device)
    loss = out["loss"]

    def step(sc=scope):
        return exe.run(main, feed=pool[0], fetch_list=[loss], scope=sc)[0]

    for on in (False, True):
        with deterministic_convs(fluid, on):
            step()
            step()
    dev = {False: [], True: []}
    wall = {False: [], True: []}
    for on in (False, True, True, False) * reps:
        with deterministic_convs(fluid, on):
            if cuda:
                dev[on].append(profiled_ms(torch, step))
            t0 = time.perf_counter()
            step()
            wall[on].append((time.perf_counter() - t0) * 1e3)
    bitwise = {}
    for on in (False, True):
        scopes = [copied_scope(torch, fluid, scope) for _ in range(2)]
        with deterministic_convs(fluid, on):
            for sc in scopes:
                step(sc)
        bitwise[on] = not scope_diff(torch, *scopes)
        del scopes
    with fluid.unique_name.guard():
        lmain, lstart, _, fetches = build_lenet_train()
    lpool = lenet_pool(np, lenet_B)
    lenet = {}
    for on in (False, True):
        with deterministic_convs(fluid, on):
            runs = [eager_losses(torch, np, fluid, place, lmain, lstart,
                                 fetches[0].name, lpool, lenet_steps)
                    for _ in range(2)]
        lenet[on] = bool(np.array_equal(runs[0], runs[1]))
    key = {False: "off", True: "on"}
    rec = {"phase": "cudnn_deterministic_ab", **CARD, "B": run["B"],
           "depth": run["depth"], "amp": "bf16", "order": "off on on off",
           "reps": reps,
           "wall_ms": {key[k]: v for k, v in wall.items()},
           "resnet_step_bitwise": {key[k]: v for k, v in bitwise.items()},
           "lenet_eager_runs_bitwise": {key[k]: v for k, v in lenet.items()},
           "lenet_B": lenet_B, "lenet_steps": lenet_steps}
    if cuda:
        rec["device_ms"] = {key[k]: v for k, v in dev.items()}
        off, on = (float(np.median(dev[k])) for k in (False, True))
        rec["device_ms_median"] = {"off": off, "on": on}
        rec["cost_of_flag"] = on / off - 1
    rec["ok"] = lenet[True]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"cudnn_deterministic_ab: two LeNet runs "
                             f"differ under the flag: {rec}")
    return rec


# bench.py bench_dygraph_transformer (:463-532): Transformer(8000, 8000,
# max_len=64), Transformer-base widths, Adam(1e-4), a pool of 4 batches
# of B256 src 32 tgt 32
DY_TRANSFORMER = {"B": 256, "src": 32, "tgt": 32, "vocab": 8000,
                  "d_model": 512, "heads": 8, "d_inner": 2048, "layers": 6,
                  "max_len": 64, "dropout": 0.1, "lr": 1e-4, "pool": 4,
                  "warm_rows": 8, "timed": 20}
DY_TR_KEYS = ("src_ids", "src_mask", "tgt_ids", "labels", "label_mask")


def transformer_train_flops(run):
    """FLOP of one training step of the Transformer at ``run``'s shape,
    counted as bench.py's ``_*_train_flops_per_sample`` helpers count:
    3 x (2 x the multiply-adds of the forward GEMMs and attention
    products); dropout, softmax, LayerNorm, the loss and Adam left out,
    as are the forwards the generic grads recompute (not useful work).
    Per source token: an encoder layer's Q, K, V, O (4 d^2) and FFN
    (2 d d_inner); per target token: a decoder layer's self and cross
    attention (8 d^2) and FFN, and the output projection (d x vocab);
    per token and attention: the score and context products (2 T d)."""
    d, di, L = run["d_model"], run["d_inner"], run["layers"]
    src_tok, tgt_tok = run["B"] * run["src"], run["B"] * run["tgt"]
    enc = L * (4 * d * d + 2 * d * di + 2 * run["src"] * d)
    dec = L * (8 * d * d + 2 * d * di + 2 * run["tgt"] * d
               + 2 * run["src"] * d) + d * run["vocab"]
    return 3 * 2 * (src_tok * enc + tgt_tok * dec)


def _dy_state(model, opt):
    """Copies of every parameter and optimizer slot of a dygraph model."""
    return ([p.value.clone() for p in model.parameters()],
            {pn: {s: t.clone() for s, t in st.items()}
             for pn, st in opt._eager_state.items()})


def _dy_restore(model, opt, state):
    params, slots = state
    for p, v in zip(model.parameters(), params):
        p.value = v.clone()
    opt._eager_state = {pn: {s: t.clone() for s, t in st.items()}
                        for pn, st in slots.items()}


def _dy_bitwise(torch, model, opt, state):
    """Names of the parameters and slots that differ from ``state``."""
    params, slots = state
    out = [p.name for p, v in zip(model.parameters(), params)
           if not torch.equal(p.value, v)]
    out += [f"{pn}.{s}" for pn, st in slots.items() for s, t in st.items()
            if not torch.equal(opt._eager_state[pn][s], t)]
    return out


def _dy_step(fluid, dygraph, model, opt):
    """bench.py's step function under dygraph.jit_step."""
    @dygraph.jit_step
    def step(*args):
        loss = model(*args)
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        return loss
    return step


def _timed_wall(torch, cuda, fn):
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dygraph_transformer(torch, np, place=None, run=DY_TRANSFORMER, seed=0,
                        eager_steps=4):
    """bench.py's bench_dygraph_transformer on the port: the dygraph
    Transformer at ``run``'s shape under ``dygraph.guard(place)``, Adam
    1e-4, a pool of 4 seeded batches staged on the device. One eager
    warm-up step on ``warm_rows`` rows; ``eager_steps`` eager steps at the
    full batch (``CompiledStep.eager``: wall ms, the median of steps 1 on,
    device ms and kernel launches of one); the capture at the full batch
    (its seconds, the graph pool's bytes) and its replay; ``timed``
    replays on the host clock with one sync at the end (ms/step,
    samples/s, target tokens/s, TFLOP/s by ``transformer_train_flops``);
    device ms and launches of one replay; the peaks. Gates: every loss
    finite; one replay from a copied state equals one eager step from
    the same state and tracer key bitwise (the loss, every parameter and
    every Adam slot; dropout on)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.models import transformer
    rng = np.random.default_rng(seed)
    B = run["B"]
    with dygraph.guard(place):
        tracer = dygraph.base._current_tracer()
        dev = tracer.device
        cuda = dev.type == "cuda"
        model = transformer.Transformer(
            run["vocab"], run["vocab"], d_model=run["d_model"],
            n_head=run["heads"], d_inner=run["d_inner"],
            n_layer=run["layers"], max_len=run["max_len"],
            dropout=run["dropout"])
        opt = fluid.optimizer.Adam(run["lr"],
                                   parameter_list=model.parameters())
        pool = [transformer.random_batch(B, run["src"], run["tgt"],
                                         run["vocab"], run["vocab"], rng=rng)
                for _ in range(run["pool"])]
        staged = [[torch.from_numpy(b[k]).to(dev) for k in DY_TR_KEYS]
                  for b in pool]
        step = _dy_step(fluid, dygraph, model, opt)
        cs = step._compiled_step
        n_params = sum(p.value.numel() for p in model.parameters())
        warm = [t[:run["warm_rows"]] for t in staged[0]]
        losses = [float(step(*warm).numpy().reshape(-1)[0])]
        base = _peak_base(torch, cuda)
        eager_ms = []
        for i in range(eager_steps):
            out, ms = _timed_wall(torch, cuda,
                                  lambda i=i: cs.eager(*staged[i % 4]))
            losses.append(float(out.numpy().reshape(-1)[0]))
            eager_ms.append(ms)
        rec = {"phase": "dygraph_transformer", **CARD, "B": B,
               "src_len": run["src"], "tgt_len": run["tgt"],
               "vocab": run["vocab"], "d_model": run["d_model"],
               "layers": run["layers"], "dropout": run["dropout"],
               "params": n_params, "eager_ms_per_step": eager_ms,
               "eager_ms_per_step_median": float(np.median(eager_ms[1:]))}
        if cuda:
            rec["peak_gb_eager"] = _peak_from(torch, cuda, base)
            rec["device_ms_eager"], rec["launches_eager"] = \
                profiled_launches(torch, lambda: cs.eager(*staged[0]))
        base = _peak_base(torch, cuda)
        out, first_ms = _timed_wall(torch, cuda, lambda: step(*staged[0]))
        losses.append(float(out.numpy().reshape(-1)[0]))
        entry = next(iter(cs._cache.values()))
        rec.update(capture_s=entry.capture_s, first_call_ms=first_ms,
                   graph_pool_gb=entry.nbytes / 1e9,
                   stochastic_call_sites=len(entry._sites),
                   staged_host_arrays=len(entry._staged),
                   external_vars=len(entry._ext),
                   optimizer_slots=len(entry._binding))
        losses.append(float(step(*staged[1]).numpy().reshape(-1)[0]))
        n = run["timed"]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = None
        for i in range(n):
            last = step(*staged[i % 4])
        losses.append(float(last.numpy().reshape(-1)[0]))   # the one sync
        dt = time.perf_counter() - t0
        flops = transformer_train_flops(run)
        rec.update(timed_steps=n, jit_ms_per_step=dt / n * 1e3,
                   samples_per_s=B * n / dt,
                   target_tokens_per_s=B * n / dt * run["tgt"],
                   train_flop_per_step=flops,
                   tflops=flops / (dt / n) / 1e12)
        if cuda:
            rec["peak_gb_capture_and_replays"] = _peak_from(torch, cuda,
                                                            base)
            rec["device_ms_replay"], rec["launches_replay"] = \
                profiled_launches(torch, lambda: step(*staged[2]))
            rec["idle_share_eager"] = 1 - rec["device_ms_eager"] / \
                rec["eager_ms_per_step_median"]
            rec["idle_share_jit"] = 1 - rec["device_ms_replay"] / \
                rec["jit_ms_per_step"]
        # the gate: a replay from a copied state against an eager step from
        # the same state and tracer key
        state, key = _dy_state(model, opt), tracer._key
        loss_r = step(*staged[3]).value.clone()
        after = _dy_state(model, opt)
        _dy_restore(model, opt, state)
        tracer._key = key
        loss_e = cs.eager(*staged[3]).value
        diff = _dy_bitwise(torch, model, opt, after)
        rec.update(first_loss=losses[0], last_loss=losses[-1],
                   losses=losses,
                   replay_equals_eager_bitwise=bool(
                       torch.equal(loss_r, loss_e)) and not diff,
                   bitwise_diff=diff[:8])
    rec["ok"] = bool(np.isfinite(losses).all()) and \
        rec["replay_equals_eager_bitwise"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"dygraph_transformer failed: {rec}")
    return rec


# tools/bench_dygraph_ab.py: BERT-base fp32, B64 S128 P20, Adam 1e-4,
# dropout 0.1, a pool of 2 batches; the static side by run_steps
DY_BERT_AB = {"B": 64, "S": 128, "P": 20, "lr": 1e-4, "K": 8,
              "warm_rows": 4, "timed": 20}
DY_BERT_KEYS = ("src_ids", "sent_ids", "pos_ids", "input_mask", "mask_pos",
                "mask_label", "labels")


def dygraph_bert_ab(torch, np, place=None, run=DY_BERT_AB, layers=None,
                    seed=0):
    """tools/bench_dygraph_ab.py on the port: BertPretrainDy by
    ``jit_step`` against the static ``bert_pretrain`` of the same config
    trained by ``Executor.run_steps`` (a slab of K), both fp32 Adam 1e-4
    on one seeded pool: ms/step (host clock), device ms and launches of
    one replay each (a slab / K for the static side), their ratio, and
    the eager dygraph step's ms. Finite losses on both sides."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.models import bert, bert_dygraph
    cfg = bert.BertConfig.base()
    if layers is not None:
        cfg.num_layers = layers
    B, S, P, K = run["B"], run["S"], run["P"], run["K"]
    rng = np.random.default_rng(seed)
    pool = [bert.random_batch(cfg, B, S, P, rng=rng) for _ in range(2)]
    rec = {"phase": "dygraph_bert_ab", **CARD, "B": B, "S": S, "P": P,
           "layers": cfg.num_layers, "dtype": "float32", "K": K}

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        fluid.optimizer.Adam(run["lr"]).minimize(out["loss"])
    exe = fluid.Executor(place)
    cuda = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    slab = {n: torch.from_numpy(np.stack([pool[i % 2][n]
                                          for i in range(K)])).to(exe.device)
            for n in pool[0]}
    got = exe.run_steps(main, feed=slab, fetch_list=[out["loss"]],
                        scope=scope)[0]
    static_losses = [float(x) for x in np.asarray(got).reshape(-1)]
    _, ms = _timed_wall(torch, cuda, lambda: exe.run_steps(
        main, feed=slab, fetch_list=[out["loss"]], scope=scope))
    rec["static_run_steps_ms_per_step"] = ms / K
    if cuda:
        dms, launches = profiled_launches(torch, lambda: exe.run_steps(
            main, feed=slab, fetch_list=[out["loss"]], scope=scope))
        rec["static_device_ms_per_step"] = dms / K
        rec["static_launches_per_step"] = launches / K
    exe.close()
    del scope, slab

    with dygraph.guard(place):
        dev = dygraph.base._current_tracer().device
        model = bert_dygraph.BertPretrainDy(cfg)
        opt = fluid.optimizer.Adam(run["lr"],
                                   parameter_list=model.parameters())
        step = _dy_step(fluid, dygraph, model, opt)
        staged = [[torch.from_numpy(b[k]).to(dev) for k in DY_BERT_KEYS]
                  for b in pool]
        w = run["warm_rows"]
        small = [t[:w] for t in staged[0]]
        small[4] = staged[0][4][:w * P]
        small[5] = staged[0][5][:w * P]
        dy_losses = [float(step(*small).numpy().reshape(-1)[0])]
        eager_ms = []
        for i in range(3):
            o, ms = _timed_wall(torch, cuda, lambda i=i: step._compiled_step
                                .eager(*staged[i % 2]))
            dy_losses.append(float(o.numpy().reshape(-1)[0]))
            eager_ms.append(ms)
        rec["dygraph_eager_ms_per_step"] = float(np.median(eager_ms[1:]))
        dy_losses.append(float(step(*staged[0]).numpy().reshape(-1)[0]))
        entry = next(iter(step._compiled_step._cache.values()))
        rec["dygraph_capture_s"] = entry.capture_s
        rec["dygraph_graph_pool_gb"] = entry.nbytes / 1e9
        n = run["timed"]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = None
        for i in range(n):
            last = step(*staged[i % 2])
        dy_losses.append(float(last.numpy().reshape(-1)[0]))
        rec["dygraph_jit_ms_per_step"] = (time.perf_counter() - t0) / n * 1e3
        if cuda:
            rec["dygraph_device_ms_per_step"], \
                rec["dygraph_launches_per_step"] = profiled_launches(
                    torch, lambda: step(*staged[1]))
    flops = bert_train_flops_per_sample(cfg, S, P) * B
    rec["train_flop_per_step"] = flops
    rec["static_tflops"] = flops / rec["static_run_steps_ms_per_step"] / 1e9
    rec["dygraph_tflops"] = flops / rec["dygraph_jit_ms_per_step"] / 1e9
    rec["jit_over_static_ms"] = rec["dygraph_jit_ms_per_step"] / \
        rec["static_run_steps_ms_per_step"]
    rec["dygraph_over_static_samples_per_s"] = 1 / rec["jit_over_static_ms"]
    rec.update(static_losses=static_losses, dygraph_losses=dy_losses)
    rec["ok"] = bool(np.isfinite(static_losses + dy_losses).all())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"dygraph_bert_ab failed: {rec}")
    return rec


def dygraph_capture_refusals(torch, np, place=None, width=64, seed=9):
    """Nothing hides the device under ``jit_step``: a step that copies
    host data to the device without ``to_variable`` (``h2d``), one that
    reads a value back to the host (``d2h``) and one whose
    ``to_variable`` data change from call to call (``unstaged``) each
    raise ``GraphCaptureError`` at the call that captures (on the CPU,
    where nothing is captured, only ``unstaged`` raises, at the step
    after discovery); the step runs no eager pass instead and leaves
    every parameter and Adam slot as it was."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.framework.cuda_graph import GraphCaptureError
    rng = np.random.default_rng(seed)
    xv = rng.standard_normal((8, width)).astype("float32")
    rec = {"phase": "dygraph_capture_refusals", **CARD}
    with dygraph.guard(place):
        cuda = dygraph.base._current_tracer().device.type == "cuda"
        lin = dygraph.Linear(width, width)
        opt = fluid.optimizer.Adam(1e-3, parameter_list=lin.parameters())
        calls = []

        def make(kind):
            @dygraph.jit_step
            def step(x):
                h = lin(x)
                if kind == "h2d":
                    h = h + dygraph.VarBase(np.ones(width, np.float32))
                if kind == "unstaged":
                    calls.append(1)
                    h = h + dygraph.to_variable(
                        np.full(width, len(calls), np.float32))
                loss = fluid.layers.mean(fluid.layers.square(h))
                if kind == "d2h":
                    loss.numpy()
                loss.backward()
                opt.minimize(loss)
                lin.clear_gradients()
                return loss
            return step

        x = dygraph.to_variable(xv)
        for kind in ("h2d", "d2h", "unstaged"):
            step = make(kind)
            step(x)                                   # the eager warm-up
            state = _dy_state(lin, opt)
            err = None
            try:
                step(x)
            except GraphCaptureError as e:
                # kept as text: the exception's frames hold the entry
                err = {"op_type": e.op_type, "message": str(e)[:160]}
            must = cuda or kind == "unstaged"
            rec[kind] = {
                "raised": err is not None, **(err or {}),
                "state_unchanged": not _dy_bitwise(torch, lin, opt, state),
                "graphs": sum(e.graph is not None
                              for e in step._compiled_step._cache.values())}
            rec[kind]["ok"] = (err is not None) == must and \
                (not must or (rec[kind]["state_unchanged"]
                              and rec[kind]["graphs"] == 0))
    rec["ok"] = all(rec[k]["ok"] for k in ("h2d", "d2h", "unstaged"))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"dygraph_capture_refusals: {rec}")
    return rec


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="TREE", help="another checkout "
                    "(e.g. a git archive of the parent commit): each K5 "
                    "phase and the K2 determinism phase then time that "
                    "tree's kernel, called through its own wrapper, beside "
                    "the port's, in the order parent, new, new, parent")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py drives the port on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    CARD["card"] = smi
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.cuda.set_device(0)

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import GPTConfig
    t0 = time.perf_counter()
    parent = parent_paged(os.path.abspath(args.parent)) if args.parent \
        else None
    parent_fa = parent_flash() if args.parent else None
    parent_built = []
    if parent is not None:
        # that tree's paged and backward kernels build beside the port's
        import threading
        th = threading.Thread(target=lambda: parent_built.append(
            parent._build.build_all(("paged_attention",
                                     "flash_attention_bwd"))))
        th.start()
    # a current library whose compiler report was not kept is rebuilt, so
    # the ptxas lines and the spill check below see every kernel
    built = _build.build_all(force=[n for n in _build.SOURCES
                                    if _build.build_log(n) is None])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f}s "
          f"into {_build.BUILD_DIR}", flush=True)
    failures = []
    for name in _build.SOURCES:
        # the compiler's report of the current build, rebuilt or not
        rep = ptxas_report(name, _build.build_log(name))
        emit(rep)
        spilled = [k["entry"] for k in rep["kernels"]
                   if k.get("spill_stores") or k.get("spill_loads")]
        if name == "paged_attention" and spilled:
            failures.append(f"K5 instantiations spill registers: {spilled}")
    for name in _build.SOURCES:
        rep = sass_report(_build._nvcc(), _build._paths(name)[1])
        if rep is not None:
            emit(rep)
    fa = sys.modules["paddle_tpu_torch.kernels.flash_attention"]
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    if parent is not None:
        th.join()
        if not parent_built:
            raise RuntimeError(f"{args.parent}: its paged kernel did not "
                               f"build")

    # causal phases take q/k/v as the prefill lays them out (strided views
    # of one qkv projection); one contiguous causal run and the
    # non-causal bias run cover the other layout
    main_fa = None
    for S in (128, 1024, 2048):
        for dtype in ("float32", "bfloat16"):
            rec = flash_phase(torch, fa, 8, 12, S, 64, dtype, True, False,
                              seed=S, packed=True)
            if S == 1024 and dtype == "float32":
                main_fa = rec
    flash_phase(torch, fa, 8, 12, 1024, 64, "float32", True, False, seed=2,
                packed=False)
    flash_phase(torch, fa, 8, 12, 1024, 64, "float32", False, True, seed=1,
                packed=False)
    # the tiling's edges: head dim 128 (H6 keeps the width at 768) and a
    # ragged S = 1000, both types, causal; non-causal + bias at D = 128
    edges = ((6, 1024, 128), (12, 1000, 64), (6, 1000, 128))
    for H, S, D in edges:
        for dtype in ("float32", "bfloat16"):
            flash_phase(torch, fa, 8, H, S, D, dtype, True, False,
                        seed=S + D, packed=True)
    flash_phase(torch, fa, 8, 6, 1024, 128, "float32", False, True, seed=3,
                packed=False)
    # head dims 80 and 96 (D128's tile plan)
    for D in (80, 96):
        for dtype in ("float32", "bfloat16"):
            flash_phase(torch, fa, 4, 8, 1024, D, dtype, True, False,
                        seed=D, packed=True)
    main_pa = paged_phases(torch, pa, parent)

    # K2 at the S1024 shape, K3/K4 at S2048, causal on the model's
    # strided views; then non-causal + bias and bf16
    main_bwd = {}
    for name, S in (("flash_attention_bwd_single", 1024),
                    ("flash_attention_bwd_dq", 2048),
                    ("flash_attention_bwd_dkv", 2048)):
        main_bwd[name] = bwd_phase(torch, fa, name, 8, 12, S, 64, "float32",
                                   True, False, seed=S + 5, packed=True)
        bwd_phase(torch, fa, name, 8, 12, S, 64, "float32", False, True,
                  seed=S + 6, packed=False)
        bwd_phase(torch, fa, name, 8, 12, S, 64, "bfloat16", True, False,
                  seed=S + 7, packed=True)
    for H, S, D in edges:
        for dtype in ("float32", "bfloat16"):
            bwd_phase(torch, fa, "flash_attention_bwd_single", 8, H, S, D,
                      dtype, True, False, seed=S + D + 1, packed=True)
    # K3/K4 at their tiling's edges: head dim 128 (H6) and a ragged S =
    # 2000, both types, causal; non-causal + bias at D = 128
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        for H, S, D in ((6, 2048, 128), (12, 2000, 64), (6, 2000, 128)):
            for dtype in ("float32", "bfloat16"):
                bwd_phase(torch, fa, name, 8, H, S, D, dtype, True, False,
                          seed=S + D + 2, packed=True)
        bwd_phase(torch, fa, name, 8, 6, 2048, 128, "float32", False, True,
                  seed=4, packed=False)
    # head dims 80 and 96 (D128's tile plan): K2 at S1024, K3/K4 at
    # causal S2048 (D80)
    for dtype in ("float32", "bfloat16"):
        for D in (80, 96):
            bwd_phase(torch, fa, "flash_attention_bwd_single", 4, 8, 1024,
                      D, dtype, True, False, seed=D + 1, packed=True)
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            bwd_phase(torch, fa, name, 4, 8, 2048, 80, dtype, True, False,
                      seed=83, packed=True)
    # K2 off its route, at the S2048 shape of K3 + K4, for the route rule
    bwd_phase(torch, fa, "flash_attention_bwd_single", 8, 12, 2048, 64,
              "float32", True, False, seed=2053, packed=True)
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        k2_determinism(torch, fa, dtype, parent_fa)
    torch.cuda.empty_cache()
    # the route rule: K3 + K4 (the route of causal S2048 and S4096)
    # against K2 off its route and SDPA's backward
    for S in (2048, 4096):
        for dtype in ("float32", "bfloat16"):
            bwd_pair_phase(torch, fa, 8, 12, S, 64, dtype, seed=S + 8)
            torch.cuda.empty_cache()
    # K1 and K2 at bench_bert_long's attention (B16 H12 S2048 D64,
    # non-causal, a key bias masking each row's padded tail), then K3 +
    # K4 off their route there against K2 and SDPA's backward
    bert_k = {}
    for dtype in ("float32", "bfloat16"):
        bert_k[("fwd", dtype)] = flash_phase(
            torch, fa, 16, 12, 2048, 64, dtype, False, "padded", seed=2049,
            packed=True)
        bert_k[("bwd", dtype)] = bwd_phase(
            torch, fa, "flash_attention_bwd_single", 16, 12, 2048, 64,
            dtype, False, "padded", seed=2050, packed=True)
        torch.cuda.empty_cache()
        bwd_pair_phase(torch, fa, 16, 12, 2048, 64, dtype, seed=2051,
                       causal=False, with_bias="padded")
        torch.cuda.empty_cache()

    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_single": fa.flash_attention_bwd_single,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "paged_attention": pa.paged_attention}
    launches = dict.fromkeys(counters, 0)

    def drive(path, needs, fn):
        """Run one main path with every launch count zeroed just before
        it and read just after; ``needs`` must each have launched."""
        for c in counters.values():
            c.launches = 0
            if hasattr(c, "bf16_launches"):
                c.bf16_launches = 0
        rec = fn()
        got = {n: c.launches for n, c in counters.items()}
        bf16 = {n: c.bf16_launches for n, c in counters.items()
                if hasattr(c, "bf16_launches")}
        gc.collect()       # a path's graphs that only cycles still hold
        torch.cuda.empty_cache()
        # what the path left on the card (a live graph keeps its pool)
        emit({"phase": f"launches_{path}", "launches": got,
              "bf16_launches": bf16,
              "allocated_gb_after": torch.cuda.memory_allocated() / 1e9,
              "reserved_gb_after": torch.cuda.memory_reserved() / 1e9})
        if needs and min(got[n] for n in needs) < 1:
            raise AssertionError(f"a kernel of the {path} path never "
                                 f"launched: {got}")
        for n, c in got.items():
            launches[n] += c
        return rec, got, bf16

    # the dygraph paths (they need two eager B256 Transformer steps of
    # memory, ~15 GB each): bench_dygraph_transformer by jit_step (one
    # CUDA graph over the taped step), the dygraph-vs-static BERT A/B and
    # the capture refusals; no kernel of the port (attention as matmul +
    # softmax, and einsum)
    for name, fn in (("dygraph_transformer",
                      lambda: dygraph_transformer(torch, np)),
                     ("dygraph_bert_ab", lambda: dygraph_bert_ab(torch, np)),
                     ("dygraph_capture_refusals",
                      lambda: dygraph_capture_refusals(torch, np))):
        _, got, _ = drive(name, (), fn)
        if any(got.values()):
            failures.append(f"the {name} path launched a kernel of the "
                            f"port: {got}")

    cfg = GPTConfig.base()

    def serving():
        rec = end_to_end(torch, np, cfg)
        rec["k5_base"] = pa.paged_attention.launches
        tiny_generate(torch, np)
        rec["k5_tiny"] = pa.paged_attention.launches - rec["k5_base"]
        return rec

    rec, got, _ = drive("serving", ("flash_attention_fwd",
                                    "paged_attention"), serving)
    # one K5 wrapper call per layer of every paged decode step
    steps = rec["paged_decode_steps"]
    emit({"phase": "paged_launches_per_decode_step", "steps": steps,
          "launches": rec["k5_base"], "per_step": rec["k5_base"] / steps,
          "tiny_config_launches": rec["k5_tiny"]})
    if rec["k5_base"] != cfg.num_layers * steps:
        failures.append(f"K5 launched {rec['k5_base']} times in {steps} "
                        f"paged decode steps")
    if rec["k5_tiny"] < 1:
        failures.append("the tiny config's paged generate never launched "
                        "K5")
    long_needs = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
    for S, amp, needs in (
            (2048, None, long_needs),
            (1024, None, ("flash_attention_fwd",
                          "flash_attention_bwd_single")),
            (2048, "static", long_needs)):
        rec, got, bf16 = drive(
            f"train_S{S}" + ("" if amp is None else "_amp_bf16"), needs,
            lambda S=S, amp=amp: train_phase(torch, np, GPTConfig.base(), 8,
                                             S, 5, amp=amp))
        rec["launches_per_step"] = {n: c / rec["steps"]
                                    for n, c in got.items()}
        rec["bf16_launches_per_step"] = {n: c / rec["steps"]
                                         for n, c in bf16.items()}
        emit(rec)
        if amp is not None and any(bf16[n] != got[n] for n in needs):
            failures.append(f"the AMP step launched {needs} with other "
                            f"than bf16 inputs: {got}, bf16 {bf16}")
    small = GPTConfig.base()
    small.num_layers = 2
    for S in (1024, 2048):
        for amp in (None, "static"):
            grad_check(torch, np, small, 8, S, amp=amp)
            torch.cuda.empty_cache()
    pipeline_ab(torch, np, small, 8, 1024)
    dynamic_scaling(torch, np, small, 8, 1024, 3)
    torch.cuda.empty_cache()

    # BERT-base pretraining, bench.py's two trainers: bert_long (K1, K2 in
    # bf16, once per layer and step each) and the flagship (einsum
    # attention: no kernel of the port)
    bert_needs = ("flash_attention_fwd", "flash_attention_bwd_single")
    for run, needs in ((BERT_LONG, bert_needs), (BERT_FLAGSHIP, ())):
        rec, got, bf16 = drive(
            f"train_{run['name']}_amp_bf16", needs,
            lambda run=run: bert_train_phase(torch, np, run, 5))
        rec["launches_per_step"] = {n: c / rec["steps"]
                                    for n, c in got.items()}
        rec["bf16_launches_per_step"] = {n: c / rec["steps"]
                                         for n, c in bf16.items()}
        emit(rec)
        want = {n: rec["layers"] * rec["steps"] if n in needs else 0
                for n in got}
        if got != want or any(bf16[n] != got[n] for n in needs):
            failures.append(f"{run['name']} launched {got} (bf16 {bf16}), "
                            f"not once per layer and step: {want}")
    drive("eval_bert_entry", (), lambda: eval_bert_entry(torch, np))
    drive("bert_verified_step", bert_needs,
          lambda: bert_verified_step(torch, np))
    bert_small(torch, np)
    torch.cuda.empty_cache()

    # ResNet-50 (bench.py's bench_resnet50) and LeNet (BASELINE config 1):
    # convolutions in cuDNN, GEMMs in cuBLAS, no kernel of the port
    trained = {}

    def resnet50():
        rec, trained["scope"], trained["exe"] = resnet_train_phase(torch, np)
        return rec

    rec, _, _ = drive("resnet50_train", (), resnet50)
    emit(rec)
    drive("resnet50_eval", (), lambda: resnet_eval_phase(
        torch, np, trained["scope"], trained["exe"]))
    trained.clear()
    # Queue 3's fault 3: FLAGS_cudnn_deterministic off and on at
    # bench_resnet50's step, and LeNet run to run
    drive("cudnn_deterministic_ab", (),
          lambda: cudnn_deterministic_ab(torch, np))
    drive("resnet18_tiny_trains", (), lambda: resnet18_tiny_trains(torch, np))
    resnet_grads(torch, np)
    for opt, lr in (("adam", 0.001), ("sgd", 0.01)):
        drive(f"lenet_train_{opt}", (),
              lambda opt=opt, lr=lr: lenet_train(torch, np, opt, lr))
    fused_optimizers(torch, np)
    torch.cuda.empty_cache()

    # saved-model persistence and serving: io at ResNet-50's width, then
    # ResNet-50 (cuDNN, no kernel of the port) and BERT-base with flash
    # attention (K1 once per layer of every executed batch) served from
    # their saved directories under bench_serving's traffic, each bucket
    # a captured CUDA graph
    drive("io_roundtrip", (), lambda: io_roundtrip(torch, np))
    served = {}
    for name, build, request, needs, k1 in (
            ("resnet50", resnet50_serving_program, image_request, (), 0),
            ("bert_base", bert_serving_program, bert_request,
             ("flash_attention_fwd",), 12)):
        _, got, _ = drive(f"serve_{name}", needs, lambda b=build, r=request,
                          n=name: served.setdefault(n, serve_traffic(
                              torch, np, n, b, r)))
        check_served(torch, np, served.pop(name), got, k1)
        torch.cuda.empty_cache()
    # K1 at the served shape: B32 H12 S128 D64 f32, non-causal, each
    # row's padded tail masked by the key bias
    flash_phase(torch, fa, 32, 12, 128, 64, "float32", False, "padded",
                seed=129, packed=True)
    capture_refuses_host_sync(torch, np)
    torch.cuda.empty_cache()

    # the training loop: run_steps (a captured step replayed), the
    # non-finite guard and rollback, train_from_dataset; the slice's path
    # first: BERT-base at bench_bert_long's shape under recompute, K1
    # forward and recomputed and K2 inside a captured training graph
    drive("bert_long_recompute", bert_needs,
          lambda: bert_long_recompute(torch, np, fa))
    drive("capture_names_flash_grad", bert_needs,
          lambda: capture_names_flash_grad(torch, np))
    drive("flagship_steps", (), lambda: flagship_steps(torch, np))
    drive("train_loop_lenet", (), lambda: train_loop_lenet(torch, np))
    drive("nonfinite_steps", bert_needs,
          lambda: nonfinite_steps(torch, np))
    drive("train_from_dataset", (),
          lambda: train_from_dataset_phase(torch, np))
    torch.cuda.empty_cache()

    # Wide&Deep CTR (bench.py's bench_widedeep) with SelectedRows
    # embedding grads: trained by run and run_steps, lazy Adam captured,
    # then the trained model served from its saved directory; no kernel
    # of the port (the JAX package's sparse updates are XLA scatters)
    wd = {}

    def wd_train():
        rec, wd["scope"] = widedeep_train(torch, np)
        return rec

    paths = [drive("widedeep_train", (), wd_train)[1],
             drive("widedeep_lazy_adam", (),
                   lambda: widedeep_lazy_adam(torch, np))[1]]
    _, got, _ = drive("widedeep_serve", (), lambda: served.setdefault(
        "widedeep", serve_traffic(
            torch, np, "widedeep", widedeep_serving_program,
            widedeep_request, traffic=dict(SERVE_TRAFFIC,
                                           request_batches=(1, 32)),
            scope=wd.pop("scope"))))
    check_served(torch, np, served.pop("widedeep"), got, 0)
    for got in paths + [got]:
        if any(got.values()):
            failures.append(f"a Wide&Deep path launched a kernel of the "
                            f"port: {got}")

    kernels = []
    rows = [("flash_attention_fwd", FA_SOURCE, FA_REPLACES, main_fa),
            ("paged_attention", PA_SOURCE, PA_REPLACES, main_pa)]
    rows += [(n, BWD_SOURCE, BWD_KERNELS[n][0], main_bwd[n])
             for n in main_bwd]
    for name, source, replaces, rec in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    if failures:
        print(f"failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 — report, then fail the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
