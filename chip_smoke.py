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
6. Prints the {"kernels": [...]} line (K1-K5), then as the last line
   {"ok": true, "device": {...}}.

Any failed phase exits non-zero and prints no result line.
"""
import json
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


def optimizer_ops(exe, program, fetch_names):
    """{op type: count} of the optimizer update ops in the program the
    executor runs for ``program`` (the pass pipeline's output)."""
    ops = exe._optimize(program, fetch_names).global_block().ops
    return {t: sum(op.type == t for op in ops)
            for t in ("adam", "fused_adam")}


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


def noam_lr(np, step, d_model):
    """The learning rate ``noam_decay(d_model, 10000, 200.0)`` gives at
    ``step``, in the program's float32 operations and order: 200 *
    d_model^-0.5 * min(rsqrt(step), step * 10000^-1.5). Below step 10000
    the min is the linear term, so the value is exact IEEE float32
    arithmetic (rsqrt's rounding does not enter)."""
    f = np.float32
    n = f(step)
    return f(200.0 * d_model ** -0.5) * min(f(1) / np.sqrt(n),
                                            n * f(10000 ** -1.5))


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
        emit({"phase": f"launches_{path}", "launches": got,
              "bf16_launches": bf16})
        if needs and min(got[n] for n in needs) < 1:
            raise AssertionError(f"a kernel of the {path} path never "
                                 f"launched: {got}")
        for n, c in got.items():
            launches[n] += c
        torch.cuda.empty_cache()
        return rec, got, bf16

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
