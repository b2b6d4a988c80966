#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; exits non-zero without a CUDA device.
2. Builds the port's CUDA kernels from paddle_tpu_torch/kernels/csrc/
   (one nvcc per source, all started together) and prints each kernel's
   registers, stack and spills from ``-Xptxas -v`` and, where the toolkit
   has ``cuobjdump``, the tensor-core (HMMA) instructions in K1-K4's SASS.
3. Kernel phases: each kernel against its plain PyTorch version on the
   card at the main paths' shapes, with the tolerance stated; prints one
   JSON line per phase with the error, the kernel's, the plain version's
   and (where one exists) a single PyTorch call's time, and the bound
   (bytes or operations of this input over the card's peak). K1 (flash
   forward) and K5 (paged decode) at the serving shapes; K2 (combined
   backward) at B8 H12 S1024 D64 causal and K3/K4 (dq; dk, dv) at S2048
   causal, on the strided q/k/v views the model makes, plus a non-causal
   + bias and a bf16 case each; K1 and K2 also at the tiling's edges
   (head dim 128 and a ragged S = 1000, float32 and bf16, causal; K1
   non-causal + bias at D = 128), K3 and K4 at head dim 128 and a ragged
   S = 2000 (both types, causal; non-causal + bias at D = 128). Bounds
   take float32 at 165 TFLOP/s (3xTF32). One ``bwd_pair`` line per
   (S, type) at S2048 and S4096 causal times K3 then K4 back to back
   beside K2 off its route and SDPA's backward, and holds the pair's
   outputs against K2's.
4. The main paths at GPTConfig.base() widths, seeded random weights, each
   with every kernel launch count zeroed just before it and read just
   after; each path's kernels must have launched:
   - serving: offline greedy generate (dense and paged), teacher-forced
     paged (kernel) vs dense (plain) decode logits, then an
     InferenceServer with 8 decode slots answering 16 requests from 8
     concurrent wire clients, each reply equal to offline greedy generate
     (K1, K5);
   - training through the Fluid surface (gpt_pretrain + AdamOptimizer +
     Executor), fp32, dropout 0.1, 5 Adam steps at lr 1e-4 on one seeded
     batch: B8 S2048 (K1, K3, K4) and B8 S1024 (K1, K2), all 12 layers;
     finite losses, step 0 within 1.0 of ln(32000), step 4 below step 0;
     ms/step, tokens/s, TFLOP/s and peak memory.
5. Gradient check at GPT-base width, 2 layers, S1024 and S2048: every
   param@GRAD of one step through the kernels against the same program
   cloned with the flash_attention op's impl set to "xla" (the plain
   composite), within 1e-3 of its max |grad|.
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
    """``flash_bwd_k2_kernel<float,64>`` from a mangled template kernel
    name: its last ``<length><name>I<args>E`` component."""
    import re
    best = mangled
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        start, n = m.end(), int(m.group(1))
        name = mangled[start:start + n]
        if name.endswith("kernel") and mangled[start + n:start + n + 1] == "I":
            args = mangled[start + n + 1:].split("E", 1)[0]
            args = args.replace("Li", ",").replace("13__nv_bfloat16", "bf16")
            if args.split(",")[0] == "f":
                args = "float" + args[1:]
            best = f"{name}<{args}>"
    return best


def sass_report(nvcc, lib_path):
    """Tensor-core instructions (HMMA opcodes) in each kernel of a built
    library, counted in ``cuobjdump -sass`` from ``nvcc``'s toolkit; None
    where the toolkit has no cuobjdump."""
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
            cur = {"entry": _kernel_name(m.group(1)), "hmma": {}}
            rows.append(cur)
            continue
        m = re.search(r"\b(HMMA\.[\w.]+)", line)
        if m and cur is not None:
            cur["hmma"][m.group(1)] = cur["hmma"].get(m.group(1), 0) + 1
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
    D]`` and transposed to ``[B, H, S, D]``, as ``models/gpt.py`` does);
    else contiguous tensors."""
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
    if with_bias:
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


def paged_phase(torch, pa, kv_dtype, seed):
    import numpy as np
    B, H, D, bs, nblk = 8, 12, 64, 16, 128
    N = B * nblk + 1
    rng = np.random.default_rng(seed)
    pos = np.linspace(0, nblk * bs - 1, B).round().astype(np.int32)
    tables = np.zeros((B, nblk), np.int32)
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    used = 0
    for b, p in enumerate(pos):
        n = int(p) // bs + 1
        tables[b, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, 1, D, device="cuda", generator=g)
    kf = torch.randn(N, H, bs, D, device="cuda", generator=g)
    vf = torch.randn(N, H, bs, D, device="cuda", generator=g)
    ks = vs = None
    if kv_dtype == "int8":
        (kp, ks), (vp, vs) = pa.quantize_kv(kf), pa.quantize_kv(vf)
    else:
        kp, vp = kf.to(getattr(torch, kv_dtype)), vf.to(
            getattr(torch, kv_dtype))
    t = torch.from_numpy(tables).cuda()
    p = torch.from_numpy(pos).cuda()
    out = pa.paged_attention(q, kp, vp, t, p, k_scale=ks, v_scale=vs)
    ref = pa.paged_attention_ref(q, kp, vp, t, p, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # both sides read the same stored values and compute in float32, so
    # every pool type is held to the float32 limit
    tol = 1e-4
    ok = err <= tol and bool(torch.isfinite(out).all())
    ms = time_ms(torch, lambda: pa.paged_attention(
        q, kp, vp, t, p, k_scale=ks, v_scale=vs), 50)
    plain_ms = time_ms(torch, lambda: pa.paged_attention_ref(
        q, kp, vp, t, p, k_scale=ks, v_scale=vs), 10)
    live = int((pos.astype(np.int64) + 1).sum())
    nbytes = 2 * live * H * D * kp.element_size() \
        + (2 * live * H * 4 if ks is not None else 0) \
        + 2 * B * H * D * 4 + B * nblk * 4 + B * 4
    ops = 4.0 * live * H * D
    bound_ms, bound_by = bound(nbytes, ops, "float32")
    rec = {"phase": "paged_attention", "B": B, "H": H, "D": D,
           "block_size": bs, "nblk": nblk, "pos": pos.tolist(),
           "kv_dtype": kv_dtype, "max_abs_err": err, "atol": tol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "gbytes_per_s": nbytes / ms / 1e6,
           "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"paged_attention disagrees with its plain "
                             f"version: {rec}")
    return rec


# ------------------------------------------------------------- end to end

def end_to_end(torch, np, cfg, device=None, max_len=2048, lo=64, hi=1024,
               new=32):
    """The main path at ``cfg``; prompts of ``lo``..``hi`` tokens and
    ``new`` new tokens each."""
    from paddle_tpu_torch.models import GPTGenerator, init_params
    from paddle_tpu_torch.serving import (Client, InferenceServer,
                                          KVBlockPool, ServingStats)
    t0 = time.perf_counter()
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=max_len,
                       device=device)
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


def bwd_pair_phase(torch, fa, B, H, S, D, dtype, seed):
    """The K3 + K4 route against its yardsticks on one causal input (the
    model's strided views): K3 then K4 back to back as one timed call,
    K2 off its route on the same input, and the backward of
    ``scaled_dot_product_attention`` (the one library call that computes
    dq, dk and dv). The pair's outputs are held against K2's (two
    independent kernels; limit as in ``bwd_phase``), so no S x S plain
    backward is materialized."""
    F = torch.nn.functional
    q, k, v, _, g = attention_inputs(torch, B, H, S, D, dtype, False, seed,
                                     True)
    scale = D ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, None, scale, True)
    dout = torch.randn(B, H, S, D, device="cuda", generator=g).to(q.dtype)
    args = (q, k, v, None, scale, True, out, lse, dout)

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
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_ms = event_ms(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, lv), dout, retain_graph=True), 10)
    pairs = S * (S + 1) // 2
    nbytes = 7 * B * H * S * D * q.element_size() + 2 * B * H * S * 4
    # the pair does 7 score-sized products (K3: 3, K4: 4), K2 5
    bound_ms, bound_by = bound(nbytes, 14.0 * B * H * pairs * D, dtype)
    k2_bound_ms = bound(nbytes, 10.0 * B * H * pairs * D, dtype)[0]
    rec = {"phase": "bwd_pair", "B": B, "H": H, "S": S, "D": D,
           "dtype": dtype, "causal": True, "layout": "packed qkv views",
           "err_over_max_k2": rel, "limit_over_max_ref": tol,
           "k3_ms": k3_ms, "k4_ms": k4_ms, "ms": ms, "k2_ms": k2_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms,
           "k2_bound_ms": k2_bound_ms, "bound_by": bound_by,
           "single_pass_route": fa.single_pass_backward(S, True), "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"K3 + K4 disagree with K2: {rec}")
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


def build_train(cfg, B, S):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = gpt.gpt_pretrain(cfg, B, S)
        _, params_grads = fluid.optimizer.AdamOptimizer(1e-4).minimize(
            out["loss"])
    return main, startup, out["loss"], params_grads


def train_phase(torch, np, cfg, B, S, steps, place=None, seed=0):
    """``steps`` Adam steps of ``gpt_pretrain`` through the Fluid surface
    on one seeded batch; ``place`` None is the GPU (a CPUPlace rehearses
    the path at a tiny size). Returns the phase record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup, loss, _ = build_train(cfg, B, S)
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
    rec = {"phase": f"train_gpt_B{B}_S{S}", "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "dropout": cfg.dropout, "steps": steps, "losses": losses,
           "step_ms": wall, "median_step_ms_after_first": step_ms,
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


def grad_check(torch, np, cfg, B, S, place=None, seed=1):
    """Every param@GRAD of one step through the kernels against the same
    program cloned with the flash_attention op's impl set to "xla" (the
    plain composite), from copies of one startup scope (so dropout draws
    the same masks); limit 1e-3 of each grad's max |value|."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    main, startup, _, params_grads = build_train(cfg, B, S)
    plain = main.clone()
    for op in plain.global_block().ops:
        if op.type == "flash_attention":
            op.attrs["impl"] = "xla"
        elif op.type == "flash_attention_grad":
            op.attrs["__fwd_op__"]["attrs"]["impl"] = "xla"
    exe = fluid.Executor(place)
    s1, s2 = fluid.Scope(), fluid.Scope()
    exe.run(startup, scope=s1)
    for n, v in s1.items():
        s2.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    feed = gpt.random_batch(cfg, B, S, rng=np.random.default_rng(seed))
    names = [g.name for _, g in params_grads]
    kern = exe.run(main, feed=feed, fetch_list=names, scope=s1)
    ref = exe.run(plain, feed=feed, fetch_list=names, scope=s2)
    worst, worst_name = 0.0, None
    for n, a, b in zip(names, kern, ref):
        r = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) \
            if np.isfinite(a).all() else float("inf")
        if r >= worst:
            worst, worst_name = r, n
    rec = {"phase": f"grad_check_B{B}_S{S}", "layers": cfg.num_layers,
           "grads": len(names), "worst_err_over_max_grad": worst,
           "worst_grad": worst_name, "limit": 1e-3}
    emit(rec)
    if not worst <= 1e-3:
        raise AssertionError(f"kernel grads differ from the plain "
                             f"composite's: {rec}")
    return rec


def main():
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
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f}s "
          f"into {_build.BUILD_DIR}", flush=True)
    for name, out in built.items():
        emit(ptxas_report(name, out))
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        rep = sass_report(_build._nvcc(), _build._paths(name)[1])
        if rep is not None:
            emit(rep)
    fa = sys.modules["paddle_tpu_torch.kernels.flash_attention"]
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]

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
    main_pa = None
    for kv_dtype in ("float32", "bfloat16", "int8"):
        rec = paged_phase(torch, pa, kv_dtype, seed=3)
        if kv_dtype == "float32":
            main_pa = rec

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
    # K2 off its route, at the S2048 shape of K3 + K4, for the route rule
    bwd_phase(torch, fa, "flash_attention_bwd_single", 8, 12, 2048, 64,
              "float32", True, False, seed=2053, packed=True)
    torch.cuda.empty_cache()
    # the route rule: K3 + K4 (the route of causal S2048 and S4096)
    # against K2 off its route and SDPA's backward
    for S in (2048, 4096):
        for dtype in ("float32", "bfloat16"):
            bwd_pair_phase(torch, fa, 8, 12, S, 64, dtype, seed=S + 8)
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
        rec = fn()
        got = {n: c.launches for n, c in counters.items()}
        emit({"phase": f"launches_{path}", "launches": got})
        if min(got[n] for n in needs) < 1:
            raise AssertionError(f"a kernel of the {path} path never "
                                 f"launched: {got}")
        for n, c in got.items():
            launches[n] += c
        torch.cuda.empty_cache()
        return rec, got

    drive("serving", ("flash_attention_fwd", "paged_attention"),
          lambda: end_to_end(torch, np, GPTConfig.base()))
    for S, needs in ((2048, ("flash_attention_fwd", "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv")),
                     (1024, ("flash_attention_fwd",
                             "flash_attention_bwd_single"))):
        rec, got = drive(f"train_S{S}", needs, lambda S=S: train_phase(
            torch, np, GPTConfig.base(), 8, S, 5))
        rec["launches_per_step"] = {n: c / rec["steps"]
                                    for n, c in got.items()}
        emit(rec)
    small = GPTConfig.base()
    small.num_layers = 2
    for S in (1024, 2048):
        grad_check(torch, np, small, 8, S)
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
