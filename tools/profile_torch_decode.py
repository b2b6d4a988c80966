#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/profile_torch_decode.py [--steps 16]

Builds GPT-base (seeded random weights), prefills 8 prompts of 64..1024
tokens, then runs ``--steps`` decode steps over the dense bank and over
the fp32 paged pool under ``torch.profiler``. Prints one JSON line per
mode: wall ms per step (host clock, synchronized), device kernel time per
step (the time in the trace during which some CUDA kernel runs: kernels
that overlap, as a programmatic dependent launch overlaps the kernel
before it while it waits for it, count once), the device's idle
share, kernel launches per step, the kernels that take the most
device time, and the paged decode attention kernel's (K5: every kernel
named ``paged_*_kernel``) device microseconds and launches per step and
its share of the device time. Exits non-zero without a CUDA device.
"""
import argparse
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K5 = re.compile(r"paged_\w*_kernel")


def _kernel_times(prof, torch):
    """{kernel name: (total device us, count)} over the trace, and each
    kernel's (start, end, name) in us."""
    out, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        if us is None:
            us = e.cuda_time
        tot, n = out.get(e.name, (0.0, 0))
        out[e.name] = (tot + float(us), n + 1)
        spans.append((e.time_range.start, e.time_range.end, e.name))
    return out, spans


def _covered_us(spans):
    """Microseconds during which at least one of ``spans`` runs."""
    total, end = 0.0, float("-inf")
    for start, stop, _ in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    from paddle_tpu_torch.serving import KVBlockPool
    cfg = GPTConfig.base()
    gen = GPTGenerator(cfg, init_params(cfg, seed=0), max_len=2048)
    rng = np.random.default_rng(0)
    lens = np.linspace(64, 1024, 8).round().astype(int)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    tokens, pos_ids, last = gen._pack_prompts(prompts)
    bb, s = tokens.shape
    _, ks, vs = gen.run_prefill(tokens, pos_ids, last)
    cache_k, cache_v = gen.new_dense_caches(bb)
    for c, x in zip(cache_k + cache_v, ks + vs):
        c[:, :, :s] = x
    pool = KVBlockPool(slots=bb, num_layers=cfg.num_layers,
                       num_heads=cfg.num_heads, d_head=cfg.d_head,
                       max_seq_len=gen.max_len, dtype="fp32",
                       device=gen.device)
    for r, n in enumerate(lens):
        pool.alloc(r, int(n) + args.steps + 4)
    pool.scatter_prefill(list(range(bb)), ks, vs, s)
    del ks, vs
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}",
          flush=True)

    steps = {
        "dense": lambda tok, pos: gen.run_decode(tok, pos, cache_k,
                                                 cache_v),
        "paged": lambda tok, pos: gen.run_decode_paged(tok, pos, pool),
    }
    for mode, step in steps.items():
        pos = lens.astype(np.int32).copy()
        tok = rng.integers(1, cfg.vocab_size, bb).astype(np.int32)

        def run(n):
            for _ in range(n):
                logits = step(tok, pos)
                tok[:] = torch.argmax(logits, -1).cpu().numpy()
                pos[:] += 1

        run(2)                                       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(args.steps)
            torch.cuda.synchronize()
        kt, spans = _kernel_times(prof, torch)
        busy_ms = _covered_us(spans) / 1e3 / args.steps
        launches = sum(n for _, n in kt.values()) / args.steps
        top = sorted(kt.items(), key=lambda kv: -kv[1][0])[:8]
        k5 = [sp for sp in spans if K5.search(sp[2])]
        k5_us = _covered_us(k5) / args.steps
        print(json.dumps({
            "mode": mode, "steps": args.steps, "rows": bb,
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": busy_ms if kt else None,
            "device_idle_share": 1 - busy_ms / wall_ms if kt else None,
            "kernel_launches_per_step": launches,
            "k5_us_per_step": k5_us,
            "k5_launches_per_step": len(k5) / args.steps,
            "k5_share_of_device": k5_us / 1e3 / busy_ms if kt else None,
            "top_kernels": [{"name": n[:80], "ms_per_step":
                             t / 1e3 / args.steps, "calls_per_step":
                             c / args.steps} for n, (t, c) in top],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
