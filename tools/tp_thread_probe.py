"""Where an eager tensor-parallel call spends its time when a serving
thread issues it: one rank a card, GPT-base (seeded weights) at tp =
every rank, each rank timing the same work issued from its main thread
and from a thread of its own (the way ``serving.tp``'s loops issue it),
all ranks in step (a gloo barrier before each measurement).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=4 \\
        tools/tp_thread_probe.py [--reps 5]

Measured, each the median of ``--reps`` after a warm-up call: an eager
prefill of one 1024-token prompt (``GPTGenerator.run_prefill``, K1 and
the model's 25 all-reduces and one all-gather), 25 eager all-reduces of
the prefill's activation (1 x 1024 x 768 float32) alone, and one
all-reduce of it; host ms with a device synchronize at the end. Each
rank prints one JSON line with the card (``nvidia-smi``'s name and power
limit). Imports no JAX."""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.models import GPTConfig, GPTGenerator, init_params
    from paddle_tpu_torch.ops.collective_ops import all_reduce
    from paddle_tpu_torch.parallel import mesh
    n = mesh.init_parallel_env()
    if not torch.cuda.is_available():
        print("tp_thread_probe.py measures on CUDA cards", file=sys.stderr)
        return 2
    rank = mesh.rank()
    coord = dist.new_group(backend="gloo")
    cfg = GPTConfig.base()
    gen = GPTGenerator(cfg, init_params(cfg, 0), max_len=2048, tp=n)
    dev = gen.model.param("word_embedding").device
    prompt = np.random.default_rng(1).integers(
        1, cfg.vocab_size, 1024).astype(np.int32)
    tokens, pos_ids, last = gen._pack_prompts([prompt])
    x = torch.randn(1, 1024, cfg.hidden_size, device=dev)

    def prefill():
        gen.run_prefill(tokens, pos_ids, last)

    def reduces(k):
        def fn():
            for _ in range(k):
                all_reduce(x, "sum", "tp", mesh=gen.mesh)
        return fn

    def timed(fn):
        dist.barrier(group=coord)
        fn()
        torch.cuda.synchronize(dev)
        out = []
        for _ in range(args.reps):
            dist.barrier(group=coord)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    def on_thread(fn):
        box = {}

        def run():
            torch.cuda.set_device(dev)
            box["ms"] = timed(fn)
        t = threading.Thread(target=run)
        t.start()
        t.join()
        return box["ms"]

    rec = {"rank": rank, "tp": n, "card": card_name(), "reps": args.reps}
    for name, fn in (("prefill_1x1024", prefill),
                     ("allreduce_x25", reduces(25)),
                     ("allreduce_x1", reduces(1))):
        rec[f"{name}_main_ms"] = timed(fn)
        rec[f"{name}_thread_ms"] = on_thread(fn)
    print(json.dumps(rec), flush=True)
    mesh.barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
