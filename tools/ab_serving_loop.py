"""Serving-loop A/B on one CUDA card: GPT-base generation served over the
wire by ``chip_smoke.observability_phase`` (paged fp32 pool, 8 decode
slots, 8 wire clients, 32 new tokens a request) from two or more
checkouts, one process a run, in the order given (e.g. parent, change,
change, parent), so the versions are compared within one machine and
one call.

    python3 tools/ab_serving_loop.py --tree build/parent --tree . \\
        --tree . --tree build/parent

Each run prints one JSON line: the tree, the card (``nvidia-smi``'s name
and power limit), the phase's wall seconds, whether its gates held, and
its telemetry cost passes (``telemetry_cost``: tokens/s, decode ms a
step by replay and the decode loop's step ms at trace rates 0 and 1,
medians and ranges over 16-request passes). The phase's own output goes
to ``chiprun_out/ab_serving_loop_<n>.log``. Each tree's kernels build in
that tree's ``build/`` directory. Imports no JAX."""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run_one(tree, cost_reps):
    """Child process: the observability phase of ``tree``'s chip_smoke
    over ``tree``'s package; prints the summary line last."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.cuda.set_device(0)
    import chip_smoke
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import GPTConfig
    import paddle_tpu_torch
    for mod in (chip_smoke, paddle_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise SystemExit(f"imported {mod.__file__}, not {tree}'s")
    chip_smoke.CARD["card"] = card_name()
    _build.build_all()
    fa = sys.modules["paddle_tpu_torch.kernels.flash_attention"]
    pa = sys.modules["paddle_tpu_torch.kernels.paged_attention"]
    t0 = time.perf_counter()
    rec = chip_smoke.observability_phase(torch, np, GPTConfig.base(), fa,
                                         pa, cost_reps=cost_reps)
    print(json.dumps({"tree": tree, "card": chip_smoke.CARD["card"],
                      "phase_s": time.perf_counter() - t0,
                      "ok": rec["ok"],
                      "telemetry_cost": rec["telemetry_cost"]}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout to run (repeat, in run order)")
    ap.add_argument("--cost-reps", type=int, default=16)
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(args.run, args.cost_reps)
        return
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    failed = []
    for i, tree in enumerate(args.tree):
        tree = os.path.abspath(tree)
        log = os.path.join(out_dir, f"ab_serving_loop_{i}.log")
        with open(log, "w") as f:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--tree", tree,
                 "--run", tree, "--cost-reps", str(args.cost_reps)],
                stdout=f, stderr=subprocess.STDOUT, cwd=tree)
        with open(log) as f:
            lines = f.read().splitlines()
        if p.returncode or not lines:
            failed.append(tree)
            print(json.dumps({"run": i, "tree": tree, "rc": p.returncode,
                              "tail": lines[-5:]}), flush=True)
            continue
        print(json.dumps({"run": i, **json.loads(lines[-1])}), flush=True)
    if failed:
        raise SystemExit(f"runs failed: {failed}")


if __name__ == "__main__":
    main()
