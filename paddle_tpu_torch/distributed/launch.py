"""Multi-process launcher, the collective half of
``paddle_tpu/distributed/launch.py`` (reference
python/paddle/distributed/launch.py:193): one trainer process per card.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=4 \\
        train.py [args]
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=4 \\
        --device=cpu train.py [args]      # gloo ranks on the CPU

Trainer i gets ``PADDLE_TRAINER_ID=i``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS`` (trainer 0's endpoint is the process
group's rendezvous: ``parallel.mesh.init_parallel_env`` dials it),
``PADDLE_CURRENT_ENDPOINT`` and ``FLAGS_selected_gpus=i`` (its card);
``--device=cpu`` sets ``PADDLE_DISTRI_BACKEND=gloo`` in place of NCCL.
The first trainer to exit non-zero tears the rest down (after
``--grace_s`` seconds in which the others may end on their own: a
tensor-parallel server's leader then reports the lost rank and exits by
itself), and the launch exits with that first non-zero code; every
rank's exit code is printed to stderr (``launch: exit codes [...]``).
The parameter-server half (``--server_num``, ``--worker_num``) raises
``NotImplementedError``: ROADMAP.md Queue 1 item 9.
"""
import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def _free_ports(n, ip="127.0.0.1"):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind((ip, 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="trainer processes on this node, one per card")
    p.add_argument("--node_ip", default="127.0.0.1")
    p.add_argument("--started_port", type=int, default=None)
    p.add_argument("--server_num", type=int, default=0,
                   help="parameter-server processes (not ported)")
    p.add_argument("--worker_num", type=int, default=0,
                   help="parameter-server trainers (not ported)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--grace_s", type=float, default=0.0,
                   help="after a trainer exits non-zero, the others get "
                        "this long to end on their own before they are "
                        "terminated (default 0: at once)")
    p.add_argument("--device", default=None, choices=(None, "gpu", "cpu"),
                   help="cpu: gloo ranks on the CPU (the tests' world); "
                        "default: NCCL, one card per rank")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _spawn(cmd, env, log_dir, tag):
    out = None
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, f"{tag}.log"), "wb")
    return subprocess.Popen(cmd, env=env, stdout=out, stderr=out)


def launch(args):
    """Start the trainers and wait; returns the launch's exit code."""
    if args.server_num or args.worker_num:
        raise NotImplementedError(
            "paddle_tpu_torch: the parameter-server launch (--server_num, "
            "--worker_num) is not ported (ROADMAP.md Queue 1 item 9)")
    n = args.nproc_per_node or 1
    ports = ([args.started_port + i for i in range(n)]
             if args.started_port else _free_ports(n, args.node_ip))
    eps = ",".join(f"{args.node_ip}:{p}" for p in ports)
    cmd = [sys.executable, "-u", args.training_script] + \
        args.training_script_args
    procs = []
    for i in range(n):
        env = dict(os.environ, TRAINING_ROLE="TRAINER",
                   PADDLE_TRAINER_ID=str(i), PADDLE_TRAINERS_NUM=str(n),
                   PADDLE_TRAINER_ENDPOINTS=eps,
                   PADDLE_CURRENT_ENDPOINT=f"{args.node_ip}:{ports[i]}",
                   FLAGS_selected_gpus=str(i),
                   PADDLE_DISTRI_BACKEND=("gloo" if args.device == "cpu"
                                          else "nccl"))
        procs.append(_spawn(cmd, env, args.log_dir, f"trainer.{i}"))

    def _terminate(signum=None, frame=None):
        for p in procs:
            if p.poll() is None:
                p.terminate()

    old = {s: signal.signal(s, _terminate)
           for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        # the first nonzero exit tears the rest down (after the grace): a
        # crashed rank must not leave the others blocked in a collective
        rc, live = 0, list(procs)
        while live and not rc:
            still = []
            for p in live:
                code = p.poll()
                if code is None:
                    still.append(p)
                elif code != 0:
                    rc = code
            live = still
            if live and not rc:
                time.sleep(0.1)
        if rc:
            deadline = time.monotonic() + max(args.grace_s, 0.0)
            while time.monotonic() < deadline and any(
                    p.poll() is None for p in procs):
                time.sleep(0.1)
            _terminate()
            deadline = time.monotonic() + 10.0
            for p in procs:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        codes = [p.wait() for p in procs]
        print(f"launch: exit codes {codes}", file=sys.stderr, flush=True)
        return rc
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def main(argv=None):
    return launch(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
