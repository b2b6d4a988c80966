"""Captured programs: one feed signature of a program, run many times.

The port's counterpart of the JAX serving engine's ahead-of-time
``jit(...).lower(...).compile()`` per feed signature
(``paddle_tpu/serving/engine.py``). On the GPU a :class:`CapturedProgram`
owns static feed buffers of one signature, runs the program once eagerly
on a side stream (which builds the kernels and cuBLAS/cuDNN workspaces
before capture), then captures a second pass into a
``torch.cuda.CUDAGraph``. The program's state is read from the scope's
device tensors, never copied. A replay copies the feeds into the static
buffers, replays the graph and copies the fetches out before the next
replay can overwrite them. On the CPU an entry is the program, run
eagerly.

Nothing falls back: a capture that fails (an op that syncs the host,
such as ``.item()``, ``.cpu()`` or a data-dependent shape) raises
:class:`GraphCaptureError` naming the op, and no eager path takes over.

Kernel launch counters: a replay makes no Python call, so the wrappers'
``launches`` counters (``kernels.COUNTED``) would not move. Each entry
records the wrapper calls its capture made, takes them back off the
counters (a capture launches nothing), and adds them again on every
replay, so ``launches`` keeps counting kernel launches.
"""
import threading

import numpy as np
import torch

from .dtype import torch_dtype
from .executor import _to_numpy
from .lowering import LowerCtx, analyze_block_io, last_uses, run_ops


class GraphCaptureError(RuntimeError):
    """A program could not be captured into a CUDA graph. Carries
    ``op_type`` and ``op_index`` (the op that was running, or None when
    the capture failed after the last op)."""

    def __init__(self, message, op_type=None, op_index=None):
        super().__init__(message)
        self.op_type = op_type
        self.op_index = op_index


def _counter_attrs(wrappers):
    return [(w, a) for w in wrappers
            for a in ("launches", "bf16_launches") if hasattr(w, a)]


class CapturedProgram:
    """``program`` (already through the pass pipeline) at the signature
    of ``feed`` (``{name: np.ndarray}``), fetching ``fetch_names``, over
    the tensors ``scope`` holds, on ``device``. CUDA graphs of one owner
    share ``pool`` (``torch.cuda.graph_pool_handle()``) and ``stream``,
    the side stream they are built and captured on: the caching
    allocator hands a block freed in one capture to the next only on
    the same stream. Their replays must not overlap (each copies its
    fetches out before another replay may reuse their memory).
    ``nbytes`` is the growth of the device's reserved memory during this
    capture (the feed bytes on the CPU). ``counters``: the kernel
    wrappers whose launch counts replays keep up to date."""

    def __init__(self, program, feed, fetch_names, scope, device,
                 pool=None, stream=None, counters=()):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA graph needs a CUDA device; run the "
                               "program on the CPU with device='cpu'")
        self.program = program
        self.block = program.global_block()
        self.feed_names = list(feed)
        self.fetch_names = list(fetch_names)
        self.signature = {n: (tuple(np.shape(a)), np.asarray(a).dtype)
                          for n, a in feed.items()}
        reads, _ = analyze_block_io(program, 0, self.feed_names)
        self._state = {}
        for n in reads:
            val = scope.find_var(n)
            if val is None:
                raise RuntimeError(f"var {n!r} is read by the program but "
                                   f"is not in the scope")
            if isinstance(val, torch.Tensor) \
                    and val.device.type != self.device.type:
                raise RuntimeError(f"scope var {n!r} lies on {val.device}, "
                                   f"the program runs on {self.device}")
            self._state[n] = val
        self._free = last_uses(self.block, set(self.fetch_names))
        self._seed = int(program.random_seed or 0)
        self._lock = threading.Lock()
        self._counters = _counter_attrs(counters)
        self.replay_launches = {}
        self.graph = None
        if self.device.type == "cuda":
            self._capture(feed, pool, stream)
        else:
            self.nbytes = int(sum(np.asarray(a).nbytes
                                  for a in feed.values()))

    # -- running --------------------------------------------------------
    def _host_feed(self, feed):
        """Feed arrays as CPU tensors in the vars' dtypes; raises on a
        name or shape outside this entry's signature."""
        if set(feed) != set(self.signature):
            raise ValueError(f"feed names {sorted(feed)} are not this "
                             f"entry's {sorted(self.signature)}")
        out = {}
        for n, a in feed.items():
            a = np.ascontiguousarray(a)
            if tuple(a.shape) != self.signature[n][0]:
                raise ValueError(f"feed {n!r} has shape {a.shape}, this "
                                 f"entry takes {self.signature[n][0]}")
            var = self.block.vars.get(n)
            t = torch.from_numpy(a)
            out[n] = t if var is None else t.to(torch_dtype(var.dtype))
        return out

    def _feed_tensors(self, feed):
        return {n: t.to(self.device)
                for n, t in self._host_feed(feed).items()}

    def _run_ops(self, feed_tensors, trace=None):
        env = dict(self._state)
        env.update(feed_tensors)
        ctx = LowerCtx(self.program, self.block, env, self.device,
                       run_seed=self._seed)
        if trace is not None:
            trace["ctx"] = ctx
        with torch.no_grad():
            run_ops(ctx, free_after=self._free)
        if trace is not None:
            trace["done"] = True
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were never computed")
        return [env[n] for n in self.fetch_names]

    def eager(self, feed):
        """The program run eagerly on ``feed`` (no graph): numpy
        fetches. The yardstick a replay is held to."""
        with self._lock:
            return [_to_numpy(o)
                    for o in self._run_ops(self._feed_tensors(feed))]

    def run(self, feed):
        """Numpy fetches for ``feed``: a graph replay on the GPU, an
        eager run on the CPU."""
        if self.graph is None:
            return self.eager(feed)
        with self._lock:
            for n, t in self._host_feed(feed).items():
                self._bufs[n].copy_(t)
            self.graph.replay()
            for (w, attr), n in self.replay_launches.items():
                setattr(w, attr, getattr(w, attr) + n)
            return [_to_numpy(o) for o in self._outs]

    # -- capture --------------------------------------------------------
    def _capture(self, feed, pool, stream):
        self._bufs = self._feed_tensors(feed)
        side = stream or torch.cuda.Stream(device=self.device)
        prev = torch.cuda.current_stream(self.device)
        side.wait_stream(prev)
        with torch.cuda.stream(side):
            self._run_ops(self._bufs)       # builds what capture needs
        torch.cuda.synchronize(self.device)
        before = {k: getattr(*k) for k in self._counters}
        graph = torch.cuda.CUDAGraph()
        trace = {}
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                # read inside: entering the capture empties the cache
                reserved = torch.cuda.memory_reserved(self.device)
                outs = self._run_ops(self._bufs, trace)
        except Exception as e:  # noqa: BLE001 — re-raised, typed
            for (w, attr), v in before.items():
                setattr(w, attr, v)
            # a capture_end that raises leaves the side stream current
            torch.cuda.set_stream(prev)
            ctx = trace.get("ctx")
            op = None if trace.get("done") or ctx is None else ctx.op
            idx = None if op is None else self.block.ops.index(op)
            where = (f"op #{idx} {op.type!r}" if op is not None
                     else "the end of capture, after the last op")
            raise GraphCaptureError(
                f"CUDA graph capture failed at {where}: "
                f"{type(e).__name__}: {e}. An op that syncs the host "
                f"(.item(), .cpu(), nonzero, a data-dependent shape) "
                f"cannot be captured; nothing runs it eagerly instead",
                op_type=None if op is None else op.type,
                op_index=idx) from e
        self.replay_launches = {k: getattr(*k) - v
                                for k, v in before.items()
                                if getattr(*k) != v}
        for (w, attr), v in before.items():
            setattr(w, attr, v)
        self.nbytes = max(torch.cuda.memory_reserved(self.device)
                          - reserved, 0)
        self.graph = graph
        self._outs = outs
