"""Captured programs: one feed signature of a program, run many times.

Three kinds: :class:`CapturedProgram` (serving: a program that reads its
state and never writes it), :class:`CapturedStep` (training: a step
that writes its state back in place, behind ``Executor.run_steps``) and
:class:`CapturedDecode` (generation: a GPT decode step and its sample
over a KV bank or block pool).

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
import time
import weakref

import numpy as np
import torch

from .dtype import torch_dtype
from .executor import _to_numpy
from .lowering import (LowerCtx, analyze_block_io, first_offender,
                       generator_seed, last_uses, nonfinite_counts, run_ops,
                       splitmix64)


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
        graph = torch.cuda.CUDAGraph()
        self._outs, self.replay_launches, self.nbytes = capture_graph(
            graph, self.block, lambda trace: self._run_ops(self._bufs, trace),
            pool, side, self._counters, self.device)
        self.graph = graph


def capture_graph(graph, block, fn, pool, side, counters, device):
    """Capture ``fn(trace)`` into ``graph`` on the stream ``side``;
    returns (what ``fn`` returned, the wrapper calls the capture made
    as ``{(wrapper, attr): n}``, the growth of reserved memory). The
    counters are set back (a capture launches nothing). ``fn`` puts its
    ``LowerCtx`` in ``trace["ctx"]`` (or, for a dygraph step with
    ``block`` None, the last op begun in ``trace["op_type"]`` and
    ``["op_index"]``, and ``["op_finished"]`` once it returned) and sets
    ``trace["done"]`` after the last op, so a failure names the op that
    was running: it raises :class:`GraphCaptureError`, and nothing runs
    the program eagerly instead. ``pool`` None gives the graph a private
    pool of its own."""
    before = {k: getattr(*k) for k in counters}
    prev = torch.cuda.current_stream(device)
    if pool is None:
        pool = torch.cuda.graph_pool_handle()
    trace = {}
    try:
        with torch.cuda.graph(graph, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            # read inside: entering the capture empties the cache
            reserved = torch.cuda.memory_reserved(device)
            outs = fn(trace)
    except Exception as e:  # noqa: BLE001 — re-raised, typed
        for (w, attr), v in before.items():
            setattr(w, attr, v)
        # a capture_end that raises leaves the side stream current
        torch.cuda.set_stream(prev)
        _end_failed_capture(device, pool)
        if isinstance(e, GraphCaptureError):
            raise
        op_type, idx = _running_op(block, trace)
        after = "host code after " if trace.get("op_finished") else ""
        where = (f"{after}op #{idx} {op_type!r}" if op_type is not None
                 else "the end of capture, after the last op")
        raise GraphCaptureError(
            f"CUDA graph capture failed at {where}: "
            f"{type(e).__name__}: {e}. An op that syncs the host "
            f"(.item(), .cpu(), nonzero, a data-dependent shape) "
            f"cannot be captured; nothing runs it eagerly instead",
            op_type=op_type, op_index=idx) from e
    launches = {k: getattr(*k) - v for k, v in before.items()
                if getattr(*k) != v}
    for (w, attr), v in before.items():
        setattr(w, attr, v)
    nbytes = max(torch.cuda.memory_reserved(device) - reserved, 0)
    return outs, launches, nbytes


def _end_failed_capture(device, pool):
    """After a capture that CUDA invalidated (a host sync inside it),
    ``capture_end`` raises before it ends the caching allocator's
    routing of the capture stream's allocations into ``pool``. Left so,
    the allocator counts a capture as underway for good: that stream's
    later allocations go to the dead pool and ``empty_cache`` frees
    nothing more. End the routing and release the pool; after a capture
    that ended cleanly there is nothing to end (the allocator raises)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(idx, pool)
    except RuntimeError:
        return
    torch._C._cuda_releasePool(idx, pool)


def _running_op(block, trace):
    """(type, index) of the op a failed capture was running, or (None,
    None) after the last op: from ``trace["ctx"].op`` of a program, or
    from ``trace["op_type"]``/``["op_index"]`` that a dygraph step's
    tracer writes (``block`` None)."""
    if trace.get("done"):
        return None, None
    if "op_type" in trace:
        return trace["op_type"], trace.get("op_index")
    ctx = trace.get("ctx")
    op = None if ctx is None else ctx.op
    if op is None:
        return None, None
    return op.type, block.ops.index(op)


class CapturedStep:
    """One training step (an executor ``Step``: the optimized program and
    its io analysis) at the row signature of ``slab`` (``{name: tensor
    [K, ...]}`` on ``device``), run once per slab row.

    The entry owns one static tensor for each persistable the step reads
    or writes (a write-only one the scope lacks starts as zeros) and one
    static buffer per feed. A step copies its feed row into the buffers,
    runs the program over the static state and ends with
    ``static.copy_(new)`` for each written var, so the next step reads
    the new state where the last one left it; after a slab the scope is
    pointed at the static tensors. A scope tensor that is not the
    entry's (an eager ``Executor.run``, ``scope_from_arrays`` or an
    ``io`` load put it there) is copied into the static tensor before a
    slab, so no replay reads stale state. With ``guard`` the step also
    counts the nan/inf elements of its fetches and new state (fetches
    first, then the written vars in program order) into two device
    scalars (the count and the first offending slot); with ``skip`` the
    copy-back keeps the old state where the count is nonzero
    (``static.copy_(where(viol > 0, static, new))``): the rollback is on
    the device and no host backup exists.

    On the GPU the step is captured into a ``torch.cuda.CUDAGraph``
    (after one eager warm-up pass on ``stream`` that writes no state)
    and each row is a replay. Each stochastic call site of the step (a
    dropout, and the grad op that draws its mask again) gets a CUDA
    generator of its own, registered with the graph
    (``CUDAGraph.register_generator_state``) and seeded before every
    replay to what ``LowerCtx.generator`` would seed it with for that
    step's run seed, so a replay draws what an eager run of the step
    draws. On the CPU each row runs the same step eagerly.
    ``warmup_launches``: the kernel launches of the warm-up pass
    (counted; replays add ``replay_launches`` each).

    A data-parallel step (``Step.data_parallel``) captures its NCCL
    all-reduces with the rest: the warm-up pass issues the same
    collectives on every rank (so each communicator exists before
    capture), the guard's counts are all-reduced (max) inside the graph
    before the rollback, and the rank is folded into the call sites'
    seeds (``Step.rng_seed``). A capture that fails raises on this rank
    and ends its process; the launcher then ends the others."""

    def __init__(self, step, slab, scope, device, guard=False, skip=False,
                 pool=None, stream=None, counters=()):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA graph needs a CUDA device; run the "
                               "program on the CPU with device='cpu'")
        self.step = step
        self.block = step.program.global_block()
        self.guard, self.skip = bool(guard or skip), bool(skip)
        self._lock = threading.Lock()
        self._counters = _counter_attrs(counters)
        self._owner = None
        self._seed = 0
        self._static = {}
        for n in step.state_names:
            val = scope.find_var(n)
            if val is None:
                if n in step.reads:
                    raise RuntimeError(
                        f"var {n!r} is read by the program but is not "
                        f"initialized in the scope: run the startup "
                        f"program first, or feed it")
                continue        # a fetch of scope state the scope lacks
            if not isinstance(val, torch.Tensor) \
                    or val.device.type != self.device.type:
                raise RuntimeError(f"scope var {n!r} is not a tensor on "
                                   f"{self.device}")
            self._static[n] = val.detach().clone()
        self._bufs = {n: torch.empty_like(t[0]) for n, t in slab.items()}
        for n, t in slab.items():
            self._bufs[n].copy_(t[0])
        self.signature = {n: (tuple(t.shape), t.dtype)
                          for n, t in self._bufs.items()}
        self._viol = torch.zeros((), dtype=torch.int32, device=self.device)
        self._slot = torch.zeros((), dtype=torch.int32, device=self.device)
        self.replay_launches, self.warmup_launches = {}, {}
        self.graph = None
        self.nbytes = 0
        self._sites = []
        if self.device.type == "cuda":
            self._capture(pool, stream)
        else:
            self._init_write_only(self._body(copy_back=False, keep=True))

    # -- the step -------------------------------------------------------
    def _init_write_only(self, new):
        """Static tensors for the written vars the scope did not give
        (zeros; the values ``new`` of a pass with no copy-back give their
        shapes and types), and the set of write-only vars."""
        self._write_only = [n for n in new if n not in self.step.reads]
        for n, v in new.items():
            if n not in self._static:
                self._static[n] = torch.zeros_like(v)
            elif self._static[n].shape != v.shape:
                raise RuntimeError(
                    f"var {n!r}: the step writes shape {tuple(v.shape)} "
                    f"over the scope's {tuple(self._static[n].shape)}")
        self._static_ptrs = {t.untyped_storage().data_ptr()
                             for t in self._static.values()}

    def _body(self, copy_back=True, keep=False, trace=None, hook=None):
        """One step over the static state and feed buffers: the fetches,
        the guard's scalars, the copy-back. ``keep``: return the new
        state instead (the warm-up pass)."""
        step = self.step
        env = {n: t for n, t in self._static.items() if n in step.reads
               or n in step.fetch_state}
        env.update(self._bufs)
        ctx = LowerCtx(step.program, self.block, env, self.device,
                       run_seed=self._seed)
        ctx.generator_hook = hook
        if trace is not None:
            trace["ctx"] = ctx
        with torch.no_grad():
            run_ops(ctx, free_after=step.free)
            if trace is not None:
                trace["done"] = True
            missing = [n for n in step.fetch_names if n not in env]
            if missing:
                raise KeyError(f"fetch targets {missing} were never "
                               f"computed")
            new = {n: env[n] for n in step.writes if n in env}
            if keep:
                return new
            outs = [self._own(env[n]) for n in step.fetch_names]
            if self.guard:
                viol, slot = first_offender(step.agree(nonfinite_counts(
                    outs + list(new.values()), self.device)))
                self._viol.copy_(viol)
                self._slot.copy_(slot)
            if copy_back:
                new = {n: self._own(v, n) for n, v in new.items()}
                for n, v in new.items():
                    st = self._static[n]
                    st.copy_(torch.where(viol > 0, st, v) if self.skip
                             else v)
        return outs

    def _own(self, t, name=None):
        """``t``, or a copy of it where it shares storage with a static
        tensor other than ``name``'s own (a copy-back or a later replay
        would overwrite it)."""
        if t.untyped_storage().data_ptr() in self._static_ptrs and \
                (name is None or t is not self._static.get(name)):
            return t.clone()
        return t

    # -- running --------------------------------------------------------
    def _bind_scope(self, scope):
        """Point the entry's static tensors at ``scope``'s values: copy in
        every scope tensor that is not the entry's (a scope that used
        the entry before keeps copies of what it held). Returns the
        write-only vars the scope lacks (their static tensors zeroed)."""
        owner = self._owner() if self._owner is not None else None
        if owner is not None and owner is not scope:
            for n, st in self._static.items():
                if owner.find_var(n) is st:
                    owner.set(n, st.clone())
        self._owner = weakref.ref(scope)
        absent = set()
        for n, st in self._static.items():
            val = scope.find_var(n)
            if val is st:
                continue
            if val is None:
                if n not in self._write_only:
                    raise RuntimeError(
                        f"var {n!r} is read by the program but is not "
                        f"initialized in the scope: run the startup "
                        f"program first, or feed it")
                st.zero_()
                absent.add(n)
                continue
            if tuple(val.shape) != tuple(st.shape):
                raise ValueError(f"scope var {n!r} has shape "
                                 f"{tuple(val.shape)}, the captured step "
                                 f"holds {tuple(st.shape)}")
            st.copy_(val)
        return absent

    def run_slab(self, slab, scope, run_seed):
        """Run one step per row of ``slab`` (``{name: tensor [K, ...]}``
        on the device) over ``scope``'s state, the run seed advancing by
        ``splitmix64`` once per step (rolled back or not). Returns
        (fetch slabs ``[K, ...]`` on the device, per-step violation
        counts and first slots as numpy int32 arrays or None without the
        guard, the next run seed). One host read per slab: the counts."""
        k_steps = int(next(iter(slab.values())).shape[0])
        for n, t in slab.items():
            if (tuple(t.shape[1:]), t.dtype) != self.signature.get(n):
                raise ValueError(f"feed {n!r} rows are {tuple(t.shape[1:])}"
                                 f" {t.dtype}, this entry takes "
                                 f"{self.signature.get(n)}")
        with self._lock:
            absent = self._bind_scope(scope)
            fetch_slabs = viols = slots = None
            seed = int(run_seed)
            for k in range(k_steps):
                for n, b in self._bufs.items():
                    b.copy_(slab[n][k])
                self._seed = self.step.rng_seed(seed)
                if self.graph is not None:
                    for gen, attrs in self._sites:
                        gen.manual_seed(generator_seed(self._seed, attrs))
                    self.graph.replay()
                    for (w, attr), n in self.replay_launches.items():
                        setattr(w, attr, getattr(w, attr) + n)
                    outs = self._outs
                else:
                    outs = self._body()
                if fetch_slabs is None:
                    fetch_slabs = [torch.empty((k_steps,) + tuple(o.shape),
                                               dtype=o.dtype,
                                               device=o.device)
                                   for o in outs]
                    if self.guard:
                        viols = torch.empty(k_steps, dtype=torch.int32,
                                            device=self.device)
                        slots = torch.empty_like(viols)
                for fs, o in zip(fetch_slabs, outs):
                    fs[k].copy_(o)
                if self.guard:
                    viols[k].copy_(self._viol)
                    slots[k].copy_(self._slot)
                seed = splitmix64(seed)
            if self.guard:
                viols, slots = viols.cpu().numpy(), slots.cpu().numpy()
            # a write-only var the scope lacked stays out of it when every
            # step rolled back, as K skipped runs would leave it
            all_rolled = self.skip and bool((viols > 0).all())
            for n, st in self._static.items():
                if not (all_rolled and n in absent):
                    scope.set(n, st)
        return fetch_slabs or [], viols, slots, seed

    # -- capture --------------------------------------------------------
    def _capture(self, pool, stream):
        side = stream or torch.cuda.Stream(device=self.device)
        prev = torch.cuda.current_stream(self.device)
        side.wait_stream(prev)
        sites = []

        def record(ctx, attrs):
            sites.append((ctx.op.type, dict(attrs)))
            gen = torch.Generator(device=ctx.device)
            gen.manual_seed(generator_seed(ctx.run_seed, attrs))
            return gen

        before = {k: getattr(*k) for k in self._counters}
        with torch.cuda.stream(side):       # builds what capture needs
            self._init_write_only(self._body(copy_back=False, keep=True,
                                             hook=record))
        torch.cuda.synchronize(self.device)
        self.warmup_launches = {k: getattr(*k) - v
                                for k, v in before.items()
                                if getattr(*k) != v}
        graph = torch.cuda.CUDAGraph()
        gens = []
        if sites:
            if not hasattr(graph, "register_generator_state"):
                raise GraphCaptureError(
                    f"this PyTorch ({torch.__version__}) has no "
                    f"CUDAGraph.register_generator_state: the stochastic "
                    f"op {sites[0][0]!r} cannot draw a new stream on each "
                    f"replay, so the step cannot be captured",
                    op_type=sites[0][0])
            for _ in sites:
                gen = torch.Generator(device=self.device)
                graph.register_generator_state(gen)
                gens.append(gen)
        taken = []

        def hand_out(ctx, attrs):
            i = len(taken)
            if i >= len(sites) or sites[i] != (ctx.op.type, dict(attrs)):
                raise GraphCaptureError(
                    f"stochastic call #{i} of op {ctx.op.type!r} was not "
                    f"made by the warm-up pass: the step's random draws "
                    f"are not the same from run to run",
                    op_type=ctx.op.type)
            taken.append(i)
            return gens[i]

        self._outs, self.replay_launches, self.nbytes = capture_graph(
            graph, self.block,
            lambda trace: self._body(trace=trace, hook=hand_out),
            pool, side, self._counters, self.device)
        self._sites = [(g, attrs) for g, (_, attrs) in zip(gens, sites)]
        self.graph = graph


class CapturedDecode:
    """One GPT decode step plus its sample, captured as a CUDA graph once
    per signature and replayed for every token: the port's counterpart of
    the JAX generator's compiled decode executable
    (``GPTGenerator._ensure_fn`` and ``_invoke``,
    ``paddle_tpu/models/generation.py:430,518``), whose executables live
    in its cache as these graphs live in an LRU (``utils.lru``).

    ``model`` is a ``models.gpt.GPT``. A KV storage ``kv`` is a dense bank
    ``(cache_k, cache_v)`` (lists of ``[rows, H, L, D]`` tensors) or a
    ``serving.kvpool.KVBlockPool``. A signature is (rows, dense or paged,
    kv dtype, block size, blocks per row, greedy-only or mixed sampling)
    plus the storage's tensors: a graph holds their addresses, so an entry
    keeps weak references to them and one whose storage was released
    (``KVBlockPool.drop_device``/``reset``, a dropped bank) is captured
    anew, never replayed over freed memory.

    Before each replay the host writes the step's token, position,
    temperature, top-k and (paged) block tables into pinned host buffers,
    and the capture stream copies them into the graph's static device
    buffers; after it the ``[rows]`` int32 tokens are the only read back
    (:attr:`logits` keeps the step's logits on the device until the next
    step). A greedy-only signature replays an argmax-only graph and draws
    nothing; a mixed one draws from :attr:`generator` (registered with
    the graph, so a replay draws what :meth:`eager` draws from the same
    generator state). Replays keep the kernel wrappers' ``launches``
    counters (``counters``) up to date, as :class:`CapturedStep` does.

    The capture runs the step once eagerly first (with the block tables
    pointing at the trash block, or the dense bank's written slots saved
    and put back), so a capture that fails leaves the storage as it was
    and raises :class:`GraphCaptureError`; nothing decodes eagerly
    instead. :meth:`eager` runs the same body without a graph: the twin a
    replay is held to, not a fallback. On the CPU every step is that
    body, run over the static tensors."""

    # signatures kept (a bank decodes through one or two: greedy, mixed)
    MAX_GRAPHS = 16

    def __init__(self, model, device, *, seed=0, counters=()):
        self.model = model
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA graph needs a CUDA device; decode "
                               "on the CPU with device='cpu'")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        from ..utils.lru import LRUCache
        self.cache = LRUCache(max_entries=self.MAX_GRAPHS)
        self._counters = _counter_attrs(counters)
        self._lock = threading.Lock()
        self._pool = self._stream = None
        self.logits = None
        # bodies run on the device per storage kind (capture warm-ups,
        # replays and eager twins): each paged one launches K5 per layer
        self.steps = {"dense": 0, "paged": 0}
        self.captures = 0
        self.capture_s = 0.0
        self.graph_bytes = 0

    # -- signatures -----------------------------------------------------
    @staticmethod
    def _describe(kv):
        """(kind, kv dtype, block size, blocks per row, tensors) of a
        storage."""
        if hasattr(kv, "tensors"):
            return ("paged", kv.dtype, kv.block_size, kv.blocks_per_row,
                    kv.tensors())
        cache_k, cache_v = kv
        return ("dense", "fp32", 0, 0, list(cache_k) + list(cache_v))

    def signature(self, rows, kv, greedy):
        kind, dtype, bs, nblk, tensors = self._describe(kv)
        return (int(rows), kind, dtype, bs, nblk, bool(greedy),
                tuple(t.data_ptr() for t in tensors))

    def _entry(self, key, kv, greedy, rows):
        """The live entry of ``key``, or a new one (captured on the GPU);
        entries whose storage is gone are dropped."""
        e = self.cache.get(key)
        if e is not None and e.alive():
            return e, False
        for k, old in self.cache.items():
            if not old.alive():
                self.cache.pop(k)
        e = _DecodeEntry(self, kv, greedy, rows)
        return e, True

    # -- the step -------------------------------------------------------
    def _body(self, e, kv, generator, tables=None):
        """The decode step and the sample over ``e``'s static inputs:
        ``(logits [rows, V], tokens [rows] int32)``."""
        from ..ops.decode_ops import sample_tokens
        if e.kind == "paged":
            logits = self.model.decode_step_paged(
                e.buf["token"], e.buf["pos"],
                e.buf["tables"] if tables is None else tables, kv.layers())
        else:
            logits = self.model.decode_step(e.buf["token"], e.buf["pos"],
                                            kv[0], kv[1])
        toks = sample_tokens(logits, e.buf["temperature"], e.buf["top_k"],
                             generator=generator, greedy=e.greedy)
        return logits, toks

    def _inputs(self, token, pos, temperature, top_k, kv, live):
        rows = int(np.shape(token)[0])
        arrays = {"token": np.asarray(token), "pos": np.asarray(pos),
                  "temperature": np.asarray(temperature, np.float32),
                  "top_k": np.asarray(top_k)}
        if hasattr(kv, "tables"):
            if kv.tables.shape[0] != rows:
                raise ValueError(f"the pool has {kv.tables.shape[0]} "
                                 f"slots, the step feeds {rows} rows")
            arrays["tables"] = kv.tables
            if live is not None:
                # rows outside ``live`` write (and read) the trash block:
                # a slot mid chunked prefill owns blocks its stale
                # position would overwrite
                arrays["tables"] = np.where(
                    np.asarray(live, bool)[:, None], kv.tables, 0)
        from ..ops.decode_ops import all_greedy
        return rows, arrays, all_greedy(arrays["temperature"])

    def run(self, token, pos, temperature, top_k, kv, live=None):
        """One step over ``kv``: np.int32 tokens ``[rows]``. A graph
        replay on the GPU (captured on the signature's first step), the
        body on the CPU. ``live`` (bool ``[rows]``, None: every row)
        picks the pool rows whose blocks the step writes; the others
        write the trash block."""
        rows, arrays, greedy = self._inputs(token, pos, temperature, top_k,
                                            kv, live)
        key = self.signature(rows, kv, greedy)
        with self._lock:
            e, new = self._entry(key, kv, greedy, rows)
            if self.device.type != "cuda":
                if new:
                    self.cache.put(key, e)
                e.load(arrays)
                self.logits, toks = self._body(e, kv, self.generator)
                self.steps[e.kind] += 1
                return toks.numpy()
            if new:
                self._capture(e, kv, arrays)
                self.cache.put(key, e, nbytes=e.nbytes)
            return self._replay(e, arrays)

    def eager(self, token, pos, temperature, top_k, kv, live=None):
        """The same step without a graph, over the same static inputs and
        :attr:`generator`: the A/B twin of a replay. np.int32 tokens."""
        rows, arrays, greedy = self._inputs(token, pos, temperature, top_k,
                                            kv, live)
        with self._lock:
            e, _ = self._entry(self.signature(rows, kv, greedy), kv, greedy,
                               rows)
            e.load(arrays)
            self.logits, toks = self._body(e, kv, self.generator)
            self.steps[e.kind] += 1
            return toks.cpu().numpy()

    # -- graphs ---------------------------------------------------------
    def _capture(self, e, kv, arrays):
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        if not any(x.graph is not None for _, x in self.cache.items()):
            # the allocator retires a graph pool once its last graph is
            # gone (storage dropped, clear()) and refuses to capture into
            # it again: the first graph of an empty cache takes a new one
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        e.load(arrays)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            # warm-up (builds what the capture needs) that leaves the
            # storage as it was: paged writes go to the trash block, the
            # dense bank's written slots are put back
            scratch = torch.Generator(device=self.device)
            if e.kind == "paged":
                self._body(e, kv, scratch,
                           tables=torch.zeros_like(e.buf["tables"]))
            else:
                saved = _dense_slots(kv, e.buf["pos"])
                self._body(e, kv, scratch)
                _restore_dense_slots(kv, e.buf["pos"], saved)
        torch.cuda.synchronize(self.device)
        self.steps[e.kind] += 1
        graph = torch.cuda.CUDAGraph()
        if not e.greedy:
            if not hasattr(graph, "register_generator_state"):
                raise GraphCaptureError(
                    f"this PyTorch ({torch.__version__}) has no "
                    f"CUDAGraph.register_generator_state: a sampling "
                    f"decode step cannot draw anew on each replay",
                    op_type="sample_tokens")
            graph.register_generator_state(self.generator)

        def fn(trace):
            trace["op_type"], trace["op_index"] = "decode_step", 0
            logits, toks = self._body(e, kv, self.generator)
            trace["done"] = True
            return logits, toks

        (e.logits, e.tokens), e.replay_launches, e.nbytes = capture_graph(
            graph, None, fn, self._pool, side, self._counters, self.device)
        e.graph = graph
        e.tok_host = torch.empty(e.rows, dtype=torch.int32, pin_memory=True)
        self.captures += 1
        self.graph_bytes += e.nbytes
        self.capture_s += time.perf_counter() - t0

    def _replay(self, e, arrays):
        side = self._stream
        for n, a in arrays.items():
            e.host[n][...] = a
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for n, b in e.buf.items():
                b.copy_(e.pinned[n], non_blocking=True)
            e.graph.replay()
            e.tok_host.copy_(e.tokens, non_blocking=True)
        side.synchronize()
        for (w, attr), n in e.replay_launches.items():
            setattr(w, attr, getattr(w, attr) + n)
        self.steps[e.kind] += 1
        self.logits = e.logits
        return e.tok_host.numpy().copy()

    def clear(self):
        """Drop every graph (their memory returns with the last one)."""
        with self._lock:
            self.cache.clear()
            self.logits = None


def _dense_slots(kv, pos):
    """The dense bank's vectors at each row's ``pos`` (what a decode step
    overwrites), per layer."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    col = pos.long().clamp(0, kv[0][0].shape[2] - 1)
    return [c[rows, :, col].clone() for c in list(kv[0]) + list(kv[1])]


def _restore_dense_slots(kv, pos, saved):
    rows = torch.arange(pos.shape[0], device=pos.device)
    col = pos.long().clamp(0, kv[0][0].shape[2] - 1)
    for c, s in zip(list(kv[0]) + list(kv[1]), saved):
        c[rows, :, col] = s


class _DecodeEntry:
    """One signature of a :class:`CapturedDecode`: static input buffers
    (pinned host mirrors on the GPU), weak references to the storage's
    tensors, and the graph with its outputs."""

    _DTYPES = {"token": torch.long, "pos": torch.long,
               "temperature": torch.float32, "top_k": torch.long,
               "tables": torch.int32}

    def __init__(self, owner, kv, greedy, rows):
        kind, _, _, nblk, tensors = owner._describe(kv)
        self.kind, self.greedy, self.rows = kind, bool(greedy), int(rows)
        self._refs = [(weakref.ref(t), t.data_ptr()) for t in tensors]
        shapes = {"token": (rows,), "pos": (rows,), "temperature": (rows,),
                  "top_k": (rows,)}
        if kind == "paged":
            shapes["tables"] = (rows, nblk)
        dev = owner.device
        self.buf = {n: torch.zeros(s, dtype=self._DTYPES[n], device=dev)
                    for n, s in shapes.items()}
        self.pinned = self.host = None
        if dev.type == "cuda":
            self.pinned = {n: torch.zeros(s, dtype=self._DTYPES[n],
                                          pin_memory=True)
                           for n, s in shapes.items()}
            self.host = {n: t.numpy() for n, t in self.pinned.items()}
        self.graph = self.logits = self.tokens = self.tok_host = None
        self.replay_launches = {}
        self.nbytes = 0

    def alive(self):
        """True while every storage tensor the graph holds the address of
        still lives there."""
        for ref, ptr in self._refs:
            t = ref()
            if t is None or t.data_ptr() != ptr:
                return False
        return True

    def load(self, arrays):
        """Write the step's inputs into the static buffers directly (the
        eager body and the capture's warm-up)."""
        for n, a in arrays.items():
            self.buf[n].copy_(torch.from_numpy(np.ascontiguousarray(a)).to(
                self._DTYPES[n]))
