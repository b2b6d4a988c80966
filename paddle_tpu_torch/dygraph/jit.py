"""dygraph.jit_step: a whole dygraph training step as one CUDA graph.

The port's ``CompiledStep``/``jit_step`` (``paddle_tpu/dygraph/jit.py:
254-509``), after the JAX protocol. There one executable holds forward,
``loss.backward()``, ``optimizer.minimize()`` and ``clear_gradients``;
here one ``torch.cuda.CUDAGraph`` over the taped step does:

- call 1 runs eagerly: it materialises the parameters and the
  optimizers' state, and one warm-up serves every signature;
- the first call at a new input signature runs the step once on a side
  stream to find the external VarBases it reads and writes (a spy on
  ``Tracer.trace_op`` and ``Optimizer._dygraph_minimize``), the
  optimizers' state, its stochastic call sites and its ``to_variable``
  copies of host data, then puts every value back (that pass writes no
  state). It then captures the step with ``cuda_graph.capture_graph``
  over static tensors: a clone of each external value and optimizer slot,
  which the graph's last kernels overwrite with the new values
  (``static.copy_(new)``), and one buffer per argument; then it replays
  once, the real step;
- later calls copy the arguments into the buffers and replay.

A VarBase whose ``.value`` is no longer the entry's static tensor (an
eager step, ``set_dict``, ``load_dygraph`` between calls) is copied in
before a replay, as ``CapturedStep`` treats its scope. Host-to-device
copies cannot be captured: each ``to_variable`` of host data in the step
takes the device tensor staged for it by the discovery pass, in call
order, and must match it in shape, type and bytes. The learning rate is
the device scalar of the capture (``Optimizer._eager_lr``), frozen there
as in the JAX package. Each stochastic call site (a dropout, and the
grad replay that draws its mask again) gets a CUDA generator registered
with the graph and seeded before each replay to what an eager step with
that step's run seed draws (the tracer's ``splitmix64`` stream), so a
replay equals :meth:`CompiledStep.eager` bit for bit. Nothing falls back:
a failed capture raises ``GraphCaptureError`` naming the op. On the CPU
an entry runs the same body eagerly over its static tensors.

Grads do not leave a step (each external's ``.grad`` is None inside it
and restored after), as in the JAX package. ``TracedLayer``,
``declarative``, ``ProgramTranslator`` and ``dygraph_to_static_func``
are not ported and raise.
"""
import time

import numpy as np
import torch

from ..framework.cuda_graph import (GraphCaptureError, _counter_attrs,
                                    capture_graph)
from ..framework.lowering import generator_seed, splitmix64
from .base import VarBase, _current_tracer, not_ported


TracedLayer = not_ported("TracedLayer", "dygraph to static")
ProgramTranslator = not_ported("ProgramTranslator", "dygraph to static")
declarative = not_ported("declarative", "dygraph to static")
dygraph_to_static_func = not_ported("dygraph_to_static_func",
                                    "dygraph to static")


def _tracer():
    t = _current_tracer()
    if t is None:
        raise RuntimeError("a jit_step step must run under dygraph.guard()")
    return t


def _chain(key, n):
    """[key, splitmix64(key), ...]: the run seeds of a step's n draws."""
    out = [key]
    for _ in range(n):
        out.append(splitmix64(out[-1]))
    return out


def _flatten(out):
    """(tensors, rebuild) of a step's return value: a VarBase, a list or
    tuple of VarBases, or None."""
    if out is None:
        return [], lambda ts: None
    if isinstance(out, VarBase):
        return [out.value], lambda ts: VarBase(ts[0])
    if isinstance(out, (list, tuple)) and \
            all(isinstance(o, VarBase) for o in out):
        kind = type(out)
        return [o.value for o in out], \
            lambda ts: kind(VarBase(t) for t in ts)
    raise TypeError(f"a jit_step step returns a VarBase, a list or tuple "
                    f"of VarBases, or None, not {type(out).__name__}")


class CompiledStep:
    """A dygraph training step (forward, ``backward()``, ``minimize()``,
    ``clear_gradients()``) as one cached CUDA graph per input signature
    (see the module docstring)."""

    def __init__(self, fn):
        self._fn = fn
        self._cache = {}      # signature -> _StepEntry
        self._warm = False    # params and optimizer state materialised
        self._pool = None
        self._stream = None

    @staticmethod
    def _args(args):
        return [a if isinstance(a, VarBase) else VarBase(a) for a in args]

    def __call__(self, *args):
        tracer = _tracer()
        vb_args = self._args(args)
        sig = tuple((tuple(v.value.shape), v.value.dtype) for v in vb_args)
        entry = self._cache.get(sig)
        if entry is None:
            if not self._warm:
                # eager warm-up: makes params and optimizer state; warm on
                # a small batch to keep its memory low
                out = self._fn(*vb_args)
                self._warm = True
                return out
            if tracer.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(device=tracer.device)
            entry = _StepEntry(self, tracer, vb_args)
            self._cache[sig] = entry
        return entry.run(tracer, vb_args)

    def eager(self, *args):
        """The step run eagerly under the run-seed protocol of a replay
        (one key from the tracer's stream, the step's draws from it): an
        eager step that a replay from the same state and tracer key
        equals bit for bit."""
        tracer = _tracer()
        vb_args = self._args(args)
        key = tracer.next_key()
        after, tape = tracer._key, tracer.tape
        tracer._key, tracer.tape = key, []
        try:
            return self._fn(*vb_args)
        finally:
            tracer._key, tracer.tape = after, tape


class _StepEntry:
    """One input signature of a :class:`CompiledStep`: its static tensors
    and, on the GPU, its graph."""

    def __init__(self, owner, tracer, vb_args):
        from .. import kernels
        self._fn = owner._fn
        self.device = tracer.device
        self._bufs = [v.value.detach().clone() for v in vb_args]
        self._args = [VarBase(b, name=v.name, stop_gradient=v.stop_gradient)
                      for b, v in zip(self._bufs, vb_args)]
        self._counters = _counter_attrs(kernels.COUNTED)
        self.replay_launches, self.nbytes = {}, 0
        self.graph = None
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            side = owner._stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._discover(tracer)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()    # the graph's pool may take it
            self._bind_static()
            torch.cuda.synchronize(self.device)
            self._capture(tracer, owner._pool, side)
        else:
            self._discover(tracer)
            self._bind_static()
        self.capture_s = time.perf_counter() - t0

    # -- discovery ------------------------------------------------------
    def _discover(self, tracer):
        """Run the step once (eagerly) to find what it reads and writes;
        put every value back."""
        from ..optimizer import Optimizer
        seen = {id(v): "arg" for v in self._args}
        ext, pre, opts, pre_states = [], {}, [], {}
        staged, sites = [], []
        key0 = splitmix64(tracer._key)
        orig_trace_op = tracer.trace_op
        orig_minimize = Optimizer._dygraph_minimize

        def note_ext(v):
            if id(v) not in seen:
                seen[id(v)] = "ext"
                pre[id(v)] = (v.value, v._grad)
                ext.append(v)

        def spy_trace_op(op_type, inputs, outputs, attrs=None,
                         in_vals_override=None):
            for vs in inputs.values():
                for v in vs:
                    note_ext(v)
            for vs in outputs.values():
                for v in vs:
                    # a placeholder has no value yet; an output that has
                    # one existed before the op (an in-place write)
                    if v.value is not None:
                        note_ext(v)
            res = orig_trace_op(op_type, inputs, outputs, attrs,
                                in_vals_override)
            for vs in outputs.values():
                for v in vs:
                    seen.setdefault(id(v), "int")
            return res

        def spy_minimize(opt, parameter_list=None):
            if opt not in opts:
                pre_states[id(opt)] = {
                    pn: dict(st)
                    for pn, st in getattr(opt, "_eager_state", {}).items()}
                opts.append(opt)
                for p in (parameter_list or opt._parameter_list or []):
                    note_ext(p)
            return orig_minimize(opt, parameter_list)

        def stage(arr, name):
            v = VarBase(arr, name=name, stop_gradient=True)
            seen[id(v)] = "int"
            staged.append((np.array(arr), v.value))
            return v

        def record_site(ctx, attrs):
            sites.append((ctx.run_seed, dict(attrs)))
            gen = torch.Generator(device=ctx.device)
            gen.manual_seed(generator_seed(ctx.run_seed, attrs))
            return gen

        old_key, old_tape = tracer._key, tracer.tape
        tracer._key, tracer.tape = key0, []
        tracer.trace_op = spy_trace_op
        tracer.variable_hook = stage
        if self.device.type == "cuda":
            tracer.generator_hook = record_site
        Optimizer._dygraph_minimize = spy_minimize
        try:
            self._fn(*self._args)
            end_key = tracer._key
        finally:
            Optimizer._dygraph_minimize = orig_minimize
            del tracer.trace_op
            tracer.variable_hook = tracer.generator_hook = None
            tracer._key, tracer.tape = old_key, old_tape
            for v in ext:
                v.value, v._grad = pre[id(v)]
            for o in opts:
                o._eager_state = pre_states[id(o)]
        # the step's draws: how far its stream advanced
        n, k = 0, key0
        while k != end_key:
            k, n = splitmix64(k), n + 1
        index = {s: j for j, s in enumerate(_chain(key0, n))}
        self._draws = n
        self._sites = [(index[seed], attrs) for seed, attrs in sites]
        self._ext, self._opts, self._staged = ext, opts, staged

    def _bind_static(self):
        """A static clone of every external value and optimizer slot, put
        in their place."""
        self._static = []
        for v in self._ext:
            if v.value is None:
                raise RuntimeError(f"VarBase {v.name} is read by the step "
                                   f"but has no value")
            st = v.value.detach().clone()
            v.value = st
            self._static.append(st)
        self._binding = [(o, pn, slot) for o in self._opts
                         for pn, st in o._eager_state.items()
                         for slot in st]
        self._opt_static = []
        for o, pn, slot in self._binding:
            st = o._eager_state[pn][slot].detach().clone()
            o._eager_state[pn][slot] = st
            self._opt_static.append(st)
        self._ptrs = {t.untyped_storage().data_ptr()
                      for t in self._static + self._opt_static + self._bufs}

    def _bind_in(self):
        """Copy in every value that is no longer the entry's static tensor
        (it was rebound between calls), and point it back at it."""
        for v, st in zip(self._ext, self._static):
            if v.value is not st:
                _copy_in(st, v.value, v.name)
                v.value = st
        for (o, pn, slot), st in zip(self._binding, self._opt_static):
            cur = o._eager_state.get(pn, {}).get(slot)
            if cur is None:
                raise RuntimeError(f"optimizer state {pn}.{slot} of the "
                                   f"captured step is gone")
            if cur is not st:
                _copy_in(st, cur, f"{pn}.{slot}")
                o._eager_state[pn][slot] = st

    # -- the step -------------------------------------------------------
    def _body(self, tracer, key, generator_hook=None, trace=None):
        """The step over the static tensors, ending with each new value
        copied into its static tensor; returns (output tensors, rebuild)."""
        handed = []

        def hand_out(arr, name):
            i = len(handed)
            if i >= len(self._staged):
                raise GraphCaptureError(
                    f"to_variable #{i} of host data {arr.shape} "
                    f"{arr.dtype} was not staged before capture: a "
                    f"host-to-device copy cannot run inside the graph",
                    op_type="to_variable")
            ref, t = self._staged[i]
            if ref.shape != arr.shape or ref.dtype != arr.dtype or \
                    ref.tobytes() != np.ascontiguousarray(arr).tobytes():
                raise GraphCaptureError(
                    f"to_variable #{i} of host data differs from the "
                    f"array staged for it ({arr.shape} {arr.dtype} against "
                    f"{ref.shape} {ref.dtype}, or other bytes): host data "
                    f"inside a captured step must be the same every call",
                    op_type="to_variable")
            handed.append(i)
            return VarBase(t, name=name, stop_gradient=True)

        grads = [v._grad for v in self._ext]
        states = {id(o): set(o._eager_state) for o in self._opts}
        old_key, old_tape = tracer._key, tracer.tape
        tracer._key, tracer.tape = key, []
        tracer.variable_hook, tracer.generator_hook = hand_out, \
            generator_hook
        tracer.op_log = trace
        try:
            for v in self._ext:
                v._grad = None
            out = self._fn(*self._args)
            if trace is not None:
                trace["done"] = True
            outs, rebuild = _flatten(out)
            news = []
            for v, st in zip(self._ext, self._static):
                if v.value is not st:
                    news.append((st, v.value))
                    v.value = st
            for (o, pn, slot), st in zip(self._binding, self._opt_static):
                cur = o._eager_state[pn][slot]
                if cur is not st:
                    news.append((st, cur))
                    o._eager_state[pn][slot] = st
            for o in self._opts:
                extra = set(o._eager_state) - states[id(o)]
                if extra:
                    raise RuntimeError(
                        f"parameters {sorted(extra)} got their first "
                        f"optimizer state inside a captured step: run an "
                        f"eager step in which they get a grad first")
            # a new value that shares storage with a static tensor (an op
            # that returned its input) is copied before any copy-back
            news = [(st, self._own(t)) for st, t in news]
            for st, t in news:
                st.copy_(t)
            return [self._own(t) for t in outs], rebuild
        finally:
            # a step that failed leaves each value at its static tensor,
            # which holds the state from before the step
            for v, st, g in zip(self._ext, self._static, grads):
                v.value, v._grad = st, g
            for (o, pn, slot), st in zip(self._binding, self._opt_static):
                o._eager_state[pn][slot] = st
            tracer._key, tracer.tape = old_key, old_tape
            tracer.variable_hook = tracer.generator_hook = None
            tracer.op_log = None

    def _own(self, t):
        if t is not None and t.untyped_storage().data_ptr() in self._ptrs:
            return t.clone()
        return t

    # -- capture and replay ---------------------------------------------
    def _capture(self, tracer, pool, side):
        graph = torch.cuda.CUDAGraph()
        gens = []
        if self._sites:
            if not hasattr(graph, "register_generator_state"):
                raise GraphCaptureError(
                    f"this PyTorch ({torch.__version__}) has no "
                    f"CUDAGraph.register_generator_state: the step's "
                    f"stochastic ops cannot draw new numbers on each "
                    f"replay", op_type="dropout")
            for _ in self._sites:
                gen = torch.Generator(device=self.device)
                graph.register_generator_state(gen)
                gens.append(gen)
        key0 = splitmix64(tracer._key)
        chain = _chain(key0, self._draws)
        taken = []

        def hand_gen(ctx, attrs):
            i = len(taken)
            site = (chain.index(ctx.run_seed) if ctx.run_seed in chain
                    else None, dict(attrs))
            if i >= len(self._sites) or self._sites[i] != site:
                raise GraphCaptureError(
                    f"stochastic call #{i} was not made by the discovery "
                    f"pass: the step's random draws are not the same from "
                    f"run to run", op_type="dropout")
            taken.append(i)
            return gens[i]

        (self._outs, self._rebuild), self.replay_launches, self.nbytes = \
            capture_graph(graph, None,
                          lambda trace: self._body(tracer, key0, hand_gen,
                                                   trace),
                          pool, side, self._counters, self.device)
        self._gens = gens
        self.graph = graph

    def run(self, tracer, vb_args):
        """One step: the arguments into the buffers, then a replay (an
        eager run of the body on the CPU)."""
        self._bind_in()
        for b, v in zip(self._bufs, vb_args):
            _copy_in(b, v.value, v.name)
        key = tracer.next_key()
        if self.graph is None:
            outs, rebuild = self._body(tracer, key)
            return rebuild(outs)
        chain = _chain(key, self._draws)
        for gen, (j, attrs) in zip(self._gens, self._sites):
            gen.manual_seed(generator_seed(chain[j], attrs))
        self.graph.replay()
        for (w, attr), n in self.replay_launches.items():
            setattr(w, attr, getattr(w, attr) + n)
        return self._rebuild([t.clone() for t in self._outs])


def _copy_in(static, value, name):
    if tuple(value.shape) != tuple(static.shape):
        raise ValueError(f"{name} has shape {tuple(value.shape)}, the "
                         f"captured step holds {tuple(static.shape)}")
    static.copy_(value)


def jit_step(fn):
    """Decorator: ``fn`` (a dygraph training step) as a
    :class:`CompiledStep`, reachable as ``wrapper._compiled_step``."""
    step = CompiledStep(fn)

    def wrapper(*args):
        return step(*args)

    wrapper._compiled_step = step
    return wrapper
