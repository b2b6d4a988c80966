"""DyGraph core: VarBase, the eager tracer and the tape autograd engine.

A trimmed copy of ``paddle_tpu/dygraph/base.py``. Ops run eagerly on
torch tensors through the same registered lowerings the executor
interprets (a ``LowerCtx`` with no block). The tape records (op, inputs,
outputs, input snapshots) for every op with an input that needs a grad,
and ``backward()`` replays it in reverse through each op's registered
grad lowering, ``get_op_def(T + "_grad")``: the bespoke grad where one is
registered (``mul``, ``lookup_table``, ``batch_norm``, ``gather``, ...),
``registry.generic_grad_lower`` otherwise. Each is fed the
``__fwd_op__``, ``__grad_inputs__`` and ``__out_grad_mask__`` attrs that
``append_backward`` writes, so a dygraph grad is the static grad's
computation. ``grad(create_graph=True)`` records each replayed grad as a
``__tape_vjp__`` op, which is itself differentiable.

Randomness: the tracer's key advances by ``splitmix64`` once per
stochastic op and is that op's run seed (``LowerCtx.run_seed``); its grad
replay takes the same run seed, so a dropout's backward draws its
forward's mask. A placeholder output carries no tensor until its op runs.
Left out: ``ComplexVariable`` inputs raise.
"""
import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..framework import unique_name
from ..framework.core import CPUPlace, CUDAPlace
from ..framework.dtype import convert_dtype, dtype_name, torch_dtype
from ..framework.lowering import LowerCtx, splitmix64
from ..framework.registry import get_op_def, normalize_outs, register_op

_tracer = None


def enabled():
    return _tracer is not None


in_dygraph_mode = enabled


def _current_tracer():
    return _tracer


def _place_device(place):
    """``None`` is the GPU (raises without one), as everywhere in the
    port; ``CPUPlace()``/``CUDAPlace(i)`` or a torch device name."""
    if isinstance(place, (CPUPlace, CUDAPlace)):
        place = place.device
    return resolve_device(place)


@contextlib.contextmanager
def guard(place=None):
    """fluid.dygraph.guard: eager mode on ``place`` (None: the GPU)."""
    global _tracer
    old = _tracer
    _tracer = Tracer(_place_device(place))
    try:
        yield
    finally:
        _tracer = old


def enable_dygraph(place=None):
    """Eager mode until :func:`disable_dygraph` (the global switch)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(_place_device(place))


def disable_dygraph():
    global _tracer
    _tracer = None


class no_grad:
    """Context manager and decorator turning tape recording off:
    ``@no_grad``, ``@no_grad()`` and ``with no_grad():``."""

    def __init__(self, func=None):
        self._func = func

    def __call__(self, *args, **kwargs):
        if self._func is not None:
            with no_grad():
                return self._func(*args, **kwargs)
        if len(args) == 1 and callable(args[0]) and not kwargs:
            return no_grad(args[0])
        raise TypeError("no_grad: use as @no_grad, @no_grad(), or "
                        "`with no_grad():`")

    def __enter__(self):
        t = _current_tracer()
        self._old = t._no_grad if t else False
        if t:
            t._no_grad = True
        return self

    def __exit__(self, *a):
        t = _current_tracer()
        if t:
            t._no_grad = self._old
        return False


def _device():
    t = _current_tracer()
    return t.device if t is not None else torch.device("cpu")


def _as_tensor(value, dtype=None):
    """A tensor on the tracer's device (the CPU outside dygraph mode).
    float64 host data becomes float32, as the JAX package's arrays do."""
    dev = _device()
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        arr = np.asarray(value)
        if arr.dtype.kind == "c":
            raise NotImplementedError("paddle_tpu_torch: complex VarBases "
                                      "(ComplexVariable) are not ported")
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(dev)


class VarBase:
    """Eager tensor: value + grad + stop_gradient. A placeholder (value
    None) stands for an op output until the op runs."""

    def __init__(self, value=None, name=None, stop_gradient=True,
                 persistable=False, dtype=None):
        self.value = None if value is None else _as_tensor(value, dtype)
        self._dtype = convert_dtype(dtype)
        self.name = name or unique_name.generate("eager_tmp")
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self._grad = None

    # ---- introspection ----
    @property
    def shape(self):
        if self.value is None:
            raise ValueError(f"VarBase {self.name} has no value yet")
        return tuple(self.value.shape)

    @property
    def dtype(self):
        if self.value is None:
            return self._dtype
        return dtype_name(self.value.dtype)

    @property
    def ndim(self):
        return self.value.dim()

    def numpy(self):
        """The value as a numpy array (bf16 as float32), a copy: the only
        read of a value back to the host."""
        return _to_numpy(self.value)

    def gradient(self):
        return None if self._grad is None else _to_numpy(self._grad)

    @property
    def grad(self):
        return self._grad

    def clear_gradient(self):
        self._grad = None

    def detach(self):
        return VarBase(self.value, stop_gradient=True)

    def astype(self, dtype):
        from ..layers import tensor as T
        return T.cast(self, dtype)

    def backward(self, retain_graph=False):
        # a BackwardStrategy passed positionally (the reference signature
        # backward(backward_strategy=None)) is not a retain_graph request
        from . import BackwardStrategy
        if isinstance(retain_graph, BackwardStrategy):
            retain_graph = False
        t = _current_tracer()
        if t is None:
            raise RuntimeError("backward() requires dygraph mode")
        t.run_backward(self, retain_graph=retain_graph)

    def __repr__(self):
        return (f"VarBase(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, stop_gradient={self.stop_gradient})\n"
                f"{self.numpy()}")

    __str__ = __repr__

    def __len__(self):
        return int(self.value.shape[0])

    def __bool__(self):
        if self.value.numel() != 1:
            raise ValueError(
                "truth value of a multi-element VarBase is ambiguous")
        return bool(self.value.reshape(()).item())

    def __float__(self):
        return float(self.value.reshape(()).item())

    def __int__(self):
        return int(self.value.reshape(()).item())


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    a = t.cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def not_ported(name, what):
    """A stand-in for an entry point of the JAX package's dygraph that the
    port lacks: calling it raises."""
    def stub(*args, **kwargs):
        raise NotImplementedError(f"paddle_tpu_torch: dygraph.{name} "
                                  f"({what}) is not ported")
    stub.__name__ = stub.__qualname__ = name
    return stub


def _names(io):
    return {s: [v.name for v in vs] for s, vs in io.items()}


class TapeEntry:
    __slots__ = ("op_type", "attrs", "ins", "outs", "key", "in_vals")

    def __init__(self, op_type, attrs, ins, outs, key, in_vals):
        self.op_type = op_type
        self.attrs = attrs
        self.ins = ins      # {slot: [VarBase]}
        self.outs = outs    # {slot: [VarBase]}
        self.key = key      # the op's run seed (0: not stochastic)
        # the input tensors at trace time: a later in-place op may rebind
        # a VarBase's value, which must not change this op's grad
        self.in_vals = in_vals


class Tracer:
    """Eager op dispatch and the tape, on one device."""

    def __init__(self, device, seed=0):
        self.device = torch.device(device)
        self.tape = []
        self._no_grad = False
        self._key = seed
        # set by a captured step (``jit.CompiledStep``): the generator
        # each stochastic call site draws from, the staged tensor each
        # ``to_variable`` of host data takes, and the op being run
        self.generator_hook = None
        self.variable_hook = None
        self.op_log = None

    def next_key(self):
        """The next run seed of the tracer's stream."""
        self._key = splitmix64(self._key)
        return self._key

    def _ctx(self, run_seed):
        ctx = LowerCtx(None, None, None, self.device, run_seed=run_seed)
        ctx.generator_hook = self.generator_hook
        return ctx

    def _log(self, op_type=None):
        """Note in ``op_log`` (a capture's trace) the op that begins
        (``op_type``) or that the last one returned (None)."""
        log = self.op_log
        if log is None:
            return
        if op_type is None:
            log["op_finished"] = True
            return
        log.update(op_type=op_type, op_index=log.get("op_index", -1) + 1,
                   op_finished=False)

    def trace_op(self, op_type, inputs, outputs, attrs=None,
                 in_vals_override=None):
        """Run one op now. ``inputs``: {slot: [VarBase]}; ``outputs``:
        {slot: [VarBase placeholders]} whose ``.value`` this fills;
        returns ``outputs``. ``in_vals_override`` replaces some slots'
        tensors (the traced backward feeds the tape's snapshots)."""
        attrs = dict(attrs or {})
        opdef = get_op_def(op_type)
        key = self.next_key() if opdef.needs_rng else 0
        ins = {}
        for s, vs in inputs.items():
            for v in vs:
                if v.value is None:
                    raise ValueError(f"op {op_type!r}: input {s} "
                                     f"({v.name}) has no value")
            ins[s] = [v.value for v in vs]
        if in_vals_override:
            ins.update({s: list(a) for s, a in in_vals_override.items()})
        self._log(op_type)
        outs = normalize_outs(opdef.lower(self._ctx(key), ins, attrs) or {})
        self._log()
        requires = opdef.grad is not False and not self._no_grad and any(
            not v.stop_gradient for vs in inputs.values() for v in vs)
        for slot, vars_ in outputs.items():
            for v, val in zip(vars_, outs.get(slot) or ()):
                if val is not None:
                    v.value = val
                    # an explicit stop_gradient=True placeholder (dropout's
                    # Mask, BN's running stats) stays so
                    if not requires:
                        v.stop_gradient = True
        if requires:
            self.tape.append(TapeEntry(op_type, attrs, inputs, outputs, key,
                                       ins))
        return outputs

    def _seed_grad(self, root, seed_grad):
        if seed_grad is None:
            return torch.ones_like(root.value)
        if isinstance(seed_grad, VarBase):
            seed_grad = seed_grad.value
        return torch.as_tensor(seed_grad).to(dtype=root.value.dtype,
                                             device=self.device)

    # ---- the backward engine ----
    def run_backward(self, root, retain_graph=False, seed_grad=None):
        """Replay the tape in reverse from ``root`` through each op's
        registered grad lowering and sum the grads into ``.grad``
        (repeated backward() calls accumulate)."""
        grads = {id(root): self._seed_grad(root, seed_grad)}  # pending
        out_grads = {}      # consumed as a cotangent: a var's final grad
        for entry in reversed(self.tape):
            g_ins, mask, consumed = {}, {}, []
            for slot, vars_ in entry.outs.items():
                gs = [grads.get(id(v)) for v in vars_]
                if any(g is not None for g in gs):
                    mask[slot] = [g is not None for g in gs]
                    g_ins[slot + "@GRAD"] = [g for g in gs if g is not None]
                    consumed += [id(v) for v, g in zip(vars_, gs)
                                 if g is not None]
            if not g_ins:
                continue
            # an out-grad used as a cotangent is replaced by in-grads: for
            # an in-place op (an output VarBase that is also an input)
            # leaving it pending would count it twice below
            for vid in consumed:
                if vid in grads:
                    out_grads.setdefault(vid, grads.pop(vid))
            req = _grad_request(entry)
            if not req:
                continue
            self._log(entry.op_type + "_grad")
            res = normalize_outs(get_op_def(entry.op_type + "_grad").lower(
                self._ctx(entry.key), {**entry.in_vals, **g_ins},
                _grad_attrs(entry, req, mask)) or {})
            self._log()
            for slot, vs in entry.ins.items():
                for v, g in zip(vs, res.get(slot + "@GRAD") or ()):
                    if v.stop_gradient or g is None:
                        continue
                    prev = grads.get(id(v))
                    grads[id(v)] = g if prev is None else prev + g

        touched = {}
        for entry in self.tape:
            for vs in list(entry.ins.values()) + list(entry.outs.values()):
                for v in vs:
                    touched.setdefault(id(v), v)
        # a pending grad (a leaf, an aliased input) wins over the consumed
        # out-grad of the same VarBase: it is the grad w.r.t. the var's
        # value before the in-place op
        final = dict(out_grads)
        final.update(grads)
        for vid, g in final.items():
            v = touched.get(vid)
            if v is None and vid == id(root):
                v = root
            if v is None or v.stop_gradient:
                continue
            v._grad = g if v._grad is None else v._grad + g
        if not retain_graph:
            self.tape.clear()

    def run_backward_traced(self, root, seed_grad=None):
        """The backward pass run through :meth:`trace_op` (one
        ``__tape_vjp__`` op per tape entry), so the grads land on the
        tape and can be differentiated again (``grad(create_graph=True)``).
        Returns {id(VarBase): grad VarBase}; ``.grad`` is untouched."""
        tape_snapshot = list(self.tape)     # new entries are appended live
        if isinstance(seed_grad, VarBase):
            seed = seed_grad
        else:
            seed = VarBase(self._seed_grad(root, seed_grad))
        grads = {id(root): seed}
        out_grads = {}
        for entry in reversed(tape_snapshot):
            ins = {s: list(vs) for s, vs in entry.ins.items()}
            mask, consumed = {}, []
            for slot, vs in entry.outs.items():
                gs = [grads.get(id(v)) for v in vs]
                if any(g is not None for g in gs):
                    mask[slot] = [g is not None for g in gs]
                    ins[slot + "@CT"] = [g for g in gs if g is not None]
                    consumed += [id(v) for v, g in zip(vs, gs)
                                 if g is not None]
            if not mask:
                continue
            for vid in consumed:
                if vid in grads:
                    out_grads.setdefault(vid, grads.pop(vid))
            req = _grad_request(entry)
            if not req:
                continue
            attrs = {"fwd_type": entry.op_type, "fwd_attrs": entry.attrs,
                     "fwd_inputs": _names(entry.ins),
                     "fwd_outputs": _names(entry.outs), "out_mask": mask,
                     "needs": req, "run_seed": entry.key}
            outs = {s + "@GRAD": [VarBase(stop_gradient=False) for _ in vs]
                    for s, vs in entry.ins.items()}
            self.trace_op("__tape_vjp__", ins, outs, attrs,
                          in_vals_override=entry.in_vals)
            for slot, vs in entry.ins.items():
                for v, gv in zip(vs, outs[slot + "@GRAD"]):
                    if v.stop_gradient or gv.value is None:
                        continue
                    prev = grads.get(id(v))
                    grads[id(v)] = gv if prev is None else prev + gv
        final = dict(out_grads)
        final.update(grads)
        return final


def _grad_request(entry):
    """{slot: [needs a grad per input]} of a tape entry, by the inputs'
    stop_gradient now (``grad(no_grad_vars=)`` sets it) and their type."""
    req = {}
    for slot, vs in entry.ins.items():
        flags = [not v.stop_gradient and t.is_floating_point()
                 for v, t in zip(vs, entry.in_vals[slot])]
        if any(flags):
            req[slot] = flags
    return req


def _grad_attrs(entry, req, mask):
    """The attrs ``append_backward`` gives the grad op of this entry."""
    return {"__fwd_op__": {"type": entry.op_type,
                           "inputs": _names(entry.ins),
                           "outputs": _names(entry.outs),
                           "attrs": entry.attrs},
            "__grad_inputs__": req, "__out_grad_mask__": mask}


@register_op("__tape_vjp__", infer_shape=False)
def _tape_vjp_lower(ctx, ins, attrs):
    """One tape entry's backward as a regular (differentiable) op: the
    forward op's registered grad lowering, given the forward inputs
    (their slots) and the output cotangents (``<slot>@CT``); returns
    ``<slot>@GRAD``. Recorded on the tape, its own backward is the
    generic vjp through this lowering: the double-backward path."""
    fwd_in, fwd_out = attrs["fwd_inputs"], attrs["fwd_outputs"]
    g_ins = {s: ins[s] for s in fwd_in}
    for s in fwd_out:
        if s + "@CT" in ins:
            g_ins[s + "@GRAD"] = ins[s + "@CT"]
    gattrs = {"__fwd_op__": {"type": attrs["fwd_type"], "inputs": fwd_in,
                             "outputs": fwd_out,
                             "attrs": attrs["fwd_attrs"]},
              "__grad_inputs__": attrs["needs"],
              "__out_grad_mask__": attrs["out_mask"]}
    gctx = LowerCtx(None, None, None, ctx.device, run_seed=attrs["run_seed"])
    gctx.generator_hook = ctx.generator_hook
    return get_op_def(attrs["fwd_type"] + "_grad").lower(gctx, g_ins, gattrs)


def to_variable(value, name=None, zero_copy=None):
    """numpy / list / tensor -> VarBase on the tracer's device
    (stop_gradient). Host data inside a captured step takes the tensor
    staged for it before capture (``Tracer.variable_hook``)."""
    if isinstance(value, VarBase):
        return value
    t = _current_tracer()
    if isinstance(value, torch.Tensor):
        if t is None or value.device == t.device:
            return VarBase(value, name=name, stop_gradient=True)
        value = _to_numpy(value)
    arr = np.asarray(value)
    if arr.dtype.kind == "c":
        raise NotImplementedError("paddle_tpu_torch: complex to_variable "
                                  "(ComplexVariable) is not ported")
    if t is not None and t.variable_hook is not None:
        return t.variable_hook(arr, name)
    return VarBase(arr, name=name, stop_gradient=True)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """fluid.dygraph.grad: d outputs / d inputs without touching the
    ``.grad`` accumulators; ``create_graph`` makes the grads
    differentiable."""
    t = _current_tracer()
    if t is None:
        raise RuntimeError("dygraph.grad requires dygraph mode")
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    frozen = []
    for v in (no_grad_vars or []):
        if not v.stop_gradient:
            v.stop_gradient = True
            frozen.append(v)

    def seed_of(i):
        if grad_outputs is not None and i < len(grad_outputs):
            return grad_outputs[i]
        return None

    try:
        if create_graph:
            acc = {}
            for i, root in enumerate(outputs):
                for vid, g in t.run_backward_traced(
                        root, seed_grad=seed_of(i)).items():
                    prev = acc.get(vid)
                    acc[vid] = g if prev is None else prev + g
            res = [acc.get(id(iv)) for iv in inputs]
        else:
            touched = {id(v): v for e in t.tape
                       for vs in list(e.ins.values()) + list(e.outs.values())
                       for v in vs}
            for iv in inputs:
                touched.setdefault(id(iv), iv)
            saved = {vid: v._grad for vid, v in touched.items()}
            for v in touched.values():
                v._grad = None
            for i, root in enumerate(outputs):
                t.run_backward(root, retain_graph=True,
                               seed_grad=seed_of(i))
            res = [None if iv._grad is None
                   else VarBase(iv._grad, stop_gradient=True)
                   for iv in inputs]
            for vid, v in touched.items():
                v._grad = saved[vid]
            if not retain_graph:
                t.tape.clear()
    finally:
        for v in frozen:
            v.stop_gradient = False
    for iv, g in zip(inputs, res):
        if g is None and not allow_unused:
            raise RuntimeError(f"input {iv.name} is unused in the graph")
    return res
