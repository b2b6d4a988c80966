"""Scope + Executor.

Counterpart of ``paddle_tpu/framework/executor.py``. The JAX package
compiles a whole program per feed signature; this ``Executor.run``
interprets the block op by op on torch tensors, eagerly, on the
executor's device (``place=None`` is the GPU and raises without one).

Before it runs, a program goes through the ``FLAGS_program_passes``
pipeline (``passes.optimize_program``: dce, cse, fuse_optimizer by
default; under ``FLAGS_verify_passes`` the program is verified first
and each pass's output after it) on a clone, memoized on (program uid,
program version, fetch names, pipeline signature); the user's program
is never mutated, and ``FLAGS_program_passes="0"`` runs it as built.
Scope state the block reads comes in from the scope, persistable vars it
writes go back to it when the run ends, and every other var is dropped
from the env after its last reader (``lowering.last_uses``), so a
training step holds what a compiler's buffer liveness would hold, not
every activation and grad at once.
"""
import time

import numpy as np
import torch

from ..device import resolve_device
from ..flags import flag
from .analysis import verify_program
from .core import CPUPlace, CUDAPlace, Variable, default_main_program
from .dtype import torch_dtype
from .lowering import (LowerCtx, analyze_block_io, last_uses, run_ops,
                       splitmix64)
from .passes import optimize_program, pipeline_signature
from .passes import stats as pass_stats

RNG_STATE_NAME = "@RNG_SEED@"


class Scope:
    """name -> tensor table (flat, as in the JAX package)."""

    def __init__(self):
        self._vars = {}

    def find_var(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    def __contains__(self, name):
        return name in self._vars


_global_scope = Scope()


def global_scope():
    return _global_scope


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        global _global_scope
        self.old = _global_scope
        _global_scope = self.scope

    def __exit__(self, *exc):
        global _global_scope
        _global_scope = self.old


def scope_from_arrays(scope, arrays):
    """Load arrays (``{name: np.ndarray}``, e.g. a JAX package scope's
    parameters, Adam moments, beta-pows and learning rate) into
    ``scope``, over the tensors a run of the port's startup program put
    there: each keeps its device and dtype. Raises on a name the scope
    does not hold, on a scope var the arrays lack, and on a shape that
    differs."""
    have = {n for n in scope.keys() if n != RNG_STATE_NAME}
    unknown = sorted(set(arrays) - have)
    missing = sorted(have - set(arrays))
    if unknown or missing:
        raise ValueError(f"arrays do not match the scope: unknown "
                         f"{unknown}, missing {missing}")
    for name, a in arrays.items():
        old = scope.find_var(name)
        a = np.array(a)              # a writable copy for torch
        if tuple(a.shape) != tuple(old.shape):
            raise ValueError(f"{name!r} has shape {tuple(a.shape)}, the "
                             f"scope holds {tuple(old.shape)}")
        scope.set(name, torch.from_numpy(a).to(device=old.device,
                                               dtype=old.dtype))


class Executor:
    """Runs programs op by op on one device: ``place`` None (the GPU;
    raises without one), ``CUDAPlace(i)`` or ``CPUPlace()``."""

    def __init__(self, place=None):
        if place is None or isinstance(place, CUDAPlace):
            self.device = resolve_device(None if place is None
                                         else place.device)
        elif isinstance(place, CPUPlace):
            self.device = resolve_device("cpu")
        else:
            raise TypeError(f"unsupported place {place!r}")
        self._opt_cache = {}
        self.verify_ms = 0.0

    def _optimize(self, program, fetch_names, feed_names=(), scope=None):
        """The pipeline's clone of ``program`` (``program`` itself with
        the pipeline off), memoized: a program's version moves with every
        edit, so an edited program is optimized again.

        Under ``FLAGS_verify_passes`` each memo miss first verifies the
        user program (``analysis.verify_program``, with the scope's names,
        so reads and fetches of scope state check exactly), then every
        pass's output; a malformed program raises ``ProgramVerifyError``
        naming the op (and the pass) before any op runs. The feed names
        and the scope's names join the memo key then, so a clean verdict
        under one binding is not served to another. Verification time
        accumulates in ``verify_ms``."""
        sig = pipeline_signature()
        verify = flag("verify_passes")
        if not sig and not verify:
            return program
        key = (program._uid, program.version, tuple(fetch_names), sig,
               verify)
        if verify:
            scope_names = None if scope is None else \
                frozenset(scope.keys()) - {RNG_STATE_NAME}
            key += (frozenset(feed_names), scope_names)
        opt = self._opt_cache.get(key)
        if opt is not None:
            return opt
        if verify:
            t0 = time.perf_counter()
            verify_program(program, fetch_names=fetch_names,
                           feed_names=feed_names, scope_names=scope_names)
            self.verify_ms += (time.perf_counter() - t0) * 1e3
        opt = optimize_program(program, fetch_names) if sig else program
        if verify and sig:
            self.verify_ms += pass_stats()["verify_ms"]
        self._opt_cache[key] = opt
        return opt

    def _feed_tensor(self, block, name, val):
        var = block.vars.get(name)
        t = val if isinstance(val, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(val))
        dt = torch_dtype(var.dtype) if var is not None else t.dtype
        return t.to(device=self.device, dtype=dt)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program``'s global block once; returns the fetched
        values (numpy arrays, or tensors with ``return_numpy=False``).
        ``fetch_list`` may name any var the block computes, ``param@GRAD``
        names included."""
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        feed = {(k.name if isinstance(k, Variable) else k): v
                for k, v in (feed or {}).items()}
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        program = self._optimize(program, fetch_names, feed.keys(), scope)
        block = program.global_block()

        env = {n: self._feed_tensor(block, n, v) for n, v in feed.items()}
        reads, writes = analyze_block_io(program, 0, env.keys())
        for n in reads:
            val = scope.find_var(n)
            if val is None:
                raise RuntimeError(
                    f"var {n!r} is read by the program but is not "
                    f"initialized in the scope: run the startup program "
                    f"first, or feed it")
            env[n] = val
        for n in fetch_names:
            if n not in env and scope.find_var(n) is not None:
                env[n] = scope.find_var(n)       # a fetch of scope state

        run_seed = scope.find_var(RNG_STATE_NAME)
        if run_seed is None:
            run_seed = int(program.random_seed or 0)
        ctx = LowerCtx(program, block, env, self.device, run_seed=run_seed)
        keep = set(fetch_names) | set(writes)
        with torch.no_grad():
            run_ops(ctx, free_after=last_uses(block, keep))

        fetches = []
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was never computed")
            fetches.append(env[n])
        for n in writes:
            scope.set(n, env[n])
        scope.set(RNG_STATE_NAME, splitmix64(run_seed))
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
        return fetches


__all__ = ["CPUPlace", "CUDAPlace", "Executor", "RNG_STATE_NAME", "Scope",
           "global_scope", "scope_from_arrays", "scope_guard"]
