"""Typed failures of the port and its fault points.

A trimmed copy of ``paddle_tpu/resilience.py``: the two errors that
``io`` raises, ``NonFiniteError`` (the executor's non-finite guard),
the training loop's ``PreemptedError`` and ``RestartBudgetExceeded``
(``:144-192``), and fault injection (``FaultInjected``, ``maybe_fail``,
``fault_injection``, ``clear_faults``, ``:637-684``), which tests use
to break ``io.CheckpointSaver``'s commit (``"io.commit"``). A fault that
fires is reported as the JAX package's chaos harness reports its
firings: a ``chaos`` flight-recorder event naming the point and
``chaos_faults_fired_total{point}``. Retry budgets, the chaos harness
itself and the circuit breaker are not ported.
"""
import threading
from contextlib import contextmanager

from .framework.core import EnforceNotMet
from .observability.metrics import default_registry as _registry
from .observability.recorder import flight_recorder as _flightrec

_CHAOS_FIRED = _registry().counter(
    "chaos_faults_fired_total",
    "chaos-harness faults actually injected, by armed point",
    labels=("point",), max_series=64)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its manifest integrity check (sha256
    mismatch, truncation, or unreadable payload). Carries ``path``, the
    offending file."""

    def __init__(self, message, path=None):
        super().__init__(message)
        self.path = path


class CheckpointIncompleteError(CheckpointCorruptError):
    """A checkpoint loaded for training resume lacks part of the full
    training state. Carries ``missing`` (the absent variable or extra
    names)."""

    def __init__(self, message, path=None, missing=None):
        super().__init__(message, path=path)
        self.missing = list(missing or [])


class NonFiniteError(EnforceNotMet):
    """``check_nan_inf`` tripped: a fetched output or an updated variable
    holds nan/inf. Carries ``var_name`` (the first offender) and
    ``count`` (its non-finite element count, or the step's count across
    outputs and state under ``run_steps``)."""

    def __init__(self, message, var_name=None, count=None):
        super().__init__(message)
        self.var_name = var_name
        self.count = count


class PreemptedError(RuntimeError):
    """The training loop was preempted and exited at a slab boundary
    after its fast checkpoint. Carries ``slab``/``step`` (progress at
    exit), ``checkpoint_no`` (the newest durable checkpoint) and
    ``reason``."""

    def __init__(self, message, slab=None, step=None, checkpoint_no=None,
                 reason=None):
        super().__init__(message)
        self.slab = slab
        self.step = step
        self.checkpoint_no = checkpoint_no
        self.reason = reason


class RestartBudgetExceeded(RuntimeError):
    """A supervised training loop crashed more times than its restart
    budget allows. Carries ``restarts`` and ``errors`` (the error names
    of every restart cause, oldest first)."""

    def __init__(self, message, restarts=None, errors=None):
        super().__init__(message)
        self.restarts = restarts
        self.errors = list(errors or [])


class FaultInjected(RuntimeError):
    """What an armed fault point raises by default: distinct from real
    failures, so a test can tell injected damage from a bug in the
    recovery."""


_faults = {}
_faults_lock = threading.Lock()


def maybe_fail(point, **context):
    """A failure point in production code: raises the exception a test
    armed for ``point`` (:func:`fault_injection`); one dict lookup
    otherwise."""
    with _faults_lock:
        spec = _faults.get(point)
        if spec is None or spec["remaining"] == 0:
            return
        spec["remaining"] -= 1
        spec["fired"] += 1
        exc = spec["exc"]
    if callable(exc) and not isinstance(exc, type):
        exc = exc(point, context)
        if exc is None:
            return
    _CHAOS_FIRED.inc(labels=(point,))
    _flightrec().record("chaos", point=point)
    raise exc if not isinstance(exc, type) else exc(
        f"fault injected at {point}")


def clear_faults():
    with _faults_lock:
        _faults.clear()


@contextmanager
def fault_injection(point, exc=ConnectionError, times=1):
    """Arm ``point`` to raise ``exc`` for its next ``times`` hits
    (``times=-1``: every hit while armed). ``exc`` is an exception
    class, an instance, or a callable ``(point, context) -> exception or
    None``. Yields the spec; ``spec['fired']`` counts the trips."""
    spec = {"exc": exc, "remaining": int(times), "fired": 0}
    with _faults_lock:
        prev = _faults.get(point)
        _faults[point] = spec
    try:
        yield spec
    finally:
        with _faults_lock:
            if prev is None:
                _faults.pop(point, None)
            else:
                _faults[point] = prev
