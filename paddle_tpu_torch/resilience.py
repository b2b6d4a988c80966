"""Typed checkpoint failures of the port.

A trimmed copy of ``paddle_tpu/resilience.py``: the two errors that
``io`` raises and ``NonFiniteError``, which the executor's non-finite
guard raises. Fault injection (``maybe_fail``), retry budgets and the
circuit breaker are not ported.
"""
from .framework.core import EnforceNotMet


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
