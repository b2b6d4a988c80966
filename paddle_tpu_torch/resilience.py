"""Typed checkpoint failures of the port.

A trimmed copy of ``paddle_tpu/resilience.py``: only the two errors that
``io`` raises. Fault injection (``maybe_fail``), retry budgets and the
circuit breaker are not ported.
"""


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
