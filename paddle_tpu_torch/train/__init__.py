"""Exact training resume (a trimmed copy of ``paddle_tpu/train``):
:class:`TrainCheckpoint` (numbered full-training-state checkpoints,
background saves, and a restore that skips a corrupt or incomplete
newest checkpoint) and the typed errors of the training loop.

Not ported, and raising ``NotImplementedError``: ``TrainingSupervisor``,
``HealthMonitor``, ``SliceSupervisor`` / ``validate_restored_widths``
and the preemption API (``request_preemption`` and the rest). They need
the goodput ledger, the metrics registry, the flight recorder and the
SLO monitor (ROADMAP Queue 1 items 6 and 8).
"""
from ..resilience import (  # noqa: F401  (typed error surface)
    CheckpointIncompleteError, PreemptedError, RestartBudgetExceeded,
)
from .checkpoint import TRAIN_STATE_FILE, TrainCheckpoint  # noqa: F401


def _unported(name):
    def _raise(*args, **kwargs):
        raise NotImplementedError(
            f"paddle_tpu_torch: train.{name} is not ported: it needs the "
            f"observability layer (ROADMAP Queue 1 items 6 and 8)")
    _raise.__name__ = name
    return _raise


TrainingSupervisor = _unported("TrainingSupervisor")
HealthMonitor = _unported("HealthMonitor")
SliceSupervisor = _unported("SliceSupervisor")
validate_restored_widths = _unported("validate_restored_widths")
request_preemption = _unported("request_preemption")
preemption_requested = _unported("preemption_requested")
preemption_reason = _unported("preemption_reason")
clear_preemption = _unported("clear_preemption")
signal_preemption = _unported("signal_preemption")
