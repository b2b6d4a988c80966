"""Elastic training (a copy of ``paddle_tpu/train`` without the
multi-slice part): :class:`TrainingSupervisor` (a killable, exactly
resumable supervised loop: periodic checkpoints, preemption with a
bounded-deadline fast save, watchdogged slabs and budgeted restarts from
the newest verified checkpoint, the goodput ledger), the preemption API
(``request_preemption``, ``preemption_requested``,
``preemption_reason``, ``clear_preemption``, ``signal_preemption``),
:class:`HealthMonitor` (loss and grad-norm spike rules on in-graph
fetches), :class:`TrainCheckpoint` (numbered full-training-state
checkpoints) and the typed errors of the loop.

Not ported, and raising ``NotImplementedError``: ``SliceSupervisor`` and
``validate_restored_widths`` (multi-slice meshes, ROADMAP Queue 1 item
7b).
"""
from ..resilience import (  # noqa: F401  (typed error surface)
    CheckpointIncompleteError, PreemptedError, RestartBudgetExceeded,
    WatchdogTimeout,
)
from .checkpoint import TRAIN_STATE_FILE, TrainCheckpoint  # noqa: F401
from .health import HealthMonitor  # noqa: F401
from .preemption import (  # noqa: F401
    clear_preemption, preemption_reason, preemption_requested,
    request_preemption, signal_preemption,
)
from .supervisor import TrainingSupervisor  # noqa: F401


def _unported(name):
    def _raise(*args, **kwargs):
        raise NotImplementedError(
            f"paddle_tpu_torch: train.{name} is not ported: it needs "
            f"multi-slice meshes (ROADMAP Queue 1 item 7b)")
    _raise.__name__ = name
    return _raise


SliceSupervisor = _unported("SliceSupervisor")
validate_restored_widths = _unported("validate_restored_widths")
