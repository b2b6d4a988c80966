"""Elastic training (a copy of ``paddle_tpu/train``):
:class:`TrainingSupervisor` (a killable, exactly
resumable supervised loop: periodic checkpoints, preemption with a
bounded-deadline fast save, watchdogged slabs and budgeted restarts from
the newest verified checkpoint, the goodput ledger), the preemption API
(``request_preemption``, ``preemption_requested``,
``preemption_reason``, ``clear_preemption``, ``signal_preemption``),
:class:`HealthMonitor` (loss and grad-norm spike rules on in-graph
fetches), :class:`TrainCheckpoint` (numbered full-training-state
checkpoints), :class:`SliceSupervisor` and
:func:`validate_restored_widths` (multi-slice training: slices lost and
regrown at a slab boundary, ``train.slices``) and the typed errors of
the loop.
"""
from ..resilience import (  # noqa: F401  (typed error surface)
    CheckpointIncompleteError, PreemptedError, RestartBudgetExceeded,
    SliceWidthError, WatchdogTimeout,
)
from .checkpoint import TRAIN_STATE_FILE, TrainCheckpoint  # noqa: F401
from .health import HealthMonitor  # noqa: F401
from .preemption import (  # noqa: F401
    clear_preemption, preemption_reason, preemption_requested,
    request_preemption, signal_preemption,
)
from .supervisor import TrainingSupervisor  # noqa: F401
from .slices import SliceSupervisor, validate_restored_widths  # noqa: F401
