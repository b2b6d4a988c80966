"""Preemption signalling for the supervised training loop.

A copy of ``paddle_tpu/train/preemption.py``. A preemptible job gets a
signal and a bounded grace window: a process-wide flag, polled by
``TrainingSupervisor`` at every slab boundary, turns the next boundary
into a bounded-deadline fast checkpoint and a typed
:class:`~paddle_tpu_torch.resilience.PreemptedError`. The flag is raised
by a signal while :func:`signal_preemption` is active (SIGTERM/SIGINT;
handlers are installed only on the main thread and restored on exit) or
by :func:`request_preemption` from any thread. A supervisor restart does
not clear it (the scheduler is still coming for the process).
"""
import signal
import threading
from contextlib import contextmanager

from ..resilience import PreemptedError  # noqa: F401  (re-export surface)

_preempt = threading.Event()
_reason = [None]


def request_preemption(reason="requested"):
    """Raise the process-wide preemption flag. Safe from any thread and
    from signal handlers; idempotent (the first reason wins).

    Deliberately LOCK-FREE: a handler for a second signal can run on
    the main thread between any two bytecodes of the first handler, so
    taking a non-reentrant lock here could deadlock the process inside
    its own SIGTERM grace window. The check-then-set below is benign to
    race — at worst a near-simultaneous second trigger's reason wins."""
    if _reason[0] is None:
        _reason[0] = str(reason)
    _preempt.set()


def preemption_requested():
    """True once a preemption has been requested and not cleared."""
    return _preempt.is_set()


def preemption_reason():
    """The first recorded trigger ("signal SIGTERM", "requested", ...)
    or None."""
    return _reason[0]


def clear_preemption():
    """Drop the flag — for tests and for a fresh training run in a
    process that previously handled a preemption."""
    _reason[0] = None
    _preempt.clear()


@contextmanager
def signal_preemption(signals=(signal.SIGTERM, signal.SIGINT)):
    """Route the given signals into :func:`request_preemption` while the
    block runs. On a non-main thread this is a no-op passthrough (Python
    only delivers signals to the main thread, and ``signal.signal``
    refuses elsewhere). Prior handlers are restored on exit, so a
    Ctrl-C AFTER training is a normal KeyboardInterrupt again."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = {}

    def _handler(signum, frame):
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        request_preemption(reason=f"signal {name}")

    for s in signals:
        prev[s] = signal.signal(s, _handler)
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
