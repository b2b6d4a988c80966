"""Full-training-state checkpoints for exact resume (a copy of
``paddle_tpu/train/checkpoint.py``).

:class:`TrainCheckpoint` puts the exact-resume contract on
``io.CheckpointSaver`` (numbered, staged, manifest-checked, atomically
renamed directories): each checkpoint holds the params, the optimizer
state, the run seed and the dataset cursor (``train_state.json``), all
under the manifest. ``save(async_save=True)`` gathers host copies of the
scope before it returns and writes on a thread, so the step loop pays
only the gather. :meth:`restore_latest` walks the checkpoints newest
first and skips a corrupt or incomplete one, raising only when none is
usable.
"""
from .. import io as _io
from ..resilience import CheckpointCorruptError

TRAIN_STATE_FILE = _io.TRAIN_STATE_FILE


class TrainCheckpoint:
    """Numbered full-training-state checkpoints under ``dirname``."""

    def __init__(self, dirname, max_to_keep=5,
                 prefix="__train_checkpoint__"):
        self.saver = _io.CheckpointSaver(dirname, max_to_keep=max_to_keep,
                                         prefix=prefix)
        self.dirname = dirname

    def save(self, executor, program=None, scope=None, train_state=None,
             async_save=False):
        """Save a numbered checkpoint; returns its number. With
        ``async_save`` the files are written in the background (call
        :meth:`wait` before relying on them)."""
        extra = {TRAIN_STATE_FILE: dict(train_state or {})}
        if async_save:
            return self.saver.save_async(executor, main_program=program,
                                         scope=scope, extra_files=extra)
        return self.saver.save(executor, main_program=program,
                               scope=scope, extra_files=extra)

    def wait(self):
        """Join the pending background saves; raises the first
        failure."""
        self.saver.wait()

    def latest_no(self):
        return self.saver.latest()[0]

    def restore_latest(self, executor, program=None, scope=None):
        """Load the newest usable checkpoint into ``scope`` for exact
        resume. Returns ``(number, train_state)``, or ``(None, None)``
        when the directory holds none. A corrupt, incomplete or
        partially written checkpoint is skipped with a message, newest
        first; when every one fails, the last error is raised."""
        last_exc = None
        for no in reversed(self.saver.checkpoint_numbers()):
            path = self.saver._path(no)
            try:
                state = _io.load_checkpoint(executor, path,
                                            main_program=program,
                                            scope=scope)
                return no, (state or {})
            except (CheckpointCorruptError, RuntimeError) as exc:
                last_exc = exc
                print(f"[train] checkpoint {path} unusable "
                      f"({type(exc).__name__}: {exc}); trying the "
                      f"previous one")
        if last_exc is not None:
            raise last_exc
        return None, None
