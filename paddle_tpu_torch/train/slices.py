"""SliceSupervisor: multi-slice elastic training with slice-loss
remediation (a copy of ``paddle_tpu/train/slices.py`` over the port's
:class:`~paddle_tpu_torch.train.supervisor.TrainingSupervisor`).

The outer data-parallel axis, ``dcn_dp``, crosses slices, and losing a
slice is a routine event (a drain, a link flap, a preempted
reservation), not an outage:

- every slice reports liveness by :meth:`SliceSupervisor.beat`; a slice
  whose last beat is older than ``FLAGS_slice_heartbeat_timeout_s`` for
  ``FLAGS_slice_window`` consecutive :meth:`SliceSupervisor.tick`
  observations is lost (hysteresis: one missed beat never changes the
  membership);
- a persistent failure of the collective across slices (the inner
  supervisor's restart budget spent on ``train.allreduce_dcn``) shrinks
  at once, blaming the stalest slice;
- a change drains, never kills: the loop requests a preemption, the
  inner supervisor writes its fast checkpoint at the next slab boundary,
  then the program is rebuilt at the new ``dcn_dp`` width and the
  checkpoint restored, so no slab is dropped or trained twice (the
  cursor is the global slab index and the global batch stays the same:
  a narrower mesh gives each card more rows);
- a lost slice whose beats come back fresh for a full window, after
  ``FLAGS_slice_cooldown_s`` of quiet, regrows through the same drain,
  checkpoint and rebuild.

Every second of a change is charged to the goodput ledger's
``recovery`` category; each change is a ``slice_lost`` or
``slice_rejoined`` flight event with its seconds, and the
``train_slices_count{state}`` gauge and the
``train_slice_events_total{event}`` counter keep the history.

**One process a card.** The JAX package is one controller. Here each
rank of a launched world runs its own supervisor over its rows, so:

- **one decision for every rank**: at every slab boundary every world
  rank takes part in one exchange over a gloo group of the world (made
  when the supervisors are, on every rank together): each sends the
  beats it recorded (a rank beats for its own slice at each exchange,
  through the ``train.slice_heartbeat`` fault point), world rank 0
  merges them, runs :meth:`tick` and sends its decision back, and every
  rank applies it at that same boundary;
- **the ranks of a lost slice stay in the loop** without training: they
  take part in each exchange (their beats tell when the slice is back),
  and on a regrow they restore from the shared checkpoint and rejoin;
- **the narrower meshes' process groups** are made right after the
  first build, while every rank is alive: one mesh
  (``make_mesh(..., devices=...)``) for each set of slices the run can
  shrink to.

``build(dcn_dp, devices)`` returns the executor and program (and the
startup program and scope) for that width over ``devices``, the world
ranks of the active slices in slice order (None outside a launched
world): pass them to ``make_mesh``. Each global slab ``[K, B, ...]`` is
cut to the rank's rows of its current mesh (data coordinate ``c * dp +
d`` of ``dcn_dp x dp``, by ``split``) before it runs. A process that is
killed rather than drained fails its group's collectives: surviving
that needs a new rendezvous (a new launch), which this loop does not
do.
"""
import itertools
import time
from collections import deque

import numpy as np

from ..flags import flag as _flag
from ..observability.goodput import GoodputLedger
from ..observability.metrics import default_registry as _registry
from ..observability.recorder import flight_recorder as _flightrec
from ..resilience import (FaultInjected, PreemptedError,
                          RestartBudgetExceeded, SliceWidthError,
                          maybe_fail)
from . import preemption as _preempt
from .supervisor import TrainingSupervisor

_M_SLICES = _registry().gauge(
    "train_slices_count",
    "slices by membership state (active participates in dcn_dp, lost "
    "is awaiting regrow)",
    labels=("state",), max_series=4)
_M_SLICE_EVENTS = _registry().counter(
    "train_slice_events_total",
    "slice membership changes applied by the SliceSupervisor",
    labels=("event",), max_series=4)

SHRINK_REASON = "slice_shrink"
REGROW_REASON = "slice_regrow"


def validate_restored_widths(scope, program, width):
    """Every persistable a restore put in ``scope`` must have the shape
    the ``dcn_dp=width`` program declares (dynamic ``-1``/None dims
    skipped); a mismatch raises :class:`SliceWidthError` naming the
    variable instead of failing later with a shape error."""
    gb = program.global_block()
    for name, var in gb.vars.items():
        if not getattr(var, "persistable", False):
            continue
        declared = getattr(var, "shape", None)
        val = scope.find_var(name)
        if declared is None or val is None or not hasattr(val, "shape"):
            continue
        found = tuple(int(d) for d in val.shape)
        ok = len(found) == len(declared) and all(
            d in (-1, None) or int(f) == int(d)
            for f, d in zip(found, declared))
        if not ok:
            raise SliceWidthError(
                f"restored state {name!r} has shape {found} but the "
                f"dcn_dp={width} program declares {tuple(declared)}: the "
                f"checkpoint was written for another program or width, "
                f"and state does not reshard on a restore. Restore it at "
                f"the width it was written at, or point the "
                f"SliceSupervisor at the matching checkpoint_dir.",
                var=name, found=found, expected=declared)


class _WidthStampedSupervisor(TrainingSupervisor):
    """A TrainingSupervisor whose checkpoints record the ``dcn_dp`` width
    they were written at, and which times its preemption exit."""

    def __init__(self, *args, dcn_dp=1, **kwargs):
        super().__init__(*args, **kwargs)
        self.dcn_dp = int(dcn_dp)
        self.preempt_exit_s = None

    def _train_state(self, epoch, batches, slab, step, base_seed):
        st = super()._train_state(epoch, batches, slab, step, base_seed)
        st["dcn_dp"] = self.dcn_dp
        return st

    def _preempt_exit(self, *args):
        t0 = time.perf_counter()
        try:
            super()._preempt_exit(*args)
        finally:
            self.preempt_exit_s = time.perf_counter() - t0


def even_split(slab, index, count):
    """Part ``index`` of ``count`` equal parts of dim 1 (the rows) of
    every array of a slab ``[K, B, ...]``."""
    out = {}
    for k, v in slab.items():
        b = np.shape(v)[1] // count
        out[k] = v[:, index * b:(index + 1) * b]
    return out


class _Rows:
    """The rows of each global slab that this rank's mesh feeds it."""

    def __init__(self, slabs, mesh, split):
        self.slabs, self.mesh, self.split = slabs, mesh, split

    def __len__(self):
        return len(self.slabs)

    def __getitem__(self, i):
        slab = self.slabs[i]
        if self.mesh is None:
            return slab
        from ..parallel.mesh import DATA_AXIS
        return self.split(slab, self.mesh.coords()[DATA_AXIS],
                          self.mesh.axis_size(DATA_AXIS))


class SliceSupervisor:
    """The slice-membership control loop over a rebuildable training run.

    ``build(dcn_dp, devices) -> dict`` returns at least ``executor`` and
    ``program`` (and optionally ``startup_program`` and ``scope``) for
    that width (the module docstring says what ``devices`` is);
    ``supervisor_kwargs`` go to the inner :class:`TrainingSupervisor`
    (``checkpoint_every_n_slabs=1`` makes changes replay nothing).
    ``split(slab, index, count)`` gives the rank at data coordinate
    ``index`` of ``count`` its part of a global slab (default
    :func:`even_split`; a feed of flattened indices needs its own, e.g.
    ``models.bert.split_batch(slab, index, count, axis=1)``).
    ``clock`` is injectable (a fake clock in tests; in a launched world
    every rank's clock must agree, as ``time.monotonic`` does on one
    host)."""

    def __init__(self, build, checkpoint_dir, *, slices=2, min_slices=1,
                 heartbeat_timeout_s=None, window=None, cooldown_s=None,
                 clock=time.monotonic, split=even_split,
                 **supervisor_kwargs):
        if int(slices) < int(min_slices) or int(min_slices) < 1:
            raise ValueError(
                f"need slices >= min_slices >= 1, got slices={slices} "
                f"min_slices={min_slices}")
        from ..parallel import mesh as _mesh
        self.build = build
        self.checkpoint_dir = checkpoint_dir
        self.total_slices = int(slices)
        self.min_slices = int(min_slices)
        self.heartbeat_timeout_s = float(
            heartbeat_timeout_s if heartbeat_timeout_s is not None
            else _flag("slice_heartbeat_timeout_s"))
        self.window = max(1, int(window if window is not None
                                 else _flag("slice_window")))
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else _flag("slice_cooldown_s"))
        self._clock = clock
        self._split = split
        self._kwargs = dict(supervisor_kwargs)
        self._user_on_slab_end = self._kwargs.pop("on_slab_end", None)
        # a launched world: one process a card, the slices consecutive
        # blocks of ranks
        self.world = _mesh.world_size() if _mesh.is_initialized() else 1
        self.rank = _mesh.rank()
        self._group = None
        if self.world > 1:
            if self.world % self.total_slices:
                raise ValueError(f"{self.total_slices} slices over a world "
                                 f"of {self.world} ranks")
            import torch.distributed as dist
            from datetime import timedelta
            self._group = dist.new_group(backend="gloo",
                                         timeout=timedelta(hours=2))
        self.per_slice = max(self.world // self.total_slices, 1)
        self.slice = self.rank // self.per_slice if self.world > 1 else 0
        self.rounds = 0
        now = self._clock()
        self._active = list(range(self.total_slices))
        self._lost = []
        self._beats = {s: now for s in self._active}
        self._outbox = {}
        self._last_change_t = None
        self._pending = None          # ("shrink"|"regrow", slice_id)
        self._change_t = None
        self._reset_windows()
        self.supervisor = None
        self.events = []              # applied changes, oldest first
        self._update_gauges()

    # -- membership state --------------------------------------------------
    @property
    def width(self):
        """The current ``dcn_dp`` degree (the number of active
        slices)."""
        return len(self._active)

    @property
    def active_slices(self):
        return tuple(self._active)

    @property
    def lost_slices(self):
        return tuple(self._lost)

    def devices(self, active=None):
        """The world ranks of ``active`` slices (default: the current
        ones), in slice order; None outside a launched world."""
        if self.world == 1:
            return None
        return [s * self.per_slice + i for s in sorted(
            self._active if active is None else active)
            for i in range(self.per_slice)]

    def _training(self):
        return self.world == 1 or self.slice in self._active

    def _reset_windows(self):
        self._stale_hist = {s: deque(maxlen=self.window)
                            for s in self._active}
        self._fresh_hist = {s: deque(maxlen=self.window)
                            for s in self._lost}

    def _update_gauges(self):
        _M_SLICES.set(len(self._active), labels=("active",))
        _M_SLICES.set(len(self._lost), labels=("lost",))

    # -- liveness ----------------------------------------------------------
    def beat(self, slice_id, now=None):
        """Record a heartbeat from ``slice_id``. Returns False when the
        beat was dropped (the ``train.slice_heartbeat`` fault point
        raised: a dead slice); a ``delay=`` there makes the beat land
        late, as a straggling slice's would."""
        try:
            maybe_fail("train.slice_heartbeat", slice=slice_id,
                       round=self.rounds)
        except FaultInjected:
            return False
        t = self._clock() if now is None else now
        self._beats[slice_id] = t
        self._outbox[slice_id] = t
        return True

    def _decide(self, now):
        """The change a full window asks for, outside the cooldown and
        with none draining: ``(action, slice_id)`` or None."""
        cut = now - self.heartbeat_timeout_s
        for s in self._active:
            self._stale_hist[s].append(
                self._beats.get(s, float("-inf")) < cut)
        for s in self._lost:
            self._fresh_hist[s].append(
                self._beats.get(s, float("-inf")) >= cut)
        if self._pending is not None:
            return None               # a change is already draining
        if self._last_change_t is not None and \
                now - self._last_change_t < self.cooldown_s:
            return None
        # shrink outranks regrow: a dead slice stalls every collective
        # across slices
        if len(self._active) > self.min_slices:
            for s in list(self._active):
                h = self._stale_hist[s]
                if len(h) == h.maxlen and all(h):
                    return ("shrink", s)
        if len(self._active) < self.total_slices:
            for s in list(self._lost):
                h = self._fresh_hist[s]
                if len(h) == h.maxlen and all(h):
                    return ("regrow", s)
        return None

    def tick(self, now=None):
        """One control-loop observation: each slice's staleness into its
        hysteresis window, and (outside the cooldown, one change at a
        time) a drain-aware shrink (an active slice stale for a full
        window) or regrow (a lost slice fresh for a full window)
        requested. Returns the requested ``(action, slice_id)`` or None.
        Run at every slab boundary while :meth:`run_slabs` is active (by
        world rank 0 in a launched world)."""
        d = self._decide(self._clock() if now is None else now)
        return self._request(*d) if d else None

    def _request(self, action, slice_id):
        self._pending = (action, slice_id)
        self._change_t = time.perf_counter()
        reason = SHRINK_REASON if action == "shrink" else REGROW_REASON
        # drain, don't kill: the inner supervisor exits at the next slab
        # boundary through its bounded-deadline fast checkpoint
        _preempt.request_preemption(reason)
        return (action, slice_id)

    def _stalest_active(self):
        return min(self._active,
                   key=lambda s: self._beats.get(s, float("-inf")))

    def _exchange(self, done=False, failed=False):
        """The slab boundary's decision, the same on every rank: a change
        requested (``(action, slice)``), ``"done"``, ``"raise"`` (a
        failure no shrink can absorb) or None. In a launched world every
        world rank takes part (module docstring)."""
        self.rounds += 1
        if self.world == 1:
            if failed:
                return self._on_failure()
            return "done" if done else self.tick()
        import torch.distributed as dist
        self.beat(self.slice)
        got = [None] * self.world
        dist.all_gather_object(got, (self._outbox, done, failed),
                               group=self._group)
        self._outbox = {}
        box = [None]
        if self.rank == 0:
            for beats, _, _ in got:
                for s, t in beats.items():
                    self._beats[s] = max(self._beats.get(s, t), t)
            if any(f for _, _, f in got):
                box[0] = self._failure_decision()
            elif any(d for _, d, _ in got):
                box[0] = "done"
            else:
                box[0] = self._decide(self._clock())
        dist.broadcast_object_list(box, src=0, group=self._group)
        d = box[0]
        if isinstance(d, tuple):
            self._request(*d)
        return d

    def _failure_decision(self):
        if len(self._active) > self.min_slices:
            return ("shrink", self._stalest_active())
        return "raise"

    def _on_failure(self):
        d = self._failure_decision()
        if isinstance(d, tuple):
            self._pending = d
            self._change_t = time.perf_counter()
        return d

    # -- the supervised multi-width loop -----------------------------------
    def _on_slab_end(self, slab_idx, step, last_fetches):
        if self._user_on_slab_end is not None:
            self._user_on_slab_end(slab_idx, step, last_fetches)
        if self.events and self.events[-1].get("capture_s") is None:
            cs = self.supervisor.executor.cache_stats()
            self.events[-1]["capture_s"] = \
                (cs["capture_ms"] - self._capture_ms0) / 1e3
        self._exchange()

    def _premake_meshes(self, parts):
        """The meshes of every narrower set of slices, made by every
        world rank now, while all are alive (their process groups)."""
        mesh = getattr(parts["program"], "mesh", None)
        if self.world == 1 or mesh is None:
            return
        from ..parallel.mesh import MeshConfig, make_mesh
        for k in range(self.total_slices - 1, self.min_slices - 1, -1):
            for sub in itertools.combinations(range(self.total_slices), k):
                make_mesh(MeshConfig(dcn_dp=k, dp=mesh.dp, tp=mesh.tp,
                                     sp=mesh.sp, pp=mesh.pp, ep=mesh.ep),
                          devices=self.devices(sub))

    def _make_supervisor(self, width):
        from ..framework import unique_name
        from ..parallel import mesh as _mesh
        first = self.supervisor is None and not self.events
        if self.supervisor is not None:
            # the old width's captured steps and their pools go first
            self.supervisor.executor.close()
            self.supervisor = None
            _release()
        if not self._training():
            _mesh.activate(None)
            return None
        t0 = time.perf_counter()
        # a fresh unique-name generator per build: the rebuilt program's
        # variables carry the names the checkpoint was written under
        with unique_name.guard():
            parts = self.build(width, self.devices())
        if first:
            self._premake_meshes(parts)
        sup = _WidthStampedSupervisor(
            parts["executor"], parts["program"], self.checkpoint_dir,
            startup_program=parts.get("startup_program"),
            scope=parts.get("scope"), dcn_dp=width,
            on_slab_end=self._on_slab_end, **self._kwargs)
        t1 = time.perf_counter()
        mesh = getattr(parts["program"], "mesh", None)
        _mesh.activate(mesh)       # the mesh the restore's ranks follow
        state = sup.resume()
        if state is not None:
            validate_restored_widths(sup.scope, sup._plain_program, width)
        self._timing = {"rebuild_s": t1 - t0,
                        "restore_s": time.perf_counter() - t1}
        self._capture_ms0 = parts["executor"].cache_stats()["capture_ms"]
        self._mesh = mesh if self.world > 1 else None
        self.supervisor = sup
        return sup

    def _apply_pending(self, drain_s=None, checkpoint_s=None):
        action, s = self._pending
        self._pending = None
        event = "slice_lost" if action == "shrink" else "slice_rejoined"
        if action == "shrink":
            self._active.remove(s)
            self._lost.append(s)
        else:
            self._lost.remove(s)
            self._active.append(s)
            self._active.sort()
        self._reset_windows()
        width = len(self._active)
        if self._group is not None:
            # the fast checkpoint is written before anyone restores it
            import torch.distributed as dist
            dist.barrier(group=self._group)
        t0 = time.perf_counter()
        self._timing = {}
        self._make_supervisor(width)
        dt = time.perf_counter() - t0
        # the registry-wide recovery counters see every second of it
        GoodputLedger().add("recovery", dt)
        self._last_change_t = self._clock()
        rec = {"event": event, "slice": int(s), "dcn_dp": width,
               "recovery_s": dt, "drain_s": drain_s,
               "checkpoint_s": checkpoint_s, **self._timing,
               "capture_s": None if self.supervisor is not None else 0.0}
        self.events.append(rec)
        _M_SLICE_EVENTS.inc(labels=(event,))
        self._update_gauges()
        _flightrec().record(event, slice=int(s), dcn_dp=width,
                            recovery_s=round(dt, 6))
        print(f"[slices] {event}: slice {s} -> dcn_dp={width} "
              f"(recovery {dt * 1e3:.0f}ms; active "
              f"{list(self._active)}, lost {list(self._lost)})")

    def _idle(self):
        """The loop of a rank whose slice is lost: one exchange a slab
        boundary of the training ranks until the run is done (returns
        "done") or a change (a regrow) is decided."""
        while True:
            d = self._exchange()
            if d in ("done", "raise") or isinstance(d, tuple):
                return d

    def run_slabs(self, slabs, fetch_list=None, collect_fetches=False):
        """Run the global slabs to the end across membership changes:
        each drain restores from the slab-boundary checkpoint into the
        rebuilt width and continues at the global cursor. Returns the
        final segment's result extended with ``dcn_dp`` (the final
        width) and ``slice_events`` (every change applied, with its
        recovery seconds: ``recovery_s`` the rebuild and restore, as the
        JAX package's, beside ``drain_s``, ``checkpoint_s``,
        ``rebuild_s``, ``restore_s`` and ``capture_s``). A rank whose
        slice is lost at the end returns ``{"idle": True, ...}``."""
        slabs = list(slabs)
        if self.supervisor is None and not self.events:
            self._make_supervisor(self.width)
        while True:
            drain_s = checkpoint_s = None
            if not self._training() and self._pending is None:
                d = self._idle()
                if d == "done":
                    return {"idle": True, "dcn_dp": self.width,
                            "slice_events": list(self.events)}
                if d == "raise":
                    raise RestartBudgetExceeded(
                        "the collective across slices kept failing and "
                        "no slice can be shrunk away (min_slices)")
            if self._pending is not None:
                # a change requested between runs (or carried out of a
                # failed segment) applies before more work
                if _preempt.preemption_reason() in (SHRINK_REASON,
                                                    REGROW_REASON):
                    _preempt.clear_preemption()
                if self._change_t is not None:
                    drain_s = time.perf_counter() - self._change_t
                if self.supervisor is not None:
                    checkpoint_s = self.supervisor.preempt_exit_s
                self._apply_pending(drain_s, checkpoint_s)
                continue
            try:
                result = self.supervisor.run_slabs(
                    _Rows(slabs, self._mesh, self._split),
                    fetch_list=fetch_list,
                    collect_fetches=collect_fetches)
            except PreemptedError as exc:
                if exc.reason in (SHRINK_REASON, REGROW_REASON) \
                        and self._pending is not None:
                    _preempt.clear_preemption()
                    continue          # the loop head applies the change
                raise                 # a real preemption (signal, user)
            except (RestartBudgetExceeded, FaultInjected) as exc:
                # the inner restart loop absorbs transient faults; a
                # budget spent on the collective across slices means a
                # slice is unreachable: shrink it away (every rank fails
                # alike and takes part in the decision)
                if "train.allreduce_dcn" in str(exc):
                    d = self._exchange(failed=True)
                    if isinstance(d, tuple):
                        continue
                raise
            d = self._exchange(done=True)
            result["dcn_dp"] = self.width
            result["slice_events"] = list(self.events)
            return result


def _release():
    """Free the card's cached blocks after a rebuild dropped the old
    width's graphs."""
    import gc
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


__all__ = ["SliceSupervisor", "even_split", "validate_restored_widths"]
