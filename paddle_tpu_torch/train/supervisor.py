"""TrainingSupervisor: a killable and exactly resumable training loop.

Counterpart of ``paddle_tpu/train/supervisor.py``. A ``run_steps`` or
``train_from_dataset``-shaped loop under supervision, with bitwise
resume: a run killed at slab k and resumed continues exactly where the
uninterrupted run would be (params, optimizer state, the run seed, the
reported losses), because each checkpoint
(:class:`~paddle_tpu_torch.train.checkpoint.TrainCheckpoint`) carries
every persistable, the run seed and the dataset cursor (epoch, batches
consumed, slab, shuffle seed).

- **checkpoints** every ``FLAGS_checkpoint_every_n_slabs`` slabs,
  written in the background (the loop pays the host gather);
- **preemption**: SIGTERM/SIGINT (``handle_signals=True``) or
  :func:`~paddle_tpu_torch.train.preemption.request_preemption` raise a
  flag polled at every slab boundary; the next boundary saves a fast
  checkpoint within ``FLAGS_preempt_deadline_s`` (a save past it is
  abandoned through ``io.CheckpointSaver.abandon_inflight`` and the
  previous checkpoint stands) and raises ``PreemptedError``;
- **supervision**: each slab optionally runs under
  ``resilience.run_with_watchdog`` (``step_watchdog_s``); any crash (the
  watchdog, a fault, a non-finite step, a failed checkpoint write)
  restarts the loop from the newest verified checkpoint on a fresh
  ``Scope``, with capped exponential backoff, up to
  ``FLAGS_train_restart_budget`` restarts (then ``RestartBudgetExceeded``
  chains the last failure). After a watchdog trip the old scope is
  deposed (``Scope.depose``): the abandoned worker, should its slab
  reach dispatch later, refuses to run instead of taking the captured
  step's lock or writing the state the restarted run shares with it. A
  restart reuses the executor's captured step (it binds the fresh
  scope's tensors into the step's statics): no new capture;
- **rollback**: ``skip_nonfinite_steps`` passes through to ``run_steps``
  and composes with resume;
- **health** (``health_every_n``): ``train.health.HealthMonitor``.

The goodput ledger (``observability.goodput``) attributes the run's wall
time (``goodput_report()``): the ``compile`` share is the executor's
pass, verify and capture ms of the slabs that built a captured step.
Telemetry: the ``train_slab_ms`` and ``train_checkpoint_ms`` histograms,
``train_checkpoints_total``, ``train_restarts_total``,
``train_preemptions_total`` and ``checkpoint``, ``train_restart`` and
``preempted`` flight events. Fault points on a slab's path:
``train.dispatch`` and ``train.h2d`` (executor), ``dataio.producer``
(dataset), ``io.fsync_write``, ``io.fsync``, ``io.rename`` and
``io.commit`` (checkpoints).
"""
import time
from contextlib import nullcontext

import numpy as np

from ..flags import flag as _flag
from ..framework.executor import Scope, device_put_slab, global_scope
from ..observability.goodput import GoodputLedger
from ..observability.metrics import default_registry as _registry
from ..observability.recorder import flight_recorder as _flightrec
from ..resilience import (PreemptedError, RestartBudgetExceeded,
                          WatchdogTimeout, run_with_watchdog)
from .checkpoint import TrainCheckpoint
from . import preemption as _preempt

_M_SLAB_MS = _registry().histogram(
    "train_slab_ms",
    "wall ms per supervised fused slab (dispatch + any guard sync)",
    bounds=(1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
            1000.0, 2500.0, 5000.0, 10000.0, 30000.0))
_M_CKPT_MS = _registry().histogram(
    "train_checkpoint_ms",
    "wall ms per training checkpoint save (critical-path half: the "
    "synchronous gather for async saves, the full write otherwise)",
    bounds=(5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
            2500.0, 5000.0, 10000.0, 30000.0))
_M_CKPTS = _registry().counter(
    "train_checkpoints_total", "training checkpoints saved")
_M_RESTARTS = _registry().counter(
    "train_restarts_total", "supervised training-loop restarts")
_M_PREEMPTIONS = _registry().counter(
    "train_preemptions_total", "preemption exits (typed PreemptedError)")


class _ListSlabIter:
    """Position-tracking iterator over a prestacked list of feed slabs —
    the ``run_steps`` twin of the dataset position API."""

    def __init__(self, slabs, start=0, epoch=0):
        self._slabs = list(slabs)
        self._i = int(start)
        self._epoch = int(epoch)
        self._skipped = int(start)

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._slabs):
            raise StopIteration
        out = self._slabs[self._i]
        self._i += 1
        return out

    def position(self):
        return {"epoch": self._epoch, "batches": self._i,
                "slabs": self._i, "skipped": self._skipped,
                "shuffle_seed": None}


class TrainingSupervisor:
    """Supervised, preemption-aware, exactly-resumable training loop.

    ``program`` may be a plain Program or a data-parallel
    ``CompiledProgram``. ``scope`` defaults to the global scope; after a
    restart the supervisor continues on a fresh internal scope: read
    ``sup.scope`` for the live one.
    """

    def __init__(self, executor, program, checkpoint_dir, *,
                 startup_program=None, scope=None, steps_per_run=None,
                 checkpoint_every_n_slabs=None, preempt_deadline_s=None,
                 restart_budget=None, max_to_keep=5, step_watchdog_s=0.0,
                 restart_backoff=0.05, max_backoff=2.0,
                 handle_signals=False, skip_nonfinite_steps=False,
                 shuffle_each_epoch=False, on_slab_end=None,
                 health_every_n=None, health_rules=None,
                 on_health_breach=None):
        self.executor = executor
        self.program = program
        self.startup_program = startup_program
        self._scope = scope or global_scope()
        self.steps_per_run = int(steps_per_run if steps_per_run is not None
                                 else max(1, _flag("steps_per_run")))
        self.checkpoint_every_n_slabs = int(
            checkpoint_every_n_slabs if checkpoint_every_n_slabs is not None
            else _flag("checkpoint_every_n_slabs"))
        self.preempt_deadline_s = float(
            preempt_deadline_s if preempt_deadline_s is not None
            else _flag("preempt_deadline_s"))
        self.restart_budget = int(restart_budget if restart_budget is not None
                                  else _flag("train_restart_budget"))
        self.step_watchdog_s = float(step_watchdog_s)
        self.restart_backoff = float(restart_backoff)
        self.max_backoff = float(max_backoff)
        self.handle_signals = bool(handle_signals)
        self.skip_nonfinite_steps = bool(skip_nonfinite_steps)
        self.shuffle_each_epoch = bool(shuffle_each_epoch)
        self.on_slab_end = on_slab_end
        self.checkpoint = TrainCheckpoint(checkpoint_dir,
                                          max_to_keep=max_to_keep)
        self._epoch0_order = None   # dataset load order, for reshuffles
        # a data-parallel program takes its rank's rows of the host
        # slab: no whole-slab prefetch to the device
        from ..parallel.compiler import CompiledProgram
        self._prefetch = not isinstance(program, CompiledProgram)
        self._plain_program = (program.program
                               if isinstance(program, CompiledProgram)
                               else program)
        # goodput ledger (one per supervised run; goodput_report()
        # reads the most recent) + replay watermark for the
        # restart-replay -> recovery attribution
        self._ledger = None
        self._max_slab_done = 0
        # model-health monitor (FLAGS_train_health_every_n; 0 = off:
        # nothing constructed, no ops added, fused path bitwise-unchanged)
        hn = int(health_every_n if health_every_n is not None
                 else _flag("train_health_every_n"))
        if hn > 0:
            from .health import HealthMonitor
            self.health = HealthMonitor(
                self._plain_program, every_n=hn, rules=health_rules,
                on_breach=on_health_breach)
        else:
            self.health = None

    @property
    def scope(self):
        """The live training scope (replaced by a fresh one after a
        watchdog restart deposes a possibly-still-running worker)."""
        return self._scope

    def goodput_report(self):
        """The goodput ledger's attribution of the current/most recent
        run (:meth:`~paddle_tpu.observability.goodput.GoodputLedger.
        report`), or None before the first run."""
        return self._ledger.report() if self._ledger is not None else None

    def health_report(self):
        """The model-health monitor's live snapshot (values, trailing
        EMAs, breached rules), or None when health monitoring is off."""
        return self.health.snapshot() if self.health is not None else None

    def _led_span(self, category):
        return (self._ledger.span(category)
                if self._ledger is not None else nullcontext())

    # -- public entry points ----------------------------------------------
    def resume(self):
        """Load the newest verified checkpoint into the scope. Returns
        its train_state dict, or None when starting fresh."""
        no, state = self.checkpoint.restore_latest(
            self.executor, program=self._plain_program, scope=self._scope)
        return state if no is not None else None

    def train(self, dataset, fetch_list=None, epochs=1,
              collect_fetches=False):
        """Supervised ``train_from_dataset``-shaped loop: ``dataset``
        provides ``batch_iterator(slab=K, position=...)`` (duck-typed
        datasets without those kwargs are wrapped). Auto-resumes from
        the newest checkpoint in ``checkpoint_dir`` when one exists."""
        k = self.steps_per_run

        def make_iter(cursor):
            try:
                return dataset.batch_iterator(slab=k, position=cursor)
            except TypeError:
                # duck-typed dataset: collate + position-wrap here
                from ..dataio.dataset import PositionedBatchIterator
                return PositionedBatchIterator(
                    iter(dataset.batch_iterator()), slab=k,
                    epoch=cursor.get("epoch", 0),
                    skip_batches=cursor.get("batches", 0))

        # a supervisor reused with a different dataset must not restore
        # the PREVIOUS dataset's load order on reshuffle
        self._epoch0_order = None
        return self._supervised(make_iter, dataset, fetch_list,
                                int(epochs), collect_fetches)

    def run_slabs(self, slabs, fetch_list=None, collect_fetches=False):
        """Supervised ``run_steps``-shaped loop over a prestacked list
        of feed slabs (each a dict with a leading K axis)."""
        slabs = list(slabs)

        def make_iter(cursor):
            # one prestacked slab == one "batch" in cursor units
            return _ListSlabIter(slabs, start=cursor.get("batches", 0),
                                 epoch=cursor.get("epoch", 0))

        return self._supervised(make_iter, None, fetch_list, 1,
                                collect_fetches)

    # -- the supervised outer loop ----------------------------------------
    def _supervised(self, make_iter, dataset, fetch_list, epochs,
                    collect_fetches):
        restarts = 0
        restart_errors = []
        recoveries_ms = []
        backoff = self.restart_backoff
        pending_recovery_t0 = None
        # collected fetches survive supervised restarts: slabs reported
        # before a crash WERE reported; the resumed attempt re-reports
        # from its checkpoint onward (later attempts win on overlap)
        fetches = {} if collect_fetches else None
        self._ledger = GoodputLedger().start()
        self._max_slab_done = 0
        try:
            while True:
                try:
                    result = self._attempt(make_iter, dataset, fetch_list,
                                           epochs, fetches,
                                           pending_recovery_t0,
                                           recoveries_ms)
                    result["restarts"] = restarts
                    result["restart_errors"] = list(restart_errors)
                    result["recoveries_ms"] = list(recoveries_ms)
                    self._ledger.stop()
                    result["goodput"] = self._ledger.report()
                    return result
                except (PreemptedError, KeyboardInterrupt):
                    raise
                except Exception as exc:  # noqa: BLE001 — supervised
                    restarts += 1         # restart
                    restart_errors.append(type(exc).__name__)
                    _M_RESTARTS.inc()
                    _flightrec().record("train_restart",
                                        error=type(exc).__name__,
                                        restarts=restarts)
                    if restarts > self.restart_budget:
                        raise RestartBudgetExceeded(
                            f"training crashed {restarts} time(s), "
                            f"exceeding the restart budget of "
                            f"{self.restart_budget} "
                            f"(FLAGS_train_restart_budget); last failure: "
                            f"{type(exc).__name__}: {exc}",
                            restarts=restarts,
                            errors=restart_errors) from exc
                    print(f"[train] supervised restart {restarts}/"
                          f"{self.restart_budget} after "
                          f"{type(exc).__name__}: {exc} (backoff "
                          f"{backoff * 1e3:.0f}ms)")
                    pending_recovery_t0 = time.monotonic()
                    with self._led_span("recovery"):
                        time.sleep(backoff)
                        backoff = min(backoff * 2.0, self.max_backoff)
                        # drain the crashed attempt's in-flight async
                        # saves BEFORE resuming: a stale parked failure
                        # must not re-raise at the next attempt's first
                        # wait() (a phantom crash burning restart
                        # budget), and resume() must not race a commit
                        # landing mid-restore
                        try:
                            self.checkpoint.wait()
                        except Exception as stale:  # noqa: BLE001
                            print(f"[train] dropping failed async "
                                  f"checkpoint from the crashed "
                                  f"attempt: {type(stale).__name__}: "
                                  f"{stale}")
                        # a fresh scope on every restart: a crash before
                        # the first checkpoint restarts from the bitwise
                        # fresh init, not half-trained state; after a
                        # watchdog trip the old scope is deposed, so its
                        # abandoned worker can never run a late slab
                        if isinstance(exc, WatchdogTimeout):
                            self._scope.depose(
                                f"watchdog restart {restarts}")
                        self._scope = Scope()
        finally:
            self._ledger.stop()

    # -- one attempt (fresh or resumed) -----------------------------------
    def _attempt(self, make_iter, dataset, fetch_list, epochs,
                 fetches, recovery_t0, recoveries_ms):
        # on a restarted attempt the reload/re-init is crash recovery;
        # on a fresh run it is startup (unattributed -> "other")
        is_restart = recovery_t0 is not None
        with self._led_span("recovery" if is_restart else "other"):
            state = self.resume()
            if state is None:
                self._fresh_init(dataset)
                state = {"epoch": 0, "batches": 0, "slab": 0, "step": 0,
                         "shuffle_base_seed": self._base_seed(dataset)}
        cursor_epoch = int(state.get("epoch", 0))
        cursor_batches = int(state.get("batches", 0))
        slab_idx = int(state.get("slab", 0))
        step = int(state.get("step", 0))
        base_seed = state.get("shuffle_base_seed")
        checkpoints = 0
        last_fetches = None
        every_n = max(1, self.checkpoint_every_n_slabs)
        # model-health fetch extension: built once (pure ops, dead on
        # non-health slabs -> those executables stay bitwise-unchanged)
        health_names = []
        if self.health is not None and self.health.every_n > 0:
            health_names = self.health.ensure_fetches(
                self._first_fetch_name(fetch_list))
        n_user = len(fetch_list) if fetch_list else 0
        with _preempt.signal_preemption() if self.handle_signals \
                else nullcontext():
            for epoch in range(cursor_epoch, max(1, epochs)):
                self._maybe_shuffle(dataset, base_seed, epoch)
                with self._led_span("recovery" if is_restart
                                    else "data_stall"):
                    # creating the iterator replays/skips the consumed
                    # prefix — lost-input work on a restart, input wait
                    # otherwise
                    it = make_iter({"epoch": epoch,
                                    "batches": cursor_batches,
                                    "shuffle_seed": base_seed})
                is_restart = False   # later epochs are normal progress
                cur, cur_pos = self._pull(it)
                while cur is not None:
                    if _preempt.preemption_requested():
                        self._preempt_exit(slab_idx, step, epoch,
                                           cursor_batches, base_seed)
                    nxt, nxt_pos = self._pull(it)
                    health_slab = bool(health_names) and \
                        self.health.is_health_slab(slab_idx)
                    fl = (list(fetch_list or []) + health_names
                          if health_slab else fetch_list)
                    out = self._run_slab(
                        cur, fl, replay=slab_idx < self._max_slab_done)
                    if health_slab:
                        self.health.observe(slab_idx, out[n_user:])
                        out = out[:n_user]
                    k = int(np.shape(next(iter(cur.values())))[0])
                    slab_idx += 1
                    self._max_slab_done = max(self._max_slab_done,
                                              slab_idx)
                    step += k
                    cursor_batches = int(cur_pos["batches"])
                    if recovery_t0 is not None:
                        recoveries_ms.append(
                            (time.monotonic() - recovery_t0) * 1e3)
                        recovery_t0 = None
                    if fetch_list:
                        last_fetches = [np.asarray(v) for v in out]
                        if fetches is not None:
                            fetches[slab_idx - 1] = last_fetches
                    if self.on_slab_end is not None:
                        self.on_slab_end(slab_idx, step, last_fetches)
                    if _preempt.preemption_requested():
                        self._preempt_exit(slab_idx, step, epoch,
                                           cursor_batches, base_seed)
                    if slab_idx % every_n == 0:
                        # CheckFreq staging: join the PREVIOUS persist
                        # (usually done), snapshot now, write async
                        with self._led_span("checkpoint"):
                            self.checkpoint.wait()
                        self._timed_save(
                            self._train_state(epoch, cursor_batches,
                                              slab_idx, step, base_seed),
                            async_save=True)
                        checkpoints += 1
                    cur, cur_pos = nxt, nxt_pos
                cursor_batches = 0
        # final durable checkpoint: next-epoch cursor, synchronous
        with self._led_span("checkpoint"):
            self.checkpoint.wait()
        final_no = self._timed_save(
            self._train_state(max(1, epochs), 0, slab_idx, step,
                              base_seed))
        result = {"slabs": slab_idx, "steps": step,
                  "epochs": max(1, epochs), "checkpoints": checkpoints + 1,
                  "checkpoint_no": final_no, "last_fetches": last_fetches}
        if fetches is not None:
            result["fetches"] = fetches
        return result

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _first_fetch_name(fetch_list):
        """The loss var name the health monitor reports: the first
        fetch target (the training-loop convention), or None."""
        for f in fetch_list or []:
            name = getattr(f, "name", f if isinstance(f, str) else None)
            if name:
                return str(name)
        return None

    def _timed_save(self, train_state, async_save=False,
                    ledger_cat="checkpoint"):
        """One checkpoint save with its critical-path duration landed in
        the ``train_checkpoint_ms`` histogram + a flight-recorder event
        + the goodput ledger (``ledger_cat=None`` when an enclosing
        span — the preemption exit — already owns the interval)."""
        t0 = time.perf_counter()
        try:
            no = self.checkpoint.save(
                self.executor, program=self._plain_program,
                scope=self._scope, train_state=train_state,
                async_save=async_save)
        finally:
            if self._ledger is not None and ledger_cat:
                self._ledger.add(ledger_cat,
                                 time.perf_counter() - t0)
        dt_ms = (time.perf_counter() - t0) * 1e3
        if (not async_save
                and no not in self.checkpoint.saver.checkpoint_numbers()):
            # the commit was abandoned mid-save (bounded-deadline
            # preemption gave up on this number): nothing durable
            # exists, so counting it would have the telemetry
            # contradict the adjacent "preempted" event
            return no
        _M_CKPT_MS.observe(dt_ms)
        _M_CKPTS.inc()
        _flightrec().record("checkpoint", no=no,
                            slab=train_state.get("slab"),
                            async_save=bool(async_save),
                            critical_path_ms=round(dt_ms, 3))
        return no

    def _train_state(self, epoch, batches, slab, step, base_seed):
        return {"epoch": epoch, "batches": batches, "slab": slab,
                "step": step, "shuffle_base_seed": base_seed,
                "steps_per_run": self.steps_per_run}

    @staticmethod
    def _base_seed(dataset):
        return getattr(dataset, "_seed", None)

    def _maybe_shuffle(self, dataset, base_seed, epoch):
        """Deterministic per-epoch reshuffle: the samples are reset to
        their load order and shuffled with seed = base + epoch, so the
        permutation depends only on (base_seed, epoch) — a resumed OR
        restarted run replays the SAME order the uninterrupted run drew
        for this epoch before skipping to the cursor, no matter how many
        shuffles the crashed attempt already applied in place."""
        if not self.shuffle_each_epoch or dataset is None:
            return
        shuffle = getattr(dataset, "local_shuffle", None)
        samples = getattr(dataset, "_samples", None)
        if shuffle is None or samples is None or base_seed is None:
            return
        if self._epoch0_order is None:
            self._epoch0_order = list(samples)
        dataset._samples = list(self._epoch0_order)
        dataset._seed = int(base_seed) + int(epoch)
        shuffle()

    def _fresh_init(self, dataset):
        """No checkpoint: run the startup program when the scope lacks
        any of the program's persistables (deterministic — the RNG chain
        reseeds from program.random_seed, so a from-scratch restart is
        bitwise the original fresh run)."""
        if self.startup_program is None:
            return
        gb = self._plain_program.global_block()
        missing = any(self._scope.find_var(v.name) is None
                      for v in gb.vars.values()
                      if getattr(v, "persistable", False)
                      and getattr(v, "type", None) not in ("reader",
                                                           "raw"))
        if missing:
            self.executor.run(self.startup_program, scope=self._scope)

    def _pull(self, it):
        """Advance the iterator and capture ITS position before the next
        prefetch moves it — the checkpoint after slab i must record the
        cursor at slab i, not at the prefetched slab i+1. The time the
        loop spends blocked in ``next`` is the goodput ledger's
        ``data_stall``; the device transfer is ``h2d`` (both spans are
        exception-safe so an injected producer/h2d fault still lands
        its elapsed time)."""
        with self._led_span("data_stall"):
            slab = next(it, None)
        if slab is None:
            return None, None
        pos = it.position()
        if self._prefetch:
            with self._led_span("h2d"):
                slab = device_put_slab(slab, self._plain_program,
                                       self.executor.device)
        return slab, pos

    # the executor's cache-miss costs: the JAX package's trace and XLA
    # compile ms are here the capture of the step
    _COMPILE_KEYS = ("pass_ms", "verify_ms", "capture_ms")

    def _run_slab(self, slab, fetch_list, replay=False):
        k = int(np.shape(next(iter(slab.values())))[0])
        kwargs = dict(feed=slab, fetch_list=fetch_list,
                      scope=self._scope, return_numpy=True,
                      skip_nonfinite_steps=self.skip_nonfinite_steps)
        from .. import profiler as _prof
        cs0 = (self.executor.cache_stats()
               if self._ledger is not None and not replay else None)
        t0 = time.perf_counter()
        try:
            with _prof.record_event("train/slab"):
                if self.step_watchdog_s > 0:
                    return run_with_watchdog(
                        self.executor.run_steps, self.step_watchdog_s,
                        self.program,
                        what=f"fused training slab ({k} steps)",
                        **kwargs)
                return self.executor.run_steps(self.program, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            _M_SLAB_MS.observe(dt * 1e3)
            if self._ledger is not None:
                if replay:
                    # re-running a slab the crash destroyed is
                    # restart-replay, not forward progress
                    self._ledger.add("recovery", dt)
                else:
                    # split the cache-miss pass/capture share out of
                    # the slab wall so steady state reports compute
                    cs1 = self.executor.cache_stats()
                    comp = sum(cs1[c] - cs0[c]
                               for c in self._COMPILE_KEYS) / 1e3
                    comp = min(max(comp, 0.0), dt)
                    if comp:
                        self._ledger.add("compile", comp)
                    self._ledger.add("compute", dt - comp)

    def _preempt_exit(self, slab_idx, step, epoch, batches, base_seed):
        """Bounded-deadline fast checkpoint, then typed exit. A save
        that misses ``FLAGS_preempt_deadline_s`` is abandoned (its
        staging dir is GC'd by the next saver); the previous verified
        checkpoint stands."""
        no = None
        state = self._train_state(epoch, batches, slab_idx, step,
                                  base_seed)

        def _fast_save():
            self.checkpoint.wait()     # pending async persists count too
            # the preempt ledger span owns this whole interval — the
            # save must not double-charge "checkpoint"
            return self._timed_save(state, ledger_cat=None)

        with self._led_span("preempt"):
            try:
                if self.preempt_deadline_s > 0:
                    no = run_with_watchdog(
                        _fast_save, self.preempt_deadline_s,
                        what="preemption fast checkpoint")
                else:
                    no = _fast_save()
            except WatchdogTimeout:
                # the overbudget worker cannot be cancelled, but it
                # must not publish a checkpoint AFTER we report it
                # nonexistent — abandon every in-flight number so its
                # eventual commit is dropped and the staging dir removed
                self.checkpoint.saver.abandon_inflight()
                no = self.checkpoint.latest_no()
            except Exception as exc:  # noqa: BLE001 — exit > durability
                print(f"[train] preemption checkpoint failed "
                      f"({type(exc).__name__}: {exc}); the previous "
                      f"checkpoint stands")
                no = self.checkpoint.latest_no()
            reason = _preempt.preemption_reason() or "requested"
            _M_PREEMPTIONS.inc()
            _flightrec().record("preempted", reason=reason, slab=slab_idx,
                                step=step, checkpoint_no=no)
        raise PreemptedError(
            f"training preempted ({reason}) at slab {slab_idx} "
            f"(step {step}); newest durable checkpoint: "
            f"{no if no is not None else 'none'}",
            slab=slab_idx, step=step, checkpoint_no=no, reason=reason)
