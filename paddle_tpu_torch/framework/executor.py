"""Scope + Executor.

Counterpart of ``paddle_tpu/framework/executor.py``. The JAX package
compiles a whole program per feed signature; this ``Executor.run``
interprets the block op by op on torch tensors, eagerly, on the
executor's device (``place=None`` is the GPU and raises without one).

Before it runs, a program goes through the ``FLAGS_program_passes``
pipeline (``passes.optimize_program``: dce, cse, fuse_optimizer by
default; under ``FLAGS_verify_passes`` the program is verified first
and each pass's output after it) on a clone, memoized on (program uid,
program version, fetch names, pipeline signature); the user's program
is never mutated, and ``FLAGS_program_passes="0"`` runs it as built.
Scope state the block reads comes in from the scope, persistable vars it
writes go back to it when the run ends, and every other var is dropped
from the env after its last reader (``lowering.last_uses``), so a
training step holds what a compiler's buffer liveness would hold, not
every activation and grad at once.

The training loop: ``run`` and ``run_steps`` take the JAX package's
non-finite guard (``check_nan_inf``, ``skip_nonfinite_steps``);
``run_steps`` runs K steps as replays of one captured CUDA graph
(``cuda_graph.CapturedStep``); ``train_from_dataset`` feeds a dataset
(``dataio``) to either.

Each takes a ``parallel.CompiledProgram`` too: a data-parallel one runs
its rewritten program on this rank's rows (``with_data_parallel``), its
first run on a scope broadcasts the state it reads from rank 0, its
stochastic ops fold the rank's data coordinate into their seeds and its
guard's counts are all-reduced (max), so every rank commits or rolls
back the same steps. A multi-slice one (a ``dcn_dp`` mesh, its grads
synced by ``hier_allreduce``) is checked before its first slab by the
gate of ``parallel.dcn`` (``FLAGS_dcn_assert_hier``, the report kept as
the ``CompiledProgram``'s ``hier_report``), and the fault point
``train.allreduce_dcn`` fires before each of its slabs when the sync
decomposes. ``run`` decomposes it too (the op does it, not the
executor): the JAX package's single-step run goes flat and records
``hier_single_step_flat``, the port's does not.

Telemetry (``observability``): ``cache_stats()`` (the memo of prepared
steps and captured graphs, where the JAX package has its compile cache)
feeds the ``executor_*`` families; each execution is timed by a pair of
CUDA events on its stream (the host clock on the CPU), read once
complete, never by a forced sync, and attached to the step's estimated
cost (``observability.profiling.program_cost``) for the utilization
gauges, ``where="step"`` for ``run`` and ``"train"`` for ``run_steps``
(K times the step's cost a slab); the profiler gets the ``run/...``,
``pass/program_...``, ``h2d/slab`` and step-time events; non-finite
steps go to the flight recorder; ``FLAGS_profile_ops=N`` replays every
N-th ``run`` of a program op by op on copies
(``observability.profiling.measure_op_times``).
"""
import time

import numpy as np
import torch

from .. import profiler as _prof
from ..device import resolve_device
from ..flags import flag
from ..observability import metrics as _obs_metrics
from ..observability import utilization as _util
from ..observability.metrics import default_registry as _registry
from ..observability.recorder import flight_recorder as _flightrec
from ..resilience import NonFiniteError, maybe_fail
from .analysis import verify_program
from .core import CPUPlace, CUDAPlace, Variable, default_main_program
from .dtype import torch_dtype
from .lowering import (LowerCtx, analyze_block_io, fold_rank, last_uses,
                       nonfinite_counts, run_ops, splitmix64)
from .passes import optimize_program, pipeline_signature
from .passes import stats as pass_stats

RNG_STATE_NAME = "@RNG_SEED@"

# cache_stats() key -> exported metric (name, kind): the JAX package's
# families where the port keeps the stat. The memo of prepared steps
# and captured graphs never evicts, and a capture has no trace/compile
# split, so executor_cache_evictions_total and
# executor_compile_{trace,xla}_ms_total are left out
_CACHE_METRICS = (
    ("hits", "executor_cache_hits_total", "counter"),
    ("misses", "executor_cache_misses_total", "counter"),
    ("inserts", "executor_cache_inserts_total", "counter"),
    ("entries", "executor_cache_entries_count", "gauge"),
    ("bytes", "executor_cache_bytes", "gauge"),
    ("pass_ms", "executor_compile_pass_ms_total", "counter"),
    ("verify_ms", "executor_compile_verify_ms_total", "counter"),
    ("compiles", "executor_compiles_total", "counter"),
)

# counters bank on GC so the exported *_total stay monotonic across
# executor churn; the gauges retire with the executor they describe
_exec_agg = _obs_metrics.InstanceAggregator(
    [k for k, _n, kd in _CACHE_METRICS if kd == "counter"])


def _collect_executors():
    """Scrape-time collector: Executor.cache_stats() summed across every
    live executor plus the retired totals of collected ones."""
    totals = _exec_agg.totals(
        lambda exe: exe.cache_stats(),
        live_only_keys=[k for k, _n, kd in _CACHE_METRICS
                        if kd == "gauge"])
    return [{"name": name, "kind": kind,
             "help": f"Executor cache_stats() {key!r} (summed across "
                     f"live executors)",
             "labels": (), "samples": [((), totals[key])]}
            for key, name, kind in _CACHE_METRICS]


_registry().register_collector(
    _collect_executors,
    families=[{"name": name, "kind": kind,
               "help": f"Executor cache_stats() {key!r}", "labels": ()}
              for key, name, kind in _CACHE_METRICS])


class Scope:
    """name -> tensor table (flat, as in the JAX package).

    A supervisor that gives up on a hung step marks its scope
    :meth:`depose` d: a training slab that reaches dispatch afterwards
    on it (the abandoned worker waking up) raises instead of running,
    so it can never take the captured step's lock or write state the
    restarted run shares with it.

    ``tp_layouts``: ``{name: parallel.tp.Layout}`` of the values it holds
    as shards, cut for the tp axis of ``tp_mesh`` (or its pp axis: a
    pipeline's stage slices); a save gathers them whole."""

    def __init__(self):
        self._vars = {}
        self.deposed = None          # the reason, once deposed
        self.tp_layouts = {}
        self.tp_mesh = None

    def depose(self, reason="deposed"):
        self.deposed = str(reason)

    def find_var(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    def __contains__(self, name):
        return name in self._vars


_global_scope = Scope()


def global_scope():
    return _global_scope


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        global _global_scope
        self.old = _global_scope
        _global_scope = self.scope

    def __exit__(self, *exc):
        global _global_scope
        _global_scope = self.old


def scope_from_arrays(scope, arrays):
    """Load arrays (``{name: np.ndarray}``, e.g. a JAX package scope's
    parameters, Adam moments, beta-pows and learning rate) into
    ``scope``, over the tensors a run of the port's startup program put
    there: each keeps its device and dtype. Raises on a name the scope
    does not hold, on a scope var the arrays lack, and on a shape that
    differs."""
    have = {n for n in scope.keys() if n != RNG_STATE_NAME}
    unknown = sorted(set(arrays) - have)
    missing = sorted(have - set(arrays))
    if unknown or missing:
        raise ValueError(f"arrays do not match the scope: unknown "
                         f"{unknown}, missing {missing}")
    for name, a in arrays.items():
        old = scope.find_var(name)
        a = np.array(a)              # a writable copy for torch
        if tuple(a.shape) != tuple(old.shape):
            raise ValueError(f"{name!r} has shape {tuple(a.shape)}, the "
                             f"scope holds {tuple(old.shape)}")
        scope.set(name, torch.from_numpy(a).to(device=old.device,
                                               dtype=old.dtype))


class Executor:
    """Runs programs op by op on one device: ``place`` None (the GPU;
    raises without one), ``CUDAPlace(i)`` or ``CPUPlace()``."""

    def __init__(self, place=None):
        if place is None or isinstance(place, CUDAPlace):
            self.device = resolve_device(None if place is None
                                         else place.device)
        elif isinstance(place, CPUPlace):
            self.device = resolve_device("cpu")
        else:
            raise TypeError(f"unsupported place {place!r}")
        self._opt_cache = {}
        self._steps = {}
        self._graphs = {}
        self.verify_ms = 0.0
        from ..utils.lru import LRUCache
        # cache_stats() counters; the collector's closure binds this
        # dict, never the executor
        self._cstats = {"hits": 0, "misses": 0, "inserts": 0,
                        "pass_ms": 0.0, "verify_ms": 0.0, "compiles": 0,
                        "capture_ms": 0.0}
        # estimated step costs (False: nothing to count), the timer of
        # pending executions, the cadence of the last observation
        self._costs = LRUCache(max_entries=256)
        self._timer = _util.ExecutionTimer()
        self._last_obs = None
        self._gap_streak = 0
        # FLAGS_profile_ops sampling counts, per step
        self._profile_seq = {}
        _exec_agg.track(self, lambda cs=self._cstats: dict(cs))

    def cache_stats(self):
        """The memo of prepared steps (``run``) and captured graphs
        (``run_steps``): ``hits``, ``misses``, ``inserts``, ``entries``,
        ``bytes`` (the captured graphs' device memory), ``compiles``
        (captures), ``pass_ms`` (the pass pipeline on memo misses),
        ``verify_ms`` (``FLAGS_verify_passes``) and ``capture_ms`` (the
        making of ``run_steps``' captured steps: on the GPU the warm-up
        and the graph capture, where the JAX package traces and
        compiles)."""
        out = dict(self._cstats)
        out["entries"] = len(self._steps) + len(self._graphs)
        out["bytes"] = sum(int(getattr(g, "nbytes", 0) or 0)
                           for g in self._graphs.values())
        return out

    # -- utilization ----------------------------------------------------
    def _step_cost(self, step, shapes, k_steps=1):
        """The estimated cost of one run of ``step`` at the feed
        ``shapes`` (``{name: shape}``), memoized per step and shapes;
        times ``k_steps`` for a slab."""
        from ..observability.profiling import program_cost
        key = (id(step), step.program.version,
               tuple(sorted(shapes.items())))
        try:
            cost = _util.cost_for(self._costs, key, lambda: program_cost(
                step.program, dict(shapes)))
        except Exception:  # noqa: BLE001 — telemetry never kills a step
            cost = False
        if cost and k_steps != 1:
            cost = {"flops": cost["flops"] * k_steps,
                    "bytes": cost["bytes"] * k_steps}
        return key + (k_steps,), cost

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _maybe_profile_ops(self, every_n, step, program, env, scope,
                           run_seed):
        """The ``FLAGS_profile_ops`` sampling gate and measured replay:
        every ``every_n``-th run of ``step``, its program runs op by op
        once more, on copies of what it writes and at the step's run
        seed (``observability.profiling.measure_op_times``: the per-op
        table, the op spans and the ``hbm_live_bytes`` track), before
        the step itself, which it leaves bitwise as it would be.
        Failures are swallowed: profiling never breaks a step."""
        if len(self._profile_seq) > 512:
            self._profile_seq.clear()
        seq = self._profile_seq.get(id(step), 0) + 1
        self._profile_seq[id(step)] = seq
        if (seq - 1) % max(every_n, 1):
            return
        try:
            from ..observability import profiling as _opprof
            menv = dict(env)
            for n in step.reads + step.fetch_state:
                val = scope.find_var(n)
                if val is not None:
                    menv[n] = val
            _opprof.measure_op_times(step.program, menv,
                                     tag=f"program_{program._uid}",
                                     device=self.device,
                                     run_seed=step.rng_seed(run_seed))
        except Exception:  # noqa: BLE001 — telemetry never kills a step
            pass

    def _drain_utilization(self):
        """Attach every timed execution that has completed to the
        gauges. Telemetry never kills a step."""
        try:
            for seconds, (where, key, cost) in self._timer.poll():
                self._observe_utilization(where, key, cost, seconds)
        except Exception:  # noqa: BLE001 — telemetry never kills a step
            pass

    def _observe_utilization(self, where, cost_key, cost, seconds):
        """Feed the live MFU / HBM-bandwidth gauges one measured
        execution of ``cost_key`` that took ``seconds`` on the device.
        The first execution of a key seeds the cadence (it may follow a
        capture or a warm-up), and one far above the recent cadence
        (10x) is an outlier (a host stall inside an eager run), dropped;
        a run of three such re-seeds the cadence, so a durably slower
        step is measured again instead of freezing the gauges."""
        prev = self._last_obs
        cadence = prev[1] if prev is not None and prev[0] == cost_key \
            else None
        measured = None
        if cadence is None:
            cadence = seconds
            self._gap_streak = 0
        elif seconds > 10.0 * cadence:
            self._gap_streak += 1
            if self._gap_streak >= 3:
                cadence = seconds
                self._gap_streak = 0
        else:
            cadence = measured = seconds
            self._gap_streak = 0
        self._last_obs = (cost_key, cadence)
        if measured is not None and cost:
            _util.observe_execution(where, cost, measured)

    def _optimize(self, program, fetch_names, feed_names=(), scope=None):
        """The pipeline's clone of ``program`` (``program`` itself with
        the pipeline off), memoized: a program's version moves with every
        edit, so an edited program is optimized again.

        Under ``FLAGS_verify_passes`` each memo miss first verifies the
        user program (``analysis.verify_program``, with the scope's names,
        so reads and fetches of scope state check exactly), then every
        pass's output; a malformed program raises ``ProgramVerifyError``
        naming the op (and the pass) before any op runs. The feed names
        and the scope's names join the memo key then, so a clean verdict
        under one binding is not served to another. Verification time
        accumulates in ``verify_ms``."""
        sig = pipeline_signature()
        verify = flag("verify_passes")
        if not sig and not verify:
            return program
        key = (program._uid, program.version, tuple(fetch_names), sig,
               verify)
        if verify:
            scope_names = None if scope is None else \
                frozenset(scope.keys()) - {RNG_STATE_NAME}
            key += (frozenset(feed_names), scope_names)
        opt = self._opt_cache.get(key)
        if opt is not None:
            return opt
        verify_ms = 0.0
        if verify:
            t0 = time.perf_counter()
            verify_program(program, fetch_names=fetch_names,
                           feed_names=feed_names, scope_names=scope_names)
            verify_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        opt = optimize_program(program, fetch_names) if sig else program
        dt = time.perf_counter() - t0
        pipeline_verify = pass_stats()["verify_ms"] if verify and sig \
            else 0.0
        verify_ms += pipeline_verify
        self.verify_ms += verify_ms
        self._cstats["verify_ms"] += verify_ms
        if opt is not program:
            # pass_ms and verify_ms sum to the miss's cost
            pass_s = max(dt - pipeline_verify / 1e3, 0.0)
            self._cstats["pass_ms"] += pass_s * 1e3
            _prof.record_duration(f"pass/program_{program._uid}", pass_s)
        self._opt_cache[key] = opt
        return opt

    def _feed_tensor(self, block, name, val):
        return _stage_feed(block, name, val, self.device)

    @staticmethod
    def _feed_dict(feed):
        return {(k.name if isinstance(k, Variable) else k): v
                for k, v in (feed or {}).items()}

    @staticmethod
    def _fetch_names(fetch_list):
        return [f.name if isinstance(f, Variable) else str(f)
                for f in (fetch_list or [])]

    def _step(self, program, feed_names, fetch_names, scope, compiled=None):
        """The pipeline's clone of ``program`` with its io analysis
        (:class:`Step`), memoized with the clone. ``compiled``: the
        ``CompiledProgram`` it came from; a data-parallel one's first
        run on ``scope`` broadcasts the state the step reads."""
        opt = self._optimize(program, fetch_names, feed_names, scope)
        dp = bool(getattr(compiled, "_data_parallel", False))
        key = (id(opt), opt.version, frozenset(feed_names),
               tuple(fetch_names), dp)
        step = self._steps.get(key)
        hit = step is not None and step.program is opt
        self._cstats["hits" if hit else "misses"] += 1
        if not hit:
            step = Step(opt, feed_names, fetch_names, data_parallel=dp,
                        mesh=getattr(compiled, "mesh", None))
            self._steps[key] = step
            self._cstats["inserts"] += 1
        if dp:
            compiled._sync_once(scope, step.reads)
            compiled._place_shards(scope, step.reads)
        return step

    def _unwrap(self, program):
        """(program, the CompiledProgram it came from or None)."""
        if program is None:
            return default_main_program(), None
        if hasattr(program, "_prepare") and hasattr(program, "program"):
            return program._prepare(self.device), program
        from ..parallel.mesh import activate
        activate(None)         # a plain program's rings span the world
        return program, None

    @staticmethod
    def _run_seed(scope, program):
        seed = scope.find_var(RNG_STATE_NAME)
        return int(program.random_seed or 0) if seed is None else seed

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True, check_nan_inf=None,
            skip_nonfinite_steps=False):
        """Run ``program``'s global block once; returns the fetched
        values (numpy arrays, bf16 as float32, or tensors with
        ``return_numpy=False``).
        ``fetch_list`` may name any var the block computes, ``param@GRAD``
        names included.

        ``check_nan_inf`` (default ``FLAGS_check_nan_inf``) counts the
        nan/inf elements of the fetches and the updated variables on the
        device after the step (one small host read) and raises
        :class:`NonFiniteError` naming the first offender; the step is
        committed all the same. ``skip_nonfinite_steps`` rolls the step
        back instead: the scope keeps its state and the (non-finite)
        fetches are returned. The run seed advances with every executed
        step, rolled back or not (the JAX package restores its key)."""
        program, compiled = self._unwrap(program)
        scope = scope if scope is not None else global_scope()
        feed = self._feed_dict(feed)
        fetch_names = self._fetch_names(fetch_list)
        step = self._step(program, fetch_names=fetch_names,
                          feed_names=feed.keys(), scope=scope,
                          compiled=compiled)
        block = step.program.global_block()
        env = {n: self._feed_tensor(block, n, v) for n, v in feed.items()}
        run_seed = self._run_seed(scope, program)
        if check_nan_inf is None:
            check_nan_inf = flag("check_nan_inf")
        guard = bool(check_nan_inf or skip_nonfinite_steps)
        prof_n = int(flag("profile_ops"))
        if prof_n > 0 and not step.data_parallel:
            self._maybe_profile_ops(prof_n, step, program, env, scope,
                                    run_seed)
        cost_key, cost = self._step_cost(
            step, {n: tuple(t.shape) for n, t in env.items()})
        start = self._timer.begin(self.device)
        if _prof.is_profiling():
            with _prof.record_event(f"run/program_{program._uid}"):
                fetches, new, counts = step.execute(env, scope, self.device,
                                                    run_seed, guard)
                self._sync()
        else:
            fetches, new, counts = step.execute(env, scope, self.device,
                                                run_seed, guard)
        self._timer.end(start, ("step", cost_key, cost))
        scope.set(RNG_STATE_NAME, splitmix64(run_seed))
        bad = None
        if guard:
            c = counts.cpu().numpy()            # the one host read
            if c.any():
                i = int(np.argmax(c > 0))
                bad = step.slots[i] + (int(c[i]),)
        if bad is not None and skip_nonfinite_steps:
            kind, name, count = bad
            _flightrec().record("nonfinite", program=program._uid,
                                var=name, count=count, where=kind,
                                rolled_back=True)
            print(f"[executor] skip_nonfinite_steps: {kind} {name!r} has "
                  f"{count} non-finite value(s) — step rolled back")
        else:
            for n, v in new.items():
                scope.set(n, v)
            if bad is not None:
                kind, name, count = bad
                _flightrec().record("nonfinite", program=program._uid,
                                    var=name, count=count, where=kind)
                raise NonFiniteError(
                    f"Operator output contains Inf/Nan "
                    f"(FLAGS_check_nan_inf): {kind} {name!r} has {count} "
                    f"non-finite value(s) in program_{program._uid}. Feed "
                    f"data, learning rate, or loss scaling are the usual "
                    f"suspects.", var_name=name, count=count)
        if return_numpy:
            fetches = [_to_numpy(f) for f in fetches]
        self._drain_utilization()
        return fetches

    # -- fused multi-step entry -----------------------------------------
    def run_steps(self, program=None, feed=None, fetch_list=None,
                  scope=None, return_numpy=True, use_program_cache=True,
                  check_nan_inf=None, skip_nonfinite_steps=False,
                  steps_per_run=None, unroll=None):
        """Run K training steps, one per row of a feed slab: bitwise K
        sequential :meth:`run` calls (the same ops, state and run seeds;
        a conv program's under ``FLAGS_cudnn_deterministic``, on by
        default), with the Python dispatch of a step paid once. On the
        GPU the step is captured once into a CUDA graph
        (``cuda_graph.CapturedStep``; cached per program version, feed
        row signature, fetches, guard and pass pipeline) and each row is
        a replay; the K feed rows are staged on the device in one copy
        and the fetches come back stacked on a leading K axis in one
        copy. On the CPU each row runs the same step eagerly.

        ``feed``: a dict of arrays with a leading K axis, or a list of K
        feed dicts (stacked here). ``check_nan_inf`` (default
        ``FLAGS_check_nan_inf``) counts each step's nan/inf elements over
        its fetches and updated state on the device; the host reads the
        K counts once, after the slab, and raises
        :class:`NonFiniteError` naming the first bad step, with every
        step executed and committed. ``skip_nonfinite_steps`` rolls each
        bad step back on the device instead. The run seed advances once
        per step, rolled back or not. ``unroll`` (the JAX package's scan
        unroll) is accepted and changes nothing: the graph holds one
        step whatever its value."""
        program, compiled = self._unwrap(program)
        scope = scope if scope is not None else global_scope()
        if isinstance(feed, (list, tuple)):
            feed = _stack_feed_slab([self._feed_dict(f) for f in feed])
        feed = self._feed_dict(feed)
        if not feed:
            raise ValueError(
                "run_steps needs at least one fed variable: the slab's "
                "leading axis defines the step count")
        fetch_names = self._fetch_names(fetch_list)
        block = program.global_block()
        k_steps = None
        slab = {}
        t_h2d = time.perf_counter()
        for name, val in feed.items():
            if np.ndim(val) == 0:
                raise ValueError(
                    f"feed {name!r} is a scalar — run_steps feeds need a "
                    f"leading steps axis")
            k = int(np.shape(val)[0])
            if k_steps is None:
                k_steps = k
            elif k != k_steps:
                raise ValueError(
                    f"feed {name!r} has {k} steps on its leading axis, "
                    f"other feeds have {k_steps}")
            slab[name] = self._feed_tensor(block, name, val)
        _prof.record_duration("h2d/slab", time.perf_counter() - t_h2d)
        if steps_per_run is not None and int(steps_per_run) != k_steps:
            raise ValueError(
                f"steps_per_run={steps_per_run} but the fed slab carries "
                f"{k_steps} steps on its leading axis")
        if check_nan_inf is None:
            check_nan_inf = flag("check_nan_inf")
        guard = bool(check_nan_inf or skip_nonfinite_steps)
        skip = bool(skip_nonfinite_steps)

        step = self._step(program, fetch_names=fetch_names,
                          feed_names=slab.keys(), scope=scope,
                          compiled=compiled)
        from .cuda_graph import CapturedStep
        sig = tuple(sorted((n, tuple(t.shape[1:]), str(t.dtype))
                           for n, t in slab.items()))
        # a multi-slice program's grad sync: decomposed or flat
        dcn = _dcn_mode(compiled, step.program)
        key = (program._uid, program.version, sig, tuple(fetch_names),
               guard, skip, pipeline_signature(), id(step), dcn)
        entry = self._graphs.get(key) if use_program_cache else None
        if use_program_cache:
            self._cstats["hits" if entry is not None else "misses"] += 1
        if entry is None:
            from ..kernels import COUNTED
            if dcn is not None:
                # the pre-run gate of the multi-slice grad sync, before
                # the first slab (parallel.dcn)
                from ..parallel.dcn import check_hier_sync, hier_sync_report
                where = f"fused_program_{program._uid}_x{k_steps}"
                shapes = {n: tuple(t.shape[1:]) for n, t in slab.items()}
                compiled.hier_report = check_hier_sync(
                    step.program, compiled.mesh, where, shapes) \
                    if dcn and flag("dcn_assert_hier") else \
                    hier_sync_report(step.program, compiled.mesh, dcn,
                                     shapes)
            t_cap = time.perf_counter()
            entry = CapturedStep(step, slab, scope, self.device, guard=guard,
                                 skip=skip, counters=COUNTED)
            self._cstats["capture_ms"] += (time.perf_counter() - t_cap) * 1e3
            self._cstats["compiles"] += 1
            if use_program_cache:
                self._graphs[key] = entry
                self._cstats["inserts"] += 1
        cost_key, cost = self._step_cost(
            step, {n: tuple(t.shape[1:]) for n, t in slab.items()}, k_steps)
        # the training dispatch's fault point: before the captured
        # entry's lock, so a stall here (a hung step) never holds the
        # entry against the supervisor's restarted attempt; a scope
        # deposed meanwhile refuses the slab
        maybe_fail("train.dispatch")
        if dcn:
            # the hop across slices: raising is a slice whose collective
            # fails, delay= a straggling slice
            maybe_fail("train.allreduce_dcn")
        if scope.deposed is not None:
            raise RuntimeError(f"the scope was deposed ({scope.deposed}): "
                               f"this slab was abandoned and does not run")
        profiling = _prof.is_profiling()
        start = self._timer.begin(self.device)
        t0 = time.perf_counter()
        fetches, viols, slots, seed = entry.run_slab(
            slab, scope, self._run_seed(scope, program))
        if profiling:
            t1 = time.perf_counter()
            self._sync()
            span = time.perf_counter() - t0
            tag = f"program_{program._uid}_x{k_steps}"
            _prof.record_duration(f"dispatch/{tag}", t1 - t0)
            _prof.record_duration(f"scan/{tag}", span)
            _prof.record_step_time(span / k_steps, k_steps)
        self._timer.end(start, ("train", cost_key, cost))
        scope.set(RNG_STATE_NAME, seed)

        if guard and viols.any():
            first = int(np.argmax(viols > 0))
            i = int(slots[first])
            kind, name = step.slots[i] if 0 <= i < len(step.slots) \
                else ("slot", i)
            name = f"{kind} {name!r}"
            _flightrec().record(
                "nonfinite", program=program._uid, var=name,
                count=int(viols[first]), where=f"fused step {first}",
                rolled_back=skip)
            if skip:
                rolled = int((viols > 0).sum())
                print(f"[executor] skip_nonfinite_steps: {rolled} of "
                      f"{k_steps} fused step(s) rolled back in-graph "
                      f"(first at slab step {first}: {int(viols[first])} "
                      f"non-finite value(s) across outputs/state, "
                      f"first offender {name})")
            else:
                raise NonFiniteError(
                    f"Operator output contains Inf/Nan "
                    f"(FLAGS_check_nan_inf): fused step "
                    f"{first}/{k_steps} of program_{program._uid} "
                    f"produced {int(viols[first])} non-finite value(s) "
                    f"across outputs/state; first offender {name}. "
                    f"Feed data, learning rate, or loss scaling are "
                    f"the usual suspects.",
                    var_name=name, count=int(viols[first]))
        if return_numpy:
            fetches = [_to_numpy(f) for f in fetches]
        self._drain_utilization()
        return fetches

    def close(self):
        """Drop the memoized programs and the captured steps (and the
        device memory their graphs hold)."""
        self._opt_cache.clear()
        self._steps.clear()
        self._graphs.clear()

    # -- dataset ingestion ----------------------------------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, skip_nonfinite_steps=False,
                           steps_per_run=None, fetch_every_n=None):
        """Train over ``dataset``'s batches. ``steps_per_run=K`` (default
        ``FLAGS_steps_per_run``) > 1 takes the fused path: K-step slabs
        (``batch_iterator(slab=K)``) through :meth:`run_steps`, a short
        tail slab through K :meth:`run` calls. ``print_period`` reports
        from the slab's fetches. ``fetch_every_n=N`` (default
        ``FLAGS_fetch_every_n``) > 1 fetches only on slabs that hold a
        ``print_period`` step, every N-th slab and the last. Under the
        fused path the returned last fetches are stacked per step, with
        a leading slab axis. ``fetch_handler`` (a monitor thread in the
        JAX package) is not ported."""
        if fetch_handler is not None:
            raise NotImplementedError("paddle_tpu_torch: fetch_handler is "
                                      "not ported")
        assert dataset is not None, "train_from_dataset needs a dataset"
        k_steps = int(steps_per_run if steps_per_run is not None
                      else flag("steps_per_run"))
        fetch_every = int(fetch_every_n if fetch_every_n is not None
                          else flag("fetch_every_n"))
        fetch_names = self._fetch_names(fetch_list)
        fetch_info = fetch_info or fetch_names
        if k_steps > 1:
            return self._train_fused(
                program, dataset, scope, fetch_list, fetch_names,
                fetch_info, print_period, skip_nonfinite_steps, k_steps,
                fetch_every)
        return self._train_stepwise(
            program, dataset, scope, fetch_list, fetch_names, fetch_info,
            print_period, skip_nonfinite_steps)

    def _train_stepwise(self, program, dataset, scope, fetch_list,
                        fetch_names, fetch_info, print_period,
                        skip_nonfinite_steps):
        """One :meth:`run` per batch; fetches are read on the host only on
        a reporting step (step 0, untrained, is not reported)."""
        last = None
        for step, feed in enumerate(dataset.batch_iterator()):
            out = self.run(program, feed=feed, fetch_list=fetch_list,
                           scope=scope, return_numpy=False,
                           skip_nonfinite_steps=skip_nonfinite_steps)
            last = out
            if fetch_names and print_period and step \
                    and step % print_period == 0:
                msg = ", ".join(f"{i}={_to_numpy(v).mean():.6f}"
                                for i, v in zip(fetch_info, out))
                print(f"step {step}: {msg}")
        if last is not None:
            last = [_to_numpy(v) for v in last]
        return last

    def _train_fused(self, program, dataset, scope, fetch_list,
                     fetch_names, fetch_info, print_period,
                     skip_nonfinite_steps, k_steps, fetch_every):
        """The slab loop behind ``train_from_dataset(steps_per_run=K)``:
        full slabs through :meth:`run_steps`, a short slab (the tail, or
        a shape change) through :meth:`run` calls, so no step is
        captured for a shape seen once."""
        from ..dataio.dataset import DatasetBase
        try:
            it = dataset.batch_iterator(slab=k_steps)
        except TypeError:
            it = DatasetBase._slab_batches(dataset.batch_iterator(),
                                           k_steps)
        last = None
        step = slab_idx = 0
        cur = next(it, None)
        while cur is not None:
            nxt = next(it, None)
            k = int(np.shape(next(iter(cur.values())))[0])
            hit = bool(print_period) and bool(fetch_names) and any(
                (step + j) and (step + j) % print_period == 0
                for j in range(k))
            want = bool(fetch_names) and (
                fetch_every <= 1 or hit or slab_idx % fetch_every == 0
                or nxt is None)     # the last slab: the return is fresh
            flist = fetch_list if want else []
            if k == k_steps:
                out = self.run_steps(
                    program, feed=cur, fetch_list=flist, scope=scope,
                    return_numpy=False,
                    skip_nonfinite_steps=skip_nonfinite_steps)
            else:
                outs = [self.run(program,
                                 feed={n: a[j] for n, a in cur.items()},
                                 fetch_list=flist, scope=scope,
                                 return_numpy=False,
                                 skip_nonfinite_steps=skip_nonfinite_steps)
                        for j in range(k)]
                out = [torch.stack([o[i] for o in outs])
                       for i in range(len(fetch_names))] if want else []
            if want and out:
                mats = [_to_numpy(v) for v in out]    # one copy a slab
                last = mats
                for j in range(k) if hit else ():
                    g = step + j
                    if g and g % print_period == 0:
                        msg = ", ".join(f"{i}={v[j].mean():.6f}"
                                        for i, v in zip(fetch_info, mats))
                        print(f"step {g}: {msg}")
            step += k
            slab_idx += 1
            cur = nxt
        if last is None and not fetch_names and slab_idx:
            last = []       # the stepwise path's no-fetch return
        return last

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        if program is not None and hasattr(program, "_prepare"):
            prog = program._for_test()     # keeps its mesh and shards
        else:
            prog = program.clone(for_test=True) if program is not None \
                else None
        return self.train_from_dataset(prog, dataset, scope, thread, debug,
                                       fetch_list, fetch_info, print_period)


def _dcn_mode(compiled, program):
    """How the ``hier_allreduce`` ops of a data-parallel ``program`` run
    on its mesh: True decomposed, False flat, None when the mesh has no
    ``dcn_dp`` axis or the program no such op."""
    mesh = getattr(compiled, "mesh", None)
    if not getattr(compiled, "_data_parallel", False) or mesh is None \
            or mesh.dcn_dp == 1 or not any(
                op.type == "hier_allreduce"
                for op in program.global_block().ops):
        return None
    from ..ops.collective_ops import hierarchical
    return hierarchical(mesh)


class Step:
    """One program (already through the pass pipeline) at one set of fed
    and fetched names: the scope state it reads (``reads``, then
    ``fetch_state``: fetched names only the scope holds), the
    persistables it writes (``writes``), when each other var can be
    dropped (``free``) and the guard's slot names (``slots``: fetches,
    then written vars). A ``data_parallel`` step in a launched world
    folds the rank into its stochastic ops' seeds (:meth:`rng_seed`)
    and all-reduces its guard's counts (:meth:`agree`)."""

    def __init__(self, program, feed_names, fetch_names,
                 data_parallel=False, mesh=None):
        from ..parallel import mesh as _mesh
        self.program = program
        self.data_parallel = bool(data_parallel) and _mesh.is_initialized()
        # the data coordinate (c * dp + d) on the program's own mesh: the
        # ranks of one tp group draw alike, and dcn_dp x dp draws the
        # masks of a dp run of as many ranks
        self.rank = _mesh.axis_rank(_mesh.DATA_AXIS, mesh) \
            if self.data_parallel else 0
        block = program.global_block()
        self.fetch_names = list(fetch_names)
        self.reads, self.writes = analyze_block_io(program, 0, feed_names)
        made = set(feed_names) | {n for op in block.ops
                                  for n in op.output_arg_names}
        self.fetch_state = [n for n in dict.fromkeys(self.fetch_names)
                            if n not in made and n not in self.reads]
        self.state_names = list(dict.fromkeys(
            self.reads + self.fetch_state + self.writes))
        self.free = last_uses(block, set(self.fetch_names)
                              | set(self.writes))
        self.slots = ([("fetched output", n) for n in self.fetch_names]
                      + [("updated variable", n) for n in self.writes])

    def rng_seed(self, run_seed):
        """The seed this rank's stochastic ops draw from at ``run_seed``:
        the run seed itself at data coordinate 0 (and outside data
        parallelism), one folded with the data coordinate ``c * dp + d``
        elsewhere, so
        each dp rank's rows get their own dropout masks while
        ``@RNG_SEED@`` stays equal on every rank. The ranks of one tp
        group share the fold: a replicated activation gets one mask on
        all of them (a rank's own attention heads draw the mask of the
        first heads of the single-card draw; a difference by design).
        So do the ranks of one sp group: a dropout inside the sequence
        split draws the whole tensor's mask and keeps the rank's chunk
        (``sp_chunk``, pass ``sp_shard``)."""
        return fold_rank(run_seed, self.rank)

    def agree(self, counts):
        """The guard's per-slot counts, maxed over the world's ranks in a
        data-parallel world (a NaN on one rank, in its rows or in its tp
        shard, rolls back every rank)."""
        if self.data_parallel and counts is not None:
            from ..ops.collective_ops import all_reduce
            all_reduce(counts, "max", None)
        return counts

    def execute(self, env, scope, device, run_seed, guard=False):
        """Run the step eagerly over ``env`` (the feed tensors) and the
        scope's state; returns (fetches, {written var: new value}, the
        guard's per-slot nan/inf counts on the device or None). Commits
        nothing."""
        for n in self.reads:
            val = scope.find_var(n)
            if val is None:
                raise RuntimeError(
                    f"var {n!r} is read by the program but is not "
                    f"initialized in the scope: run the startup program "
                    f"first, or feed it")
            env[n] = val
        for n in self.fetch_state:
            if scope.find_var(n) is not None:
                env[n] = scope.find_var(n)      # a fetch of scope state
        ctx = LowerCtx(self.program, self.program.global_block(), env,
                       device, run_seed=self.rng_seed(run_seed))
        with torch.no_grad():
            run_ops(ctx, free_after=self.free)
        fetches = []
        for n in self.fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was never computed")
            fetches.append(env[n])
        new = {n: env[n] for n in self.writes if n in env}
        counts = None
        if guard:
            counts = self.agree(nonfinite_counts(
                fetches + list(new.values()), device))
        return fetches, new, counts


def device_put_slab(slab, program, device):
    """A host feed slab (``{name: array [K, ...]}``) as tensors on
    ``device``, each in its program var's dtype, as ``run_steps`` would
    stage it: the training loop's prefetch of the next slab (fault point
    ``train.h2d``)."""
    maybe_fail("train.h2d")
    block = program.global_block()
    return {name: _stage_feed(block, name, val, device)
            for name, val in slab.items()}


def _stage_feed(block, name, val, device):
    """One fed value (array or tensor) on ``device`` in its program
    var's dtype (its own dtype when ``block`` has no such var)."""
    var = block.vars.get(name)
    t = val if isinstance(val, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(val))
    dt = torch_dtype(var.dtype) if var is not None else t.dtype
    return t.to(device=device, dtype=dt)


def _stack_feed_slab(feeds):
    """Stack a list of per-step feed dicts on a new leading K axis. Key
    order may differ between steps; the variable set may not."""
    if not feeds:
        raise ValueError("run_steps got an empty feed list")
    names = list(feeds[0].keys())
    for f in feeds[1:]:
        if set(f.keys()) != set(names):
            raise ValueError(
                "run_steps feed dicts must bind the same variables in "
                f"every step: {sorted(names)} vs {sorted(f.keys())}")
    return {n: torch.stack([_as_tensor(f[n]) for f in feeds])
            if any(isinstance(f[n], torch.Tensor) for f in feeds)
            else np.stack([np.asarray(f[n]) for f in feeds]) for n in names}


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(v))


def _to_numpy(t):
    """A fetched tensor as a numpy array; bf16, which numpy lacks, comes
    back as float32 (every bf16 value is exact in it)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


__all__ = ["CPUPlace", "CUDAPlace", "Executor", "RNG_STATE_NAME", "Scope",
           "Step", "global_scope", "scope_from_arrays", "scope_guard"]
