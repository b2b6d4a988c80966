"""Program passes: the registry, ordered application and the executor's
pre-lowering pipeline.

A trimmed copy of ``paddle_tpu/framework/passes.py``. A pass is a
callable over the Program IR; ``register_pass`` adds one,
``apply_passes(program, [...])`` runs an ordered pipeline and
``stats()`` reports the last run. The default pipeline
(``FLAGS_program_passes`` "1") runs in ``Executor.run`` over a CLONE of
the user's program (``optimize_program``), which is never mutated:

- ``dce``: drop ops whose outputs no fetch target, persistable write or
  side-effecting op needs;
- ``cse``: merge identical pure ops of the global block (the same type,
  attrs and inputs at the same binding version);
- ``fuse_optimizer``: per-param ``sgd``, ``momentum``, ``adam`` and
  ``adamw`` ops of one (type, dtype, hyperparameters, LR var, beta-pow
  shape) group join byte-capped buckets, each one ``fused_<type>`` op
  whose outputs equal the per-param ops' bit for bit
  (``ops/optimizer_ops.py``).

``amp_bf16`` wraps ``contrib.mixed_precision.rewrite_program``.
``sync_batch_norm`` (batch_norm -> sync_batch_norm) and the port's own
``dp_grad_allreduce`` (each parameter grad all-reduced and scaled by 1/N
after its last producer) make a program data-parallel; the port's
``tp_shard`` (``parallel.tp``: each annotated parameter cut to the
rank's shard, Megatron's collectives around the split matmuls) makes it
tensor-parallel and ``sp_shard`` (``parallel.sp``: the activations'
sequence dim split per rank from the first ``sp`` constraint) makes it
sequence-parallel, ``pp_shard`` (``parallel.pp``: a pipeline's
stacked stage state cut to the rank's stage slice) pipeline-parallel
and ``ep_shard`` (``parallel.ep``: the stacked experts cut to the
rank's slice) expert-parallel, where GSPMD does these for the JAX
package;
``CompiledProgram.with_data_parallel`` applies them to a clone. Every
pass treats collectives as side effects (``analysis.is_side_effect_type``):
never dropped, merged or moved past one another, since every rank must
issue the same collectives in the same order. Under
``FLAGS_verify_passes`` every pass's output is translation-validated
(``analysis.PipelineValidator``): a pass that drops a live random
stream, side effect or persistable write, or leaves a malformed program,
raises ``analysis.ProgramVerifyError`` naming the pass. Each pass's wall
time lands in the profiler as ``pass/<name>`` and in the
``program_pass_*`` registry families. ``hier_grad_sync`` (a copy
of the JAX pass: one ``hier_allreduce`` after each parameter grad's last
producer, its readers rewired to ``<grad>@HIER``) makes it multi-slice,
and ``dp_grad_allreduce`` leaves the grads it syncs alone. Not ported:
the pass ``quant_aware`` (item 10).
"""
import time

import numpy as np

from .. import profiler as _prof
from ..flags import flag as _flag
from ..observability.metrics import default_registry as _registry
from .analysis import has_sub_block as _has_sub_block
from .core import OP_ROLE_KEY
from .core import Operator as _Operator
from .core import OpRole as _OpRole
from .dtype import itemsize as _itemsize


class UnknownPassError(KeyError):
    """A pass name that is not in the registry; the message names the
    registered passes."""

    def __init__(self, name):
        self.pass_name = name
        super().__init__(name)

    def __str__(self):
        return (f"pass {self.pass_name!r} is not registered; "
                f"known passes: {list_passes()}")


class Pass:
    """Base pass: override ``apply(program)`` and mutate in place.
    ``name`` defaults to the registration name; attrs given at
    construction are set on the instance. ``pipeline_order`` ranks the
    pass in canonical order (lower runs earlier; None = by
    registration)."""

    name = None
    pipeline_order = None

    def __init__(self, **attrs):
        for k, v in attrs.items():
            setattr(self, k, v)

    def apply(self, program):
        raise NotImplementedError

    def __call__(self, program):
        out = self.apply(program)
        out = program if out is None else out
        # the executor memoizes optimized programs on (uid, version): a
        # mutation-only pass must move the version on
        out._bump_version()
        return out


_PASSES = {}
_REG_SEQ = {}          # name -> registration index (ordering tiebreak)
_REG_GEN = [0]         # bumped per registration: pass identity version
_sig_memo = {}         # (flag values, reg gen) -> pipeline_signature()


def register_pass(name):
    """Decorator: register a Pass subclass under ``name``. Registering a
    name again replaces the entry and changes
    :func:`pipeline_signature`, so no program optimized by the old pass
    is served for the new one."""
    def deco(cls):
        _PASSES[name] = cls
        _REG_SEQ.setdefault(name, len(_REG_SEQ))
        _REG_GEN[0] += 1
        cls._reg_serial = _REG_GEN[0]
        _sig_memo.clear()
        if getattr(cls, "name", None) is None:
            cls.name = name
        return cls
    return deco


def get_pass(name, **attrs):
    cls = _PASSES.get(name)
    if cls is None:
        raise UnknownPassError(name)
    return cls(**attrs)


def has_pass(name):
    return name in _PASSES


def list_passes():
    return sorted(_PASSES)


def canonical_order(names):
    """Pipeline order for a collection of pass names: by
    ``pipeline_order`` (dce < cse < fuse_optimizer), then by
    registration for passes without one."""
    def rank(n):
        cls = _PASSES.get(n)
        order = getattr(cls, "pipeline_order", None) if cls else None
        return (0, order, "") if order is not None \
            else (1, _REG_SEQ.get(n, len(_REG_SEQ)), n)
    return sorted(names, key=rank)


# ---------------------------------------------------------------------------
# Pipeline application + stats
# ---------------------------------------------------------------------------

_last_stats = {"passes": [], "total_ms": 0.0, "verify_ms": 0.0}

# cumulative per-pass telemetry (stats() stays "the LAST run")
_M_PASS_RUNS = _registry().counter(
    "program_pass_runs_total", "pipeline pass applications",
    labels=("pass",), max_series=32)
_M_PASS_MS = _registry().counter(
    "program_pass_ms_total", "wall ms spent inside each pass",
    labels=("pass",), max_series=32)
_M_PASS_OPS_REMOVED = _registry().counter(
    "program_pass_ops_removed_total",
    "ops removed by each pass (net, clamped at 0 per run)",
    labels=("pass",), max_series=32)


def stats():
    """Report of the LAST apply_passes run: per pass {pass, ops_before,
    ops_after, bytes_before, bytes_after, ms, detail, verify_ms}, the
    pipeline's total ms, and ``verify_ms``, the translation validation's
    wall time (0.0 with ``FLAGS_verify_passes`` off)."""
    return {"passes": [dict(r) for r in _last_stats["passes"]],
            "total_ms": _last_stats["total_ms"],
            "verify_ms": _last_stats["verify_ms"]}


def _program_op_count(program):
    return sum(len(blk.ops) for blk in program.blocks)


def _program_bytes(program):
    """Static size of every var the program's ops touch (dims of -1 and
    unknown shapes count 0)."""
    seen = set()
    total = 0
    for blk in program.blocks:
        for op in blk.ops:
            for n in op.input_arg_names + op.output_arg_names:
                if n in seen or not blk.has_var(n):
                    continue
                seen.add(n)
                var = blk.var(n)
                shape = var.shape
                if shape is None or any(int(s) < 0 for s in shape):
                    continue
                total += int(np.prod(shape, dtype=np.int64)) * \
                    _itemsize(var.dtype)
    return total


def apply_passes(program, names, _validate=None, **common_attrs):
    """Run passes over ``program`` in order. ``names`` holds registered
    names or Pass instances; a set is put in :func:`canonical_order`
    first. An unknown name raises
    :class:`UnknownPassError`. Per-pass op and byte counts and wall
    time land in :func:`stats`, the profiler (``pass/<name>``) and the
    ``program_pass_*`` registry families. ``_validate`` (an
    ``analysis.PipelineValidator``) checks each pass's output and adds
    its time to the pass's row as ``verify_ms``."""
    if isinstance(names, (set, frozenset)):
        names = canonical_order(list(names))
    rows = []
    t_pipeline = time.perf_counter()
    ops = _program_op_count(program)
    nbytes = _program_bytes(program)
    for n in names:
        p = get_pass(n, **common_attrs) if isinstance(n, str) else n
        pname = getattr(p, "name", None) or type(p).__name__
        t0 = time.perf_counter()
        program = p(program) or program
        dt = time.perf_counter() - t0
        ops_after = _program_op_count(program)
        bytes_after = _program_bytes(program)
        row = {"pass": pname, "ops_before": ops, "ops_after": ops_after,
               "bytes_before": nbytes, "bytes_after": bytes_after,
               "ms": dt * 1e3}
        detail = getattr(p, "_report", None)
        if detail:
            row["detail"] = dict(detail)
        if _validate is not None:
            _validate.after_pass(program, pname)
            row["verify_ms"] = _validate.last_pass_ms
        rows.append(row)
        _prof.record_duration(f"pass/{pname}", dt)
        _M_PASS_RUNS.inc(labels=(pname,))
        _M_PASS_MS.inc(dt * 1e3, labels=(pname,))
        _M_PASS_OPS_REMOVED.inc(max(ops - ops_after, 0), labels=(pname,))
        ops, nbytes = ops_after, bytes_after
    _last_stats["passes"] = rows
    _last_stats["total_ms"] = (time.perf_counter() - t_pipeline) * 1e3
    _last_stats["verify_ms"] = (_validate.verify_ms
                                if _validate is not None else 0.0)
    return program


# The executor's default pipeline (canonical order).
DEFAULT_PIPELINE = ("dce", "cse", "fuse_optimizer")


def resolve_pipeline(spec=None):
    """``FLAGS_program_passes`` -> ordered tuple of pass names: "0" (or
    off/false/none/"") is no pipeline, "1" (on/true/default) is
    DEFAULT_PIPELINE, anything else a comma-separated pass list run in
    canonical order."""
    if spec is None:
        spec = _flag("program_passes")
    s = str(spec).strip().lower()
    if s in ("0", "", "off", "false", "none"):
        return ()
    if s in ("1", "on", "true", "default"):
        names = list(DEFAULT_PIPELINE)
    else:
        names = [t.strip() for t in str(spec).split(",") if t.strip()]
    for n in names:
        if n not in _PASSES:
            raise UnknownPassError(n)
    return tuple(canonical_order(names))


def pipeline_signature(spec=None):
    """Hashable identity of the active pass configuration: the resolved
    pipeline, each pass's registration serial, and the attrs that change
    a pass's output (the fusion bucket cap). Part of the executor's memo
    key, so flipping a flag never serves a stale program."""
    raw = (_flag("program_passes") if spec is None else spec,
           _flag("fuse_optimizer_bucket_mb"), _REG_GEN[0])
    sig = _sig_memo.get(raw)
    if sig is not None:
        return sig
    names = resolve_pipeline(raw[0])
    if not names:
        sig = ()
    else:
        extras = []
        if "fuse_optimizer" in names:
            extras.append(("fuse_optimizer_bucket_mb", int(raw[1])))
        sig = (tuple((n, _PASSES[n]._reg_serial) for n in names),
               tuple(extras))
    if len(_sig_memo) < 64:        # flags take few distinct values
        _sig_memo[raw] = sig
    return sig


def optimize_program(program, fetch_names=(), spec=None):
    """Run the configured pipeline over a CLONE of ``program`` and return
    it; the caller's program is never mutated. With the pipeline off the
    original program is returned as it is. A pass that fails raises:
    the unoptimized program is never returned in its place. Under
    ``FLAGS_verify_passes`` each pass's output is validated
    (``analysis.PipelineValidator``); a broken one raises
    ``ProgramVerifyError`` naming the pass."""
    names = resolve_pipeline(spec)
    if not names:
        return program
    if isinstance(fetch_names, str):
        fetch_names = (fetch_names,)    # one target, not its characters
    fetch_names = tuple(fetch_names)
    opt = program.clone()
    pipeline = [get_pass(n, fetch_names=fetch_names) for n in names]
    validator = None
    if _flag("verify_passes"):
        from .analysis import PipelineValidator
        # on a finding, the replay names the pass that made it
        validator = PipelineValidator(
            opt, fetch_names,
            replay=lambda: (program.clone(),
                            [get_pass(n, fetch_names=fetch_names)
                             for n in names]))
    apply_passes(opt, pipeline, _validate=validator)
    if validator is not None:
        validator.finalize(opt, last_pass_name=names[-1])
        _last_stats["verify_ms"] = validator.verify_ms
    return opt


# ---------------------------------------------------------------------------
# Built-in passes
# ---------------------------------------------------------------------------

@register_pass("amp_bf16")
class AmpBf16Pass(Pass):
    """bf16 mixed-precision cast insertion
    (``contrib.mixed_precision.fp16_utils.rewrite_program``). attrs:
    amp_lists (AutoMixedPrecisionLists), dest_dtype."""

    amp_lists = None
    dest_dtype = "bfloat16"

    def apply(self, program):
        from ..contrib.mixed_precision.fp16_lists import (
            AutoMixedPrecisionLists)
        from ..contrib.mixed_precision.fp16_utils import rewrite_program
        rewrite_program(program,
                        self.amp_lists or AutoMixedPrecisionLists(),
                        dest_dtype=self.dest_dtype)


@register_pass("sync_batch_norm")
class SyncBatchNormPass(Pass):
    """batch_norm -> sync_batch_norm, its grad ops included (reference
    framework/ir/sync_batch_norm_pass.cc): the statistics of a training
    batch norm are then taken over every rank's rows. A test-mode op
    stays local either way (``ops/nn_ops.py``)."""

    def apply(self, program):
        for block in program.blocks:
            for op in block.ops:
                if op.type in ("batch_norm", "batch_norm_grad"):
                    op.type = "sync_" + op.type
                    fwd = op.attrs.get("__fwd_op__")
                    if isinstance(fwd, dict) and \
                            fwd.get("type") == "batch_norm":
                        fwd["type"] = "sync_batch_norm"


#: the most bytes of grads one c_coalesced_allreduce_sum carries
DP_BUCKET_BYTES = 32 << 20


@register_pass("dp_grad_allreduce")
class DataParallelGradAllreducePass(Pass):
    """The gradient sync of a data-parallel program, which GSPMD inserts
    for the JAX package (reference
    ir/multi_devices_graph_pass/multi_devices_graph_pass.cc:456, the
    collective transpiler's c_allreduce_sum). Every trainable
    parameter's ``@GRAD``, after its last producer in the global block
    and before any op that reads or writes it again (AMP's unscale and
    finite check, clips, regularizers, the optimizer, a gradient-merge
    accumulate), is summed over the ranks and scaled by ``1/nranks``
    (``BuildStrategy.GradientScaleStrategy.CoeffNumDevice``). The grads
    go in buckets of one dtype and at most ``DP_BUCKET_BYTES``, each one
    ``c_coalesced_allreduce_sum`` issued when its last member is made,
    in backward order. A grad that may hold ``SelectedRows`` (an
    ``is_sparse`` embedding's, :meth:`FuseOptimizerPass._maybe_sparse_names`)
    sits outside the buckets: one ``c_allgather_selected_rows`` after its
    last producer gathers every rank's (rows, values) over the same ring
    in rank order, which is the global batch's order, and scales the
    values by ``1/nranks``, so the sparse update then runs on the union
    (a multi-slice program's sparse grads come here too, over the joint
    data axis: ``hier_grad_sync`` leaves them). A grad that a
    ``hier_allreduce`` already syncs is left to it. attrs:
    nranks, axis_name (the ring's axis: ``dp``, the default, or
    ``dp_sp`` for a sequence-parallel program), ``stage_ring``
    (``(axis_name, nranks)`` for the grads of the pipeline stage slices
    that pass ``pp_shard`` cut, ``program._pp_layouts``: over ``dp``
    alone beside ``sp``), each ring bucketed apart."""

    nranks = 1
    axis_name = None
    stage_ring = None

    def apply(self, program):
        block = program.global_block()
        hier = {n for op in block.ops if op.type == "hier_allreduce"
                for n in op.input("X")}
        wanted = {p.name + "@GRAD": p for p in block.all_parameters()
                  if getattr(p, "trainable", True)
                  and p.name + "@GRAD" not in hier}
        last = {}
        for i, op in enumerate(block.ops):
            for n in op.output_arg_names:
                if n in wanted:
                    last[n] = i
        sparse = set(last) & FuseOptimizerPass._maybe_sparse_names(block)
        ring = {n + "@GRAD": tuple(self.stage_ring)
                for n in getattr(program, "_pp_layouts", {})} \
            if self.stage_ring else {}
        default = (self.axis_name, self.nranks)
        new_ops, buckets = [], {}     # (dtype, ring) -> [names, bytes]
        report = {"allreduce_ops": 0, "grads": 0, "sparse_allgather_ops": 0}

        def flush(key):
            names, _ = buckets.pop(key)
            axis, nranks = key[1]
            report["grads"] += len(names)
            new_ops.append(_Operator(
                block, "c_coalesced_allreduce_sum", inputs={"X": names},
                outputs={"Out": names},
                attrs={"ring_id": 0, "scale": 1.0 / float(nranks),
                       **({"axis_name": axis} if axis else {}),
                       OP_ROLE_KEY: _OpRole.Backward}))
            report["allreduce_ops"] += 1

        for i, op in enumerate(block.ops):
            touched = set(op.input_arg_names) | set(op.output_arg_names)
            if _has_sub_block(op):
                from .analysis import op_reads, op_writes
                touched |= op_reads(program, op) | op_writes(program, op)
            for key in [key for key, (names, _) in buckets.items()
                        if touched.intersection(names)]:
                flush(key)
            new_ops.append(op)
            for n in dict.fromkeys(op.output_arg_names):
                if last.get(n) != i:
                    continue
                var = block.var(n)
                if n in sparse:
                    axis, nranks = ring.get(n, default)
                    new_ops.append(_Operator(
                        block, "c_allgather_selected_rows",
                        inputs={"X": [n]}, outputs={"Out": [n]},
                        attrs={"ring_id": 0, "scale": 1.0 / float(nranks),
                               **({"axis_name": axis} if axis else {}),
                               OP_ROLE_KEY: _OpRole.Backward}))
                    report["sparse_allgather_ops"] += 1
                    continue
                key = (str(var.dtype), tuple(ring.get(n, default)))
                shape = var.shape or ()
                nbytes = int(np.prod([max(int(d), 1) for d in shape],
                                     dtype=np.int64)) * _itemsize(var.dtype)
                b = buckets.setdefault(key, [[], 0])
                b[0].append(n)
                b[1] += nbytes
                if b[1] >= DP_BUCKET_BYTES:
                    flush(key)
        for key in list(buckets):
            flush(key)
        block.ops = new_ops
        self._report = report


@register_pass("hier_grad_sync")
class HierGradSyncPass(Pass):
    """One ``hier_allreduce`` after every parameter grad's last producer:
    the multi-slice grad sync (a copy of the JAX pass;
    ``CompiledProgram`` applies it when the mesh has a ``dcn_dp`` axis).
    Each rank's grad of its rows becomes the global batch's mean grad:
    reduce-scatter over ``dp``, all-reduce of the 1/dp shard over
    ``dcn_dp``, all-gather over ``dp`` (``ops.collective_ops``), or one
    all-reduce over ``dcn_dp+dp`` (the flat path). The synced value is
    ``<grad>@HIER``, and every later reader of the grad (clips,
    regularizers, AMP's unscale, the optimizer) is rewired to it; the
    grads picked are the raw ``<param>@GRAD`` of each optimizer op's
    parameter, else its Grad input. Idempotent: a grad whose ``@HIER``
    twin exists is skipped. A rewired op gets new input lists (never a
    mutated one: ``Operator.to_dict`` shares them). attrs: inner_axis
    ("dp"; ``dp_sp`` for a sequence-parallel program), outer_axis
    ("dcn_dp"), ``stage_ring`` (the inner axis of the grads of the
    pipeline stage slices, ``program._pp_layouts``: ``dp`` beside
    ``sp``)."""

    inner_axis = "dp"
    outer_axis = "dcn_dp"
    stage_ring = None
    GRAD_SUFFIX = "@GRAD"
    SYNC_SUFFIX = "@HIER"

    def apply(self, program):
        for block in program.blocks:
            self._apply_block(block)

    def _grad_names(self, block):
        # a SelectedRows grad goes to dp_grad_allreduce's all-gather over
        # the joint data axis
        out, seen = [], set(FuseOptimizerPass._maybe_sparse_names(block))
        for op in block.ops:
            if op.attrs.get(OP_ROLE_KEY) != _OpRole.Optimize:
                continue
            params = op.input("Param")
            for i, g in enumerate(op.input("Grad")):
                if i < len(params):
                    raw = params[i] + self.GRAD_SUFFIX
                    if raw in block.vars:
                        g = raw
                if g not in seen:
                    seen.add(g)
                    out.append(g)
        return out

    def _apply_block(self, block):
        rings = {n + self.GRAD_SUFFIX: self.stage_ring
                 for n in getattr(block.program, "_pp_layouts", {})} \
            if self.stage_ring else {}
        for g in self._grad_names(block):
            synced = g + self.SYNC_SUFFIX
            if synced in block.vars:
                continue
            writers = [i for i, op in enumerate(block.ops)
                       if g in op.output_arg_names
                       and op.type != "hier_allreduce"]
            if not writers:
                continue
            idx = writers[-1]
            v = block.vars.get(g)
            block.create_var(name=synced,
                             shape=getattr(v, "shape", None),
                             dtype=getattr(v, "dtype", "float32"))
            block._insert_op(
                idx + 1, "hier_allreduce",
                inputs={"X": [g]}, outputs={"Out": [synced]},
                attrs={"inner_axis": rings.get(g, self.inner_axis),
                       "outer_axis": self.outer_axis,
                       "mean": True,
                       OP_ROLE_KEY: _OpRole.Backward})
            for op in block.ops[idx + 2:]:
                if g in op.input_arg_names:
                    op.inputs = {slot: [synced if n == g else n
                                        for n in names]
                                 for slot, names in op.inputs.items()}


@register_pass("tp_shard")
class TensorParallelShardPass(Pass):
    """The per-rank Megatron rewrite of a program over the ``tp`` axis of
    ``mesh`` (``parallel.tp.tp_rewrite``), for the rank at ``tp_rank``
    (this rank's by default): the parameters annotated on ``tp`` take
    their shard shapes and the conjugate collectives go in around the
    split matmuls, grad ops included. Nothing changes at tp 1. The split
    layouts are left on ``program._tp_layouts``. attrs: mesh,
    tp_rank."""

    mesh = None
    tp_rank = None

    def apply(self, program):
        from ..parallel.tp import tp_rewrite
        program._tp_layouts = tp_rewrite(program, self.mesh, self.tp_rank)
        self._report = dict(getattr(program, "_tp_report", {}))


@register_pass("sp_shard")
class SequenceParallelShardPass(Pass):
    """The per-rank sequence split of a program over the ``sp`` axis of
    ``mesh`` (``parallel.sp.sp_rewrite``), for the rank at ``sp_rank``
    (this rank's by default): from the first ``sharding_constraint``
    that names ``sp`` the activations hold the rank's chunk of the
    sequence, gathered where an op needs it whole, grad ops included.
    Nothing changes at sp 1. attrs: mesh, sp_rank."""

    mesh = None
    sp_rank = None

    def apply(self, program):
        from ..parallel.sp import sp_rewrite
        self._report = sp_rewrite(program, self.mesh, self.sp_rank)
        program._sp_report = dict(self._report)


@register_pass("pp_shard")
class PipelineParallelShardPass(Pass):
    """The per-rank cut of a program's pipeline stage state over the
    ``pp`` axis of ``mesh`` (``parallel.pp.pp_rewrite``): each stacked
    stage parameter, its accumulators and its grad take the rank's
    ``[1, ...]`` stage slice. Nothing changes at pp 1. The slices'
    layouts are left on ``program._pp_layouts``. attrs: mesh."""

    mesh = None

    def apply(self, program):
        from ..parallel.pp import pp_rewrite
        program._pp_layouts = pp_rewrite(program, self.mesh)
        self._report = dict(getattr(program, "_pp_report", {}))


@register_pass("ep_shard")
class ExpertParallelShardPass(Pass):
    """The per-rank cut of a program's expert state over the ``ep`` axis
    of ``mesh`` (``parallel.ep.ep_rewrite``): each stacked expert
    parameter, its accumulators and its grad take the rank's ``[E / ep,
    ...]`` slice. Nothing changes at ep 1. The slices' layouts are left
    on ``program._ep_layouts``. attrs: mesh."""

    mesh = None

    def apply(self, program):
        from ..parallel.ep import ep_rewrite
        program._ep_layouts = ep_rewrite(program, self.mesh)
        self._report = dict(getattr(program, "_ep_report", {}))


def _freeze(v):
    """Hashable form of an op attr value (nested dicts of grad ops'
    ``__fwd_op__``, numpy arrays, lists)."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return ("__ndarray__", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted((_freeze(x) for x in v), key=repr))
    return v


@register_pass("dce")
class DeadCodeEliminationPass(Pass):
    """Drop global-block ops whose outputs no fetch target, persistable
    write or side-effecting op needs (``analysis.live_op_ids``).
    Control-flow ops keep their whole sub-block; only block 0 is
    pruned. attrs: fetch_names."""

    pipeline_order = 10
    fetch_names = ()

    def apply(self, program):
        from .analysis import live_op_ids
        block = program.global_block()
        live = live_op_ids(program, self.fetch_names or ())
        kept = [op for op in block.ops if id(op) in live]
        self._report = {"removed_ops": len(block.ops) - len(kept)}
        block.ops = kept


@register_pass("cse")
class CommonSubexpressionEliminationPass(Pass):
    """Merge identical pure ops of the global block: two ops with the
    same (type, attrs, inputs at the same binding version) compute the
    same values, so the second is dropped and later readers read the
    first's outputs. Never merges ops that draw random numbers, have
    side effects or sub-blocks, or whose outputs are persistable,
    fetched, written more than once or read inside a sub-block. attrs:
    fetch_names."""

    pipeline_order = 20
    fetch_names = ()

    def _pinned_names(self, program):
        from .analysis import sub_block_pinned_reads
        fetches = self.fetch_names or ()
        if isinstance(fetches, str):
            fetches = (fetches,)
        return set(fetches) | sub_block_pinned_reads(program)

    @staticmethod
    def _eligible(block, op, pinned, def_count, version):
        from .analysis import is_pure_op
        if not is_pure_op(op):
            return False
        outs = op.output_arg_names
        if not outs:
            return False
        for n in outs:
            if n in pinned or n in version or def_count.get(n, 0) != 1:
                return False       # only fresh, single-def outputs
            if block.has_var(n) and block.var(n).persistable:
                return False
        return True

    @staticmethod
    def _key(op, version):
        attrs = tuple(sorted((k, _freeze(v)) for k, v in op.attrs.items()
                             if k != OP_ROLE_KEY))
        ins = tuple(sorted(
            (slot, tuple((n, version.get(n, 0)) for n in names))
            for slot, names in op.inputs.items()))
        out_shape = tuple(sorted((slot, len(names))
                                 for slot, names in op.outputs.items()))
        return (op.type, attrs, ins, out_shape)

    def apply(self, program):
        from .analysis import block_def_use
        block = program.global_block()
        pinned = self._pinned_names(program)
        def_count = block_def_use(program).def_count
        version = {}       # name -> rebind count (value identity)
        rename = {}        # dropped output -> canonical output
        seen = {}          # value key -> canonical op
        kept = []
        merged = 0
        for op in block.ops:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [rename.get(n, n) for n in names]
            if self._eligible(block, op, pinned, def_count, version):
                key = self._key(op, version)
                prior = seen.get(key)
                if prior is not None:
                    for slot, names in op.outputs.items():
                        for mine, theirs in zip(names,
                                                prior.outputs.get(slot, ())):
                            rename[mine] = theirs
                    merged += 1
                    continue       # drop the duplicate
                seen[key] = op
            kept.append(op)
            for n in op.output_arg_names:
                version[n] = version.get(n, 0) + 1
        block.ops = kept
        self._report = {"merged_ops": merged}


# Fusable per-param optimizer updates: the state slots beside
# Param/Grad/LearningRate.
_FUSABLE_OPTIMIZERS = {
    "sgd": (),
    "momentum": ("Velocity",),
    "adam": ("Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
    "adamw": ("Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
}
# per-param scalars or param-shaped accumulators, never concatenated
_SCALAR_STATE = frozenset({"Beta1Pow", "Beta2Pow"})
_STATE_OUT = {"Velocity": "VelocityOut", "Moment1": "Moment1Out",
              "Moment2": "Moment2Out", "Beta1Pow": "Beta1PowOut",
              "Beta2Pow": "Beta2PowOut"}


@register_pass("fuse_optimizer")
class FuseOptimizerPass(Pass):
    """Multi-tensor optimizer fusion: per-param ``sgd``, ``momentum``,
    ``adam`` or ``adamw`` ops with the same (type, param dtype,
    hyperparameters, LR var, beta-pow shape mode) fuse into
    ``fused_<type>`` ops of at most ``max_bucket_bytes`` of params
    (default ``FLAGS_fuse_optimizer_bucket_mb``), each the per-param
    update over lists of tensors, bitwise equal to the per-param ops.
    Lazy-mode adam, ops whose grad may hold a ``SelectedRows`` value
    (:meth:`_maybe_sparse_names`: an update over its rows, or one that
    densifies it, stays per-param as in the JAX pass) and ops that do
    not update their param and state in place stay unfused; a param
    larger than the cap is a bucket of one and stays a plain per-param
    op."""

    pipeline_order = 30
    fetch_names = ()
    max_bucket_bytes = None

    @staticmethod
    def _maybe_sparse_names(block):
        """Var names that may hold a ``SelectedRows`` value at run time
        (sparsity is a property of the value, not of the IR var): the
        outputs of an ``is_sparse`` grad op or of ``merge_selected_rows``,
        and of every op they feed."""
        sparse = set()
        for op in block.ops:
            src = op.type == "merge_selected_rows"
            if not src and op.type.endswith("_grad"):
                fwd = op.attrs.get("__fwd_op__")
                src = bool(op.attrs.get("is_sparse")) or (
                    isinstance(fwd, dict)
                    and bool(fwd.get("attrs", {}).get("is_sparse")))
            if src or any(n in sparse for n in op.input_arg_names):
                sparse.update(op.output_arg_names)
        return sparse

    @staticmethod
    def _candidate(block, op, sparse_names):
        """(group_key, param_bytes) when ``op`` is a fusable per-param
        update, else None."""
        state_slots = _FUSABLE_OPTIMIZERS.get(op.type)
        if state_slots is None or op.attrs.get("lazy_mode"):
            return None
        needed = ("Param", "Grad", "LearningRate") + state_slots
        if any(len(op.inputs.get(s, ())) != 1 for s in needed):
            return None
        if op.inputs["Grad"][0] in sparse_names:
            return None            # a SelectedRows grad: per-param
        pname = op.inputs["Param"][0]
        if op.outputs.get("ParamOut", [None])[0] != pname:
            return None            # only the in-place update form
        for slot in state_slots:
            if op.outputs.get(_STATE_OUT[slot], [None])[0] != \
                    op.inputs[slot][0]:
                return None        # the fused op rebinds the input names
        if not block.has_var(pname):
            return None
        pvar = block.var(pname)
        shape = pvar.shape
        if shape is None or any(int(s) < 0 for s in shape):
            return None
        # beta-pows come scalar-shaped or param-shaped; a bucket takes
        # one of the two
        pow_mode = ""
        for slot in state_slots:
            if not block.has_var(op.inputs[slot][0]):
                return None
            if slot in _SCALAR_STATE:
                sshape = block.var(op.inputs[slot][0]).shape
                if sshape is None:
                    return None
                if tuple(sshape) == tuple(shape):
                    mode = "dense"     # wins ties for ()/(1,)-params
                elif tuple(sshape) in ((), (1,)):
                    mode = "scalar"
                else:
                    return None
                if pow_mode and mode != pow_mode:
                    return None
                pow_mode = mode
        attrs = tuple(sorted(
            (k, _freeze(v)) for k, v in op.attrs.items()
            if k not in (OP_ROLE_KEY, "op_device", "lazy_mode")))
        nbytes = int(np.prod(shape, dtype=np.int64)) * _itemsize(pvar.dtype)
        key = (op.type, str(pvar.dtype), op.inputs["LearningRate"][0],
               attrs, pow_mode)
        return key, nbytes

    @staticmethod
    def _op_names(block, op):
        # a control-flow op touching an updated var only inside its
        # sub-block must still close the bucket
        from .analysis import op_reads, op_writes
        if _has_sub_block(op):
            return (op_reads(block.program, op),
                    op_writes(block.program, op))
        return set(op.input_arg_names), set(op.output_arg_names)

    @staticmethod
    def _build_fused(block, ops):
        first = ops[0]
        state_slots = _FUSABLE_OPTIMIZERS[first.type]
        inputs = {"Param": [o.inputs["Param"][0] for o in ops],
                  "Grad": [o.inputs["Grad"][0] for o in ops],
                  "LearningRate": [first.inputs["LearningRate"][0]]}
        outputs = {"ParamOut": [o.inputs["Param"][0] for o in ops]}
        for slot in state_slots:
            inputs[slot] = [o.inputs[slot][0] for o in ops]
            outputs[_STATE_OUT[slot]] = [o.inputs[slot][0] for o in ops]
        attrs = {k: v for k, v in first.attrs.items()
                 if k not in (OP_ROLE_KEY, "op_device")}
        attrs[OP_ROLE_KEY] = _OpRole.Optimize
        return _Operator(block, "fused_" + first.type, inputs=inputs,
                         outputs=outputs, attrs=attrs)

    def apply(self, program):
        block = program.global_block()
        cap = self.max_bucket_bytes or \
            int(_flag("fuse_optimizer_bucket_mb")) * (1 << 20)
        # One forward walk. A fusable op joins the open bucket of its
        # group key; the fused op is emitted where the bucket CLOSES, so
        # members only move later, to just before the first op that
        # observes them: an op that reads or rebinds a var a member
        # wrote, or rebinds a var a member read, closes the bucket first.
        new_ops = []
        open_buckets = {}       # key -> {"ops", "bytes", reads, writes}
        report = {"fused_buckets": 0, "fused_params": 0}

        def close(key):
            b = open_buckets.pop(key, None)
            if b is None:
                return
            if len(b["ops"]) == 1:
                new_ops.append(b["ops"][0])
            else:
                new_ops.append(self._build_fused(block, b["ops"]))
                report["fused_buckets"] += 1
                report["fused_params"] += len(b["ops"])

        def conflicts(reads, writes, bucket):
            return (writes & bucket["writes"] or reads & bucket["writes"]
                    or writes & bucket["reads"])

        sparse_names = self._maybe_sparse_names(block)
        for op in block.ops:
            reads, writes = self._op_names(block, op)
            cand = self._candidate(block, op, sparse_names)
            key = cand[0] if cand else None
            for k in [k for k, b in open_buckets.items()
                      if k != key and conflicts(reads, writes, b)]:
                close(k)
            if cand is None:
                new_ops.append(op)
                continue
            nbytes = cand[1]
            bucket = open_buckets.get(key)
            if bucket is not None and (
                    conflicts(reads, writes, bucket)
                    or bucket["bytes"] + nbytes > cap):
                close(key)
                bucket = None
            if bucket is None:
                bucket = {"ops": [], "bytes": 0, "reads": set(),
                          "writes": set()}
                open_buckets[key] = bucket
            bucket["ops"].append(op)
            bucket["bytes"] += nbytes
            bucket["reads"] |= reads
            bucket["writes"] |= writes
        for k in list(open_buckets):
            close(k)
        block.ops = new_ops
        self._report = report


__all__ = ["DEFAULT_PIPELINE", "Pass", "UnknownPassError",
           "apply_passes",
           "canonical_order", "get_pass", "has_pass", "list_passes",
           "optimize_program", "pipeline_signature", "register_pass",
           "resolve_pipeline", "stats"]
