"""Static analysis over the Program IR: def-use, liveness and the
program verifier.

A copy of ``paddle_tpu/framework/analysis.py``:

- the purity / side-effect classifier (:func:`is_side_effect_type`,
  :func:`is_pure_op`), sub-block-aware read/write sets
  (:func:`op_reads` / :func:`op_writes`), def-use chains keyed on
  binding versions (:func:`block_def_use`) and liveness from the fetch /
  persistable-write / side-effect roots (:func:`live_op_ids`, what DCE
  keeps);
- the verifier: :func:`collect_diagnostics` / :func:`verify_program`
  (the checks of :data:`CHECKS`, raising :class:`ProgramVerifyError`),
  the shape/dtype check :func:`infer_shape_diagnostics`, which runs each
  op's lowering on ``meta`` tensors where the JAX package uses
  ``jax.eval_shape``, and :class:`PipelineValidator`, the per-pass
  translation validation ``passes.optimize_program`` runs under
  ``FLAGS_verify_passes``.
"""
import collections

import torch

from .core import EnforceNotMet

# Discard sentinel for unneeded grad outputs: a write sink, legitimately
# repeated within one grad op, never read.
EMPTY_VAR = "@EMPTY@"

# Ops whose execution is observable beyond their outputs: DCE roots,
# never CSE candidates. Collective "c_*" ops count the same unlisted:
# every rank of a data-parallel world must issue the same collectives
# in the same order, so none is dropped, merged or reordered (the
# sync_batch_norm ops all-reduce their statistics).
SIDE_EFFECT_OPS = frozenset({
    "print", "py_func", "runtime_assert", "assert", "feed", "fetch",
    "send", "recv", "send_barrier", "fetch_barrier", "listen_and_serv",
    "distributed_lookup_table", "pull_sparse", "pull_sparse_v2",
    "push_sparse", "push_sparse_v2", "pull_box_sparse", "push_box_sparse",
    "broadcast", "alltoall", "run_program", "allreduce", "sync_batch_norm",
    "hier_allreduce", "mp_allreduce_sum",
})

# the attrs that name a control-flow op's sub-blocks
SUB_BLOCK_ATTRS = ("sub_block", "sub_block_true", "sub_block_false")

_side_effect_memo = {}


def is_side_effect_type(t):
    """Side-effecting op types, their grad ops included (a grad lowering
    can carry the effect itself)."""
    r = _side_effect_memo.get(t)
    if r is None:
        if t in SIDE_EFFECT_OPS or t.startswith("c_"):
            r = True
        else:
            r = t.endswith("_grad") and is_side_effect_type(t[:-5])
        _side_effect_memo[t] = r
    return r


def has_sub_block(op):
    return any(op.attrs.get(a) is not None for a in SUB_BLOCK_ATTRS)


def _ops():
    from .registry import OPS
    return OPS


def needs_rng(op):
    """Whether ``op`` draws from the program's random stream (its own
    ``__rng_seed__``, or a registered op marked needs_rng; grad ops
    inherit the forward's classification)."""
    if "__rng_seed__" in op.attrs:
        return True
    OPS = _ops()
    t = op.type
    base = OPS.get(t) or (OPS.get(t[:-5]) if t.endswith("_grad") else None)
    return bool(base is not None and base.needs_rng)


def rng_seed_of(op):
    """The seed naming an op's random stream: its own ``__rng_seed__``,
    the forward op's for a grad op (inside ``__fwd_op__``), or a pinned
    ``seed`` attr. None: no stream identity (``missing-rng-seed``)."""
    seed = op.attrs.get("__rng_seed__")
    if seed is not None:
        return seed
    fwd = op.attrs.get("__fwd_op__")
    if isinstance(fwd, dict):
        seed = fwd.get("attrs", {}).get("__rng_seed__")
        if seed is not None:
            return seed
    return op.attrs.get("seed") or None


def writes_persistable(block, op):
    return any(block.has_var(n) and block.var(n).persistable
               for n in op.output_arg_names)


def is_pure_op(op):
    """Pure = removable when its outputs are dead, mergeable when its
    value is duplicated: registered, no side effects, no sub-block, no
    random stream."""
    from .registry import has_op
    return (has_op(op.type) and not is_side_effect_type(op.type)
            and not has_sub_block(op) and not needs_rng(op))


# ---------------------------------------------------------------------------
# Sub-block-aware read/write sets.
# ---------------------------------------------------------------------------

def sub_block_bound_names(op):
    """Names a control-flow op binds inside its sub-block (scan slices,
    loop memories, branch operands): defined there, not read from the
    enclosing frame."""
    bound = set(op.attrs.get("step_input_vars", ()))
    for m in op.attrs.get("memories", ()):
        bound.add(m[0] if isinstance(m, (list, tuple)) else m)
    bound.update(op.attrs.get("x_names", ()))
    if "x_name" in op.attrs:
        bound.add(op.attrs["x_name"])
    return bound


def _sub_blocks(program, op, seen):
    """The valid sub-block indices of ``op`` not yet walked (dangling or
    cyclic attrs are skipped)."""
    for attr in SUB_BLOCK_ATTRS:
        sb = op.attrs.get(attr)
        if isinstance(sb, int) and 0 <= sb < len(program.blocks) \
                and sb not in seen:
            seen.add(sb)
            yield program.blocks[sb]


def op_reads(program, op, _seen=None):
    """Every var name an op (transitively, through its sub-blocks) reads
    from its defining block's frame."""
    reads = set(op.input_arg_names)
    _seen = set() if _seen is None else _seen
    for blk in _sub_blocks(program, op, _seen):
        inner = sub_block_bound_names(op)
        for sop in blk.ops:
            reads.update(n for n in op_reads(program, sop, _seen)
                         if n not in inner)
            inner.update(sop.output_arg_names)
    return reads


def op_writes(program, op, _seen=None):
    """Every var name an op writes into its defining block's frame: its
    own outputs plus the sub-block ops' outputs it did not bind
    locally."""
    writes = set(op.output_arg_names)
    _seen = set() if _seen is None else _seen
    for blk in _sub_blocks(program, op, _seen):
        inner = sub_block_bound_names(op)
        for sop in blk.ops:
            writes.update(n for n in op_writes(program, sop, _seen)
                          if n not in inner)
    return writes


def sub_block_pinned_reads(program):
    """Every name a control-flow op (transitively) reads: renames do not
    descend into sub-blocks, so these names stay fixed under CSE."""
    pinned = set()
    for blk in program.blocks:
        for op in blk.ops:
            if has_sub_block(op):
                pinned |= op_reads(program, op)
    return pinned


# ---------------------------------------------------------------------------
# Def-use chains keyed on binding versions.
# ---------------------------------------------------------------------------

class OpSite:
    """One op of a block walk: reads and writes as (name, version)."""

    __slots__ = ("index", "op", "reads", "writes")

    def __init__(self, index, op, reads, writes):
        self.index = index
        self.op = op
        self.reads = reads
        self.writes = writes


class BlockDefUse:
    """Def-use over one block's op list. A value is ``(name, version)``:
    version 0 is the binding live at block entry (feed or scope state),
    each write creates version + 1.

    - ``sites``: one :class:`OpSite` per op, in order
    - ``defs``: (name, version) -> defining op index (version >= 1)
    - ``uses``: (name, version) -> [op indices reading that binding]
    - ``def_count``: name -> number of writes in the block
    """

    def __init__(self, program, block):
        self.program = program
        self.block = block
        self.sites = []
        self.defs = {}
        self.uses = collections.defaultdict(list)
        self.def_count = collections.Counter()
        version = collections.Counter()
        for i, op in enumerate(block.ops):
            reads = tuple((n, version[n]) for n in op.input_arg_names)
            for key in reads:
                self.uses[key].append(i)
            writes = []
            for n in op.output_arg_names:
                version[n] += 1
                self.def_count[n] += 1
                writes.append((n, version[n]))
                self.defs[(n, version[n])] = i
            self.sites.append(OpSite(i, op, reads, tuple(writes)))


def block_def_use(program, block_idx=0):
    return BlockDefUse(program, program.blocks[block_idx])


# ---------------------------------------------------------------------------
# Liveness: reachability from the fetch / persistable-write / side-effect
# roots (what DCE keeps).
# ---------------------------------------------------------------------------

def global_persistable_names(program):
    return {n for n, v in program.global_block().vars.items()
            if v.persistable}


def live_op_ids(program, fetch_names=(), _pset=None):
    """ids of the global-block ops reachable (backwards) from the fetch
    targets, persistable writes and side-effect roots. A root is an op
    that has side effects, a sub-block or no outputs, is of an
    unregistered type, or writes a persistable or fetched var;
    control-flow ops keep their whole sub-block."""
    from .registry import has_op
    block = program.global_block()
    if isinstance(fetch_names, str):
        fetch_names = (fetch_names,)
    needed = set(fetch_names or ())
    pset = global_persistable_names(program) if _pset is None else _pset
    live = set()
    for op in reversed(block.ops):
        sub = has_sub_block(op)
        if (is_side_effect_type(op.type) or sub or not op.outputs
                or not has_op(op.type)
                or any(n in pset or n in needed
                       for n in op.output_arg_names)):
            live.add(id(op))
            needed.update(op_reads(program, op) if sub
                          else op.input_arg_names)
    return live




# ---------------------------------------------------------------------------
# The program verifier.
# ---------------------------------------------------------------------------

#: code -> one-line description; every checker emits one of these codes
CHECKS = {
    "unknown-op": "op type is not in the registry (framework.registry."
                  "OPS) and has no generic grad fallback",
    "missing-rng-seed": "an RNG-consuming op lost its __rng_seed__ attr "
                        "(its stream would collide with seed 0)",
    "dangling-read": "op reads a var no op defines that is neither "
                     "persistable, fed, nor data",
    "use-before-def": "op reads a var that is only defined by a LATER "
                      "op in the same block",
    "duplicate-output": "one op lists the same output name more than "
                        "once (ambiguous binding)",
    "dead-persistable-write": "a pure op's persistable write is "
                              "clobbered before any op reads it "
                              "(pedantic tier: per-pass validation only "
                              "-- user programs legally double-init "
                              "shared params)",
    "sub-block-scope": "a sub-block op reads a name invisible in its "
                       "frame chain, or a sub_block attr points at a "
                       "missing/mis-parented block",
    "unreachable-fetch": "a fetch target no op produces and the scope "
                         "cannot supply",
    "shape-mismatch": "declared output shape disagrees with the "
                      "registry lowering's inferred shape",
    "dtype-mismatch": "declared output dtype disagrees with the "
                      "registry lowering's inferred dtype",
    # translation-validation codes (pass-pair checks; PipelineValidator)
    "rng-stream-dropped": "a live RNG op's stream disappeared across a "
                          "pass (e.g. CSE merged two dropout ops)",
    "side-effect-dropped": "a live side-effecting op disappeared across "
                           "a pass",
    "persistable-write-dropped": "a live persistable write (e.g. an "
                                 "optimizer update) disappeared across "
                                 "a pass",
    "reordered-past-observer": "a write moved across a side-effect/"
                               "sub-block op that observes that var",
}


class Diagnostic:
    """One verifier finding. ``key`` is stable across op-index shifts, so
    the pipeline input's findings can be told apart from a pass's."""

    __slots__ = ("code", "message", "block_idx", "op_index", "op_type",
                 "var")

    def __init__(self, code, message, block_idx=0, op_index=None,
                 op_type=None, var=None):
        self.code = code
        self.message = message
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.var = var

    @property
    def key(self):
        return (self.code, self.block_idx, self.op_type, self.var)

    def __str__(self):
        loc = f"block {self.block_idx}"
        if self.op_index is not None:
            loc += f" op #{self.op_index}"
        if self.op_type:
            loc += f" ({self.op_type})"
        return f"[{self.code}] {loc}: {self.message}"

    def __repr__(self):
        return f"Diagnostic({self!s})"


class ProgramVerifyError(EnforceNotMet):
    """A program failed verification. ``code`` (one of :data:`CHECKS`),
    ``op_index``/``op_type``/``block_idx``/``var`` locate the first
    finding, ``pass_name`` names the pass that produced the program
    (per-pass validation), ``diagnostics`` holds every finding."""

    def __init__(self, diagnostics, pass_name=None, program_desc=None):
        if isinstance(diagnostics, Diagnostic):
            diagnostics = [diagnostics]
        self.diagnostics = list(diagnostics)
        first = self.diagnostics[0]
        self.code = first.code
        self.op_index = first.op_index
        self.op_type = first.op_type
        self.block_idx = first.block_idx
        self.var = first.var
        self.pass_name = pass_name
        if pass_name:
            head = f"pass {pass_name!r} produced an invalid program"
        elif program_desc:
            head = f"program verification failed ({program_desc})"
        else:
            head = "program verification failed"
        msg = f"{head}: {first}"
        more = len(self.diagnostics) - 1
        if more:
            msg += f" (+{more} more finding{'s' if more > 1 else ''})"
        super().__init__(msg)


class _WalkState:
    """Mutable state of the verifier walk (one traversal runs the schema,
    def-use, duplicate-output and dead-persistable checks together)."""

    __slots__ = ("diags", "all_defs", "pset0", "pending", "pversion",
                 "visited", "pedantic")

    def __init__(self, diags, all_defs, pset0, pedantic=False):
        self.diags = diags
        self.all_defs = all_defs     # every name any op writes
        self.pset0 = pset0           # global-block persistable names
        self.pending = {}            # unread pure persistable writes
        self.pversion = collections.Counter()
        self.visited = set()         # block idxs reached from block 0
        self.pedantic = pedantic     # dead-persistable-write tier


def _opdef_of(t):
    OPS = _ops()
    return OPS.get(t) or (OPS.get(t[:-5]) if t.endswith("_grad") else None)


def _walk_block(program, block_idx, defined, st, depth=0):
    """The verifier walk over one block: ``defined`` holds the names
    bound at its entry (extended as ops write). Per op: registered type
    and RNG seed, duplicate outputs, read binding (dangling-read /
    use-before-def / sub-block-scope), dead persistable writes (block 0
    straight line, pedantic only) and descent into sub-blocks."""
    st.visited.add(block_idx)
    diags = st.diags
    all_defs = st.all_defs
    block = program.blocks[block_idx]
    for i, op in enumerate(block.ops):
        t = op.type
        opdef = _opdef_of(t)
        registered = opdef is not None
        if not registered:
            diags.append(Diagnostic(
                "unknown-op",
                f"op type {t!r} is not registered (version skew, or a "
                f"pass invented it); known ops live in "
                f"framework.registry.OPS", block_idx, i, t))
        elif opdef.needs_rng and rng_seed_of(op) is None:
            diags.append(Diagnostic(
                "missing-rng-seed",
                "RNG op lost its __rng_seed__ attr: its stream would "
                "collide with every other seedless op", block_idx, i, t))
        # duplicate outputs within one op (@EMPTY@ is a discard sink)
        outs = op.output_arg_names
        culled = [n for n in outs if n != EMPTY_VAR]
        if len(culled) != len(set(culled)):
            dup = next(n for n in culled if culled.count(n) > 1)
            diags.append(Diagnostic(
                "duplicate-output",
                f"op writes {dup!r} more than once in one invocation",
                block_idx, i, t, dup))
        # reads must be bound (and they settle pending persistable writes)
        pending = st.pending
        for n in op.input_arg_names:
            pending.pop(n, None)
            if n in defined:
                continue
            if n in all_defs:
                code = "sub-block-scope" if depth else "use-before-def"
                where = "outside this frame chain" if depth \
                    else "by a later op"
                msg = f"reads {n!r}, which is only defined {where}"
            else:
                code = "sub-block-scope" if depth else "dangling-read"
                msg = (f"reads {n!r}, which no op defines and which is "
                       f"neither persistable, fed, nor data")
            diags.append(Diagnostic(code, msg, block_idx, i, t, n))
            defined.add(n)           # report each missing name once
        if has_sub_block(op):
            for attr in SUB_BLOCK_ATTRS:
                sb = op.attrs.get(attr)
                if sb is None:
                    continue
                if not isinstance(sb, int) or \
                        not 0 <= sb < len(program.blocks):
                    diags.append(Diagnostic(
                        "sub-block-scope",
                        f"attr {attr!r} points at missing block {sb!r}",
                        block_idx, i, t))
                    continue
                if sb in st.visited:
                    diags.append(Diagnostic(
                        "sub-block-scope",
                        f"attr {attr!r} points at block {sb}, which is "
                        f"already owned by another op (cyclic or "
                        f"mis-parented sub_block)", block_idx, i, t))
                    continue
                inner = set(defined) | sub_block_bound_names(op)
                _walk_block(program, sb, inner, st, depth + 1)
                # sub-block writes land in the shared env
                defined.update(n for n in inner if n not in defined
                               and n in all_defs)
        # writes: bind names; pedantic mode also tracks pure persistable
        # writes clobbered before any read (block 0 only: a sub-block
        # write is conditional, so it settles the pending write)
        if not st.pedantic:
            defined.update(outs)
            continue
        exempt = (not registered or is_side_effect_type(t)
                  or has_sub_block(op))
        for n in outs:
            defined.add(n)
            if n not in st.pset0:
                continue
            if depth:
                pending.pop(n, None)
                continue
            st.pversion[n] += 1
            prior = pending.pop(n, None)
            if prior is not None and not exempt:
                diags.append(Diagnostic(
                    "dead-persistable-write",
                    f"write #{prior[2]} of persistable {n!r} is "
                    f"clobbered by a later write with no read in "
                    f"between", 0, prior[0], prior[1].type, n))
            if not exempt:
                pending[n] = (i, op, st.pversion[n])


def collect_diagnostics(program, fetch_names=(), feed_names=(),
                        scope_names=None, check_shapes=False,
                        pedantic=False):
    """Run every checker and return the findings (empty: the program is
    clean). :func:`verify_program` is the raising form. ``pedantic``
    adds the dead-persistable-write check (per-pass validation, where
    the pipeline input's findings are subtracted)."""
    if isinstance(fetch_names, str):
        fetch_names = (fetch_names,)
    if isinstance(feed_names, str):
        feed_names = (feed_names,)
    diags = []
    # bound before the first op: feeds, data vars and scope state
    # (persistable vars stand in for the scope when none is given)
    entry = set(feed_names or ())
    for blk in program.blocks:
        for n, v in blk.vars.items():
            if v.persistable or v.is_data:
                entry.add(n)
    if scope_names is not None:
        entry.update(scope_names)
    all_defs = set()
    for blk in program.blocks:
        for op in blk.ops:
            all_defs.update(op.output_arg_names)

    st = _WalkState(diags, all_defs, global_persistable_names(program),
                    pedantic=pedantic)
    _walk_block(program, 0, set(entry), st)
    # blocks no sub_block attr reaches still get the schema checks
    for blk in program.blocks:
        if blk.idx in st.visited:
            continue
        for i, op in enumerate(blk.ops):
            opdef = _opdef_of(op.type)
            if opdef is None:
                diags.append(Diagnostic(
                    "unknown-op", f"op type {op.type!r} is not "
                    f"registered", blk.idx, i, op.type))
            elif needs_rng(op) and rng_seed_of(op) is None:
                diags.append(Diagnostic(
                    "missing-rng-seed", "RNG op lost its __rng_seed__ "
                    "attr", blk.idx, i, op.type))
    for n in (fetch_names or ()):
        if n not in all_defs and n not in entry:
            diags.append(Diagnostic(
                "unreachable-fetch",
                f"fetch target {n!r}: no op produces it and it is "
                f"neither persistable, fed, nor scope state", 0, None,
                None, n))
    if check_shapes:
        diags.extend(infer_shape_diagnostics(program))
    return diags


def verify_program(program, fetch_names=(), feed_names=(),
                   scope_names=None, check_shapes=False,
                   provenance=None, pedantic=False):
    """Raise :class:`ProgramVerifyError` on the first finding of
    :func:`collect_diagnostics` (all of them ride on ``.diagnostics``).
    ``scope_names``: the names the executing scope holds, when known;
    ``check_shapes`` re-derives output shapes and dtypes through each
    op's lowering; ``provenance`` names the producing pass."""
    diags = collect_diagnostics(program, fetch_names, feed_names,
                                scope_names, check_shapes, pedantic)
    if diags:
        raise ProgramVerifyError(diags, pass_name=provenance)


# ---------------------------------------------------------------------------
# Shape/dtype checking through the registered lowerings.
# ---------------------------------------------------------------------------

def infer_shape_diagnostics(program):
    """Each global-block op's declared output shapes and dtypes against
    what its registered lowering gives on ``meta`` tensors (no data, no
    compute; what ``registry.infer_op_shapes`` runs at build time, here
    without writing anything back). Ops with a custom or disabled shape
    inference, grad ops, and ops with an unknown or dynamic input shape
    are skipped; a -1 declared dim matches any size."""
    from .dtype import dtype_name, torch_dtype
    from .lowering import LowerCtx
    from .registry import normalize_outs

    diags = []
    block = program.global_block()
    ctx = LowerCtx(program, block, env=None, device="meta", abstract=True)
    for i, op in enumerate(block.ops):
        opdef = _ops().get(op.type)
        if opdef is None or opdef.infer_shape is not None \
                or "__fwd_op__" in op.attrs:
            continue
        ins = {}
        for slot, names in op.inputs.items():
            ts = []
            for n in names:
                v = block.vars.get(n)
                if v is None or v.shape is None or \
                        any(int(s) < 0 for s in v.shape):
                    break
                ts.append(torch.empty(tuple(v.shape),
                                      dtype=torch_dtype(v.dtype),
                                      device="meta"))
            if len(ts) != len(names):
                ins = None
                break
            ins[slot] = ts
        if ins is None:
            continue
        try:
            outs = normalize_outs(opdef.lower(ctx, ins, op.attrs))
        except Exception:  # noqa: BLE001 — a value-dependent op: skip
            continue
        for slot, names in op.outputs.items():
            for n, t in zip(names, outs.get(slot) or ()):
                var = block.vars.get(n)
                if t is None or var is None or var.shape is None:
                    continue
                inferred = tuple(int(d) for d in t.shape)
                decl = tuple(var.shape)
                if len(decl) != len(inferred) or any(
                        d != -1 and d != e for d, e in zip(decl, inferred)):
                    diags.append(Diagnostic(
                        "shape-mismatch",
                        f"{n!r} declared {decl} but the registered "
                        f"lowering infers {inferred}", 0, i, op.type, n))
                    continue
                inf_dtype = dtype_name(t.dtype)
                if str(var.dtype) != inf_dtype:
                    diags.append(Diagnostic(
                        "dtype-mismatch",
                        f"{n!r} declared dtype {var.dtype} but the "
                        f"registered lowering infers {inf_dtype}", 0, i,
                        op.type, n))
    return diags


# ---------------------------------------------------------------------------
# Per-pass translation validation.
# ---------------------------------------------------------------------------

class TranslationSummary:
    """What a correct pass preserves, cheap to recompute per pass:
    multisets over LIVE ops (so a correct DCE changes nothing) and, per
    observer (a side-effect or sub-block op), how many writes of each
    name it reads happened before it."""

    __slots__ = ("rng_seeds", "side_effects", "persist_writes",
                 "observer_counts")

    def __init__(self, program, fetch_names=()):
        pset = global_persistable_names(program)
        live = live_op_ids(program, fetch_names, _pset=pset)
        block = program.global_block()
        self.rng_seeds = collections.Counter()
        self.side_effects = collections.Counter()
        # a multiset: dropping one of several live writes of a var must
        # not hide behind the survivors
        self.persist_writes = collections.Counter()
        self.observer_counts = {}
        observers = []
        for op in block.ops:
            if id(op) not in live:
                continue
            if needs_rng(op):
                self.rng_seeds[(op.type, rng_seed_of(op))] += 1
            side = is_side_effect_type(op.type)
            if side:
                self.side_effects[op.type] += 1
            for n in op.output_arg_names:
                if n in pset:
                    self.persist_writes[n] += 1
            if side or has_sub_block(op):
                observers.append(op)
        if observers:
            obs_ids = {id(op) for op in observers}
            writes_so_far = collections.Counter()
            for op in block.ops:
                if id(op) not in live:
                    continue
                if id(op) in obs_ids:
                    self.observer_counts[id(op)] = {
                        n: writes_so_far[n]
                        for n in op_reads(program, op)}
                writes_so_far.update(op.output_arg_names)


def compare_summaries(before, after):
    """Findings for the invariants a pass broke: live RNG streams,
    side-effect ops and persistable writes must survive (additions are
    allowed); an observer present in both programs must have seen the
    same number of writes of every name it reads."""
    diags = []
    for (t, seed), cnt in (before.rng_seeds - after.rng_seeds).items():
        diags.append(Diagnostic(
            "rng-stream-dropped",
            f"{cnt} live {t!r} op(s) with __rng_seed__={seed} "
            f"disappeared (RNG ops are never mergeable/removable while "
            f"live)", 0, None, t))
    for t, cnt in (before.side_effects - after.side_effects).items():
        diags.append(Diagnostic(
            "side-effect-dropped",
            f"{cnt} live side-effecting {t!r} op(s) disappeared", 0,
            None, t))
    for n, cnt in sorted(
            (before.persist_writes - after.persist_writes).items()):
        diags.append(Diagnostic(
            "persistable-write-dropped",
            f"{cnt} live write(s) of persistable {n!r} (e.g. an "
            f"optimizer update) disappeared", 0, None, None, n))
    for oid, counts in before.observer_counts.items():
        now = after.observer_counts.get(oid)
        if now is None:
            continue                 # the observer itself is flagged
        for name, cnt in counts.items():
            # a name missing now was renamed by a CSE merge of a pure
            # producer; persistables are never renamed
            if name in now and now[name] != cnt:
                diags.append(Diagnostic(
                    "reordered-past-observer",
                    f"the observer saw {cnt} write(s) of {name!r} "
                    f"before the pass but {now[name]} after: a write "
                    f"moved across an op that observes it", 0, None,
                    None, name))
    return diags


class PipelineValidator:
    """Per-pass translation validation for ``passes.optimize_program``.

    After every pass the :class:`TranslationSummary` of its output is
    compared with the previous one, and a broken invariant raises at
    once, naming the pass. The full well-formedness collect runs once,
    on the pipeline's output (:meth:`finalize`), and counts only
    findings the pipeline input did not have; on such a finding the
    pipeline is replayed from a fresh clone, collecting after each pass,
    to name the pass that introduced it. ``verify_ms`` accumulates the
    validation's wall time, ``last_pass_ms`` the last pass's share."""

    def __init__(self, program, fetch_names=(), replay=None):
        import time
        t0 = time.perf_counter()
        if isinstance(fetch_names, str):
            fetch_names = (fetch_names,)
        self.fetch_names = tuple(fetch_names or ())
        self._replay = replay        # () -> (fresh clone, [passes])
        # the input's findings are needed only once the output shows one;
        # with a replay they are collected then, from a fresh clone
        self.baseline = None
        if replay is None:
            self.baseline = self._keys(program)
        self.summary = TranslationSummary(program, self.fetch_names)
        self.verify_ms = (time.perf_counter() - t0) * 1e3
        self.last_pass_ms = 0.0

    def _keys(self, program):
        return collections.Counter(
            d.key for d in collect_diagnostics(program, self.fetch_names,
                                               pedantic=True))

    def _baseline_keys(self):
        if self.baseline is None:
            self.baseline = self._keys(self._replay()[0])
        return self.baseline

    def _new_diags(self, program):
        diags = collect_diagnostics(program, self.fetch_names,
                                    pedantic=True)
        if not diags:
            return diags
        # a multiset: a pass's second finding on the same key as an
        # input finding still counts
        baseline = self._baseline_keys()
        seen = collections.Counter()
        fresh = []
        for d in diags:
            seen[d.key] += 1
            if seen[d.key] > baseline.get(d.key, 0):
                fresh.append(d)
        return fresh

    def after_pass(self, program, pass_name):
        import time
        t0 = time.perf_counter()
        try:
            summary = TranslationSummary(program, self.fetch_names)
            sem = compare_summaries(self.summary, summary)
            if sem:
                raise ProgramVerifyError(sem, pass_name=pass_name)
            self.summary = summary
        finally:
            self.last_pass_ms = (time.perf_counter() - t0) * 1e3
            self.verify_ms += self.last_pass_ms

    def finalize(self, program, last_pass_name=None):
        """The full collect over the pipeline's output; on a new finding,
        replay the pipeline pass by pass to name the pass that made it."""
        import time
        t0 = time.perf_counter()
        try:
            diags = self._new_diags(program)
            if not diags:
                return
            if self._replay is not None:
                prog, pipeline = self._replay()
                for p in pipeline:
                    pname = getattr(p, "name", None) or type(p).__name__
                    prog = p(prog) or prog
                    step = self._new_diags(prog)
                    if step:
                        raise ProgramVerifyError(step, pass_name=pname)
            raise ProgramVerifyError(diags, pass_name=last_pass_name)
        finally:
            self.verify_ms += (time.perf_counter() - t0) * 1e3


__all__ = ["BlockDefUse", "CHECKS", "Diagnostic", "EMPTY_VAR", "OpSite",
           "PipelineValidator", "ProgramVerifyError", "SIDE_EFFECT_OPS",
           "SUB_BLOCK_ATTRS", "TranslationSummary", "block_def_use",
           "collect_diagnostics", "compare_summaries",
           "global_persistable_names", "has_sub_block",
           "infer_shape_diagnostics", "is_pure_op", "is_side_effect_type",
           "live_op_ids", "needs_rng", "op_reads", "op_writes",
           "rng_seed_of", "sub_block_bound_names", "sub_block_pinned_reads",
           "verify_program", "writes_persistable"]
