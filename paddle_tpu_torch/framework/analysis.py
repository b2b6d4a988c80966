"""Static analysis over the Program IR: the def-use half the program
passes read.

A trimmed copy of ``paddle_tpu/framework/analysis.py`` (its first part):
the purity / side-effect classifier (:func:`is_side_effect_type`,
:func:`is_pure_op`), sub-block-aware read/write sets
(:func:`op_reads` / :func:`op_writes`), def-use chains keyed on binding
versions (:func:`block_def_use`) and liveness from the fetch /
persistable-write / side-effect roots (:func:`live_op_ids`, what DCE
keeps). The program verifier (``verify_program``,
``PipelineValidator``) is not ported.
"""
import collections

# Ops whose execution is observable beyond their outputs: DCE roots,
# never CSE candidates. Collective "c_*" ops count the same unlisted.
SIDE_EFFECT_OPS = frozenset({
    "print", "py_func", "runtime_assert", "assert", "feed", "fetch",
    "send", "recv", "send_barrier", "fetch_barrier", "listen_and_serv",
    "distributed_lookup_table", "pull_sparse", "pull_sparse_v2",
    "push_sparse", "push_sparse_v2", "pull_box_sparse", "push_box_sparse",
    "broadcast", "alltoall", "run_program",
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


def live_op_ids(program, fetch_names=()):
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
    pset = global_persistable_names(program)
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


__all__ = ["BlockDefUse", "OpSite", "SIDE_EFFECT_OPS", "SUB_BLOCK_ATTRS",
           "block_def_use", "global_persistable_names", "has_sub_block",
           "is_pure_op", "is_side_effect_type", "live_op_ids", "needs_rng",
           "op_reads", "op_writes", "sub_block_bound_names",
           "sub_block_pinned_reads", "writes_persistable"]
