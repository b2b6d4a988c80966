"""Pipeline parallelism over the ``pp`` axis: the per-rank rewrite of a
program's stage state (pass ``pp_shard``).

``layers.Pipeline`` stacks every parameter created inside its stage to
a leading ``[S]`` dim annotated ``("pp",)``, and the optimizer's
accumulators of that shape copy the annotation. The JAX package lets
GSPMD split those on ``pp`` inside its ``shard_map``. The port runs one
process per card, so :func:`pp_rewrite` gives each pp rank its stage's
``[1, ...]`` slice: for every ``pipeline`` op whose ``num_stages`` is
the mesh's pp size, each ``("pp",)`` persistable of ``[S, ...]`` (its
stage parameters and their accumulators), each stage parameter's grad
and every value an elementwise op makes of them take the slice's shape,
and their layouts (``parallel.tp.Layout`` on axis ``pp``) go to the
executor, which cuts the slice out of a whole value before a run reads
it and gathers it back for a save, as it does tp shards. A pipeline
whose ``num_stages`` is not the pp size takes the sequential path on
every rank (the JAX op's rule), its state whole.

A stage's ops run on a pp rank only at its own ticks, so a stage
that holds a collective (it would wait for ranks that skip the tick)
or a batch-statistics op raises ``NotImplementedError``: under dp the
JAX package normalizes over each device's share of a microbatch's rows,
where a dp rank here holds whole microbatches of its own rows, so the
statistics would differ.

What reads a slice must be elementwise: the ``pipeline`` op and its
grad (whose schedule picks the rank's stage by its pp coordinate), the
elementwise optimizer updates (SGD, Momentum, Adam, AdamW, ...) and the
elementwise ops of regularization. Anything else (a global-norm clip, a
LAMB trust ratio, a stage parameter read outside the stage) raises
``NotImplementedError`` naming the op, rather than compute on a slice
as on the whole (:func:`cut_state`, which ``parallel.ep`` shares for
the experts' slices).

With ``tp`` or ``sp`` beside ``pp`` every tp and sp rank of a pp
coordinate runs its stage whole, on the whole sequence, as the JAX
op's ``shard_map`` does (``P("pp")`` for the stacked parameters,
``P()`` for the outer reads, ``P(None, "dp")`` for the microbatches):
the slices are cut per pp coordinate only, the ``pipeline`` op is a
replicated region to passes ``tp_shard`` and ``sp_shard`` (an input
split on tp or on the sequence is gathered whole before it; the stage
is not rewritten), and only the ops outside it take the tp and sp
layouts.
"""
from .tp import _ELEMENTWISE, _ELEMENTWISE_OPT, Layout, local_shape

PP = "pp"
# ops that may read a stage slice: they compute each element of their
# output from the same element of their inputs
_SLICE_OPS = (_ELEMENTWISE | _ELEMENTWISE_OPT
              | {"scale", "sum", "assign", "cast", "fill_zeros_like",
                 "where", "c_coalesced_allreduce_sum", "clip"})


def not_ported(what):
    from .mesh import not_ported_7b
    return not_ported_7b(f"pipeline parallelism: {what}")


_BATCH_STATS = ("batch_norm", "sync_batch_norm")


def check_stage(program, op):
    """Raise for a pipeline stage whose ops cannot run on the ticks of
    one pp rank alone (a collective, a batch-statistics op)."""
    from ..framework.analysis import SUB_BLOCK_ATTRS, is_side_effect_type

    def walk(idx):
        for sop in program.blocks[idx].ops:
            if sop.type in _BATCH_STATS or is_side_effect_type(sop.type):
                raise not_ported(f"op {sop.type!r} in a pipeline stage (a "
                                 f"collective, or batch statistics over a "
                                 f"microbatch's rows)")
            for attr in SUB_BLOCK_ATTRS:
                if sop.attrs.get(attr) is not None:
                    walk(sop.attrs[attr])

    walk(op.attrs["sub_block"])


def pp_rewrite(program, mesh):
    """Rewrite ``program`` in place for ``mesh``'s pp axis; returns
    ``{name: Layout}`` of the persistables cut to the rank's stage slice
    (empty at pp 1, or when no pipeline has pp stages)."""
    from .mesh import axis_size
    pp = axis_size(mesh, PP)
    if pp == 1:
        return {}
    from .ep import check_mesh
    check_mesh(mesh, program)   # a switch_moe in a stage under ep
    stage_params = set()
    for blk in program.blocks:
        for op in blk.ops:
            if op.type != "pipeline":
                continue
            if blk.idx != 0:
                raise not_ported("a layers.Pipeline inside a control-flow "
                                 "block")
            if int(op.attrs["num_stages"]) == pp:
                check_stage(program, op)
                stage_params.update(op.input("P"))
    if not stage_params:
        return {}
    layouts = cut_state(program, PP, pp, not_ported, _pipeline_grads,
                        ("pipeline",), lambda v: v.shape[0] == pp)
    program._pp_report = {"stage_slices": len(layouts),
                          "values_cut": program._cut_report}
    return layouts


def _pipeline_grads(op):
    """The stage parameters' grads a ``pipeline_grad`` op writes."""
    if op.type != "pipeline_grad":
        return None
    return list(zip(op.input("P"), op.output("P@GRAD")))


def cut_state(program, axis, size, fail, grads_of, readers, whole_ok):
    """Cut every persistable annotated ``(axis,)`` on its leading dim
    (``whole_ok(var)`` holding) to the rank's slice, with every value
    made of one: the grads ``grads_of(op)`` lists as (param, grad)
    pairs, and what an elementwise op or optimizer makes of a slice (its
    outputs of the whole shape). Only those ops and the ``readers`` may
    read a slice; another raises ``fail(why)``. Returns ``{name:
    Layout}`` of the persistables cut."""
    block = program.global_block()
    layouts = {}
    for n, v in block.vars.items():
        spec = tuple(v.dist_attr or ())
        if v.persistable and spec[:1] == (axis,) and v.shape and \
                whole_ok(v):
            layouts[n] = Layout(0, 1, tuple(v.shape), axis)
    cut = set(layouts)
    for op in block.ops:
        pairs = grads_of(op)
        if pairs is not None:
            for p, g in pairs:
                if p in cut and g != "@EMPTY@":
                    cut.add(g)
            continue
        touched = [n for n in op.input_arg_names if n in cut]
        if not touched or op.type in readers:
            continue
        if op.type not in _SLICE_OPS:
            raise fail(f"op {op.type!r} reads the {axis} slices "
                       f"{sorted(touched)[:4]}; only "
                       f"{' and '.join(readers)}, elementwise ops and the "
                       f"elementwise optimizers may")
        full = {tuple(block.var(n).shape) for n in touched}
        for n in op.input_arg_names:
            if n not in cut and tuple(block.var(n).shape or ()) in full:
                raise fail(f"op {op.type!r} reads the {axis} slice "
                           f"{touched[0]!r} beside the whole {n!r}")
        for n in op.output_arg_names:
            if tuple(block.var(n).shape or ()) in full:
                cut.add(n)
    for n in cut:
        v = block.var(n)
        v.shape = local_shape(Layout(0, 1, tuple(v.shape), axis), size)
    program._bump_version()
    program._cut_report = len(cut)
    return layouts


__all__ = ["check_stage", "cut_state", "pp_rewrite"]
