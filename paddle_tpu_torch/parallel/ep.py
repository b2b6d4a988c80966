"""Expert parallelism over the ``ep`` axis: the per-rank cut of a
program's expert state (pass ``ep_shard``).

``layers.switch_moe`` stacks its experts' weights to a leading ``[E]``
dim annotated ``("ep",)``, and the optimizer's accumulators of that
shape copy the annotation. The JAX package lets GSPMD split them on
``ep`` and insert the all-to-alls. The port runs one process per card,
so :func:`ep_rewrite` gives each ep rank its ``[E / ep, ...]`` slice:
each ``("ep",)`` persistable whose leading dim divides by the ep size,
each expert parameter's grad and every value an elementwise op makes of
them take the slice's shape (``parallel.pp.cut_state``), and their
layouts (``parallel.tp.Layout`` on axis ``ep``) go to the executor,
which cuts the slice out of a whole value before a run reads it and
gathers it back for a save, as it does tp shards and pp slices. The
``switch_moe`` op and its grad run the rank's experts and exchange the
tokens (``ops.moe_ops``).

The feed is split over ``dp`` only, as the JAX package's ``("dcn_dp",
"dp")`` batch spec splits it: the ``ep`` ranks of one ``dp`` coordinate
are fed the same rows. Everything outside ``switch_moe`` runs on every
ep rank alike, so the grads are averaged over ``dp`` only (an expert
slice's grad is the rank's own; a replicated one is equal on the ep
ranks of a dp coordinate).

Beside ``tp``, ``sp`` or ``pp`` the experts are cut per ``ep``
coordinate only and stay whole across the other axes: ``switch_moe`` is
a replicated region, as the ``pipeline`` op is (its input whole, every
tp and sp rank of a (dp, ep) coordinate routing the same tokens over its
``dp_ep`` group). Its experts carry no ``tp`` annotation, so
``tp_shard`` splits nothing of it. A ``switch_moe`` inside a
``layers.Pipeline`` stage or another sub-block under ep raises
``NotImplementedError`` (:func:`check_mesh`; the JAX package's own
``shard_ep`` fails there with a ``ValueError``), as does a grad of an
expert slice that something other than the elementwise ops and
optimizers reads (a global-norm clip).
"""
from .pp import cut_state

EP = "ep"


def not_ported(what):
    from .mesh import not_ported_7b
    return not_ported_7b(f"expert parallelism: {what}")


#: the JAX package's own refusal of an ep-split switch_moe inside a
#: pipeline stage (``moe_ops.shard_ep`` under the stage's shard_map)
JAX_IN_STAGE = ("ValueError: pspec PartitionSpec('ep', None, None) "
                "contains a manual axes ('pp', 'ep')")


def check_mesh(mesh, program=None):
    """Raise for a ``switch_moe`` of ``program`` that the ep split cannot
    place: inside a ``layers.Pipeline`` stage (the JAX package refuses it
    too: ``JAX_IN_STAGE``) or another sub-block. Nothing at ep 1."""
    from .mesh import axis_size
    if axis_size(mesh, EP) == 1 or program is None:
        return
    stages = {op.attrs.get("sub_block") for blk in program.blocks
              for op in blk.ops if op.type == "pipeline"}
    for blk in program.blocks:
        if blk.idx == 0 or not any(op.type == "switch_moe"
                                   for op in blk.ops):
            continue
        if blk.idx in stages:
            raise not_ported(
                f"a switch_moe inside a layers.Pipeline stage under ep "
                f"(the JAX package refuses it as well: {JAX_IN_STAGE} "
                f"...); put the MoE layer outside the pipeline")
        raise not_ported("a switch_moe inside a control-flow block")


def _moe_grads(op):
    """The expert parameters' grads a ``switch_moe_grad`` op writes."""
    if op.type != "switch_moe_grad":
        return None
    return [(p, g) for slot in ("W1", "B1", "W2", "B2")
            for p, g in zip(op.input(slot), op.output(slot + "@GRAD"))]


def ep_rewrite(program, mesh):
    """Rewrite ``program`` in place for ``mesh``'s ep axis; returns
    ``{name: Layout}`` of the persistables cut to the rank's expert slice
    (empty at ep 1)."""
    from .mesh import axis_size
    ep = axis_size(mesh, EP)
    if ep == 1:
        return {}
    check_mesh(mesh, program)

    def divides(v):
        if v.shape[0] % ep:
            raise ValueError(f"ep={ep}: {v.name!r} holds {v.shape[0]} "
                             f"experts, which the ep ranks do not divide")
        return True

    layouts = cut_state(program, EP, ep, not_ported, _moe_grads,
                        ("switch_moe",), divides)
    program._ep_report = {"expert_slices": len(layouts),
                          "values_cut": program._cut_report}
    return layouts


__all__ = ["check_mesh", "ep_rewrite"]
