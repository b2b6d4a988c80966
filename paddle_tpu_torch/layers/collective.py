"""Collective layer wrappers (a copy of ``paddle_tpu/layers/collective.py``;
reference python/paddle/fluid/layers/collective.py — _allreduce :16,
_allgather, _broadcast; used by the collective transpiler and dygraph
DataParallel). ``shard`` pins a tensor to a mesh sharding: a
``sharding_constraint`` op over ``dp``, ``sp``, ``tp``, ``pp``, ``ep``
and ``dcn_dp`` (a value identity, except that pass ``sp_shard`` starts
the sequence split at the first one that names ``sp``; a ``pp``, ``ep``
or ``dcn_dp`` entry is a hint). Other axis names raise."""
from ..parallel.mesh import not_ported_7b
from .layer_helper import LayerHelper


def _allreduce(x, out=None, reduce_type="sum", sync_mode=False, ring_id=0):
    helper = LayerHelper("allreduce")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type=f"c_allreduce_{reduce_type}",
                     inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"ring_id": ring_id})
    return out


def _allgather(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("allgather")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="c_allgather", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"ring_id": ring_id, "nranks": nranks})
    return out


def shard(x, *spec):
    """Pin ``x`` to a mesh sharding, one axis name (or None) per dim, as
    the JAX package does: a ``sharding_constraint`` op, the value itself
    (every rank holds its whole rows) until pass ``sp_shard`` makes the
    first one that names ``sp`` take the rank's chunk of that dim
    (``parallel.sp``). A ``pp`` or an ``ep`` entry is a hint and nothing
    more, as in the JAX package (a pipeline's stages are
    ``layers.Pipeline``'s, the experts' split is ``switch_moe``'s), and
    so is a ``dcn_dp`` one (each rank is fed its rows of the batch, split
    over ``dcn_dp`` x ``dp``). Other axis names raise."""
    for a in spec:
        for name in (a if isinstance(a, (tuple, list)) else (a,)):
            if name is not None and name not in ("dp", "sp", "tp", "pp",
                                                 "ep", "dcn_dp"):
                raise not_ported_7b(f"layers.collective.shard over the "
                                    f"{name!r} axis")
    helper = LayerHelper("sharding_constraint")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sharding_constraint", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"spec": tuple(spec)})
    return out


def _broadcast(x, root=0, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("broadcast")
    helper.append_op(type="c_broadcast", inputs={"X": [x]},
                     outputs={"Out": [x]},
                     attrs={"ring_id": ring_id, "root": root})
    return x
