"""Collective layer wrappers (a copy of ``paddle_tpu/layers/collective.py``;
reference python/paddle/fluid/layers/collective.py — _allreduce :16,
_allgather, _broadcast; used by the collective transpiler and dygraph
DataParallel). ``shard`` pins a tensor to a mesh sharding, which needs
model parallelism: it raises (ROADMAP.md Queue 1 item 7b)."""
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
    raise not_ported_7b("layers.collective.shard")


def _broadcast(x, root=0, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("broadcast")
    helper.append_op(type="c_broadcast", inputs={"X": [x]},
                     outputs={"Out": [x]},
                     attrs={"ring_id": ring_id, "root": root})
    return x
