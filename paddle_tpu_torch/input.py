"""Top-level input helpers ``fluid.one_hot`` and ``fluid.embedding``
(a copy of ``paddle_tpu/input.py``): the v2 forms, which append the
depth / embedding axis to ids of any rank (``one_hot_v2``,
``lookup_table_v2``)."""
from .layers.layer_helper import LayerHelper


def one_hot(input, depth, allow_out_of_range=False):
    """``out.shape = input.shape + [depth]``."""
    helper = LayerHelper("one_hot_v2")
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(type="one_hot_v2", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"depth": depth,
                            "allow_out_of_range": allow_out_of_range})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Ids of any rank; ``out.shape = ids.shape + [emb_size]``."""
    from .layers.nn import _emit_embedding
    return _emit_embedding("lookup_table_v2", input, size, is_sparse,
                           is_distributed, padding_idx, param_attr, dtype)
