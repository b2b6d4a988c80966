"""Tensor layers (trimmed copy of ``paddle_tpu/layers/tensor.py``):
``data``, ``create_global_var``, ``cast``, ``fill_constant``,
``ones_like`` (``:163``), ``assign``, ``reshape``, ``transpose``,
``slice``, ``gather`` (``:259``), ``concat`` (``:67``), ``increment``
(``:349``),
``merge_selected_rows`` and ``get_tensor_from_selected_rows``
(``:415-432``), ``create_parameter`` (``:31``), ``stack`` (``:92``),
``expand`` (``:287``), ``argmax`` (``:320``), ``where`` (``:366``) and
``beam_search_decode`` (``:433``). Shapes are python ints; shape
tensors are not ported.

Also ``create_tensor :25``, ``split :74``, ``unstack :100``,
``fill_constant_batch_size_like :131``, ``zeros``, ``ones``,
``zeros_like :146-160``, ``gather_nd``, ``scatter :268-284``,
``one_hot :296`` (v1), ``range``/``arange :304-317``, ``argmin``,
``argsort :329-346``, ``cumsum :358``, ``shape :375``, ``linspace :384``
(a constant made on the host, as in the JAX package), ``diag``, ``tril``
and ``triu :389-412``; ``convert_dtype`` is importable here as there.
``reorder_lod_tensor_by_rank`` stays with Queue 1 item 10."""
import builtins
import copy

import numpy as np

from ..framework import initializer as init_mod
from ..framework.core import default_main_program
from ..framework.dtype import convert_dtype
from .layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=False,
         stop_gradient=True):
    """A feed var; stop_gradient by default, as in the reference."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return default_main_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    return helper.create_global_variable(
        shape=shape, dtype=dtype, persistable=persistable, name=name,
        initializer=init_mod.ConstantInitializer(value))


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def ones_like(x, out=None, name=None):
    helper = LayerHelper("ones_like", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"value": 1.0})
    return out


def assign(input, output=None):
    """Copy a Variable, or a numpy array (an ``assign_value`` constant),
    into ``output`` (a new var when None)."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray) or np.isscalar(input):
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(arr.dtype))
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(arr.shape),
                                "dtype": str(arr.dtype), "values": arr})
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    dtype = convert_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": dtype, "value": float(value)})
    out.stop_gradient = True
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def gather(input, index, axis=0, name=None):
    helper = LayerHelper("gather", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def increment(x, value=1.0, in_place=True):
    """``x + value``; ``in_place`` writes it to ``x`` itself."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def merge_selected_rows(x, name=None):
    helper = LayerHelper("merge_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="merge_selected_rows", inputs={"X": [x]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def get_tensor_from_selected_rows(x, name=None):
    helper = LayerHelper("get_tensor_from_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="get_tensor_from_selected_rows",
                     inputs={"X": [x]}, outputs={"Out": [out]},
                     infer_shape=False)
    return out


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr
    if attr is None:
        attr = ParamAttr(name=name)
    else:
        attr = ParamAttr._to_attr(attr)
        if attr is not False and name is not None and attr.name is None:
            attr = copy.copy(attr)       # never mutate the caller's attr
            attr.name = name
    helper = LayerHelper("create_parameter")
    return helper.create_parameter(attr, shape, dtype, is_bias=is_bias,
                                   default_initializer=default_initializer)


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type="stack", inputs={"X": list(x)},
                     outputs={"Y": [out]}, attrs={"axis": axis})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def argmax(x, axis=0, name=None):
    helper = LayerHelper("arg_max", name=name)
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="where",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def beam_search_decode(ids, scores, beam_size=None, end_id=None,
                       parent_idx=None, name=None):
    """Walk ParentIdx back to full sentences. Padded form: Ids/ParentIdx
    [T, B, beam], Scores [T, B, beam]; returns (SentenceIds [B, beam,
    T], SentenceScores [B, beam])."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference(dtype=ids.dtype)
    sent_scores = helper.create_variable_for_type_inference(
        dtype=scores.dtype)
    ins = {"Ids": [ids], "Scores": [scores]}
    if parent_idx is not None:
        ins["ParentIdx"] = [parent_idx]
    helper.append_op(type="beam_search_decode", inputs=ins,
                     outputs={"SentenceIds": [sent_ids],
                              "SentenceScores": [sent_scores]},
                     attrs={}, infer_shape=False)
    return sent_ids, sent_scores



# ---- creation, indexing and sorting --------------------------------------

def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(name=helper.name, dtype=dtype,
                                   persistable=persistable)


def split(input, num_or_sections, dim=-1, name=None):
    """``num_or_sections`` equal parts (an int) or parts of the listed
    sizes along ``dim``; returns the list of parts."""
    helper = LayerHelper("split", name=name)
    axis = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        n, sections = num_or_sections, []
    else:
        n, sections = len(num_or_sections), list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in builtins.range(n)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": axis, "num": n, "sections": sections})
    return outs


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    num = num or x.shape[axis]
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype)
            for _ in builtins.range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(
        dtype=convert_dtype(dtype))
    helper.append_op(
        type="fill_constant_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name=name)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name=name)


def zeros_like(x, out=None, name=None):
    helper = LayerHelper("zeros_like", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather_nd",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    """v1 ``one_hot``: a trailing [.., 1] dim becomes the depth axis."""
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def range(start, end, step, dtype, name=None):
    helper = LayerHelper("range", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=convert_dtype(dtype), stop_gradient=True)
    helper.append_op(type="range", outputs={"Out": [out]},
                     attrs={"start": start, "end": end, "step": step,
                            "dtype": convert_dtype(dtype)})
    return out


def arange(start=0, end=None, step=1, dtype="int64", name=None):
    if end is None:
        start, end = 0, start
    return range(start, end, step, dtype, name=name)


def argmin(x, axis=0, name=None):
    helper = LayerHelper("arg_min", name=name)
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argsort(x, axis=-1, descending=False, name=None):
    """(sorted values, their int64 indices) along ``axis``."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    idx = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    helper.append_op(type="argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [idx]},
                     attrs={"axis": axis, "descending": descending})
    return out, idx


def cumsum(x, axis=-1, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="cumsum", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(dtype="int32",
                                                    stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def linspace(start, stop, num, dtype="float32", name=None):
    return assign(np.linspace(start, stop, num).astype(
        convert_dtype(dtype)))


def diag(diagonal, name=None):
    helper = LayerHelper("diag", name=name)
    out = helper.create_variable_for_type_inference(dtype=diagonal.dtype)
    helper.append_op(type="diag_v2", inputs={"X": [diagonal]},
                     outputs={"Out": [out]})
    return out


def _tril_triu(x, diagonal, lower, name):
    helper = LayerHelper("tril" if lower else "triu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="tril_triu", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"diagonal": diagonal, "lower": lower})
    return out


def tril(x, diagonal=0, name=None):
    return _tril_triu(x, diagonal, True, name)


def triu(x, diagonal=0, name=None):
    return _tril_triu(x, diagonal, False, name)
