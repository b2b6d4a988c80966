"""Tensor layers (trimmed copy of ``paddle_tpu/layers/tensor.py``):
``data``, ``create_global_var``, ``cast``, ``fill_constant``,
``ones_like`` (``:163``), ``assign``, ``reshape``, ``transpose``,
``slice``, ``gather`` (``:259``), ``concat`` (``:67``), ``increment``
(``:349``),
``merge_selected_rows`` and ``get_tensor_from_selected_rows``
(``:415-432``). Shapes are python ints; shape tensors
and ``assign`` of numpy values are not ported."""
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
    """Copy a Variable into ``output`` (a new var when None)."""
    helper = LayerHelper("assign")
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
