"""Dtype names of the IR and their torch dtypes.

The IR keeps canonical string names ("float32", "int32", ...) as
``paddle_tpu/framework/dtype.py`` does; :func:`torch_dtype` converts at
the edge where a lowering makes a tensor, :func:`dtype_name` the other
way for build-time shape inference.
"""
import numpy as np
import torch

_CANONICAL = {
    "float16": "float16",
    "bfloat16": "bfloat16",
    "float32": "float32",
    "float64": "float64",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "uint8": "uint8",
    "bool": "bool",
    # numpy aliases
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
}

_TORCH = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAME = {v: k for k, v in _TORCH.items()}


def convert_dtype(dtype):
    """Normalize a dtype spec (str, numpy dtype, torch dtype) to a name."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return _NAME[dtype]
    if isinstance(dtype, str):
        if dtype in _CANONICAL:
            return _CANONICAL[dtype]
        return str(np.dtype(dtype))
    return str(np.dtype(dtype))


def is_float_dtype(dtype):
    return convert_dtype(dtype) in ("float16", "bfloat16", "float32",
                                    "float64")


def itemsize(dtype):
    """Bytes of one element of ``dtype``."""
    return torch_dtype(dtype).itemsize


def torch_dtype(dtype):
    return _TORCH[convert_dtype(dtype)]


def dtype_name(torch_dt):
    return _NAME[torch_dt]
