"""Tensor creation and layout ops in torch (counterpart of
``paddle_tpu/ops/tensor_ops.py``: ``fill_constant :46``,
``gaussian_random :96``, ``assign :123``, ``cast :137``, ``reshape2
:143``, ``transpose2 :165``, ``slice :255``, ``where :424``). ``cast``
takes the generic vjp, so ``cast_grad`` casts the cotangent back to the
input's type, as the JAX vjp does. ``slice`` and ``transpose2`` return
views and ``reshape2`` one where the strides allow, so the attention
kernels take q/k/v as strided views of the qkv projection."""
import torch

from ..framework.dtype import torch_dtype
from ..framework.registry import register_op
from .common import x_of


def _xshape(x):
    """The ``XShape`` output: an empty ``[0, *x.shape]`` carrier of the
    input's shape (no data)."""
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)


@register_op("fill_constant", grad=False)
def fill_constant(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    return {"Out": torch.full(shape, attrs.get("value", 0.0),
                              dtype=torch_dtype(attrs.get("dtype",
                                                          "float32")),
                              device=ctx.device)}


@register_op("gaussian_random", grad=False, needs_rng=True)
def gaussian_random(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    out = torch.randn(shape, generator=ctx.generator(attrs),
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    return {"Out": out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)}


@register_op("assign")
def assign(ctx, ins, attrs):
    return {"Out": x_of(ins)}


@register_op("cast")
def cast(ctx, ins, attrs):
    return {"Out": x_of(ins).to(torch_dtype(attrs["out_dtype"]))}


@register_op("where")
def where(ctx, ins, attrs):
    return {"Out": torch.where(x_of(ins, "Condition"), x_of(ins),
                               x_of(ins, "Y"))}


@register_op("reshape2")
def reshape2(ctx, ins, attrs):
    """Fluid semantics: a 0 copies the input's dim, one -1 is inferred."""
    x = x_of(ins)
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("transpose2")
def transpose2(ctx, ins, attrs):
    x = x_of(ins)
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


@register_op("slice")
def slice_op(ctx, ins, attrs):
    x = x_of(ins, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": x[tuple(idx)]}
