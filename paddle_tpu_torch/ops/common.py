"""Shared helpers for op lowerings (counterpart of
``paddle_tpu/ops/common.py``)."""


def x_of(ins, slot="X"):
    v = ins.get(slot)
    return v[0] if v else None


def bcast_y(x, y, axis):
    """Fluid elementwise broadcast: Y's shape matches a contiguous slice
    of X's shape starting at ``axis``; ``axis=-1`` aligns the trailing
    dims (numpy broadcasting). Trailing size-1 dims of Y are dropped as
    fluid allows."""
    if x.dim() == y.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    yshape = list(y.shape)
    while yshape and len(yshape) + axis > x.dim() and yshape[-1] == 1:
        yshape.pop()
    n_trail = x.dim() - axis - len(yshape)
    return y.reshape(tuple(yshape) + (1,) * n_trail)


def reduce_axes(attrs, ndim):
    """(axes, keep_dim) of a reduce op's attrs."""
    if attrs.get("reduce_all", False):
        return tuple(range(ndim)), bool(attrs.get("keep_dim", False))
    dim = attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % ndim for d in dim), bool(attrs.get("keep_dim", False))
