"""Parameter initializers: each appends a fill op for the parameter into
the startup program (``fill_constant``, ``uniform_random``,
``gaussian_random`` or ``truncated_gaussian_random``), as
``paddle_tpu/framework/initializer.py`` does: Constant, Uniform
(``:40``), Normal, TruncatedNormal, Xavier (``:93``) and MSRA (``:111``)
with ``_fan_in_out`` (``:79``), and the global defaults (Xavier for
weights, zeros for biases, ``:168``). The random ones draw from the
op's own ``torch.Generator`` (``LowerCtx.generator``), seeded from the
run seed and the op's ``__rng_seed__`` (or its ``seed``). Bilinear and
NumpyArray (``:127-158``) write a host-made array through one
``assign_value`` op."""
import math

import numpy as np

from .core import default_startup_program


class Initializer:
    def __call__(self, var, block=None):
        raise NotImplementedError


def _startup_block(var):
    block = default_startup_program().global_block()
    if var.name not in block.vars:
        block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=True)
    return block


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block=None):
        block = block if block is not None else _startup_block(var)
        return block.append_op(
            type="fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)}, infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block=None):
        block = block if block is not None else _startup_block(var)
        return block.append_op(
            type="uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed}, infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        block = block if block is not None else _startup_block(var)
        return block.append_op(
            type="gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed}, infer_shape=False)


class TruncatedNormalInitializer(Initializer):
    """A normal truncated at two standard deviations (``:66``)."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        block = block if block is not None else _startup_block(var)
        return block.append_op(
            type="truncated_gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed}, infer_shape=False)


def _fan_in_out(var):
    """(fan in, fan out): a conv filter ``[O, I, *k]`` counts its
    receptive field, a ``[in, out]`` matrix its two dims."""
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """Glorot: uniform in +-sqrt(6 / (fan_in + fan_out)), or a normal of
    std sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block=None):
        fin, fout = _fan_in_out(var)
        fin = self.fan_in if self.fan_in is not None else fin
        fout = self.fan_out if self.fan_out is not None else fout
        if self.uniform:
            limit = math.sqrt(6.0 / (fin + fout))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fin + fout))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """Kaiming He: uniform in +-sqrt(6 / fan_in), or a normal of std
    sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block=None):
        fin, _ = _fan_in_out(var)
        fin = self.fan_in if self.fan_in is not None else fin
        if self.uniform:
            limit = math.sqrt(6.0 / fin)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / fin)
        return NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel over the last two dims (for a
    transposed conv that upsamples)."""

    def __call__(self, var, block=None):
        shape = var.shape
        f = math.ceil(shape[-1] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        for i in range(int(np.prod(shape))):
            x = i % shape[-1]
            y = (i // shape[-1]) % shape[-2]
            weight[np.unravel_index(i, shape)] = \
                (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    """The var set to a numpy array (``assign_value``)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block=None):
        block = block if block is not None else _startup_block(var)
        return block.append_op(
            type="assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                   "values": self.value}, infer_shape=False)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
