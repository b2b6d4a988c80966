"""Parameter initializers: each appends a fill op for the parameter into
the startup program (``fill_constant``, ``gaussian_random`` or
``truncated_gaussian_random``), as ``paddle_tpu/framework/initializer.py``
does. Trimmed to the three that the GPT and BERT builders use; the
random ones draw from the op's own ``torch.Generator``
(``LowerCtx.generator``), seeded from the run seed and the op's
``__rng_seed__`` (or its ``seed``)."""
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


Constant = ConstantInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
