"""fluid.dygraph, the imperative mode (a trimmed copy of
``paddle_tpu/dygraph/``, with its export list): ``guard``, ``VarBase``
and the tape (``base``), ``Layer`` (``layers``), the ``nn`` classes, the
containers, the LR schedulers, ``save_dygraph``/``load_dygraph`` and
``jit_step``, one CUDA graph over a taped training step (``jit``).
``DataParallel``, ``prepare_context`` and ``Env`` raise (multi-device is
not ported), as do the dygraph-to-static entry points and the ``nn``
classes whose ops the port lacks."""
from .base import (  # noqa: F401
    guard, enabled, in_dygraph_mode, to_variable, no_grad, grad, VarBase,
    Tracer, _current_tracer,
)
from .layers import Layer  # noqa: F401
from . import nn  # noqa: F401
from .nn import (  # noqa: F401
    Linear, FC, Conv2D, Pool2D, BatchNorm, Embedding, LayerNorm, Dropout,
    LSTMCell, GRUCell, Conv2DTranspose, GroupNorm, PRelu, SpectralNorm,
)
from .checkpoint import save_dygraph, load_dygraph  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    LearningRateDecay, PiecewiseDecay, NaturalExpDecay, ExponentialDecay,
    InverseTimeDecay, PolynomialDecay, CosineDecay, NoamDecay,
    LinearLrWarmup, ReduceLROnPlateau,
)
from .jit import (  # noqa: F401
    TracedLayer, ProgramTranslator, declarative, jit_step, CompiledStep,
)
from . import jit  # noqa: F401
from .base import enable_dygraph, disable_dygraph, not_ported  # noqa: F401
from .container import Sequential, LayerList, ParameterList  # noqa: F401
from .nn import (  # noqa: F401
    Conv3D, Conv3DTranspose, InstanceNorm, BilinearTensorProduct,
    GRUUnit, NCE, TreeConv,
)
from .jit import dygraph_to_static_func  # noqa: F401


DataParallel = not_ported("DataParallel", "multi-device")
ParallelStrategy = not_ported("ParallelStrategy", "multi-device")
Env = ParallelEnv = not_ported("Env", "multi-device")
prepare_context = not_ported("prepare_context", "multi-device")


class BackwardStrategy:
    """The reference's sort_sum_gradient knob: the tape sums partial
    grads in reverse-trace order, so the flag is kept and has no
    effect."""

    def __init__(self):
        self.sort_sum_gradient = False
