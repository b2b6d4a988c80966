"""fluid.dygraph, the imperative mode (a trimmed copy of
``paddle_tpu/dygraph/``, with its export list): ``guard``, ``VarBase``
and the tape (``base``), ``Layer`` (``layers``), the ``nn`` classes, the
containers, the LR schedulers, ``save_dygraph``/``load_dygraph``,
``jit_step``, one CUDA graph over a taped training step (``jit``), and
``DataParallel`` with ``prepare_context``, ``ParallelStrategy`` and
``Env`` (``parallel``: one process per card). The dygraph-to-static
entry points and the ``nn`` classes whose ops the port lacks raise."""
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
from .parallel import (  # noqa: F401
    DataParallel, Env, ParallelStrategy, prepare_context,
)
from . import parallel  # noqa: F401

ParallelEnv = Env


class BackwardStrategy:
    """The reference's sort_sum_gradient knob: the tape sums partial
    grads in reverse-trace order, so the flag is kept and has no
    effect."""

    def __init__(self):
        self.sort_sum_gradient = False


def start_gperf_profiler():
    """reference dygraph start_gperf_profiler (gperftools hooks): the
    port's profiling surface is ``fluid.profiler``, started here for
    every state."""
    from .. import profiler as _p
    _p.start_profiler("All")


def stop_gperf_profiler():
    from .. import profiler as _p
    _p.stop_profiler()
