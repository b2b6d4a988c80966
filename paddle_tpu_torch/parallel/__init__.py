"""Parallelism across cards (counterpart of ``paddle_tpu/parallel``):
the process world and its mesh (``mesh``), the per-rank rewrites over
its tp, sp, pp and ep axes (``tp``, ``sp``, ``pp``, ``ep``) and
``CompiledProgram`` (``compiler``)."""
from .mesh import (  # noqa: F401
    MeshConfig, make_mesh, set_mesh, get_mesh, default_mesh, sharding_for,
    axis_size, init_parallel_env,
)
from .compiler import (  # noqa: F401
    CompiledProgram, BuildStrategy, ExecutionStrategy, ParallelExecutor,
)
