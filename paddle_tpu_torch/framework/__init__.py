"""The Program IR and its eager runtime: ``core`` (Program, Block,
Operator, Variable), ``registry`` (op lowerings, generic vjp grads,
meta-device shape inference), ``backward`` (append_backward),
``lowering`` (op-by-op interpretation), ``analysis`` (def-use and
liveness), ``passes`` (the program pass pipeline) and ``executor``
(Scope, Executor)."""
from . import analysis, passes, unique_name
from .backward import append_backward, gradients
from .core import (CPUPlace, CUDAPlace, EnforceNotMet, OpRole, Operator,
                   Parameter, Program, Variable, default_main_program,
                   default_startup_program, grad_var_name, op_role_guard,
                   program_guard)
from .executor import (Executor, Scope, global_scope, scope_from_arrays,
                       scope_guard)

__all__ = ["CPUPlace", "CUDAPlace", "EnforceNotMet", "Executor", "OpRole",
           "Operator", "Parameter", "Program", "Scope", "Variable",
           "append_backward", "default_main_program",
           "default_startup_program", "global_scope", "grad_var_name",
           "gradients", "op_role_guard", "passes", "program_guard",
           "scope_from_arrays", "scope_guard", "unique_name"]
