"""Optimizers as program transforms (trimmed copy of
``paddle_tpu/optimizer.py``): ``minimize`` = ``append_backward`` + one
update op per parameter. Ported: ``AdamOptimizer`` (dense), without
gradient clipping or weight-decay regularization, and
``rollback_updates_if`` (AMP's overflow skip)."""
from .framework import unique_name
from .framework.backward import append_backward
from .framework.core import (OP_ROLE_KEY, OpRole, Variable,
                             default_main_program, default_startup_program,
                             op_role_guard, program_guard)
from .framework.initializer import ConstantInitializer


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        if regularization is not None or grad_clip is not None:
            raise NotImplementedError("paddle_tpu_torch: gradient clipping "
                                      "and regularization are not ported")
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self._accumulators = {}       # name -> {param name: Variable}
        self._lr_var = None

    def _create_lr_var(self):
        from .layers import tensor as tensor_layers
        if self._lr_var is not None:
            return self._lr_var
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return self._lr_var
        self._lr_var = tensor_layers.create_global_var(
            shape=[], value=float(self._learning_rate), dtype="float32",
            persistable=True, name=unique_name.generate("learning_rate"))
        return self._lr_var

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        # `shape or param.shape`: an explicit scalar shape=[] ALSO falls
        # back to param.shape (param-shaped beta-pows, as the reference)
        var = default_main_program().global_block().create_var(
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=shape or param.shape, dtype=dtype or param.dtype,
            persistable=True, stop_gradient=True)
        ConstantInitializer(fill_value)(var)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        self._create_lr_var()
        for p, _ in params_grads:
            if getattr(p, "regularizer", None) is not None:
                raise NotImplementedError(
                    f"paddle_tpu_torch: parameter {p.name!r} has a "
                    f"regularizer; regularization is not ported")
        self._create_accumulators(block, [p for p, _ in params_grads])
        for pg in params_grads:
            op = self._append_optimize_op(block, pg)
            op.attrs[OP_ROLE_KEY] = OpRole.Optimize
        return params_grads

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if callbacks:
            raise NotImplementedError("paddle_tpu_torch: grad-op callbacks "
                                      "are not ported")
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append the backward and the update ops to the program that
        owns ``loss``; returns ``(optimize ops, params_grads)`` as the
        reference does."""
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        if lazy_mode:
            raise NotImplementedError("paddle_tpu_torch: lazy (sparse) "
                                      "adam is not ported")
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[])
            self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                  shape=[])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        return block.append_op(
            type=self.type,
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": False},
            infer_shape=False)



def rollback_updates_if(block, mark, cond_var):
    """Make the optimizer ops at ``block.ops[mark:]`` conditional: every
    persistable they write is copied (``assign``) before the update and
    restored with ``where(cond, copy, new)`` after it. AMP's overflow
    skip uses it."""
    written, seen = [], set()
    for op in block.ops[mark:]:
        for n in op.output_arg_names:
            if n not in seen and block.has_var(n) and \
                    block.var(n).persistable:
                seen.add(n)
                written.append(block.var(n))
    with op_role_guard(OpRole.Optimize):
        insert_at = mark
        backups = {}
        for var in written:
            bname = unique_name.generate(f"{var.name}.rollback")
            block.create_var(name=bname, shape=var.shape, dtype=var.dtype,
                             stop_gradient=True)
            block._insert_op(insert_at, type="assign",
                             inputs={"X": [var.name]},
                             outputs={"Out": [bname]}, infer_shape=False)
            insert_at += 1
            backups[var.name] = bname
        for var in written:
            block.append_op(
                type="where",
                inputs={"Condition": [cond_var.name],
                        "X": [backups[var.name]], "Y": [var.name]},
                outputs={"Out": [var.name]}, infer_shape=False)
    return written
