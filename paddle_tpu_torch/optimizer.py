"""Optimizers as program transforms (trimmed copy of
``paddle_tpu/optimizer.py``): ``minimize`` = ``append_backward`` + one
update op per parameter. Ported: ``SGDOptimizer`` (``:230``),
``MomentumOptimizer`` (``:243``, with Nesterov), ``AdamOptimizer`` and
``AdamWOptimizer`` (``:348``; ``lazy_mode`` updates only the rows of a
sparse grad), with the aliases ``SGD``,
``Momentum``, ``Adam`` and ``AdamW`` (``:728-731``), without gradient
clipping or regularization, ``rollback_updates_if`` (AMP's overflow
skip), and the wrappers ``RecomputeOptimizer`` (``:615``) and
``GradientMergeOptimizer`` (``:659``)."""
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
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set, callbacks)

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


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov}, infer_shape=False)


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = bool(lazy_mode)

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
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode,
                   **self._extra_attrs()},
            infer_shape=False)

    def _extra_attrs(self):
        return {}


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay: ``p -= lr * weight_decay * p``
    after the Adam update (the ``adamw`` op's ``coeff``)."""
    type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _extra_attrs(self):
        return {"coeff": self._coeff}




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


class RecomputeOptimizer:
    """Activation checkpointing: the backward recomputes each
    checkpoint-delimited forward segment instead of keeping its
    activations (``append_backward(checkpoints=)``)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def load(self, state):
        raise NotImplementedError(
            "RecomputeOptimizer.load is not supported (matches reference)")

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        assert self._checkpoints, "call _set_checkpoints(...) first"
        parameter_list = parameter_list or \
            getattr(self._optimizer, "_parameter_list", None)
        return append_backward(loss, parameter_list, no_grad_set, callbacks,
                               checkpoints=self._checkpoints)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            optimize_ops = self._optimizer.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


class GradientMergeOptimizer:
    """Gradient accumulation over ``k_steps`` steps: grads add into
    persistable buffers every step; the inner optimizer's update applies
    on every k-th step only, and the buffers reset. In-graph selects
    (``where``), so a step stays one program (and one captured graph)."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import tensor as T
        from .layers.math import equal, logical_not
        program = loss.block.program
        block = program.global_block()
        with program_guard(program,
                           startup_program or default_startup_program()):
            params_grads = self._inner.backward(
                loss, startup_program, parameter_list, no_grad_set)
            with op_role_guard(OpRole.Backward):
                # step counter modulo k
                ctr = T.create_global_var([1], 0.0, "float32",
                                          persistable=True,
                                          name=unique_name.generate(
                                              "grad_merge_step"))
                new_ctr = ctr + 1.0
                kconst = T.fill_constant([1], "float32", float(self.k_steps))
                ready = equal(new_ctr, kconst)
                T.assign(new_ctr - T.cast(ready, "float32") * kconst,
                         output=ctr)
                merged, accs = [], []
                for p, g in params_grads:
                    acc = block.create_var(
                        name=unique_name.generate(f"{p.name}@GradMerge"),
                        shape=p.shape, dtype=g.dtype, persistable=True,
                        stop_gradient=True)
                    ConstantInitializer(0.0)(acc)
                    summed = g + acc
                    T.assign(summed, output=acc)
                    use = summed / float(self.k_steps) if self.avg \
                        else summed
                    merged.append((p, use))
                    accs.append(acc)
            mark = len(block.ops)
            optimize_ops = self._inner.apply_gradients(merged)
            rollback_updates_if(block, mark, logical_not(ready))
            with op_role_guard(OpRole.Optimize):
                # reset the buffers after an applied update
                for acc in accs:
                    zeros = T.fill_constant(list(acc.shape), acc.dtype, 0.0)
                    block.append_op(
                        type="where",
                        inputs={"Condition": [ready.name],
                                "X": [zeros.name], "Y": [acc.name]},
                        outputs={"Out": [acc.name]}, infer_shape=False)
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._inner, item)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
