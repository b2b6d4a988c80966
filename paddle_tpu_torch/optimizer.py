"""Optimizers as program transforms (a copy of
``paddle_tpu/optimizer.py``): ``minimize`` = ``append_backward`` +
gradient clipping (``grad_clip``, or ``clip.set_gradient_clip``'s) +
regularization (``regularization``, or a parameter's own
``regularizer``) + one update op per parameter, in that order
(``:104-120``). Every class of the JAX package: ``SGDOptimizer``,
``MomentumOptimizer``, ``LarsMomentumOptimizer``, ``AdamOptimizer``,
``AdamWOptimizer``, ``LambOptimizer``, ``AdagradOptimizer``,
``DecayedAdagradOptimizer``, ``AdadeltaOptimizer``, ``AdamaxOptimizer``,
``RMSPropOptimizer``, ``FtrlOptimizer`` and ``DpsgdOptimizer``
(``:230-570``) with their aliases (``:728-740``); every accumulator is
marked ``is_optimizer_state`` (``io.load_checkpoint`` names such a var
when a checkpoint lacks it), and the beta-pows are param-shaped, as
there. ``rollback_updates_if`` (AMP's overflow skip) and the wrappers
``RecomputeOptimizer``, ``GradientMergeOptimizer``,
``ExponentialMovingAverage``, ``ModelAverage``, ``LookaheadOptimizer``
and ``DGCMomentumOptimizer`` (``:615-1139``); ``PipelineOptimizer``
needs ``layers.Pipeline`` and raises.

In dygraph mode ``minimize`` clips, regularizes (``_eager``) and updates
the parameters eagerly (``_dygraph_minimize``, ``:151-205``) through the
same update lowerings, over per-parameter state in ``_eager_state``, for
the classes with ``_EAGER_SLOTS`` (SGD, Momentum, Adam, AdamW, Lamb,
Adagrad, DecayedAdagrad); the others raise, as there."""
import contextlib

import numpy as np
import torch

from .framework import unique_name
from .framework.backward import append_backward
from .framework.core import (OP_ROLE_KEY, OpRole, Variable,
                             default_main_program, default_startup_program,
                             op_role_guard, program_guard)
from .framework.initializer import ConstantInitializer
from .framework.registry import get_op_def
from .clip import append_gradient_clip_ops
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
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

    def _global_learning_rate(self):
        return self._lr_var

    @property
    def current_step_lr(self):
        return self._learning_rate

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
        # io.load_checkpoint names such vars when a checkpoint lacks them
        var.is_optimizer_state = True
        # the parameter's sharding, on an accumulator of its shape (Adam's
        # moments split with their parameter under tp)
        if param.dist_attr is not None and \
                list(var.shape) == list(param.shape):
            var.dist_attr = param.dist_attr
        ConstantInitializer(fill_value)(var)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, params_grads):
        pass

    def apply_gradients(self, params_grads):
        """Clip, regularize, then append one update op per parameter
        (and the optimizer's ``_finish_update`` ops)."""
        block = default_main_program().global_block()
        self._create_lr_var()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        else:
            params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        self._create_accumulators(block, [p for p, _ in params_grads])
        for pg in params_grads:
            op = self._append_optimize_op(block, pg)
            if op is not None:
                op.attrs[OP_ROLE_KEY] = OpRole.Optimize
        self._finish_update(block, params_grads)
        return params_grads

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set, callbacks)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Append the backward and the update ops to the program that
        owns ``loss``; returns ``(optimize ops, params_grads)`` as the
        reference does. In dygraph mode: update the parameters now from
        their ``.grad`` (``loss.backward()`` first)."""
        from .dygraph import base as dy
        if dy.enabled():
            return self._dygraph_minimize(parameter_list)
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


    # ---- dygraph (eager) path: the update lowerings applied to VarBase
    # params with tape-accumulated .grad ----
    _EAGER_SLOTS = None   # [(slot, kind)], kind in zeros | beta1 | beta2

    def _eager_attrs(self):
        return {}

    def _eager_lr(self, lr, like):
        """The learning rate as a 0-d float32 tensor on ``like``'s device,
        made once per value: a captured step (``dygraph.jit_step``) reads
        the tensor of its capture, so its LR is frozen there."""
        key = (lr, like.device)
        if getattr(self, "_eager_lr_key", None) != key:
            self._eager_lr_key = key
            self._eager_lr_t = torch.tensor(lr, dtype=torch.float32,
                                            device=like.device)
        return self._eager_lr_t

    def _dygraph_minimize(self, parameter_list=None):
        """Clip (``grad_clip._eager``), regularize (each regularizer's
        ``_eager``) and update every parameter with a grad, in torch on
        the parameters' device with no host read (``jit_step`` captures
        it)."""
        params = parameter_list or self._parameter_list
        if not params:
            raise ValueError("in dygraph mode construct the optimizer with "
                             "parameter_list=model.parameters()")
        if self._EAGER_SLOTS is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no dygraph update path yet")
        lr = self._learning_rate
        lr = float(lr() if callable(lr) else lr)
        opdef = get_op_def(self.type)
        state = self.__dict__.setdefault("_eager_state", {})
        attrs = self._eager_attrs()
        # the clip -> regularization order of apply_gradients
        pairs = [(p, p._grad) for p in params
                 if p._grad is not None and getattr(p, "trainable", True)]
        if self._grad_clip is not None:
            pairs = self._grad_clip._eager(pairs)
        for p, g in pairs:
            reg = getattr(p, "regularizer", None) or self.regularization
            if reg is not None:
                g = reg._eager(p.value, g)
            st = state.get(p.name)
            if st is None:
                st = state[p.name] = {
                    slot: torch.zeros_like(p.value) if kind == "zeros"
                    else torch.full((1,), getattr(self, "_" + kind),
                                    dtype=p.value.dtype,
                                    device=p.value.device)
                    for slot, kind in self._EAGER_SLOTS}
            ins = {"Param": [p.value], "Grad": [g],
                   "LearningRate": [self._eager_lr(lr, p.value)]}
            for slot, _ in self._EAGER_SLOTS:
                ins[slot] = [st[slot]]
            raw = opdef.lower(None, ins, attrs)
            p.value = raw["ParamOut"]
            for slot, _ in self._EAGER_SLOTS:
                if raw.get(slot + "Out") is not None:
                    st[slot] = raw[slot + "Out"]
        return None, [(p, p._grad) for p in params if p._grad is not None]

    def clear_gradients(self):
        for p in (self._parameter_list or []):
            p.clear_gradient()

    def state_dict(self):
        """The dygraph optimizer state (``save_dygraph`` writes it as
        ``.pdopt``): ``<param name>.<slot>`` arrays."""
        from .dygraph.checkpoint import OPT_STATE_KEY
        out = {OPT_STATE_KEY: True}
        for pname, st in getattr(self, "_eager_state", {}).items():
            for slot, t in st.items():
                out[f"{pname}.{slot}"] = t.detach().cpu().numpy().copy()
        return out

    def set_state_dict(self, state):
        from .dygraph.base import _device
        dev = {p.name: p.value.device for p in self._parameter_list or ()}
        self._eager_state = {}
        for k, v in state.items():
            if "." not in k:
                continue
            pname, slot = k.rsplit(".", 1)
            self._eager_state.setdefault(pname, {})[slot] = \
                torch.from_numpy(np.array(v)).to(dev.get(pname, _device()))
    load_state_dict = set_state_dict


class SGDOptimizer(Optimizer):
    type = "sgd"
    _EAGER_SLOTS = []

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    type = "momentum"
    _EAGER_SLOTS = [("Velocity", "zeros")]

    def _eager_attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}

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


class LarsMomentumOptimizer(Optimizer):
    """Momentum at LARS's layer-adaptive rate (the ``lars_momentum``
    op); no dygraph path, as in the JAX package."""
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    type = "adam"
    _EAGER_SLOTS = [("Moment1", "zeros"), ("Moment2", "zeros"),
                    ("Beta1Pow", "beta1"), ("Beta2Pow", "beta2")]

    def _eager_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon, **self._extra_attrs()}

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


class LambOptimizer(AdamOptimizer):
    """LAMB over Adam's accumulators, param-shaped beta-pows included
    (the layout the JAX package's checkpoints hold).
    ``exclude_from_weight_decay_fn`` is accepted and ignored, as the JAX
    package ignores it: every parameter decays."""
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class AdagradOptimizer(Optimizer):
    type = "adagrad"
    _EAGER_SLOTS = [("Moment", "zeros")]

    def _eager_attrs(self):
        return {"epsilon": self._epsilon}

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._init_acc)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("moment", p)
        return block.append_op(
            type=self.type,
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "MomentOut": [mom]},
            attrs=self._eager_attrs(), infer_shape=False)


class DecayedAdagradOptimizer(AdagradOptimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, epsilon=epsilon, **kw)
        self._decay = decay

    def _eager_attrs(self):
        return {"epsilon": self._epsilon, "decay": self._decay}


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class AdamaxOptimizer(Optimizer):
    """Adamax; the param-shaped ``beta1_pow`` advances by one ``scale``
    op per parameter after every update (``_finish_update``)."""
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var], "Moment": [m],
                    "InfNorm": [inf],
                    "Beta1Pow": [self._get_accumulator("beta1_pow", p)]},
            outputs={"ParamOut": [p], "MomentOut": [m],
                     "InfNormOut": [inf]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)

    def _finish_update(self, block, params_grads):
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow", p)
            block.append_op(
                type="scale", inputs={"X": [b1p]}, outputs={"Out": [b1p]},
                attrs={"scale": self._beta1, OP_ROLE_KEY: OpRole.Optimize},
                infer_shape=False)


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        mom = self._get_accumulator("momentum", p)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var], "MeanSquare": [ms],
                    "MeanGrad": [mg], "Moment": [mom]},
            outputs={"ParamOut": [p], "MeanSquareOut": [ms],
                     "MeanGradOut": [mg], "MomentOut": [mom]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power}, infer_shape=False)


class DpsgdOptimizer(Optimizer):
    """DP-SGD (the ``dpsgd`` op): its noise comes from the op's seeded
    generator, so the port's stream is not the JAX package's."""
    type = "dpsgd"

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma}, infer_shape=False)




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
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
Adamax = AdamaxOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
Dpsgd = DpsgdOptimizer


class PipelineOptimizer:
    """Pipeline-parallel training over ``layers.Pipeline`` stages: not
    ported (ROADMAP Queue 1 item 7, with ``layers.Pipeline``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "paddle_tpu_torch: PipelineOptimizer needs layers.Pipeline, "
            "which is not ported (ROADMAP Queue 1 item 7)")


class _ScopeSwap:
    """Backup, swap and restore of parameters in the global scope (the
    apply and restore halves of EMA and ModelAverage differ only in the
    values swapped in). The backups are copies: a captured step
    (``run_steps``) that ran meanwhile writes its own tensors in place,
    and its next slab binds the restored values (``_bind_scope``)."""

    def __init__(self):
        self._backups = {}

    def _swap(self, values):
        from .framework.executor import global_scope
        scope = global_scope()
        self._backups = {}
        for pname, val in values.items():
            cur = scope.find_var(pname)
            self._backups[pname] = cur.clone()
            scope.set(pname, val.to(cur.dtype))

    def restore(self, executor=None):
        from .framework.executor import global_scope
        scope = global_scope()
        for pname, val in self._backups.items():
            scope.set(pname, val)
        self._backups = {}

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        self._swap(self._apply_values())
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def _apply_values(self):
        raise NotImplementedError


def _scalar(scope, name):
    """A one-element scope tensor's value on the host (read by
    ``apply``, outside any step)."""
    return float(scope.find_var(name).reshape(-1)[0])


class ExponentialMovingAverage(_ScopeSwap):
    """EMA of the parameters with bias correction: ``update()`` appends
    the shadow updates to the program; ``apply()``/``restore()`` swap
    the scope's parameters with the corrected averages around an
    evaluation. With ``thres_steps`` (a step-count Variable) the decay
    is ``min(decay, (1 + t) / (10 + t))`` and the correction divides by
    one minus the product of the decays used."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        super().__init__()
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._name = name or "ema"
        self._shadows = {}         # param name -> shadow var name
        self._decay_prod_name = None

    def update(self):
        """Append the shadow updates of every trainable parameter (after
        ``minimize``)."""
        from .layers import math as M
        from .layers import tensor as T
        program = default_main_program()
        block = program.global_block()
        with op_role_guard(OpRole.Optimize):
            if self._thres_steps is not None:
                t = T.cast(self._thres_steps, "float32")
                decay = M.elementwise_min(
                    T.fill_constant([1], "float32", self._decay),
                    (t + 1.0) / (t + 10.0))
            else:
                decay = T.fill_constant([1], "float32", self._decay)
            prod = T.create_global_var([1], 1.0, "float32",
                                       persistable=True,
                                       name=unique_name.generate(
                                           f"{self._name}.decay_prod"))
            T.assign(M.elementwise_mul(block.var(prod.name), decay),
                     output=prod)
            self._decay_prod_name = prod.name
            for p in program.all_parameters():
                if not p.trainable:
                    continue
                shadow = block.create_var(
                    name=unique_name.generate(f"{self._name}.{p.name}"),
                    shape=p.shape, dtype=p.dtype, persistable=True,
                    stop_gradient=True)
                ConstantInitializer(0.0)(shadow)
                one_minus = M.elementwise_sub(
                    T.fill_constant([1], "float32", 1.0), decay)
                new = M.elementwise_add(
                    M.elementwise_mul(block.var(shadow.name),
                                      T.cast(decay, p.dtype), axis=0),
                    M.elementwise_mul(p, T.cast(one_minus, p.dtype),
                                      axis=0))
                T.assign(new, output=shadow)
                self._shadows[p.name] = shadow.name

    def _apply_values(self):
        from .framework.executor import global_scope
        scope = global_scope()
        corr = max(1.0 - _scalar(scope, self._decay_prod_name), 1e-12)
        return {pname: scope.find_var(sname) / corr
                for pname, sname in self._shadows.items()}


class ModelAverage(_ScopeSwap):
    """Sliding-window parameter averaging: parameter sums accumulate in
    the program, the window restarting when ``num_accumulates >=
    max(min_average_window, min(max_average_window, num_updates *
    average_window_rate))`` (a device ``where``; the finished window
    rotates into an ``old`` bucket); ``apply()``/``restore()`` swap in
    the average for an evaluation."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__()
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._name = name or "model_average"
        self._sums = {}
        self._num_acc_name = None
        self._append()

    def _append(self):
        from .layers import math as M
        from .layers import tensor as T
        program = default_main_program()
        block = program.global_block()
        params = [p for p in program.all_parameters() if p.trainable]
        with op_role_guard(OpRole.Optimize):
            num_acc = T.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate(f"{self._name}.num_acc"))
            num_upd = T.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate(f"{self._name}.num_upd"))
            new_acc = num_acc + 1.0
            new_upd = num_upd + 1.0
            T.assign(new_upd, output=num_upd)
            window = M.elementwise_max(
                T.fill_constant([1], "float32",
                                float(self.min_average_window)),
                M.elementwise_min(
                    T.fill_constant([1], "float32",
                                    float(self.max_average_window)),
                    M.scale(new_upd, self.average_window)))
            restart = M.greater_equal(new_acc, window)
            keep = T.cast(M.logical_not(restart), "float32")
            took = T.cast(restart, "float32")
            old_num = T.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate(f"{self._name}.old_num"))
            T.assign(old_num * keep + new_acc * took, output=old_num)
            T.assign(M.elementwise_mul(new_acc, keep), output=num_acc)
            self._num_acc_name = num_acc.name
            self._old_num_name = old_num.name
            self._old_sums = {}
            for p in params:
                s = block.create_var(
                    name=unique_name.generate(f"{self._name}.{p.name}.sum"),
                    shape=p.shape, dtype=p.dtype, persistable=True,
                    stop_gradient=True)
                ConstantInitializer(0.0)(s)
                olds = block.create_var(
                    name=unique_name.generate(f"{self._name}.{p.name}.old"),
                    shape=p.shape, dtype=p.dtype, persistable=True,
                    stop_gradient=True)
                ConstantInitializer(0.0)(olds)
                summed = M.elementwise_add(block.var(s.name), p)
                T.assign(M.elementwise_add(
                    M.elementwise_mul(block.var(olds.name),
                                      T.cast(keep, p.dtype), axis=0),
                    M.elementwise_mul(summed, T.cast(took, p.dtype),
                                      axis=0)), output=olds)
                T.assign(M.elementwise_mul(summed, T.cast(keep, p.dtype),
                                           axis=0), output=s)
                self._sums[p.name] = s.name
                self._old_sums[p.name] = olds.name

    def _apply_values(self):
        from .framework.executor import global_scope
        scope = global_scope()
        n = max(_scalar(scope, self._num_acc_name)
                + _scalar(scope, self._old_num_name), 1.0)
        return {pname: (scope.find_var(sname)
                        + scope.find_var(self._old_sums[pname])) / n
                for pname, sname in self._sums.items()}


class LookaheadOptimizer:
    """Lookahead: the fast weights step every iteration; every k steps
    slow = slow + alpha (fast - slow) and fast = slow, by a step counter
    and ``where`` selects on the device. The slow weights start equal to
    the fast ones (the startup program copies each param)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0 and k >= 1
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import math as M
        from .layers import tensor as T
        from .layers.math import equal
        program = loss.block.program
        block = program.global_block()
        startup = startup_program or default_startup_program()
        with program_guard(program, startup):
            result = self.inner_optimizer.minimize(
                loss, startup_program, parameter_list, no_grad_set)
            with op_role_guard(OpRole.Optimize):
                ctr = T.create_global_var([1], 0.0, "float32",
                                          persistable=True,
                                          name=unique_name.generate(
                                              "lookahead.step"))
                new_ctr = ctr + 1.0
                kconst = T.fill_constant([1], "float32", float(self.k))
                sync = equal(new_ctr, kconst)
                T.assign(new_ctr - T.cast(sync, "float32") * kconst,
                         output=ctr)
                for p in program.all_parameters():
                    if not p.trainable:
                        continue
                    slow = block.create_var(
                        name=unique_name.generate(f"lookahead.{p.name}"),
                        shape=p.shape, dtype=p.dtype, persistable=True,
                        stop_gradient=True)
                    sblock = startup.global_block()
                    sblock.create_var(name=slow.name, shape=p.shape,
                                      dtype=p.dtype, persistable=True)
                    sblock.append_op(type="assign",
                                     inputs={"X": [p.name]},
                                     outputs={"Out": [slow.name]},
                                     infer_shape=False)
                    new_slow = M.elementwise_add(
                        M.scale(block.var(slow.name), 1.0 - self.alpha),
                        M.scale(p, self.alpha))
                    block.append_op(
                        type="where",
                        inputs={"Condition": [sync.name],
                                "X": [new_slow.name], "Y": [slow.name]},
                        outputs={"Out": [slow.name]}, infer_shape=False)
                    block.append_op(
                        type="where",
                        inputs={"Condition": [sync.name],
                                "X": [slow.name], "Y": [p.name]},
                        outputs={"Out": [p.name]}, infer_shape=False)
        return result

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression: each grad goes through
    ``dgc_sparsify`` (momentum correction into a local buffer U; dense
    up to ``rampup_begin_step``, then only the top ``1 - sparsity`` of
    |U|, the rest kept as residual), and the result through a plain
    ``sgd`` step, so momentum never applies twice. The sparsified grad
    is a masked dense tensor: DGC's numerics, not its traffic saving."""
    type = "sgd"

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), parameter_list=None,
                 use_nesterov=False, num_trainers=None, regularization=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameter_list=parameter_list,
                         regularization=regularization, grad_clip=grad_clip,
                         name=name)
        self._momentum = float(momentum)
        self._rampup_begin_step = int(rampup_begin_step)
        self._sparsity = float(sparsity[-1] if isinstance(
            sparsity, (list, tuple)) else sparsity)
        self._step_name = None

    def _dgc_transform(self, block, grads):
        from .layers import tensor as T
        with op_role_guard(OpRole.Backward):
            step = T.create_global_var([1], 0.0, "float32",
                                       persistable=True,
                                       name=unique_name.generate(
                                           "dgc.step"))
            T.assign(step + 1.0, output=step)
            self._step_name = step.name
            out = []
            for g in grads:
                u = block.create_var(
                    name=unique_name.generate(f"dgc.u.{g.name}"),
                    shape=g.shape, dtype=g.dtype, persistable=True,
                    stop_gradient=True)
                ConstantInitializer(0.0)(u)
                acc = block.create_var(
                    name=unique_name.generate("dgc.acc"),
                    shape=g.shape, dtype=g.dtype, stop_gradient=True)
                block.append_op(
                    type="dgc_sparsify",
                    inputs={"U": [u.name], "Grad": [g],
                            "Step": [step.name]},
                    outputs={"Out": [acc.name], "UOut": [u.name]},
                    attrs={"sparsity": self._sparsity,
                           "momentum": self._momentum,
                           "rampup_begin_step": self._rampup_begin_step},
                    infer_shape=False)
                out.append(block.var(acc.name))
        return out

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]}, infer_shape=False)

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        grads = self._dgc_transform(block, [g for _, g in params_grads])
        return super().apply_gradients(
            [(p, g) for (p, _), g in zip(params_grads, grads)])

