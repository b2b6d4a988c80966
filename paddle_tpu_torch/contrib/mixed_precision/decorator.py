"""OptimizerWithMixedPrecision (a copy of
``paddle_tpu/contrib/mixed_precision/decorator.py``).

minimize = rewrite the program to the low-precision compute dtype ->
scale the loss -> backward (grads arrive float32 at the master weights
through the cast vjp) -> unscale + finite check -> dynamic loss-scale
update -> optimizer ops, the whole parameter/accumulator update rolled
back with ``where`` selects when any grad overflowed.

The default compute dtype is bfloat16, which has float32's exponent
range: with a static scale of 1.0 (how ``bench_gpt_long`` trains) no
scaling op is emitted at all.
"""
from ...framework import unique_name
from ...framework.core import (OpRole, default_main_program,
                               default_startup_program, op_role_guard,
                               program_guard)
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 dest_dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._dest_dtype = dest_dtype
        self._loss_scaling = None
        self._scaled_loss = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def get_scaled_loss(self):
        return self._scaled_loss

    def _create_scale_vars(self):
        from ...layers import tensor as T
        self._loss_scaling = T.create_global_var(
            shape=[1], value=self._init_loss_scaling, dtype="float32",
            persistable=True, name=unique_name.generate("loss_scaling"))
        if self._use_dynamic_loss_scaling:
            self._num_good_steps = T.create_global_var(
                shape=[1], value=0.0, dtype="float32", persistable=True,
                name=unique_name.generate("num_good_steps"))
            self._num_bad_steps = T.create_global_var(
                shape=[1], value=0.0, dtype="float32", persistable=True,
                name=unique_name.generate("num_bad_steps"))

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        program = loss.block.program
        # scaling, unscaling, the finite check and the rollback are
        # needed only when the loss scale can differ from 1
        self._needs_scaling = (self._use_dynamic_loss_scaling or
                               self._init_loss_scaling != 1.0)
        with program_guard(program,
                           startup_program or default_startup_program()):
            rewrite_program(program, self._amp_lists, self._dest_dtype)
            self._create_scale_vars()
            if self._needs_scaling:
                self._scaled_loss = loss * self._loss_scaling
            else:
                self._scaled_loss = loss
            params_grads = self._optimizer.backward(
                self._scaled_loss, startup_program, parameter_list,
                no_grad_set, callbacks)
            if self._needs_scaling:
                with op_role_guard(OpRole.Backward):
                    params_grads = self._unscale_and_check(params_grads)
        return params_grads

    def _unscale_and_check(self, params_grads):
        """grad /= loss_scaling, and the found-inf flag (the reference's
        check_finite_and_unscale op)."""
        from ...layers import math as M
        from ...layers.layer_helper import LayerHelper
        helper = LayerHelper("check_finite_and_unscale")
        finites = []
        new_pg = []
        # divide, not multiply by the reciprocal: 1/scale underflows for
        # a scale near float32's max
        for p, g in params_grads:
            g2 = M.elementwise_div(g, self._loss_scaling)
            if self._use_dynamic_loss_scaling:
                fin = helper.create_variable_for_type_inference(dtype="bool")
                helper.append_op(type="isfinite", inputs={"X": [g2]},
                                 outputs={"Out": [fin]})
                finites.append(fin)
            new_pg.append((p, g2))
        if self._use_dynamic_loss_scaling:
            all_fin = finites[0]
            for f in finites[1:]:
                all_fin = M.logical_and(all_fin, f)
            self._found_inf = M.logical_not(all_fin)
            self._found_inf.persistable = False
            self._update_loss_scaling()
        return new_pg

    def _update_loss_scaling(self):
        """The reference's update_loss_scaling op: on overflow bad += 1,
        and after decr_every_n_nan_or_inf bad steps scale *= decr_ratio;
        on a clean step good += 1, and after incr_every_n_steps scale *=
        incr_ratio. Counters reset on each scale change (good also on
        any overflow)."""
        from ...layers import tensor as T
        from ...layers.math import elementwise_max
        scale = self._loss_scaling
        good, bad = self._num_good_steps, self._num_bad_steps
        inf = T.cast(self._found_inf, "float32")
        ok = 1.0 - inf
        good_new = (good + 1.0) * ok            # 0 after an overflow
        bad_new = (bad + 1.0) * inf             # 0 after a clean step
        hit_incr = T.cast(
            good_new >= float(self._incr_every_n_steps), "float32")
        hit_decr = T.cast(
            bad_new >= float(self._decr_every_n_nan_or_inf), "float32")
        factor = (1.0 + hit_incr * (self._incr_ratio - 1.0)) * \
                 (1.0 + hit_decr * (self._decr_ratio - 1.0))
        scale_new = elementwise_max(scale * factor,
                                    T.fill_constant([1], "float32", 1e-8))
        T.assign(scale_new, output=scale)
        T.assign(good_new * (1.0 - hit_incr), output=good)
        T.assign(bad_new * (1.0 - hit_decr), output=bad)

    def apply_gradients(self, params_grads):
        from ...optimizer import rollback_updates_if
        block = default_main_program().global_block()
        mark = len(block.ops)
        optimize_ops = self._optimizer.apply_gradients(params_grads)
        if self._use_dynamic_loss_scaling:
            # every persistable the optimizer wrote is restored when a
            # grad overflowed
            rollback_updates_if(block, mark, self._found_inf)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        with program_guard(program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, dest_dtype="bfloat16"):
    """Wrap an optimizer for mixed-precision training; ``dest_dtype``
    bfloat16 by default."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest_dtype=dest_dtype)
