"""In-graph learning-rate schedulers (a copy of
``paddle_tpu/layers/learning_rate_scheduler.py``): the step counter,
``noam_decay`` (``:25-60``), ``exponential_decay``,
``natural_exp_decay``, ``inverse_time_decay``, ``polynomial_decay``
(with ``cycle``), ``piecewise_decay``, ``cosine_decay`` and
``linear_lr_warmup`` (``:62-150``). Each is ops of the program that read
the auto-incremented step counter, so the learning rate is computed in
the step itself. The scheduler's ops take the ``LRSched`` role, so
``clone(for_test=True)`` drops them with the other non-forward ops."""
import math

from ..framework.core import OpRole, default_main_program, op_role_guard
from ..framework.initializer import ConstantInitializer
from . import nn as nn_layers
from . import tensor
from .layer_helper import LayerHelper
from .math import elementwise_max, elementwise_min, less_than

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable float32 step counter that an ``increment`` op adds
    ``step`` to on every executor run of the program."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or LR_COUNTER_NAME
    gblock = default_main_program().global_block()
    if name in gblock.vars:
        return gblock.vars[name]
    counter = gblock.create_var(
        name=name, shape=[1], dtype="float32", persistable=True,
        stop_gradient=True)
    ConstantInitializer(float(begin - step))(counter)
    helper.append_op(type="increment", inputs={"X": [counter]},
                     outputs={"Out": [counter]},
                     attrs={"step": float(step)})
    return counter


def _decay_step_counter(begin=0):
    """The first run reads ``begin``, then begin + 1, ... (the counter
    starts at begin - 1 and is incremented before it is read)."""
    with op_role_guard(OpRole.LRSched):
        return autoincreased_step_counter(begin=begin, step=1)


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """``lr = learning_rate * d_model^-0.5 * min(step^-0.5, step *
    warmup_steps^-1.5)`` as a [1] float32 var."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter(begin=1)
        a = nn_layers.rsqrt(step)
        b = step * (float(warmup_steps) ** -1.5)
        lr = (float(learning_rate) * float(d_model) ** -0.5) * \
            elementwise_min(a, b)
        return lr


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """``learning_rate * decay_rate ^ (step / decay_steps)`` (the
    exponent floored when ``staircase``)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = nn_layers.floor(div)
        rate = tensor.fill_constant([1], "float32", float(decay_rate))
        return float(learning_rate) * (rate ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """``learning_rate * exp(-decay_rate * step / decay_steps)``."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = nn_layers.floor(div)
        return float(learning_rate) * nn_layers.exp(
            div * (-float(decay_rate)))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """``learning_rate / (1 + decay_rate * step / decay_steps)``."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = nn_layers.floor(div)
        denom = div * float(decay_rate) + 1.0
        return float(learning_rate) / denom


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """``(learning_rate - end) * (1 - step / decay_steps) ^ power + end``,
    the step held at ``decay_steps``; with ``cycle`` the period grows to
    the next multiple of ``decay_steps`` instead (at least one)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        if cycle:
            div = nn_layers.ceil(step / float(decay_steps))
            one = tensor.fill_constant([1], "float32", 1.0)
            div = elementwise_max(div, one)
            decay_var = div * float(decay_steps)
        else:
            decay_var = tensor.fill_constant([1], "float32",
                                             float(decay_steps))
            step = elementwise_min(step, decay_var)
        one = tensor.fill_constant([1], "float32", 1.0)
        frac = nn_layers.pow(one - step / decay_var, float(power))
        return (float(learning_rate) - float(end_learning_rate)) * frac + \
            float(end_learning_rate)


def piecewise_decay(boundaries, values):
    """``values[i]`` while step < ``boundaries[i]``, ``values[-1]``
    after."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("piecewise_decay needs one more value than "
                         "boundaries")
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        lr = tensor.fill_constant([1], "float32", float(values[-1]))
        for b, v in reversed(list(zip(boundaries, values[:-1]))):
            bvar = tensor.fill_constant([1], "float32", float(b))
            below = tensor.cast(less_than(step, bvar), "float32")
            lr = below * float(v) + (1.0 - below) * lr
        return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """``learning_rate / 2 * (cos(epoch * pi / epochs) + 1)``, epoch =
    floor(step / step_each_epoch)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        epoch = nn_layers.floor(step / float(step_each_epoch))
        return 0.5 * float(learning_rate) * (
            nn_layers.cos(epoch * (math.pi / float(epochs))) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """A linear ramp from ``start_lr`` to ``end_lr`` over
    ``warmup_steps``, then ``learning_rate`` (a float or an LR var)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        wsteps = tensor.fill_constant([1], "float32", float(warmup_steps))
        in_warmup = tensor.cast(less_than(step, wsteps), "float32")
        warm = float(start_lr) + (float(end_lr) - float(start_lr)) * \
            (step / float(warmup_steps))
        if not isinstance(learning_rate, float):
            base = learning_rate
        else:
            base = tensor.fill_constant([1], "float32",
                                        float(learning_rate))
        return in_warmup * warm + (1.0 - in_warmup) * base
