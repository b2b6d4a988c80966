"""In-graph learning-rate schedulers (trimmed copy of
``paddle_tpu/layers/learning_rate_scheduler.py``): the step counter and
``noam_decay`` (``:25-60``). The scheduler's ops take the ``LRSched``
role, so ``clone(for_test=True)`` drops them with the other
non-forward ops. The other schedulers are not ported."""
from ..framework.core import OpRole, default_main_program, op_role_guard
from ..framework.initializer import ConstantInitializer
from . import nn as nn_layers
from .layer_helper import LayerHelper
from .math import elementwise_min

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

