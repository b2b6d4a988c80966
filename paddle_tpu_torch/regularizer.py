"""Weight-decay regularizers appended as grad-transform ops (a copy of
``paddle_tpu/regularizer.py``): ``L2DecayRegularizer`` emits ``scale``
and ``sum`` (``g + coeff * p``), ``L1DecayRegularizer`` emits ``sign``,
``scale`` and ``sum`` (``g + coeff * sign(p)``), each in the backward
role. A parameter's own ``regularizer`` (``ParamAttr(regularizer=)``)
overrides the optimizer's. ``_eager`` is the same transform on dygraph
tensors, on the device and without a host read."""
import torch

from .framework import unique_name
from .framework.core import OP_ROLE_KEY, OpRole, default_main_program


class WeightDecayRegularizer:
    def append_regularization_ops(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _eager(self, p_value, g):
        return g + self._coeff * p_value

    def __call__(self, param, grad, block):
        decayed = block.create_var(
            name=unique_name.generate(param.name + "_l2_decay"),
            dtype=grad.dtype, stop_gradient=True)
        block.append_op(
            type="scale", inputs={"X": [param]},
            outputs={"Out": [decayed]},
            attrs={"scale": self._coeff, OP_ROLE_KEY: OpRole.Backward})
        new_grad = block.create_var(
            name=unique_name.generate(grad.name + "_reg"),
            dtype=grad.dtype, stop_gradient=True)
        block.append_op(
            type="sum", inputs={"X": [grad, decayed]},
            outputs={"Out": [new_grad]},
            attrs={OP_ROLE_KEY: OpRole.Backward})
        return new_grad


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _eager(self, p_value, g):
        return g + self._coeff * torch.sign(p_value)

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=unique_name.generate(param.name + "_sign"),
            dtype=grad.dtype, stop_gradient=True)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]},
                        attrs={OP_ROLE_KEY: OpRole.Backward})
        decayed = block.create_var(
            name=unique_name.generate(param.name + "_l1_decay"),
            dtype=grad.dtype, stop_gradient=True)
        block.append_op(
            type="scale", inputs={"X": [sign]}, outputs={"Out": [decayed]},
            attrs={"scale": self._coeff, OP_ROLE_KEY: OpRole.Backward})
        new_grad = block.create_var(
            name=unique_name.generate(grad.name + "_reg"),
            dtype=grad.dtype, stop_gradient=True)
        block.append_op(
            type="sum", inputs={"X": [grad, decayed]},
            outputs={"Out": [new_grad]},
            attrs={OP_ROLE_KEY: OpRole.Backward})
        return new_grad


def append_regularization_ops(params_grads, regularization=None):
    """Each (param, grad) with a regularizer (the param's own, else
    ``regularization``) gets its decay ops; returns the new pairs."""
    block = default_main_program().global_block()
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None:
            out.append((param, grad))
            continue
        new_grad = reg(param, grad, block)
        out.append((param, block.var(new_grad.name)))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
