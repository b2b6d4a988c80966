"""Gradient and error clipping (a copy of ``paddle_tpu/clip.py``).

``GradientClipByValue`` emits one ``clip`` per grad,
``GradientClipByNorm`` one ``clip_by_norm``, and
``GradientClipByGlobalNorm`` a ``squared_l2_norm`` per grad, ``sum``,
``sqrt``, ``fill_constant``, ``elementwise_max`` and ``elementwise_div``
for the scale, then an ``elementwise_mul`` per grad: the scale stays a
device tensor, so a captured step (``run_steps``) holds the clip. A
parameter with ``need_clip=False`` keeps its grad. ``_eager`` is each
clip over dygraph (param, grad) pairs, in torch on the device and
without a host read (``dygraph.jit_step`` captures it).

``ErrorClipByValue`` set on a var (``var._set_error_clip``) clips that
var's backward error signal when ``append_backward`` finalizes it;
``error_clip_callback`` is accepted by ``append_backward`` for that."""
import torch

from .framework import unique_name
from .framework.core import OP_ROLE_KEY, OpRole, default_main_program


class BaseErrorClipAttr:
    """Base of error-signal clip attrs. Subclasses implement
    ``_append_clip_op(block, grad_name)``, emitting the clip and
    returning the clipped grad's name."""

    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError(
            f"{type(self).__name__} must implement "
            f"_append_clip_op(block, grad_name) -> clipped_name")


class ErrorClipByValue(BaseErrorClipAttr):
    """Clip a var's backward error signal to [min, max]; min defaults
    to -max."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _append_clip_op(self, block, grad_name):
        fwd = block.vars.get(grad_name.split("@GRAD")[0])
        cname = grad_name + "@CLIP"
        block.create_var(name=cname,
                         shape=fwd.shape if fwd is not None else None,
                         dtype=fwd.dtype if fwd is not None else "float32",
                         stop_gradient=True)
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [cname]},
                        attrs={"min": self.min, "max": self.max,
                               OP_ROLE_KEY: OpRole.Backward})
        return cname


def error_clip_callback(block, context):
    """The reference's ``append_backward`` callback for error clipping.
    ``append_backward`` applies error clips as each grad is finalized,
    so passing this callback is satisfied by that."""


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


def _clipped(p):
    return getattr(p, "need_clip", True)


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _eager(self, pairs):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p)
                 else g) for p, g in pairs]

    def __call__(self, params_grads):
        block = default_main_program().global_block()
        out = []
        for p, g in params_grads:
            if not _clipped(p):
                out.append((p, g))
                continue
            ng = block.create_var(
                name=unique_name.generate(g.name + "_clip"),
                dtype=g.dtype, stop_gradient=True)
            block.append_op(type="clip", inputs={"X": [g]},
                            outputs={"Out": [ng]},
                            attrs={"min": self.min, "max": self.max,
                                   OP_ROLE_KEY: OpRole.Backward})
            out.append((p, ng))
        return out


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _eager(self, pairs):
        out = []
        for p, g in pairs:
            if _clipped(p):
                n = torch.sqrt(torch.sum(torch.square(g)))
                g = g * (self.clip_norm / torch.clamp(n, min=self.clip_norm))
            out.append((p, g))
        return out

    def __call__(self, params_grads):
        block = default_main_program().global_block()
        out = []
        for p, g in params_grads:
            if not _clipped(p):
                out.append((p, g))
                continue
            ng = block.create_var(
                name=unique_name.generate(g.name + "_clip"),
                dtype=g.dtype, stop_gradient=True)
            block.append_op(type="clip_by_norm", inputs={"X": [g]},
                            outputs={"Out": [ng]},
                            attrs={"max_norm": self.clip_norm,
                                   OP_ROLE_KEY: OpRole.Backward})
            out.append((p, ng))
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    """Scale every clipped grad by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken over all of them."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _eager(self, pairs):
        sq = [torch.sum(torch.square(g)) for p, g in pairs if _clipped(p)]
        if not sq:
            return pairs
        gnorm = torch.sqrt(sum(sq))
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        return [(p, g * scale if _clipped(p) else g) for p, g in pairs]

    def __call__(self, params_grads):
        block = default_main_program().global_block()
        role = {OP_ROLE_KEY: OpRole.Backward}
        sq_norms = []
        for p, g in params_grads:
            if not _clipped(p):
                continue
            sq = block.create_var(
                name=unique_name.generate(g.name + "_sq"),
                dtype=g.dtype, stop_gradient=True)
            block.append_op(type="squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [sq]}, attrs=dict(role))
            sq_norms.append(sq)
        if not sq_norms:
            return params_grads
        gsum = block.create_var(name=unique_name.generate("global_norm_sq"),
                                dtype=sq_norms[0].dtype, stop_gradient=True)
        block.append_op(type="sum", inputs={"X": sq_norms},
                        outputs={"Out": [gsum]}, attrs=dict(role))
        gnorm = block.create_var(name=unique_name.generate("global_norm"),
                                 dtype=gsum.dtype, stop_gradient=True)
        block.append_op(type="sqrt", inputs={"X": [gsum]},
                        outputs={"Out": [gnorm]}, attrs=dict(role))
        clip_var = block.create_var(name=unique_name.generate("clip_norm"),
                                    dtype=gnorm.dtype, stop_gradient=True)
        block.append_op(type="fill_constant", outputs={"Out": [clip_var]},
                        attrs={"shape": [], "value": self.clip_norm,
                               "dtype": gnorm.dtype, **role},
                        infer_shape=False)
        denom = block.create_var(name=unique_name.generate("clip_denom"),
                                 dtype=gnorm.dtype, stop_gradient=True)
        block.append_op(type="elementwise_max",
                        inputs={"X": [gnorm], "Y": [clip_var]},
                        outputs={"Out": [denom]}, attrs=dict(role))
        scale_var = block.create_var(name=unique_name.generate("clip_scale"),
                                     dtype=gnorm.dtype, stop_gradient=True)
        block.append_op(type="elementwise_div",
                        inputs={"X": [clip_var], "Y": [denom]},
                        outputs={"Out": [scale_var]}, attrs=dict(role))
        out = []
        for p, g in params_grads:
            if not _clipped(p):
                out.append((p, g))
                continue
            ng = block.create_var(
                name=unique_name.generate(g.name + "_clip"),
                dtype=g.dtype, stop_gradient=True)
            block.append_op(type="elementwise_mul",
                            inputs={"X": [g], "Y": [scale_var]},
                            outputs={"Out": [ng]}, attrs=dict(role))
            out.append((p, ng))
        return out


# the legacy set_gradient_clip: one clip for every later minimize
_clip_attr = {}


def set_gradient_clip(clip, param_list=None, program=None):
    _clip_attr["clip"] = clip


def append_gradient_clip_ops(params_grads):
    clip = _clip_attr.get("clip")
    if clip is None:
        return params_grads
    return clip(params_grads)


ClipGradByValue = GradientClipByValue
ClipGradByNorm = GradientClipByNorm
ClipGradByGlobalNorm = GradientClipByGlobalNorm
