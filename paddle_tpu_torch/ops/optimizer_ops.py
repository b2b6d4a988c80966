"""Optimizer update ops in torch (counterpart of
``paddle_tpu/ops/optimizer_ops.py``: ``sgd :23``, ``momentum :36``,
``adam :76``, ``adamw :122``, and ``fused_sgd :305``,
``fused_momentum :313``, ``fused_adam :373``, ``fused_adamw :382``).
Each op returns new param/state tensors that rebind the same names in
the env, as the JAX lowering does; no input is written in place (a
rollback's ``assign`` snapshot aliases it).

The fused ops are a bucket of per-param updates
(``passes.FuseOptimizerPass``) over lists of tensors with
``torch._foreach_*``: each element takes its per-param op's operations
in the same order, so every output equals the per-param op's bit for
bit, while a bucket is a few multi-tensor launches instead of several
per param. Where the JAX ops concatenate the bucket (which XLA fuses
away), eager torch would copy every tensor twice.

A ``SelectedRows`` grad (an ``is_sparse`` embedding's): ``sgd`` moves
only the touched rows; ``momentum`` and ``adam`` densify it (their
moments decay every row); ``adam`` with ``lazy_mode`` updates the
touched rows' moments and params only, after merging duplicate ids
(``selected_rows.coalesce``). ``fuse_optimizer`` leaves all of these
per-param, so the fused ops see dense grads only."""
import torch

from ..framework.registry import register_op
from ..framework.selected_rows import (coalesce, is_selected_rows,
                                       run_heads, to_dense)
from .common import x_of


def _hyper(attrs):
    return (attrs.get("beta1", 0.9), attrs.get("beta2", 0.999),
            attrs.get("epsilon", 1e-8))


def _lr(ins, dt):
    """A bucket's learning rate as a 0-d tensor of the params' type (a
    scheduler's LR is a [1] var; the multi-tensor ops take a 0-d one)."""
    return ins["LearningRate"][0].to(dt).reshape(())


@register_op("sgd", grad=False)
def sgd(ctx, ins, attrs):
    """p - lr g; a sparse grad moves only its rows, duplicates summed."""
    p, g, lr = x_of(ins, "Param"), x_of(ins, "Grad"), \
        x_of(ins, "LearningRate")
    if is_selected_rows(g):
        return {"ParamOut": p.index_put(
            (g.rows,), -lr.to(p.dtype) * g.values.to(p.dtype),
            accumulate=True)}
    return {"ParamOut": p - lr.to(p.dtype) * g.to(p.dtype)}


@register_op("fused_sgd", grad=False, infer_shape=False)
def fused_sgd(ctx, ins, attrs):
    """A bucket of :func:`sgd`: p - lr g."""
    ps = ins["Param"]
    dt = ps[0].dtype
    upd = torch._foreach_mul([g.to(dt) for g in ins["Grad"]], _lr(ins, dt))
    return {"ParamOut": torch._foreach_sub(ps, upd)}


@register_op("momentum", grad=False)
def momentum(ctx, ins, attrs):
    """v = mu v + g; p - lr v, or with Nesterov p - (g + mu v) lr."""
    p, g, lr = x_of(ins, "Param"), x_of(ins, "Grad"), \
        x_of(ins, "LearningRate")
    v = x_of(ins, "Velocity")
    mu = attrs.get("mu", 0.9)
    lr = lr.to(p.dtype)
    if is_selected_rows(g):
        g = to_dense(g, p.shape, p.dtype)
    g = g.to(p.dtype)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


@register_op("fused_momentum", grad=False, infer_shape=False)
def fused_momentum(ctx, ins, attrs):
    """A bucket of :func:`momentum`, in its operation order."""
    ps = ins["Param"]
    dt = ps[0].dtype
    gs = [g.to(dt) for g in ins["Grad"]]
    lr = _lr(ins, dt)
    mu = attrs.get("mu", 0.9)
    v_new = torch._foreach_mul(ins["Velocity"], mu)
    torch._foreach_add_(v_new, gs)
    if attrs.get("use_nesterov", False):
        upd = torch._foreach_mul(v_new, mu)     # g + mu v as mu v + g
        torch._foreach_add_(upd, gs)
        torch._foreach_mul_(upd, lr)
    else:
        upd = torch._foreach_mul(v_new, lr)
    return {"ParamOut": torch._foreach_sub(ps, upd), "VelocityOut": v_new}


@register_op("adam", grad=False)
def adam(ctx, ins, attrs):
    p, g, lr = x_of(ins, "Param"), x_of(ins, "Grad"), \
        x_of(ins, "LearningRate")
    m1, m2 = x_of(ins, "Moment1"), x_of(ins, "Moment2")
    b1p, b2p = x_of(ins, "Beta1Pow"), x_of(ins, "Beta2Pow")
    b1, b2, eps = _hyper(attrs)
    if is_selected_rows(g):
        if attrs.get("lazy_mode", False):
            return _lazy_adam(p, g, lr, m1, m2, b1p, b2p, b1, b2, eps)
        g = to_dense(g, p.shape, p.dtype)
    g = g.to(p.dtype)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = lr.to(p.dtype) * torch.sqrt(1 - b2p.to(p.dtype)) / \
        (1 - b1p.to(p.dtype))
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": p_new, "Moment1Out": m1n, "Moment2Out": m2n,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


def _lazy_adam(p, g, lr, m1, m2, b1p, b2p, b1, b2, eps):
    """Adam on the rows of a sparse grad only (the reference's
    ``lazy_mode``): untouched rows keep their param and moments bit for
    bit. Duplicate ids merge first (``coalesce``), as a per-occurrence
    update would apply twice against stale moments. Every slot of a run
    of one id writes its run head's new values, so the unaccumulated
    row writes agree. The beta-pows (uniform, scalar or param-shaped)
    advance everywhere, as in the dense op."""
    g = coalesce(g)
    rows = g.rows
    gv = g.values.to(p.dtype)
    m1r = b1 * m1[rows] + (1 - b1) * gv
    m2r = b2 * m2[rows] + (1 - b2) * torch.square(gv)
    b1p_s = b1p.reshape(-1)[0].to(p.dtype)
    b2p_s = b2p.reshape(-1)[0].to(p.dtype)
    lr_t = lr.reshape(-1)[0].to(p.dtype) * torch.sqrt(1 - b2p_s) / \
        (1 - b1p_s)
    upd = lr_t * m1r / (torch.sqrt(m2r) + eps)
    head = run_heads(rows)
    return {"ParamOut": p.index_put((rows,), (p[rows] - upd)[head]),
            "Moment1Out": m1.index_put((rows,), m1r[head]),
            "Moment2Out": m2.index_put((rows,), m2r[head]),
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


@register_op("adamw", grad=False)
def adamw(ctx, ins, attrs):
    """:func:`adam`, then the decoupled decay ``- lr * coeff * p`` (of
    the param before the update) unless ``with_decay`` is off."""
    p, lr = x_of(ins, "Param"), x_of(ins, "LearningRate")
    outs = adam(ctx, ins, attrs)
    if attrs.get("with_decay", True):
        outs["ParamOut"] = outs["ParamOut"] - \
            lr.to(p.dtype) * attrs.get("coeff", 0.01) * p
    return outs


@register_op("fused_adam", grad=False, infer_shape=False)
def fused_adam(ctx, ins, attrs):
    """A bucket of :func:`adam` (~19 launches a param unfused).
    Beta-pows come param-shaped (elementwise, as the moments) or scalar
    (a per-param step size broadcast over its param)."""
    ps = ins["Param"]
    dt = ps[0].dtype
    gs = [g.to(dt) for g in ins["Grad"]]
    lr = _lr(ins, dt)
    b1ps = [b.to(dt) for b in ins["Beta1Pow"]]
    b2ps = [b.to(dt) for b in ins["Beta2Pow"]]
    b1, b2, eps = _hyper(attrs)
    # m1 = b1 m1 + (1 - b1) g;  m2 = b2 m2 + (1 - b2) g^2
    m1n = torch._foreach_mul(ins["Moment1"], b1)
    torch._foreach_add_(m1n, torch._foreach_mul(gs, 1 - b1))
    m2n = torch._foreach_mul(ins["Moment2"], b2)
    gsq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(gsq, 1 - b2)
    torch._foreach_add_(m2n, gsq)
    del gsq
    # lr_t = lr sqrt(1 - b2p) / (1 - b1p); 1 - x as -x + 1 (the same
    # rounding)
    lr_t = torch._foreach_neg(b2ps)
    torch._foreach_add_(lr_t, 1)
    torch._foreach_sqrt_(lr_t)
    torch._foreach_mul_(lr_t, lr)
    den = torch._foreach_neg(b1ps)
    torch._foreach_add_(den, 1)
    torch._foreach_div_(lr_t, den)
    del den
    # p - lr_t m1 / (sqrt(m2) + eps)
    if tuple(b1ps[0].shape) == tuple(ps[0].shape):
        upd = torch._foreach_mul(lr_t, m1n)
    else:       # scalar beta-pows: broadcast each step size
        upd = [t * m for t, m in zip(lr_t, m1n)]
    den = torch._foreach_sqrt(m2n)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(upd, den)
    del den
    return {"ParamOut": torch._foreach_sub(ps, upd), "Moment1Out": m1n,
            "Moment2Out": m2n,
            "Beta1PowOut": torch._foreach_mul(ins["Beta1Pow"], b1),
            "Beta2PowOut": torch._foreach_mul(ins["Beta2Pow"], b2)}


@register_op("fused_adamw", grad=False, infer_shape=False)
def fused_adamw(ctx, ins, attrs):
    """A bucket of :func:`adamw`: :func:`fused_adam`, then ``- (lr *
    coeff) * p`` in that op's order."""
    outs = fused_adam(ctx, ins, attrs)
    if attrs.get("with_decay", True):
        ps = ins["Param"]
        lrc = _lr(ins, ps[0].dtype) * attrs.get("coeff", 0.01)
        outs["ParamOut"] = torch._foreach_sub(
            outs["ParamOut"], torch._foreach_mul(ps, lrc))
    return outs
