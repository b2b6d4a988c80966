"""Optimizer update ops in torch (counterpart of
``paddle_tpu/ops/optimizer_ops.py``: ``sgd :23``, ``momentum :36``,
``lars_momentum :57``, ``adam :76``, ``adamw :122``, ``adagrad :134``,
``decayed_adagrad :146``, ``adadelta :159``, ``adamax :175``,
``rmsprop :194``, ``ftrl :220``, ``lamb :242``, ``dpsgd :271``,
``dgc_sparsify :394``, and ``fused_sgd :305``, ``fused_momentum :313``,
``fused_adam :373``, ``fused_adamw :382``).
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
per-param, so the fused ops see dense grads only; it leaves every other
update op per-param too (the JAX table fuses these four only).

The layer-adaptive ops (``lars_momentum``, ``lamb``), ``dpsgd``'s clip
and ``dgc_sparsify``'s top-k threshold keep their norms, trust ratios
and thresholds as device tensors (``torch.where``, no host read), so a
captured step (``run_steps``) holds them. On a parameter split over a
mesh axis (pass ``tp_shard`` sets attr ``norm_axis``) their sums of
squares are summed over that axis's ranks in one all-reduce before the
square root, so each rank's trust ratio is the whole parameter's; a
collective inside a captured step is captured with it. ``dpsgd`` draws
its noise from the op's own generator (``LowerCtx.generator``), which a
captured step registers per call site, as it does dropout's."""
import torch

from ..framework.registry import register_op
from ..framework.selected_rows import (coalesce, is_selected_rows,
                                       masked_values, run_heads, to_dense)
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
            (g.rows,), -lr.to(p.dtype) * masked_values(g).to(p.dtype),
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
    advance everywhere, as in the dense op. A row that only invalid slots
    name (ids outside a table's shard) is written back as it was."""
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
    p_new, m1_new, m2_new = (p[rows] - upd)[head], m1r[head], m2r[head]
    if g.valid is not None:
        keep = g.valid.reshape(g.valid.shape + (1,) * (p.dim() - 1))
        p_new = torch.where(keep, p_new, p[rows])
        m1_new = torch.where(keep, m1_new, m1[rows])
        m2_new = torch.where(keep, m2_new, m2[rows])
    return {"ParamOut": p.index_put((rows,), p_new),
            "Moment1Out": m1.index_put((rows,), m1_new),
            "Moment2Out": m2.index_put((rows,), m2_new),
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


def _pgl(ins):
    """(param, grad in the param's type, lr in the param's type)."""
    p = x_of(ins, "Param")
    return p, x_of(ins, "Grad").to(p.dtype), \
        x_of(ins, "LearningRate").to(p.dtype)


def _l2(x):
    return torch.sqrt(torch.sum(torch.square(x)))


def _norms(ctx, attrs, *xs):
    """The L2 norms of ``xs`` (one stacked tensor): of the whole tensors
    when attr ``norm_axis`` names the axis their split runs over (the
    ranks' sums of squares summed by one all-reduce), else of ``xs``."""
    sq = torch.stack([torch.sum(torch.square(x)) for x in xs])
    if attrs.get("norm_axis"):
        from .collective_ops import _in_world, all_reduce
        axis = _in_world(ctx, {"axis_name": attrs["norm_axis"]})
        if axis:
            sq = all_reduce(sq, "sum", axis)
    return torch.sqrt(sq)


@register_op("lars_momentum", grad=False)
def lars_momentum(ctx, ins, attrs):
    """LARS: momentum at a layer-adaptive rate ``lr * coeff * ||p|| /
    (||g|| + decay ||p|| + eps)`` (``lr`` where either norm is 0)."""
    p, g, lr = _pgl(ins)
    v = x_of(ins, "Velocity")
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 1e-9)
    pn, gn = _norms(ctx, attrs, p, g)
    local_lr = torch.where((pn > 0) & (gn > 0),
                           coeff * pn / (gn + decay * pn + eps), 1.0)
    v_new = mu * v + lr * local_lr * (g + decay * p)
    return {"ParamOut": p - v_new, "VelocityOut": v_new}


@register_op("lamb", grad=False)
def lamb(ctx, ins, attrs):
    """LAMB: Adam's bias-corrected direction plus ``weight_decay * p``,
    scaled by the trust ratio ``||p|| / ||r||`` (1 where either is 0).
    The beta-pows may be param-shaped (the optimizer's layout)."""
    p, g, lr = _pgl(ins)
    m1, m2 = x_of(ins, "Moment1"), x_of(ins, "Moment2")
    b1p, b2p = x_of(ins, "Beta1Pow"), x_of(ins, "Beta2Pow")
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    m1h = m1n / (1 - b1p.to(p.dtype))
    m2h = m2n / (1 - b2p.to(p.dtype))
    r = m1h / (torch.sqrt(m2h) + eps) + wd * p
    pn, rn = _norms(ctx, attrs, p, r)
    trust = torch.where((pn > 0) & (rn > 0), pn / rn, 1.0)
    return {"ParamOut": p - lr * trust * r, "Moment1Out": m1n,
            "Moment2Out": m2n, "Beta1PowOut": b1p * b1,
            "Beta2PowOut": b2p * b2}


@register_op("adagrad", grad=False)
def adagrad(ctx, ins, attrs):
    p, g, lr = _pgl(ins)
    mom_new = x_of(ins, "Moment") + torch.square(g)
    eps = attrs.get("epsilon", 1e-6)
    return {"ParamOut": p - lr * g / (torch.sqrt(mom_new) + eps),
            "MomentOut": mom_new}


@register_op("decayed_adagrad", grad=False)
def decayed_adagrad(ctx, ins, attrs):
    p, g, lr = _pgl(ins)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_new = decay * x_of(ins, "Moment") + (1 - decay) * torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(mom_new) + eps),
            "MomentOut": mom_new}


@register_op("adadelta", grad=False)
def adadelta(ctx, ins, attrs):
    p = x_of(ins, "Param")
    g = x_of(ins, "Grad").to(p.dtype)
    avg_sq_g = x_of(ins, "AvgSquaredGrad")
    avg_sq_u = x_of(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg = rho * avg_sq_g + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_u + eps) / (asg + eps)) * g
    asu = rho * avg_sq_u + (1 - rho) * torch.square(update)
    return {"ParamOut": p + update, "AvgSquaredGradOut": asg,
            "AvgSquaredUpdateOut": asu}


@register_op("adamax", grad=False)
def adamax(ctx, ins, attrs):
    """Adam with the infinity norm; the optimizer scales ``Beta1Pow``
    after the updates (``AdamaxOptimizer._finish_update``)."""
    p, g, lr = _pgl(ins)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * x_of(ins, "Moment") + (1 - b1) * g
    inf_new = torch.maximum(b2 * x_of(ins, "InfNorm"), torch.abs(g))
    lr_t = lr / (1 - x_of(ins, "Beta1Pow").to(p.dtype))
    return {"ParamOut": p - lr_t * m_new / (inf_new + eps),
            "MomentOut": m_new, "InfNormOut": inf_new}


@register_op("rmsprop", grad=False)
def rmsprop(ctx, ins, attrs):
    """RMSProp with momentum; ``centered`` subtracts the square of the
    mean grad from the mean square."""
    p, g, lr = _pgl(ins)
    ms, mg = x_of(ins, "MeanSquare"), x_of(ins, "MeanGrad")
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_new = rho * mg + (1 - rho) * g
        denom = ms_new - torch.square(mg_new) + eps
    else:
        mg_new = mg
        denom = ms_new + eps
    mom_new = mu * x_of(ins, "Moment") + lr * g * torch.rsqrt(denom)
    return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new,
            "MeanGradOut": mg_new, "MomentOut": mom_new}


@register_op("ftrl", grad=False)
def ftrl(ctx, ins, attrs):
    p, g, lr = _pgl(ins)
    sq = x_of(ins, "SquaredAccumulator")
    lin = x_of(ins, "LinearAccumulator")
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    new_lin = lin + g - sigma * p
    x = l1 * torch.sign(new_lin) - new_lin
    y = torch.pow(new_sq, -power) / lr + 2 * l2
    return {"ParamOut": torch.where(torch.abs(new_lin) > l1, x / y, 0.0),
            "SquaredAccumOut": new_sq, "LinearAccumOut": new_lin}


@register_op("dpsgd", grad=False, needs_rng=True)
def dpsgd(ctx, ins, attrs):
    """Differentially private SGD: the grad clipped to norm ``clip``,
    plus Gaussian noise of deviation ``sigma * clip`` from the op's own
    generator."""
    p, g, lr = _pgl(ins)
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    scale = torch.clamp(clip / torch.clamp(_l2(g), min=1e-12), max=1.0)
    noise = torch.randn(g.shape, generator=ctx.generator(attrs),
                        dtype=g.dtype, device=g.device) * sigma * clip
    return {"ParamOut": p - lr * (g * scale + noise)}


@register_op("dgc_sparsify", grad=False, infer_shape=False)
def dgc_sparsify(ctx, ins, attrs):
    """Deep Gradient Compression: momentum-correct into the local buffer
    U; up to step ``rampup_begin_step`` the whole corrected grad goes
    out (U acts as the velocity), after it only the entries of |U| at or
    above the top ``1 - sparsity`` fraction's threshold (``torch.topk``
    on the device), the rest staying in U as residual."""
    u, g = x_of(ins, "U"), x_of(ins, "Grad")
    s = float(attrs.get("sparsity", 0.999))
    m = float(attrs.get("momentum", 0.9))
    rampup = float(attrs.get("rampup_begin_step", 0))
    u_new = m * u + g
    flat = torch.abs(u_new).reshape(-1)
    k = max(int(flat.shape[0] * (1.0 - s)), 1)
    thresh = torch.topk(flat, k).values[k - 1]
    sparse_send = torch.where(torch.abs(u_new) >= thresh, u_new, 0.0)
    dense = x_of(ins, "Step").reshape(()) <= rampup
    return {"Out": torch.where(dense, u_new, sparse_send),
            "UOut": torch.where(dense, u_new, u_new - sparse_send)}
