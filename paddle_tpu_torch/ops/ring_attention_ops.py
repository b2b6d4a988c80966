"""Sequence-parallel attention: the ``ring_attention`` and
``ulysses_attention`` ops.

Counterpart of ``paddle_tpu/ops/ring_attention_ops.py``. Inputs ``Q``,
``K``, ``V`` ``[B, H, S, D]`` and an optional additive ``Bias`` (a
``[B, 1, 1, S]`` key bias, a ``[B, H, S, S]`` or a head-broadcast
``[B, 1, S, S]`` mask); attrs ``scale`` (0: ``1/sqrt(D)``) and
``causal``. Output ``Out`` ``[B, H, S, D]``.

Without a split (a program run as built, or an axis of one rank) both
are one pass of exact attention: the ring's one fold of the whole K/V
into the online softmax, Ulysses' full attention. Pass ``sp_shard``
(``parallel.sp``) marks the op it feeds with this rank's chunks of the
sequence (attr ``sp_split``); then, over the ``sp`` axis of the active
mesh (index ``s`` of ``n``, chunk ``L = S / n``):

- the ring runs ``n`` steps; step ``t`` folds the K/V block it holds
  (block ``j = (s - t) mod n``) into the online-softmax accumulator and
  passes K and V, packed in one buffer, to index ``s + 1``
  (``collective_ops.ring_shift``). Under ``causal`` the blocks above
  the diagonal (``j > s``) are skipped: ``s`` is known when the op
  runs, so the skip reads nothing from the device and the step
  captures into a CUDA graph;
- Ulysses all-to-alls Q, K and V (one buffer) from a split of the
  sequence to a split of the heads, runs full attention on its ``H /
  n`` heads over the whole sequence, and all-to-alls the output back.

The bias is whole on every rank (a feed, or a value computed before the
split): each ring step reads the key block's columns of a key bias, or
the rank's query rows and the key block's columns of a full mask;
Ulysses reads the rank's heads of a ``[B, H, S, S]`` mask. The JAX
package shards the bias and rotates a key bias with K/V; the sums are
the same.

Grads are bespoke (``register_grad_lower``): the generic vjp cannot
differentiate through the sends and receives. The forward keeps ``Out``
and the rows' log-sum-exp for its grad op (``LowerCtx.save_for_grad``;
where nothing was kept, the grad runs the forward again):

- the ring's grad runs the ring again: each step recomputes its block's
  probabilities ``p`` from the saved log-sum-exp, ``dP = dO Vᵀ``, ``dS =
  p (dP - rowsum(dO * O))``, adds ``dS K`` to the local ``dq``, and adds
  ``pᵀ dO`` and ``dSᵀ Q`` to ``dv``/``dk`` accumulators that travel
  with their K/V block (one buffer of K, V, dK, dV), so that after
  ``n`` shifts each rank holds its own block's whole ``dk``/``dv``;
- Ulysses' grad all-to-alls ``dO`` to the heads, takes the same grad of
  full attention on its heads (from the heads-split Q/K/V it kept), and
  all-to-alls ``dq``, ``dk``, ``dv`` back to the sequence split.

``Bias`` gets the gradient JAX's autodiff gives it: ``dS`` summed over
the dims the bias broadcasts. Under the split it is the rank's part
(its query rows, or its heads); pass ``sp_shard`` sums the ranks' parts
(``sp_replicate``) where the program wants that grad.
"""
import torch

from ..framework.registry import register_grad_lower, register_op
from ..parallel import mesh as _mesh
from .collective_ops import all_to_all, ring_shift
from .common import x_of

_NEG_INF = -1e30


# --------------------------------------------------------------- the math

def _fold(q, k_blk, v_blk, bias_blk, scale, m, l, acc, row0=None,
          col0=None):
    """Fold one K/V block into the online-softmax accumulator ``(m, l,
    acc)``. With ``(row0, col0)``, the global offsets of the rows and
    the block's columns, a causal mask is made from their indices."""
    s = _scores(q, k_blk, bias_blk, scale, row0, col0)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new.unsqueeze(-1))
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr.unsqueeze(-1) + torch.matmul(p, v_blk)
    return m_new, l_new, acc_new


def _scores(q, k_blk, bias_blk, scale, row0=None, col0=None):
    s = torch.matmul(q, k_blk.transpose(-1, -2)) * scale
    if bias_blk is not None:
        s = s + bias_blk
    if row0 is not None:
        rows = torch.arange(q.shape[-2], device=q.device) + row0
        cols = torch.arange(k_blk.shape[-2], device=q.device) + col0
        s = torch.where(rows[:, None] >= cols[None, :], s, _NEG_INF)
    return s


def _start(q):
    return (torch.full(q.shape[:3], _NEG_INF, dtype=q.dtype,
                       device=q.device),
            torch.zeros(q.shape[:3], dtype=q.dtype, device=q.device),
            torch.zeros_like(q))


def _finish(m, l, acc):
    """(out, the rows' log-sum-exp)."""
    return acc / l.unsqueeze(-1), m + torch.log(l)


def _block_grads(q, k_blk, v_blk, bias_blk, scale, lse, dO, drow,
                 row0=None, col0=None):
    """(dq, dk, dv, dS) of one block from the rows' log-sum-exp."""
    s = _scores(q, k_blk, bias_blk, scale, row0, col0)
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = torch.matmul(p.transpose(-1, -2), dO)
    dp = torch.matmul(dO, v_blk.transpose(-1, -2))
    ds = p * (dp - drow.unsqueeze(-1))
    dq = torch.matmul(ds, k_blk) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv, ds


def _reduce_to(g, shape):
    """``g`` summed over the dims where ``shape`` broadcasts (size 1)."""
    dims = [i for i, (a, b) in enumerate(zip(g.shape, shape))
            if b == 1 and a != 1]
    return g.sum(dims, keepdim=True) if dims else g


# ------------------------------------------------------------ the inputs

def _inputs(ins, attrs, name):
    q, k, v = x_of(ins, "Q"), x_of(ins, "K"), x_of(ins, "V")
    bias = x_of(ins, "Bias")
    scale = float(attrs.get("scale", 0.0)) or q.shape[-1] ** -0.5
    if bias is not None and (bias.dim() != 4 or bias.shape[2] not in (
            1, q.shape[2] * _sp(attrs)[1])):
        raise ValueError(f"{name}: Bias must be [B, 1, 1, S], [B, H, S, "
                         f"S] or [B, 1, S, S], got {tuple(bias.shape)}")
    return q, k, v, bias, scale, bool(attrs.get("causal", False))


def _sp(attrs):
    """(axis, n, s): the ``sp`` axis, its size and this rank's index
    when the op runs on split inputs in a world, else (None, 1, 0)."""
    if not attrs.get("sp_split") or not _mesh.is_initialized():
        return None, 1, 0
    n = _mesh.axis_world_size("sp")
    if n == 1:
        return None, 1, 0
    return "sp", n, _mesh.axis_rank("sp")


def _bias_block(bias, s, j, L, key_bias):
    """The columns of key block ``j`` (and, of a full mask, the rows of
    query block ``s``) of the whole ``bias``, ``L`` wide."""
    if bias is None:
        return None
    if key_bias:
        return bias[..., j * L:(j + 1) * L]
    return bias[:, :, s * L:(s + 1) * L, j * L:(j + 1) * L]


def _is_key_bias(bias):
    return bias is not None and bias.shape[1] == 1 and bias.shape[2] == 1


def _out_grads(attrs, grads):
    return {slot + "@GRAD": [grads[slot]]
            for slot, need in attrs["__grad_inputs__"].items()
            if any(need) and slot in grads}


def _want_bias(attrs):
    return any(attrs["__grad_inputs__"].get("Bias") or ())


# ------------------------------------------------------------------ ring

def _ring_forward(q, k, v, bias, scale, causal, axis, n, s):
    L = q.shape[2]
    key_bias = _is_key_bias(bias)
    m, l, acc = _start(q)
    kv = torch.stack([k, v])
    for t in range(n):
        j = (s - t) % n
        if not (causal and j > s):
            m, l, acc = _fold(
                q, kv[0], kv[1], _bias_block(bias, s, j, L, key_bias),
                scale, m, l, acc, row0=s * L if causal else None,
                col0=j * L if causal else None)
        if t < n - 1:
            kv = ring_shift(kv, axis)
    return _finish(m, l, acc)


def _ring_backward(q, k, v, bias, scale, causal, out, lse, dO, axis, n, s,
                   want_bias):
    L = q.shape[2]
    key_bias = _is_key_bias(bias)
    drow = (dO * out).sum(-1)
    dq = torch.zeros_like(q)
    dbias = torch.zeros_like(bias) if want_bias else None
    # K, V and the dK, dV accumulators of the block this rank holds
    buf = torch.stack([k, v, torch.zeros_like(k), torch.zeros_like(v)])
    for t in range(n):
        j = (s - t) % n
        if not (causal and j > s):
            bq, bk, bv, ds = _block_grads(
                q, buf[0], buf[1], _bias_block(bias, s, j, L, key_bias),
                scale, lse, dO, drow, row0=s * L if causal else None,
                col0=j * L if causal else None)
            dq = dq + bq
            buf = torch.cat([buf[:2], (buf[2] + bk).unsqueeze(0),
                             (buf[3] + bv).unsqueeze(0)])
            if dbias is not None:
                blk = _bias_block(dbias, s, j, L, key_bias)
                blk += _reduce_to(ds, blk.shape)
        if t < n - 1:
            buf = ring_shift(buf, axis)
    if n == 1:
        return dq, buf[2], buf[3], dbias
    # the n-th pass carries only the grads home
    dk, dv = ring_shift(buf[2:].contiguous(), axis)
    return dq, dk, dv, dbias


@register_op("ring_attention", infer_shape=False)
def ring_attention(ctx, ins, attrs):
    q, k, v, bias, scale, causal = _inputs(ins, attrs, "ring_attention")
    axis, n, s = _sp(attrs)
    out, lse = _ring_forward(q, k, v, bias, scale, causal, axis, n, s)
    if ctx.op is not None:
        ctx.save_for_grad(ctx.op.output("Out")[0], (out, lse))
    return {"Out": out}


@register_grad_lower("ring_attention")
def ring_attention_grad(ctx, ins, attrs):
    fwd = attrs["__fwd_op__"]
    q, k, v, bias, scale, causal = _inputs(ins, fwd["attrs"],
                                           "ring_attention")
    axis, n, s = _sp(fwd["attrs"])
    saved = ctx.take_saved(fwd["outputs"]["Out"][0])
    out, lse = saved if saved is not None else _ring_forward(
        q, k, v, bias, scale, causal, axis, n, s)
    dO = x_of(ins, "Out@GRAD").to(q.dtype)
    dq, dk, dv, dbias = _ring_backward(q, k, v, bias, scale, causal, out,
                                       lse, dO, axis, n, s,
                                       _want_bias(attrs))
    return _out_grads(attrs, {"Q": dq, "K": dk, "V": dv, "Bias": dbias})


# --------------------------------------------------------------- ulysses

def _ulysses_heads(bias, n, s, H):
    """This rank's heads of a ``[B, H, S, S]`` mask (a key bias and a
    head-broadcast mask as they are)."""
    if bias is None or bias.shape[1] == 1 or n == 1:
        return bias
    h = H // n
    return bias[:, s * h:(s + 1) * h]


def _ulysses_check(q, n):
    H = q.shape[1]
    if n > 1 and H % n:
        raise ValueError(
            f"ulysses_attention: S={q.shape[2] * n} and n_head={H} must "
            f"both be divisible by the sp axis size {n} (the all-to-all "
            f"swaps the split from the sequence to the heads); use "
            f"mechanism='ring' for head counts that don't divide")


def _ulysses_forward(q, k, v, bias, scale, causal, axis, n, s):
    """(out, (qh, kh, vh, out_h, lse_h)): the heads-split tensors are
    what the grad reads."""
    _ulysses_check(q, n)
    if n > 1:
        qh, kh, vh = all_to_all(torch.stack([q, k, v]), 2, 3, axis)
    else:
        qh, kh, vh = q, k, v
    m, l, acc = _fold(qh, kh, vh, _ulysses_heads(bias, n, s, q.shape[1]),
                      scale, *_start(qh), row0=0 if causal else None,
                      col0=0 if causal else None)
    out_h, lse_h = _finish(m, l, acc)
    out = all_to_all(out_h, 2, 1, axis) if n > 1 else out_h
    return out, (qh, kh, vh, out_h, lse_h)


@register_op("ulysses_attention", infer_shape=False)
def ulysses_attention(ctx, ins, attrs):
    q, k, v, bias, scale, causal = _inputs(ins, attrs, "ulysses_attention")
    axis, n, s = _sp(attrs)
    out, kept = _ulysses_forward(q, k, v, bias, scale, causal, axis, n, s)
    if ctx.op is not None:
        ctx.save_for_grad(ctx.op.output("Out")[0], kept)
    return {"Out": out}


@register_grad_lower("ulysses_attention")
def ulysses_attention_grad(ctx, ins, attrs):
    fwd = attrs["__fwd_op__"]
    q, k, v, bias, scale, causal = _inputs(ins, fwd["attrs"],
                                           "ulysses_attention")
    axis, n, s = _sp(fwd["attrs"])
    kept = ctx.take_saved(fwd["outputs"]["Out"][0])
    if kept is None:
        _, kept = _ulysses_forward(q, k, v, bias, scale, causal, axis, n,
                                   s)
    qh, kh, vh, out_h, lse_h = kept
    dO = x_of(ins, "Out@GRAD").to(q.dtype)
    dOh = all_to_all(dO, 1, 2, axis) if n > 1 else dO
    bias_h = _ulysses_heads(bias, n, s, q.shape[1])
    dqh, dkh, dvh, ds = _block_grads(
        qh, kh, vh, bias_h, scale, lse_h, dOh, (dOh * out_h).sum(-1),
        row0=0 if causal else None, col0=0 if causal else None)
    if n > 1:
        dq, dk, dv = all_to_all(torch.stack([dqh, dkh, dvh]), 3, 2, axis)
    else:
        dq, dk, dv = dqh, dkh, dvh
    dbias = None
    if _want_bias(attrs):
        dbias = torch.zeros_like(bias)
        part = _reduce_to(ds, bias_h.shape)
        if bias.shape[1] == 1 or n == 1:
            dbias += part
        else:
            h = q.shape[1] // n
            dbias[:, s * h:(s + 1) * h] += part
    return _out_grads(attrs, {"Q": dq, "K": dk, "V": dv, "Bias": dbias})
