"""The ``switch_moe`` op: a Switch-style Mixture-of-Experts FFN, its
experts split over the ``ep`` axis (counterpart of
``paddle_tpu/ops/moe_ops.py``).

The JAX op is plain ``jnp`` under GSPMD: top-1 softmax gating (the
first index on ties), each token's 0-based position in its expert's
queue from a cumsum over **all N tokens of the batch in row order**,
capacity ``C = max(int(capacity_factor * N / E), 1)``, tokens at
``pos >= C`` dropped (their output row 0), the expert FFN ``gelu(x W1 +
B1) W2 + B2`` (``jax.nn.gelu``: the tanh approximation) on ``[E, C, d]``
sharded on ``ep``, the output ``gate_val * expert_out`` at the token's
slot, and the load-balance loss ``mean(density * density_proxy) * E^2``
over all N. The port computes the same function without the JAX op's
``[N, E, C]`` one-hot dispatch tensor: each kept token is scattered into
its slot of a zeroed ``[E, C, d]`` buffer and gathered back from it by
the index ``expert * C + pos``.

**The global order.** Under a data-parallel mesh (``dp`` x ``ep`` above
1, the mesh the executor activated for a ``CompiledProgram``) each rank
holds only its rows, where the JAX op sees the global batch (its feed
is split over ``dp`` only, so the ``ep`` ranks of one ``dp`` coordinate
are fed the same rows). Rank ``(d, e)`` routes the ``e``-th of ``ep``
chunks of its ``n`` rows: chunk ``g = d * ep + e`` of the global batch
of ``N = n * dp`` rows. Its tokens' positions are the exclusive prefix
of the per-expert counts of the chunks before ``g`` (one all-gather of
the ``[E]`` counts over the ``dp_ep`` group) plus their rank within the
chunk, so the tokens kept are the JAX op's whatever the split.

Beside ``tp``, ``sp`` or ``pp`` the op is a replicated region: its
input is whole (a tp program's hidden state between the split matmuls;
gathered by ``sp_gather`` under sp), and every tp, sp and pp rank of a
(data, ep) coordinate routes the same tokens over the ``dp_ep`` group of
its own (pp, sp, tp) coordinate, so they issue the same collectives in
the same order. Over a ``dcn_dp`` axis the data replicas span ``dcn_dp``
x ``dp`` (data coordinate ``c * dp + d``, the ``dp`` of what follows).

**The dispatch.** Every rank scatters its kept tokens into a zeroed
``[E, C, d]`` buffer at their global slots (which no other rank uses)
and all-to-alls it over ``ep``: rank ``j`` of the ``ep`` group gets
every peer's ``[E / ep, C, d]`` block of its own experts and sums them
(each slot is non-zero in one block at most, so the sum is exact). The
rank runs its ``E / ep`` experts (its ``[E / ep, ...]`` slices of W1,
B1, W2, B2, cut by pass ``ep_shard``, ``parallel.ep``) on that
``[E / ep, C, d]``; the outputs go back by an all-gather over ``ep``
(the reverse all-to-all of a block every peer reads whole), each rank
gathers its tokens' rows, and the ``ep`` chunks are all-gathered into
the rank's ``n`` rows, the same on every ``ep`` rank of a ``dp``
coordinate. ``AuxLoss`` is the global value on every rank: the ``[E]``
gate sums are all-reduced over ``dp_ep``. Every buffer has a static
shape and nothing is read back to the host, so ``run_steps`` captures
the step with the collectives inside.

**The grad is hand-written** (the generic vjp cannot run collectives
inside ``torch.func.vjp``): the reverse of each step, cotangents carried
home by the conjugate collectives (the output's ``ep`` all-gather by
the rank's slice, the combine's all-gather by the dispatch's
all-to-all and sum, the dispatch by the all-gather). It reproduces
JAX's autodiff: through the gate value into the softmax (a tie's
cotangent split evenly among the tied maxima, as ``jnp.max``'s), and
through ``density_proxy`` for the aux term; the argmax, the one-hot and
the positions take none. dX and dGateW come out equal on every ``ep``
rank of a ``dp`` coordinate (GateW's partial grads all-reduced over
``ep``), the expert slices' grads are the rank's own; all are then
averaged over ``dp`` with the other grads. ``AuxLoss`` is a function of
the global batch, not a mean of per-rank terms, so averaging each
rank's share of its grad over ``dp`` would scale it by ``1 / dp``: its
cotangent is multiplied by ``dp`` to make the averaged grad JAX's.
"""
import torch
import torch.nn.functional as F

from ..framework.registry import register_grad_lower, register_op
from ..parallel import mesh as _mesh
from .collective_ops import all_gather, all_reduce, all_to_all
from .common import x_of

EP = "ep"
TOKENS = _mesh.TOKEN_AXIS


class _World:
    """Where one ``switch_moe`` call runs: this rank's data (``dcn_dp``
    x ``dp``, as ``dp``) and ``ep`` coordinates and sizes over the active
    data-parallel mesh (``mesh``),
    or a world of one (``mesh`` None: no mesh active, a plain program,
    or ``dp`` x ``ep`` 1), where every collective below is the
    identity."""

    def __init__(self, E, local_experts):
        mesh = _mesh.active_mesh() if _mesh.is_initialized() else None
        self.mesh = mesh if mesh is not None and \
            mesh.axis_size(_mesh.DATA_AXIS) * mesh.ep > 1 else None
        self.dp = self.ep = 1
        self.d = self.e = 0
        if self.mesh is not None:
            # the data replicas span dcn_dp x dp (index c * dp + d)
            c = self.mesh.coords()
            self.dp = mesh.axis_size(_mesh.DATA_AXIS)
            self.ep, self.d, self.e = mesh.ep, c[_mesh.DATA_AXIS], c["ep"]
        if local_experts * self.ep != E:
            raise ValueError(
                f"switch_moe: {local_experts} experts on this rank, "
                f"{E} gates, ep {self.ep}: the rank's expert slices must "
                f"be E/ep (pass ep_shard cuts them)")

    @property
    def chunk(self):
        """The global chunk index of the rows this rank routes."""
        return self.d * self.ep + self.e

    def gather(self, t, axis=EP):
        """The ranks' ``t`` of ``axis`` concatenated on dim 0."""
        return t if self.mesh is None else all_gather(t, axis, 0,
                                                      self.mesh)

    def sum(self, t, axis=TOKENS):
        """``t`` summed over ``axis`` (in place)."""
        return t if self.mesh is None else all_reduce(t, "sum", axis,
                                                      self.mesh)

    def exchange(self, buf):
        """The ``ep`` peers' ``[E / ep, C, k]`` blocks of this rank's
        experts in their ``[E, C, k]`` buffers, all-to-alled and summed
        (each slot is non-zero in one block at most)."""
        if self.mesh is None or self.ep == 1:
            return buf
        got = all_to_all(buf, 0, 0, EP, self.mesh)
        E, C, k = buf.shape
        return got.view(self.ep, E // self.ep, C, k).sum(0)


def _capacity(cap_factor, N, E):
    return max(int(cap_factor * N / E), 1)


def _route(x_c, gate_w, w, C, N):
    """The gating of the rank's chunk ``x_c`` ``[nc, d]``: a dict of the
    gates, the expert and gate value of each token, whether it is kept,
    its slot ``expert * C + pos`` (``E * C``, the trash slot, when it is
    dropped), the global per-expert counts and gate sums."""
    E = gate_w.shape[1]
    gates = torch.softmax(x_c @ gate_w, dim=-1)              # [nc, E]
    expert = torch.argmax(gates, dim=-1)                     # first on ties
    gate_val = gates.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, E)                            # int64
    cums = onehot.cumsum(0)
    within = (cums * onehot).sum(-1)                         # 1-based
    counts = w.gather(cums[-1:].contiguous(), TOKENS)        # [dp*ep, E]
    prefix = counts[:w.chunk].sum(0)
    pos = prefix.gather(0, expert) + within - 1
    keep = pos < C
    slot = torch.where(keep, expert * C + pos, torch.full_like(pos, E * C))
    return {"gates": gates, "gate_val": gate_val, "keep": keep,
            "slot": slot, "counts": counts.sum(0),
            "gate_sum": w.sum(gates.sum(0)), "N": N, "C": C}


def _dispatch(w, rows, slot, keep, E, C):
    """``rows`` ``[nc, k]`` scattered into a zeroed ``[E, C, k]`` at their
    slots (dropped rows into the trash slot, zeroed) and exchanged over
    ``ep``: this rank's experts' ``[E / ep, C, k]``."""
    k = rows.shape[-1]
    buf = rows.new_zeros((E * C + 1, k))
    buf.index_add_(0, slot, rows * keep[:, None].to(rows.dtype))
    return w.exchange(buf[:E * C].view(E, C, k))


def _gather_rows(full, slot, keep, E, C):
    """Each token's row of ``full`` ``[E, C, k]`` at its slot, zero where
    it was dropped."""
    idx = torch.where(keep, slot, torch.zeros_like(slot))
    rows = full.reshape(E * C, -1).index_select(0, idx)
    return torch.where(keep[:, None], rows, rows.new_zeros(()))


def _experts(xin, w1, b1, w2, b2):
    """The experts' FFN on ``xin`` ``[e, C, d]``: (pre-activation,
    output)."""
    h_pre = torch.bmm(xin, w1) + b1[:, None, :]
    y = torch.bmm(F.gelu(h_pre, approximate="tanh"), w2) + b2[:, None, :]
    return h_pre, y


def _forward(ins, attrs):
    """(Out, AuxLoss, what the grad needs)."""
    x, gate_w = x_of(ins), x_of(ins, "GateW")
    w1, b1 = x_of(ins, "W1"), x_of(ins, "B1")
    w2, b2 = x_of(ins, "W2"), x_of(ins, "B2")
    E = gate_w.shape[1]
    w = _World(E, w1.shape[0])
    n = x.shape[0]
    if n % w.ep:
        raise ValueError(f"switch_moe: {n} rows do not split into the "
                         f"{w.ep} ep chunks")
    nc = n // w.ep
    N = n * w.dp
    C = _capacity(float(attrs.get("capacity_factor", 1.25)), N, E)
    x_c = x[w.e * nc:(w.e + 1) * nc]
    r = _route(x_c, gate_w, w, C, N)
    xin = _dispatch(w, x_c, r["slot"], r["keep"], E, C)
    h_pre, y = _experts(xin, w1, b1, w2, b2)
    y_all = w.gather(y)                                      # [E, C, d]
    out_c = r["gate_val"][:, None] * _gather_rows(y_all, r["slot"],
                                                  r["keep"], E, C)
    out = w.gather(out_c)
    density = r["counts"].to(x.dtype) / N
    proxy = r["gate_sum"] / N
    aux = (density * proxy).mean() * (E * E)
    saved = dict(r, x_c=x_c, xin=xin, h_pre=h_pre, y_all=y_all,
                 density=density, world=w, E=E, nc=nc)
    return out, aux.reshape(()), saved


@register_op("switch_moe")
def switch_moe(ctx, ins, attrs):
    """inputs: X ``[N, d]`` (this rank's rows), GateW ``[d, E]``, W1
    ``[E, d, h]``, B1 ``[E, h]``, W2 ``[E, h, d]``, B2 ``[E, d]`` (or the
    rank's ``[E / ep, ...]`` slices); attrs: capacity_factor (1.25).
    outputs: Out ``[N, d]``, AuxLoss ``[]``."""
    x = x_of(ins)
    if ctx.abstract:
        return {"Out": x.new_empty(x.shape), "AuxLoss": x.new_empty(())}
    out, aux, saved = _forward(ins, attrs)
    if ctx.op is not None:
        ctx.save_for_grad(ctx.op.output("Out")[0], saved)
    return {"Out": out, "AuxLoss": aux}


def _grad(ins, s, dout, daux, req):
    """{slot@GRAD: [...]} from the forward's ``s``."""
    x, gate_w = x_of(ins), x_of(ins, "GateW")
    w1, w2 = x_of(ins, "W1"), x_of(ins, "W2")
    w, E, C, N, nc = s["world"], s["E"], s["C"], s["N"], s["nc"]
    gates, gate_val, keep, slot = s["gates"], s["gate_val"], s["keep"], \
        s["slot"]
    if dout is None:
        dout = x.new_zeros(x.shape)
    dout_c = dout[w.e * nc:(w.e + 1) * nc]
    # combine: out_c = gate_val * y_tok
    y_tok = _gather_rows(s["y_all"], slot, keep, E, C)
    dgv = (dout_c * y_tok).sum(-1)
    dy_tok = gate_val[:, None] * dout_c
    dy = _dispatch(w, dy_tok, slot, keep, E, C)              # [E/ep, C, d]
    # the experts
    h_pre, xin = s["h_pre"], s["xin"]
    h = F.gelu(h_pre, approximate="tanh")
    dh = torch.bmm(dy, w2.transpose(1, 2))
    dh_pre = torch.ops.aten.gelu_backward(dh, h_pre, approximate="tanh")
    dxin = torch.bmm(dh_pre, w1.transpose(1, 2))
    out = {"W1@GRAD": [torch.bmm(xin.transpose(1, 2), dh_pre)],
           "B1@GRAD": [dh_pre.sum(1)],
           "W2@GRAD": [torch.bmm(h.transpose(1, 2), dy)],
           "B2@GRAD": [dy.sum(1)]}
    # dispatch: the tokens' rows of the experts' input grad
    dx_c = _gather_rows(w.gather(dxin), slot, keep, E, C)
    # the gate: jnp.max's cotangent split among tied maxima, the aux
    # term's through density_proxy (scaled by dp: module docstring)
    tied = (gates == gate_val[:, None]).to(gates.dtype)
    dgates = tied * (torch.where(keep, dgv, dgv.new_zeros(()))
                     / tied.sum(-1))[:, None]
    if daux is not None:
        dgates = dgates + (daux.reshape(()) * w.dp * E / N) * \
            s["density"][None, :]
    dlogits = gates * (dgates - (dgates * gates).sum(-1, keepdim=True))
    x_c = s["x_c"]
    dx_c = dx_c + dlogits @ gate_w.t()
    out["X@GRAD"] = [w.gather(dx_c)]
    out["GateW@GRAD"] = [w.sum(x_c.t() @ dlogits, EP)]
    return {k: v for k, v in out.items()
            if any((req.get(k[:-5]) or ()))}


@register_grad_lower("switch_moe")
def switch_moe_grad(ctx, ins, attrs):
    """The hand-written backward (module docstring), from what the
    forward saved or from a rerun of the forward."""
    fwd = attrs["__fwd_op__"]
    saved = ctx.take_saved(fwd["outputs"]["Out"][0])
    if saved is None:
        _, _, saved = _forward(ins, fwd["attrs"])
    return _grad(ins, saved, x_of(ins, "Out@GRAD"),
                 x_of(ins, "AuxLoss@GRAD"), attrs["__grad_inputs__"])
