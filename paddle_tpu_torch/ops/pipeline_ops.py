"""The ``pipeline`` op: GPipe over the ``pp`` axis (counterpart of
``paddle_tpu/ops/pipeline_ops.py:33-127``).

``layers.Pipeline`` builds it: one uniform stage sub-block, the stage
parameters stacked on a leading ``[S]`` dim (``P``), the outer reads
(``R``) and the batch input ``X`` (``B`` rows, ``B % M == 0``). The JAX
op has two lowerings, and so has this one:

- **Sequential** (no ``pp`` axis of size ``num_stages`` in the active
  layout, or ``S`` 1): each of the ``M`` microbatches goes through the
  chain of the ``S`` stages in turn, each stage over its slice of every
  stacked parameter (the JAX op's ``lax.map``).
- **GPipe** (``S`` pp ranks): each rank holds its stage's ``[1, ...]``
  slice of every stacked parameter (pass ``pp_shard``, ``parallel.pp``)
  and runs only that stage, at its static pp index ``p``, over
  ``M + S - 1`` ticks: at tick ``t`` it runs microbatch ``t - p`` (stage
  0 from ``X``, the others from what the previous stage sent) and sends
  its output to stage ``p + 1`` (``collective_ops.ring_shift``). A tick
  outside ``0 <= t - p < M`` is a bubble: the rank skips its compute but
  sends all the same (zeros), so every rank issues the same shifts in
  the same order. The last tick's output has no next tick to read it,
  so no rank sends it: ``M + S - 2`` shifts. The last stage's outputs
  then reach every pp rank by a broadcast (where the JAX op ``psum``\\ s
  zeros and the last stage's outputs). The ops outside the pipeline
  (embeddings, the head, the loss) run on every pp rank, replicated, as
  they do under GSPMD.

The stage's env is strict, as there: only ``P`` (this stage's slice),
``R`` and the microbatch are bound, so a read of anything else raises
by name.

**The grad is a hand-written GPipe backward** (the JAX op lets AD run
through its scan; the port's generic vjp would run the collectives
inside ``torch.func.vjp`` and recompute the whole op). The forward keeps
the input of every stage it ran, for every microbatch (``[M]`` tensors
of ``[B / M, ...]`` on a pp rank; ``S * M`` on the sequential path), for
the grad op (``LowerCtx.save_for_grad``, as ``flash_attention`` keeps
its ``out`` and ``lse2``). The grad op then runs the schedule in
reverse, one microbatch at a time: the vjp of **one stage** through
``torch.func.vjp`` over the stage's ops from its kept input (the stage's
forward is recomputed once, GPipe with recompute at stage boundaries;
inside it ``flash_attention`` reaches K1 and its bespoke K3/K4 grad
through ``kernels.FlashAttention``), the stage's ``dX`` sent to stage
``p - 1`` over the reverse ring, ``P@GRAD`` accumulated for the rank's
slice only, ``X@GRAD`` broadcast from stage 0 to every pp rank (the
embeddings are replicated, so every rank must update them alike) and
``R@GRAD`` summed over ``pp``. The sequential path's grad is the same
per-stage, per-microbatch vjp with no collective. Where the forward ran
in another run and kept nothing, the grad op reruns the forward
schedule for the kept inputs.

Dropout inside a stage draws from the op's ``__rng_seed__`` and the run
seed only (``LowerCtx.generator``), so it draws the same mask in every
stage and microbatch of a step, in the forward and in the grad's
recompute, on both paths: what the JAX package does
(``framework/lowering.py:31-43``).
"""
import torch

from ..framework.registry import register_grad_lower, register_op
from ..parallel import mesh as _mesh
from .collective_ops import all_reduce, broadcast_, ring_shift
from .common import x_of

PP = "pp"


def pp_stage(ctx, num_stages):
    """This rank's stage when the op runs GPipe (the active layout has a
    ``pp`` axis of ``num_stages`` ranks), else None (the sequential
    path)."""
    if ctx.abstract or num_stages < 2 or not _mesh.is_initialized():
        return None
    mesh = _mesh.world_mesh()
    if mesh.axis_size(PP) != num_stages:
        return None
    return mesh.coords()[PP]


class _Pipe:
    """One run of a pipeline op: its attrs, its inputs cut into
    microbatches, and the stage function over its sub-block."""

    def __init__(self, ctx, ins, attrs):
        self.ctx = ctx
        self.S = int(attrs["num_stages"])
        self.M = int(attrs["num_microbatches"])
        self.sub = attrs["sub_block"]
        self.x_name, self.out_name = attrs["x_name"], attrs["out_name"]
        self.p_names = list(attrs.get("p_names", []))
        self.r_names = list(attrs.get("r_names", []))
        x = x_of(ins)
        B = x.shape[0]
        if B % self.M:
            raise ValueError(f"pipeline: batch {B} not divisible by "
                             f"num_microbatches {self.M}")
        self.x = x
        self.xs = x.reshape((self.M, B // self.M) + tuple(x.shape[1:]))
        self.params = list(ins.get("P", []))
        self.repl = list(ins.get("R", []))
        self.stage = pp_stage(ctx, self.S)
        lead = 1 if self.stage is not None else self.S
        for n, t in zip(self.p_names, self.params):
            if t.shape[0] != lead:
                where = (f"pp rank {self.stage}'s slice" if lead == 1
                         else f"all {self.S} stages")
                raise ValueError(
                    f"pipeline: stage parameter {n!r} has leading dim "
                    f"{t.shape[0]}, the op wants {lead} ({where})")

    def stages(self):
        """The stage indices this rank runs, in order."""
        return range(self.S) if self.stage is None else (self.stage,)

    def params_of(self, s):
        i = 0 if self.stage is not None else s
        return [t[i] for t in self.params]

    def run(self, params, repl, x_mb):
        """One stage on one microbatch over the strict env."""
        env = dict(zip(self.r_names, repl))
        env.update(zip(self.p_names, params))
        env[self.x_name] = x_mb
        self.ctx.lower_block_ops(self.sub, env)
        y = env[self.out_name]
        if y.shape != x_mb.shape or y.dtype != x_mb.dtype:
            raise ValueError(
                f"pipeline stage must be shape/dtype-preserving (uniform "
                f"chain): in {tuple(x_mb.shape)}/{x_mb.dtype} vs out "
                f"{tuple(y.shape)}/{y.dtype}")
        return y

    # -- forward ---------------------------------------------------------
    def forward(self):
        """(Out ``[B, ...]``, {stage: [its input for each microbatch]})."""
        S, M = self.S, self.M
        kept = {s: [None] * M for s in self.stages()}
        if self.stage is None:
            outs = []
            for m in range(M):
                y = self.xs[m]
                for s in range(S):
                    kept[s][m] = y
                    y = self.run(self.params_of(s), self.repl, y)
                outs.append(y)
            return torch.stack(outs).reshape(self.x.shape), kept
        p = self.stage
        mine = self.params_of(p)
        zeros = torch.zeros_like(self.xs[0])
        outs = [None] * M
        state = None
        for t in range(M + S - 1):
            m = t - p
            if 0 <= m < M:
                inp = self.xs[m] if p == 0 else state
                kept[p][m] = inp
                y = self.run(mine, self.repl, inp)
                if p == S - 1:
                    outs[m] = y
            else:
                y = zeros              # a bubble: no compute, still sent
            if t < M + S - 2:
                state = ring_shift(y, PP)
        # a dense buffer: the microbatches of a gathered X (sp) are a
        # strided view, and a broadcast writes the root's bytes in order
        out = torch.stack(outs) if p == S - 1 else torch.empty_like(
            self.xs, memory_format=torch.contiguous_format)
        broadcast_(out, S - 1, PP)
        return out.reshape(self.x.shape), kept

    # -- backward --------------------------------------------------------
    def stage_vjp(self, s, x_mb, dy, p_req, r_req):
        """(dX, [dP or None], [dR or None]) of stage ``s`` at input
        ``x_mb`` under cotangent ``dy``: its forward recomputed under
        ``torch.func.vjp``, the primals only the grads wanted."""
        params = self.params_of(s)
        pi = [i for i, need in enumerate(p_req) if need]
        ri = [i for i, need in enumerate(r_req) if need
              and self.repl[i].is_floating_point()]

        def f(px, rx, x):
            ps, rs = list(params), list(self.repl)
            for i, v in zip(pi, px):
                ps[i] = v
            for i, v in zip(ri, rx):
                rs[i] = v
            return self.run(ps, rs, x)

        _, vjp_fn = torch.func.vjp(f, [params[i] for i in pi],
                                   [self.repl[i] for i in ri], x_mb)
        gp, gr, gx = vjp_fn(dy.to(x_mb.dtype))
        dps = [None] * len(params)
        for i, g in zip(pi, gp):
            dps[i] = g
        drs = [None] * len(self.repl)
        for i, g in zip(ri, gr):
            drs[i] = g
        return gx, dps, drs

    def backward(self, kept, dout, req):
        """{slot@GRAD: [...]} of the op from ``Out@GRAD`` ``dout``."""
        S, M = self.S, self.M
        p_req = list(req.get("P") or [False] * len(self.params))
        r_req = list(req.get("R") or [False] * len(self.repl))
        douts = dout.reshape(self.xs.shape)
        acc_p = {s: [None] * len(self.params) for s in self.stages()}
        acc_r = [None] * len(self.repl)

        def add(s, dps, drs):
            for i, g in enumerate(dps):
                if g is not None:
                    a = acc_p[s][i]
                    acc_p[s][i] = g if a is None else a + g
            for i, g in enumerate(drs):
                if g is not None:
                    acc_r[i] = g if acc_r[i] is None else acc_r[i] + g

        dxs = [None] * M
        if self.stage is None:
            for m in reversed(range(M)):
                dy = douts[m]
                for s in reversed(range(S)):
                    dy, dps, drs = self.stage_vjp(s, kept[s][m], dy, p_req,
                                                  r_req)
                    add(s, dps, drs)
                dxs[m] = dy
            dx = torch.stack(dxs)
        else:
            p = self.stage
            zeros = torch.zeros_like(self.xs[0])
            state = None
            for tau in range(M + S - 1):
                m = M - 1 - tau + (S - 1 - p)
                if 0 <= m < M:
                    dy = douts[m] if p == S - 1 else state
                    g, dps, drs = self.stage_vjp(p, kept[p][m], dy, p_req,
                                                 r_req)
                    add(p, dps, drs)
                    if p == 0:
                        dxs[m] = g
                else:
                    g = zeros          # a bubble: no compute, still sent
                if tau < M + S - 2:
                    state = ring_shift(g, PP, reverse=True)
            dx = None
            if any(req.get("X") or ()):
                dx = torch.stack(dxs) if p == 0 \
                    else torch.empty_like(
                        self.xs, memory_format=torch.contiguous_format)
                broadcast_(dx, 0, PP)
            for g in acc_r:
                if g is not None:
                    all_reduce(g, "sum", PP)
        out = {}
        if any(req.get("X") or ()):
            out["X@GRAD"] = [dx.reshape(self.x.shape)]
        if any(p_req):
            grads = []
            for i, (need, t) in enumerate(zip(p_req, self.params)):
                if not need:
                    grads.append(None)
                    continue
                per = [acc_p[s][i] if acc_p[s][i] is not None
                       else torch.zeros_like(t[0]) for s in self.stages()]
                grads.append(torch.stack(per))
            out["P@GRAD"] = grads
        if any(r_req):
            out["R@GRAD"] = [
                (g if g is not None else torch.zeros_like(t)) if need
                else None
                for need, g, t in zip(r_req, acc_r, self.repl)]
        return out


@register_op("pipeline", infer_shape=False)
def pipeline_op(ctx, ins, attrs):
    """inputs: X (batch input ``[B, ...]``), P (stacked stage parameters
    ``[S, ...]``, or this pp rank's ``[1, ...]`` slice), R (the other
    outer reads); attrs: sub_block, num_stages, num_microbatches,
    x_name, out_name, p_names, r_names. Out ``[B, ...]``."""
    pipe = _Pipe(ctx, ins, attrs)
    out, kept = pipe.forward()
    if ctx.op is not None:
        ctx.save_for_grad(ctx.op.output("Out")[0], kept)
    return {"Out": out}


@register_grad_lower("pipeline")
def pipeline_grad(ctx, ins, attrs):
    """The GPipe backward (module docstring) from the stage inputs the
    forward kept, or from a rerun of the forward schedule where it kept
    none."""
    fwd = attrs["__fwd_op__"]
    pipe = _Pipe(ctx, ins, fwd["attrs"])
    kept = ctx.take_saved(fwd["outputs"]["Out"][0])
    if kept is None:
        _, kept = pipe.forward()
    return pipe.backward(kept, x_of(ins, "Out@GRAD"),
                         attrs["__grad_inputs__"])
