"""Block interpretation: runs a block's ops over an env of named tensors.

Counterpart of ``paddle_tpu/framework/lowering.py``. The JAX package
traces a block into one function that XLA compiles; here the same
op-by-op walk runs eagerly on torch tensors, so the env holds real
tensors and :func:`run_ops` can drop each one after its last reader.
"""
import torch

from .registry import get_op_def, normalize_outs

_MASK63 = (1 << 63) - 1


def splitmix64(x):
    """One step of the splitmix64 mixer (63-bit result): turns a (run
    seed, op seed) pair into a generator seed, and advances the run
    seed from one run to the next."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & _MASK63


class LowerCtx:
    """State threaded through op lowerings: the env, the device, the run
    seed, the op being run (``op``) and what a forward lowering keeps
    for its bespoke grad (:meth:`save_for_grad`)."""

    def __init__(self, program, block, env, device, run_seed=0,
                 abstract=False):
        self.program = program
        self.block = block
        self.env = env
        self.device = torch.device(device)
        self.run_seed = run_seed
        self.abstract = abstract
        self.op = None
        self.saved = {}
        self._grad_fwd_outs = None

    def save_for_grad(self, name, value):
        """Keep ``value`` under the forward output ``name`` for a grad op
        of this block whose forward wrote ``name`` (it takes it with
        ``self.saved.pop(name)``); nothing is kept when no grad op will
        read it, or while inferring shapes."""
        if self.abstract or self.block is None:
            return
        if self._grad_fwd_outs is None:
            self._grad_fwd_outs = {
                n for op in self.block.ops if "__fwd_op__" in op.attrs
                for ns in op.attrs["__fwd_op__"]["outputs"].values()
                for n in ns}
        if name in self._grad_fwd_outs:
            self.saved[name] = value

    def generator(self, attrs):
        """A fresh ``torch.Generator`` on the ctx's device for one
        stochastic op, seeded from (run seed, the op's ``__rng_seed__``),
        or from the op's own ``seed`` attr when it has one. A grad op
        recomputing its forward passes the forward's attrs, so it draws
        the same numbers (the same dropout mask). None while inferring
        shapes on the meta device."""
        if self.abstract:
            return None
        base = attrs.get("seed", 0) or self.run_seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(splitmix64((int(base) << 20)
                                   ^ int(attrs.get("__rng_seed__", 0))))
        return gen


def run_ops(ctx, free_after=None):
    """Run every op of ``ctx.block`` over ``ctx.env``. ``free_after``:
    {op index: names to drop from the env once that op has run}."""
    for i, op in enumerate(ctx.block.ops):
        run_op(ctx, op)
        for n in (free_after or {}).get(i, ()):
            ctx.env.pop(n, None)


def run_op(ctx, op):
    opdef = get_op_def(op.type)
    ctx.op = op
    ins = {slot: [ctx.env[n] if n in ctx.env else _missing(n, op)
                  for n in names]
           for slot, names in op.inputs.items()}
    raw = opdef.lower(ctx, ins, op.attrs)
    if raw is None:
        return
    outs = normalize_outs(raw)
    for slot, names in op.outputs.items():
        for n, v in zip(names, outs.get(slot) or ()):
            if v is not None:
                ctx.env[n] = v


def _missing(name, op):
    raise KeyError(
        f"var {name!r} (input of op {op.type!r}) has no value: it was "
        f"neither fed, produced by an earlier op, nor found in the scope")


def analyze_block_io(program, block_idx, feed_names):
    """Which vars a block reads from outside (scope state) and which
    persistable vars it writes (state to store back)."""
    block = program.blocks[block_idx]
    defined = set(feed_names)
    reads, writes = {}, {}          # insertion-ordered sets
    for op in block.ops:
        for n in op.input_arg_names:
            if n not in defined:
                reads[n] = None
        for n in op.output_arg_names:
            defined.add(n)
            var = block.vars.get(n)
            if var is not None and var.persistable:
                writes[n] = None
    return list(reads), list(writes)


def last_uses(block, keep):
    """{op index: names whose last reader or writer is that op}, leaving
    out ``keep`` (fetches, persistable state). Dropping these from the
    env as the walk passes them keeps an eager step's memory near what a
    compiler's buffer liveness would give, instead of holding every
    activation and grad until the step ends."""
    last = {}
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names + op.output_arg_names:
            last[n] = i
    out = {}
    for n, i in last.items():
        if n not in keep:
            out.setdefault(i, []).append(n)
    return out
