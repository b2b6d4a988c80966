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
        self._written = set()
        # set by a captured step: hands out its call-site generators
        self.generator_hook = None

    def _saved_keys(self):
        """Names a forward output is kept under for its grad op. A grad
        op of a recomputed segment (``append_backward(checkpoints=)``)
        reads the recomputed op's values, so it takes what the
        recomputed op (outputs ``<name>@RECOMPUTE``) saved, and the
        original forward of that segment saves nothing: only
        checkpoints stay live across the forward-to-backward gap."""
        if self._grad_fwd_outs is None:
            self._written = {n for op in self.block.ops
                             for n in op.output_arg_names}
            self._grad_fwd_outs = {
                self._key_of(n) for op in self.block.ops
                if "__fwd_op__" in op.attrs
                for ns in op.attrs["__fwd_op__"]["outputs"].values()
                for n in ns}
        return self._grad_fwd_outs

    def _key_of(self, name):
        """``name@RECOMPUTE`` where a recomputed op of the block writes
        it, else ``name``."""
        rc = f"{name}@RECOMPUTE"
        return rc if rc in self._written else name

    def save_for_grad(self, name, value):
        """Keep ``value`` under the forward output ``name`` for a grad op
        of this block that reads it (:meth:`take_saved`); nothing is
        kept when no grad op will read it, or while inferring shapes."""
        if self.abstract or self.block is None:
            return
        if name in self._saved_keys():
            self.saved[name] = value

    def take_saved(self, name):
        """What the forward that wrote ``name`` (the grad op's
        ``__fwd_op__`` output) saved for this grad op, or None."""
        if self.block is None:
            return None
        self._saved_keys()
        return self.saved.pop(self._key_of(name), None)

    def generator(self, attrs):
        """A fresh ``torch.Generator`` on the ctx's device for one
        stochastic call, seeded by :func:`generator_seed`. A grad op
        recomputing its forward passes the forward's attrs, so it draws
        the same numbers (the same dropout mask). None while inferring
        shapes on the meta device. Under a captured step
        (``generator_hook``) each call site takes the generator the
        graph registered for it."""
        if self.abstract:
            return None
        if self.generator_hook is not None:
            return self.generator_hook(self, attrs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(generator_seed(self.run_seed, attrs))
        return gen


def generator_seed(run_seed, attrs):
    """The seed of one stochastic call: (run seed, the op's
    ``__rng_seed__``), or the op's own ``seed`` attr in place of the run
    seed when it has one."""
    base = attrs.get("seed", 0) or run_seed
    return splitmix64((int(base) << 20) ^ int(attrs.get("__rng_seed__", 0)))


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


def nonfinite_counts(tensors, device):
    """int32 ``[len(tensors)]`` on ``device``: each tensor's count of
    nan/inf elements (0 for integer and bool tensors, which stay in the
    list so slot indices line up with slot names)."""
    if not tensors:
        return torch.zeros(1, dtype=torch.int32, device=device)
    return torch.stack([
        (~torch.isfinite(t)).sum(dtype=torch.int32)
        if t.is_floating_point() or t.is_complex()
        else torch.zeros((), dtype=torch.int32, device=t.device)
        for t in tensors]).to(device)


def first_offender(counts):
    """(total count, index of the first nonzero slot) of a count vector,
    as device scalars (the slot is 0 when every count is 0)."""
    n = counts.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=counts.device)
    first = torch.where(counts > 0, idx, torch.full_like(idx, n)).min()
    return counts.sum(dtype=torch.int32), torch.where(first < n, first, 0)


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
