"""Op registry: one torch lowering and a grad rule per op type.

Counterpart of ``paddle_tpu/framework/registry.py``. Each op registers a
lowering ``fn(ctx, ins, attrs) -> {slot: tensor | [tensors]}`` over torch
tensors. The default grad op of type ``T`` is ``T_grad``, whose lowering
runs ``torch.func.vjp`` over T's forward lowering
(:func:`generic_grad_lower`); an op with a bespoke backward registers it
with :func:`register_grad_lower`. Output shapes and dtypes are inferred
when an op is appended, by running its lowering on the ``meta`` device
(no data, no compute), the counterpart of ``jax.eval_shape``.
"""
import torch

from .dtype import dtype_name, torch_dtype

# Stand-in for a -1 (dynamic) dim during build-time shape inference.
# Prime so products/sums involving it stay divisible by it, and large so a
# real static dim is essentially never a multiple of it.
_DYN = 7919


class OpDef:
    def __init__(self, type, lower, grad=None, infer_shape=None,
                 needs_rng=False):
        self.type = type
        self.lower = lower              # (ctx, ins, attrs) -> {slot: [t]}
        # grad: None -> generic vjp grad; False -> non-differentiable
        self.grad = grad
        # None = meta-device inference; False = skip
        self.infer_shape = infer_shape
        self.needs_rng = needs_rng
        self.custom_grad_lower = None


OPS = {}


def register_op(type, grad=None, infer_shape=None, needs_rng=False):
    """Decorator: register ``fn(ctx, ins, attrs) -> {slot: t | [t]}``."""
    def deco(fn):
        OPS[type] = OpDef(type, fn, grad=grad, infer_shape=infer_shape,
                          needs_rng=needs_rng)
        return fn
    return deco


def register_grad_lower(fwd_type):
    """Register a bespoke lowering for ``<fwd_type>_grad``. It receives
    the forward inputs plus ``<slot>@GRAD`` and returns
    ``{"<slot>@GRAD": [...]}``."""
    def deco(fn):
        OPS[fwd_type].custom_grad_lower = fn
        return fn
    return deco


def has_op(type):
    return type in OPS or (type.endswith("_grad") and type[:-5] in OPS)


def get_op_def(type):
    opdef = OPS.get(type)
    if opdef is None:
        if type.endswith("_grad") and type[:-5] in OPS:
            return _grad_op_def(type[:-5])
        raise NotImplementedError(f"op {type!r} is not registered in "
                                  f"paddle_tpu_torch")
    return opdef


def normalize_outs(raw):
    """{slot: t | [t]} -> {slot: [t]}."""
    return {slot: list(v) if isinstance(v, (list, tuple)) else [v]
            for slot, v in raw.items()}


# --------------------------------------------------------------------------
# Generic vjp-based grad op
# --------------------------------------------------------------------------

def _grad_op_def(fwd_type):
    fwd_def = OPS[fwd_type]
    if fwd_def.custom_grad_lower is not None:
        return OpDef(fwd_type + "_grad", fwd_def.custom_grad_lower,
                     grad=False, needs_rng=fwd_def.needs_rng)

    def lower(ctx, ins, attrs):
        return generic_grad_lower(ctx, ins, attrs, fwd_def)

    return OpDef(fwd_type + "_grad", lower, grad=False,
                 needs_rng=fwd_def.needs_rng)


def generic_grad_lower(ctx, ins, attrs, fwd_def):
    """Backward of any op through ``torch.func.vjp`` over its forward
    lowering.

    The grad op carries the forward op in ``attrs["__fwd_op__"]``; the
    forward inputs arrive under their slot names, upstream grads under
    ``<slot>@GRAD``. The forward is recomputed here (eager torch does not
    deduplicate it against the forward pass, unlike XLA). A stochastic
    op draws the same numbers as its forward: both seed their generator
    from the forward's ``__rng_seed__`` (``LowerCtx.generator``).
    Forward outputs without an upstream grad are left out of the vjp, so
    they take no cotangent memory.
    """
    fwd = attrs["__fwd_op__"]
    fwd_attrs = fwd["attrs"]
    req = attrs["__grad_inputs__"]          # {slot: [bool per index]}
    # only the entries that want a grad are primals: a slot may mix them
    # with integer ones (a loop's counter beside its float state)
    primals = {s: [t for t, need in zip(ins[s], req[s]) if need]
               for s in fwd["inputs"] if s in ins and any(req.get(s) or ())}
    out_mask = attrs.get("__out_grad_mask__", {})
    wanted = [s for s in fwd["outputs"] if ins.get(s + "@GRAD")]

    kept = {}       # slot -> indices of its float outputs (integer
                    # outputs, such as a loop counter, take no cotangent)

    def f(p):
        full = dict(ins)
        for s, vals in p.items():
            it = iter(vals)
            full[s] = [next(it) if need else t
                       for t, need in zip(ins[s], req[s])]
        outs = normalize_outs(fwd_def.lower(
            ctx, {s: full.get(s) for s in fwd["inputs"]}, fwd_attrs))
        for s in wanted:
            kept[s] = [i for i, o in enumerate(outs[s])
                       if o.is_floating_point() or o.is_complex()]
        return {s: [outs[s][i] for i in kept[s]] for s in wanted}

    outs, vjp_fn = torch.func.vjp(f, primals)
    cts = {}
    for slot in wanted:
        it = iter(ins[slot + "@GRAD"])
        mask = out_mask.get(slot)
        lst = []
        for i, a in zip(kept[slot], outs[slot]):
            has = mask[i] if mask is not None and i < len(mask) else True
            g = next(it, None) if has else None
            lst.append(a.new_zeros(()).expand_as(a) if g is None
                       else g.to(a.dtype))
        cts[slot] = lst
    (gprimals,) = vjp_fn(cts)

    result = {}
    for slot, flags in req.items():
        grads = gprimals.get(slot)
        if grads is None:
            continue
        it = iter(grads)
        result[slot + "@GRAD"] = [next(it) if need else None
                                  for need in flags]
    return result


# --------------------------------------------------------------------------
# Build-time shape inference on the meta device
# --------------------------------------------------------------------------

def infer_op_shapes(block, op):
    """Set the output vars' shapes and dtypes by running the op's lowering
    on ``meta`` tensors (replaces per-op InferShape functions)."""
    opdef = get_op_def(op.type)
    if opdef.infer_shape is False:
        return
    ins = {}
    had_dynamic = False
    for slot, names in op.inputs.items():
        ts = []
        for n in names:
            v = block.var(n)
            if v.shape is None:
                return            # unknown: the executor binds real shapes
            had_dynamic = had_dynamic or any(s == -1 for s in v.shape)
            shape = tuple(_DYN if s == -1 else s for s in v.shape)
            ts.append(torch.empty(shape, dtype=torch_dtype(v.dtype),
                                  device="meta"))
        ins[slot] = ts

    from .lowering import LowerCtx
    ctx = LowerCtx(block.program, block, env=None, device="meta",
                   abstract=True)
    try:
        outs = normalize_outs(opdef.lower(ctx, ins, op.attrs))
    except Exception as e:  # noqa: BLE001 — re-raised with the op named
        shapes = {s: [tuple(t.shape) for t in v] for s, v in ins.items()}
        raise RuntimeError(f"shape inference failed for op {op.type!r} "
                           f"(inputs {shapes}): {e}") from e

    for slot, names in op.outputs.items():
        for n, t in zip(names, outs.get(slot) or ()):
            if t is None:
                continue
            var = block.var(n)
            # dims that are multiples of the stand-in came from a dynamic
            # input dim; map them back to -1
            var.shape = tuple(
                -1 if (had_dynamic and d % _DYN == 0 and d > 0) else int(d)
                for d in t.shape)
            var.dtype = dtype_name(t.dtype)

