"""Control-flow ops over sub-blocks, in torch (counterpart of
``paddle_tpu/ops/control_flow_ops.py``: ``block_writes :28``, ``while
:51``, ``cond :153``, ``recurrent :186``, the tensor arrays
``:218-256``).

The JAX package lowers a sub-block into ``lax.while_loop`` /
``lax.cond`` / ``lax.scan``; here each body runs through the op-by-op
interpreter (``LowerCtx.lower_block_ops``) over a copy of the env, and
the loops are Python loops over device tensors:

- ``recurrent`` (StaticRNN, DynamicRNN) steps over the time dim, in
  reverse with ``is_reverse``, and stacks its step outputs time-major;
- ``while`` has the JAX package's two lowerings. Unbounded, it reads its
  predicate on the host before every iteration. With
  ``max_trip_count`` it runs that many iterations, each write
  ``torch.where``-masked by the live predicate, with no host read, so it
  can be captured in a CUDA graph and differentiated;
- ``cond`` reads its predicate on the host and runs one branch (what
  ``lax.cond`` computes, and its grad sees only the taken branch).

A host read cannot be captured: under a CUDA graph capture the
unbounded ``while`` and ``cond`` raise ``GraphCaptureError`` naming
themselves before they read anything.

Grads come from the generic vjp (``registry.generic_grad_lower``), which
recomputes the op's forward, the whole loop included. ``cond`` and
``recurrent`` declare every outer var they read as an op input (slots
``Cond``/``X``/``Boot``/``P``), so the vjp reaches them; an unbounded
``while`` on a grad path raises at ``append_backward``.
"""
import torch

from ..framework.analysis import SUB_BLOCK_ATTRS
from ..framework.registry import register_op
from .common import x_of


def block_writes(program, block_idx):
    """Var names written by a block's ops (nested sub-blocks included),
    in first-write order."""
    names = {}
    for op in program.blocks[block_idx].ops:
        names.update(dict.fromkeys(op.output_arg_names))
        for key in SUB_BLOCK_ATTRS:
            sb = op.attrs.get(key)
            if sb is not None:
                names.update(dict.fromkeys(block_writes(program, sb)))
    return list(names)


def _refuse_capture(ctx, what):
    """Raise ``GraphCaptureError`` when the op runs inside a CUDA graph
    capture: ``what`` (a predicate read, a print) needs the host."""
    if ctx.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        from ..framework.cuda_graph import GraphCaptureError
        block = ctx.block
        idx = block.ops.index(ctx.op) if ctx.op in block.ops else None
        raise GraphCaptureError(
            f"op #{idx} {ctx.op.type!r} {what} on the host, which a CUDA "
            f"graph cannot capture; nothing runs it eagerly instead",
            op_type=ctx.op.type, op_index=idx)


def _host_pred(ctx, t):
    _refuse_capture(ctx, "reads its predicate")
    return bool(t.reshape(-1)[0].item())


def _as_pred(t):
    return t.reshape(()).to(torch.bool)


def _auto_bound_ok(ctx, sub, cond_name, max_trip):
    """Re-derive an auto-derived trip bound against the final program:
    ops appended after the loop was built (an outer loop mutating the
    bound) may have invalidated it. A program with grad ops must not
    truncate silently (ValueError); a forward-only one takes the
    unbounded loop (False)."""
    from ..layers.control_flow import _infer_max_trip
    sub_blk = ctx.program.blocks[sub]
    parent_blk = sub_blk.parent_block
    this_op = next((op for op in parent_blk.ops if op.type == "while"
                    and op.attrs.get("sub_block") == sub), None)
    now = _infer_max_trip(ctx.program, parent_blk, sub_blk, cond_name,
                          stop_op=this_op)
    if now == int(max_trip):
        return True
    if any(op.type.endswith("_grad") for blk in ctx.program.blocks
           for op in blk.ops):
        raise ValueError(
            f"While: the auto-derived max_trip_count ({max_trip}) is no "
            f"longer valid in the final program (re-derivation gives "
            f"{now}); the loop bound is mutated after the loop was built "
            f"— pass max_trip_count explicitly")
    return False


@register_op("while", infer_shape=False)
def while_op(ctx, ins, attrs):
    """Carry = the condition var + every var the body writes that exists
    outside (the loop state). Inputs: Condition, X (the outer vars the
    body reads and the loop state); attrs: sub_block, cond_name,
    x_names, out_names, max_trip_count (+ max_trip_count_auto)."""
    sub = attrs["sub_block"]
    cond_name = attrs["cond_name"]
    out_names = list(attrs.get("out_names") or
                     [n for n in block_writes(ctx.program, sub)
                      if n in ctx.env])
    x_map = dict(zip(attrs.get("x_names", []), ins.get("X", [])))
    cond0 = ins["Condition"][0]
    x_map[cond_name] = cond0
    carried = list(out_names)
    if cond_name not in carried:
        carried.insert(0, cond_name)
    outer = dict(ctx.env)
    outer.update(x_map)
    state = {}
    for n in carried:
        if n not in outer:
            raise KeyError(
                f"While loop state {n!r} has no value before the loop; "
                f"initialize it (e.g. fill_constant) before While.block()")
        state[n] = outer[n]

    def body(state):
        env = dict(outer)
        env.update(state)
        ctx.lower_block_ops(sub, env)
        return {n: env[n] for n in carried}

    max_trip = attrs.get("max_trip_count")
    if max_trip is not None and attrs.get("max_trip_count_auto") and \
            not ctx.abstract and \
            not _auto_bound_ok(ctx, sub, cond_name, max_trip):
        max_trip = None
    if max_trip is None:
        while _host_pred(ctx, state[cond_name]):
            state = body(state)
    else:
        live = _as_pred(cond0)
        for _ in range(int(max_trip)):
            new = body(state)
            state = {n: torch.where(live, new[n], state[n])
                     for n in carried}
            live = torch.logical_and(live, _as_pred(state[cond_name]))
    return {"Out": [state[n] for n in out_names]}


@register_op("cond", infer_shape=False)
def cond_op(ctx, ins, attrs):
    """Two-branch conditional. Inputs: Cond [pred], X (outer vars either
    branch reads); attrs: sub_block_true/false, x_names (the inner names
    of X), true_outs/false_outs (each branch's var per output)."""
    x_names = list(attrs.get("x_names", []))
    take = _host_pred(ctx, x_of(ins, "Cond"))
    env = dict(ctx.env)
    env.update(zip(x_names, ins.get("X", [])))
    blk, outs = (("sub_block_true", "true_outs") if take
                 else ("sub_block_false", "false_outs"))
    ctx.lower_block_ops(attrs[blk], env)
    return {"Out": [env[n] for n in attrs[outs]]}


@register_op("recurrent", infer_shape=False)
def recurrent_op(ctx, ins, attrs):
    """StaticRNN's step block run once per step of the time dim.
    Inputs: X (outer time-major sequences), Boot (initial memories), P
    (outer vars the step reads); attrs: sub_block, step_input_vars,
    memories [(pre, post)], p_names, step_outputs, is_reverse. Out: the
    step outputs stacked time-major, aligned with X's steps (also in
    reverse); FinalStates: the memories after the last step."""
    sub = attrs["sub_block"]
    step_in = list(attrs["step_input_vars"])
    memories = [tuple(m) for m in attrs["memories"]]
    step_outs = list(attrs["step_outputs"])
    xs = list(ins.get("X", []))
    carry = list(ins.get("Boot", []))
    outer = dict(ctx.env)
    outer.update(zip(attrs.get("p_names", []), ins.get("P", [])))
    T = int(xs[0].shape[0])
    order = range(T - 1, -1, -1) if attrs.get("is_reverse") else range(T)
    ys = [None] * T
    for t in order:
        env = dict(outer)
        env.update((n, x[t]) for n, x in zip(step_in, xs))
        env.update((pre, c) for (pre, _), c in zip(memories, carry))
        ctx.lower_block_ops(sub, env)
        carry = [env[post] for _, post in memories]
        ys[t] = [env[n] for n in step_outs]
    out = {"Out": [torch.stack([y[i] for y in ys])
                   for i in range(len(step_outs))]}
    if memories:
        out["FinalStates"] = carry
    return out


# ---- tensor arrays: a Python list in the env under the array's name;
# indices are folded to constants at build time (layers.array_write) ----

@register_op("write_to_array", grad=False, infer_shape=False)
def write_to_array(ctx, ins, attrs):
    i = int(attrs["index"])
    name = attrs["array_name"]
    arr = ctx.env.get(name)
    arr = list(arr) if isinstance(arr, list) else []
    arr.extend([None] * (i + 1 - len(arr)))
    arr[i] = x_of(ins)
    ctx.env[name] = arr
    return None


@register_op("read_from_array", grad=False, infer_shape=False)
def read_from_array(ctx, ins, attrs):
    return {"Out": ctx.env[attrs["array_name"]][int(attrs["index"])]}


@register_op("lod_array_length", grad=False, infer_shape=False)
def lod_array_length(ctx, ins, attrs):
    arr = ctx.env.get(attrs["array_name"], [])
    return {"Out": torch.full((1,), len(arr), dtype=torch.int32,
                              device=ctx.device)}


@register_op("print", infer_shape=False)
def print_op(ctx, ins, attrs):
    """``layers.Print``: prints its input on the host and passes it
    through (``jax.debug.print`` in the JAX package)."""
    x = x_of(ins, "In")
    _refuse_capture(ctx, "prints its input")
    print(f"{attrs.get('message', '')} {x.detach().cpu()}", flush=True)
    return {"Out": x}


@register_op("lod_tensor_to_array", grad=False, infer_shape=False)
def lod_tensor_to_array(ctx, ins, attrs):
    """X split along dim 0 into the tensor array ``array_name``
    (``runtime_ops.py:14``)."""
    x = x_of(ins)
    ctx.env[attrs["array_name"]] = list(x.unbind(0))
    return None


@register_op("array_to_lod_tensor", grad=False, infer_shape=False)
def array_to_lod_tensor(ctx, ins, attrs):
    """The tensor array ``array_name`` stacked along dim 0
    (``runtime_ops.py:26``)."""
    return {"Out": torch.stack(ctx.env[attrs["array_name"]])}
