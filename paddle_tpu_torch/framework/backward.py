"""Program-level autodiff: append_backward and gradients.

A trimmed copy of ``paddle_tpu/framework/backward.py``: the same grad
ops, named and ordered as there, appended to the same program. Each
``T_grad`` op's lowering is the torch vjp of T's forward
(``registry.generic_grad_lower``) unless T registered a bespoke one.
A forward value whose name the op or a later op rebinds is saved by an
``assign`` before the op, as there. Recompute (``checkpoints=``)
re-emits each checkpoint-delimited forward segment before its grad ops,
as there (``:214-290``). Grads through ``cond``, ``recurrent`` and a
bounded ``while`` take the generic vjp, which recomputes the loop; an
unbounded ``while`` on a grad path raises, as there (``:322``). A var's
``error_clip`` clips its grad once, when the grad is finalized, before
earlier grad ops read it (``:183-209``); ``clip.error_clip_callback`` is
accepted for that, and other grad-op callbacks warn, as there.
"""
import warnings
from collections import defaultdict

from .core import OP_ROLE_KEY, OpRole, Parameter, Variable, grad_var_name
from .dtype import is_float_dtype
from .registry import get_op_def


def _grad_flows(block, name, no_grad):
    if name in no_grad or not block.has_var(name):
        return False
    var = block.var(name)
    return not var.stop_gradient and is_float_dtype(var.dtype)


def _is_leaf_source(block, name):
    """Leaf grad sources: trainable parameters and non-stop-gradient
    data."""
    if not block.has_var(name):
        return False
    var = block.var(name)
    if isinstance(var, Parameter):
        return var.trainable
    return not var.stop_gradient


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append grad ops computing d loss / d params; returns
    ``[(param, grad)]``.

    ``checkpoints``: Variables that turn recompute on
    (``RecomputeOptimizer``): each checkpoint-delimited forward segment
    but the last is re-emitted just before its grad ops, reading its
    non-persistable inputs through one ``recompute_barrier``, so the
    backward reads recomputed activations and only the checkpoints stay
    live across the forward-to-backward gap. ``callbacks``: the
    reference's per-grad-op hooks. Error clipping (their main use,
    ``clip.error_clip_callback``) is applied when each grad is
    finalized, so that callback is accepted; others are not invoked and
    warn."""
    from ..clip import error_clip_callback
    for cb in callbacks or ():
        if cb is error_clip_callback:
            continue
        warnings.warn(
            f"append_backward callback {cb!r} is not invoked: error "
            f"clipping is built in; other per-grad-op hooks have no "
            f"equivalent in the whole-program emission model",
            stacklevel=2)
    return _append_backward_core([loss], [None],
                                 parameter_list=parameter_list,
                                 no_grad_set=no_grad_set,
                                 checkpoints=checkpoints)


def _append_backward_core(targets, target_gradients, parameter_list=None,
                          no_grad_set=None, checkpoints=None,
                          collect_params=True, finalize_names=None,
                          finalize_out=None):
    loss = targets[0]
    block = loss.block
    program = block.program
    if block.idx != 0 or any(t.block is not block for t in targets):
        raise ValueError("append_backward expects its targets in the "
                         "global block")
    no_grad = {n.name if isinstance(n, Variable) else n
               for n in (no_grad_set or ())}
    ckpt_names = [c.name if isinstance(c, Variable) else c
                  for c in (checkpoints or [])]

    # ---- forward pass: which vars can carry gradient flow ----
    flows = set()
    for op in block.ops:
        if get_op_def(op.type).grad is False:
            continue
        if any(_grad_flows(block, n, no_grad)
               and (n in flows or _is_leaf_source(block, n))
               for n in op.input_arg_names):
            flows.update(n for n in op.output_arg_names
                         if _grad_flows(block, n, no_grad))

    # ---- backward pass: which grads must be computed ----
    need = {t.name for t in targets}
    fwd_ops = list(block.ops)
    emit_plan = []
    for op in reversed(fwd_ops):
        if get_op_def(op.type).grad is False:
            continue
        if not any(n in need for n in op.output_arg_names):
            continue
        diff_inputs = [n for n in op.input_arg_names
                       if _grad_flows(block, n, no_grad)
                       and (n in flows or _is_leaf_source(block, n))]
        if diff_inputs:
            need.update(diff_inputs)
            emit_plan.append(op)

    # ---- snapshot primals that get rebound ----
    # Grad ops read forward values by name. A name the op itself or a
    # later forward op writes again (batch_norm's MeanOut rebinding Mean)
    # would hand the grad the newer value: an ``assign`` just before the
    # op saves it, and the grad op reads the saved copy.
    pos_of = {id(op): i for i, op in enumerate(fwd_ops)}
    writer_pos = defaultdict(list)
    for i, op in enumerate(fwd_ops):
        for n in op.output_arg_names:
            writer_pos[n].append(i)
    save_map = {}           # id(op) -> {name: saved name}
    save_plan = []          # (pos, name, saved name)
    for op in emit_plan:
        p = pos_of[id(op)]
        m = {}
        for n in dict.fromkeys(op.input_arg_names):
            if any(q >= p for q in writer_pos.get(n, ())):
                m[n] = f"{n}@SAVED@{p}"
                save_plan.append((p, n, m[n]))
        if m:
            save_map[id(op)] = m
    for p, n, sn in sorted(save_plan, reverse=True):
        v = block.var(n)
        block.create_var(name=sn, shape=v.shape, dtype=v.dtype,
                         stop_gradient=True)
        block._insert_op(p, type="assign", inputs={"X": [n]},
                         outputs={"Out": [sn]},
                         attrs={OP_ROLE_KEY: OpRole.Backward},
                         infer_shape=False)
    emit_set = {id(op) for op in emit_plan}

    # ---- seed grads ----
    grad_map = defaultdict(list)   # var name -> partial grad names
    for t, tg in zip(targets, target_gradients):
        if tg is None:
            seed = grad_var_name(t.name)
            block.create_var(name=seed, shape=t.shape, dtype=t.dtype,
                             stop_gradient=True)
            block.append_op(
                type="fill_constant", outputs={"Out": [seed]},
                attrs={"shape": list(t.shape or ()), "value": 1.0,
                       "dtype": t.dtype, OP_ROLE_KEY: OpRole.Backward},
                infer_shape=False)
            grad_map[t.name].append(seed)
        else:
            tg = block.var(tg) if isinstance(tg, str) else tg
            if t.shape is not None and tg.shape is not None and \
                    tuple(t.shape) != tuple(tg.shape):
                raise ValueError(
                    f"target_gradients[{t.name}] shape {tg.shape} does "
                    f"not match target shape {t.shape}")
            grad_map[t.name].append(tg.name)

    def new_partial(var_name, like_var):
        base = grad_var_name(var_name)
        existing = grad_map[var_name]
        name = base if not existing else f"{base}@RENAME@{len(existing)}"
        block.create_var(name=name, shape=like_var.shape,
                         dtype=like_var.dtype, stop_gradient=True)
        grad_map[var_name].append(name)
        return name

    error_clipped = set()

    def finalize(var_name):
        """Collapse a var's partial grads into one grad var (a ``sum``
        op when there are several), then apply the var's ``error_clip``
        before earlier grad ops read it."""
        partials = grad_map[var_name]
        if not partials:
            return None
        if len(partials) == 1:
            out = partials[0]
        else:
            out = grad_var_name(var_name)
            block.append_op(type="sum", inputs={"X": list(partials)},
                            outputs={"Out": [out]},
                            attrs={OP_ROLE_KEY: OpRole.Backward})
            grad_map[var_name] = [out]
        eclip = getattr(block.vars.get(var_name), "error_clip", None)
        if eclip is not None and out not in error_clipped:
            # keyed by the grad name: a rebound forward name has one grad
            # per writer and each clips; the clipped name is recorded so
            # a repeated finalize does not clip twice
            cname = eclip._append_clip_op(block, out)
            error_clipped.add(cname)
            grad_map[var_name] = [cname]
            return cname
        return out

    # ---- recompute: re-emit each checkpoint-delimited segment (but the
    # trailing one, whose activations are still live) just before its
    # grad ops; its non-persistable reads go through one
    # recompute_barrier, so cse cannot merge the re-emission with the
    # forward. Grad-op primals are rewired onto the recomputed names;
    # grad names and accumulation stay on the original vars.
    rc_map = {}          # original var name -> recomputed name
    seg_of = {}          # id(op) -> segment index
    seg_emitted = set()
    segments = []
    if ckpt_names:
        ckpt_set = set(ckpt_names)
        cur = []
        for op in fwd_ops:
            cur.append(op)
            seg_of[id(op)] = len(segments)
            if any(n in ckpt_set for n in op.output_arg_names):
                segments.append(cur)
                cur = []
        segments.append(cur)
        seg_emitted.add(len(segments) - 1)

    def emit_recompute(seg_idx):
        ops_in_seg = segments[seg_idx]
        interior = {n for op in ops_in_seg for n in op.output_arg_names}
        external = []
        for op in ops_in_seg:
            for n in op.input_arg_names:
                if n in interior or n in rc_map or n in external \
                        or not block.has_var(n):
                    continue
                if not block.var(n).persistable:
                    external.append(n)
        if external:
            bnames = []
            for n in external:
                v = block.var(n)
                bn = f"{n}@RC_IN@{seg_idx}"
                block.create_var(name=bn, shape=v.shape, dtype=v.dtype,
                                 stop_gradient=True)
                bnames.append(bn)
                rc_map[n] = bn
            block.append_op(
                type="recompute_barrier", inputs={"X": list(external)},
                outputs={"Out": bnames},
                attrs={OP_ROLE_KEY: OpRole.Backward}, infer_shape=False)
        for op in ops_in_seg:
            new_ins = {s: [rc_map.get(n, n) for n in ns]
                       for s, ns in op.inputs.items()}
            new_outs = {}
            for s, ns in op.outputs.items():
                outs = []
                for n in ns:
                    rn = f"{n}@RECOMPUTE"
                    v = block.var(n)
                    block.create_var(name=rn, shape=v.shape, dtype=v.dtype,
                                     stop_gradient=True)
                    rc_map[n] = rn
                    outs.append(rn)
                new_outs[s] = outs
            attrs = dict(op.attrs)
            attrs[OP_ROLE_KEY] = OpRole.Backward
            block.append_op(type=op.type, inputs=new_ins, outputs=new_outs,
                            attrs=attrs, infer_shape=False)

    finalize_set = set(finalize_names or ())

    def record_final(var_name, grad_name):
        if finalize_out is not None and grad_name is not None and \
                var_name not in finalize_out:
            finalize_out[var_name] = grad_name

    for op in reversed(fwd_ops):
        if id(op) not in emit_set:
            # still the live writer of its outputs (in reverse order):
            # pending grads belong to the value THIS op wrote and stop
            # here
            for n in op.output_arg_names:
                if grad_map.get(n):
                    if n in finalize_set:
                        record_final(n, finalize(n))
                    grad_map[n] = []
            continue
        seg_idx = seg_of.get(id(op))
        if seg_idx is not None and seg_idx not in seg_emitted:
            emit_recompute(seg_idx)
            seg_emitted.add(seg_idx)
        if op.type == "while" and "max_trip_count" not in op.attrs:
            raise ValueError(
                "layers.While without max_trip_count is not "
                "differentiable (its loop reads the predicate on the "
                "host each iteration); build it as While(cond, "
                "max_trip_count=N) for the bounded masked lowering, or "
                "use StaticRNN for recurrence")
        g_ins, out_grad_mask = {}, {}
        for slot, names in op.outputs.items():
            gs = [finalize(n) for n in names]
            for n, g in zip(names, gs):
                if n in finalize_set:
                    record_final(n, g)
            if any(g is not None for g in gs):
                out_grad_mask[slot] = [g is not None for g in gs]
                g_ins[slot + "@GRAD"] = [g for g in gs if g is not None]
        for n in op.output_arg_names:
            grad_map[n] = []
        if not g_ins:
            continue

        grad_inputs_req, g_outs = {}, {}
        for slot, names in op.inputs.items():
            flags, outs = [], []
            for n in names:
                ok = (_grad_flows(block, n, no_grad)
                      and (n in flows or _is_leaf_source(block, n))
                      and n in need)
                flags.append(ok)
                outs.append(new_partial(n, block.var(n)) if ok
                            else "@EMPTY@")
            if any(flags):
                grad_inputs_req[slot] = flags
                g_outs[slot + "@GRAD"] = outs
        if not grad_inputs_req:
            continue
        # inputs: the forward inputs (the vjp's primals; rebound names
        # from their saved copies, recomputed segments from their
        # re-emission) + upstream grads; the forward outputs are
        # recomputed by the grad lowering
        sm = save_map.get(id(op), {})
        block.append_op(
            type=op.type + "_grad",
            inputs={**{s: [sm.get(n) or rc_map.get(n, n) for n in ns]
                       for s, ns in op.inputs.items()},
                    **g_ins},
            outputs=g_outs,
            attrs={"__fwd_op__": op.to_dict(),
                   "__grad_inputs__": grad_inputs_req,
                   "__out_grad_mask__": out_grad_mask,
                   OP_ROLE_KEY: OpRole.Backward},
            infer_shape=False)

    # ---- collect (param, grad) pairs ----
    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    params_grads = []
    for p in params:
        g = finalize(p.name)
        if g is not None:
            params_grads.append((p, block.var(g)))
    for n in finalize_names or ():
        record_final(n, finalize(n))
    if collect_params:
        program._params_grads = params_grads
    return params_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of ``targets`` w.r.t. arbitrary ``inputs``, with optional
    seed cotangents (grads sum over targets)."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    elif not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    if len(target_gradients) != len(targets):
        raise ValueError(
            f"target_gradients length {len(target_gradients)} != targets "
            f"length {len(targets)}")
    fin_map = {}
    _append_backward_core(list(targets), list(target_gradients),
                          parameter_list=[], no_grad_set=no_grad_set,
                          collect_params=False,
                          finalize_names=[iv.name for iv in inputs],
                          finalize_out=fin_map)
    block = targets[0].block
    outs = []
    for iv in inputs:
        gname = fin_map.get(iv.name)
        if gname is None and block.has_var(grad_var_name(iv.name)):
            gname = grad_var_name(iv.name)
        outs.append(block.var(gname) if gname is not None else None)
    return outs
