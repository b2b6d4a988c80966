"""Control-flow layer builders (a copy of
``paddle_tpu/layers/control_flow.py``): ``While`` with the auto-derived
trip bound (``:93-228``), ``cond``, ``Switch``, ``StaticRNN``
(``:375-518``), the tensor-array helpers, ``DynamicRNN`` in masked-dense
form (``:586-718``), ``Print``, ``case``, ``switch_case`` and ``IfElse``.

The builders create nested sub-blocks as there; the ops they emit run
through ``ops/control_flow_ops.py`` (sub-block bodies through the
op-by-op interpreter, loops as Python loops over device tensors).
"""
import contextlib

import numpy as np

from ..framework import unique_name
from ..framework.core import Variable, VarType
from ..framework.lowering import analyze_block_io
from .layer_helper import LayerHelper


def _outer_reads(program, block_idx, exclude=()):
    reads, _ = analyze_block_io(program, block_idx, list(exclude))
    parent = program.blocks[block_idx].parent_block
    return [n for n in reads if parent is not None and parent.has_var(n)]


def _defining_op(block, name, stop_op=None):
    """Last op in `block` (or an ancestor) writing `name`, looking only
    at ops BEFORE `stop_op` when given (the while op itself rewrites its
    loop state, so post-hoc re-derivation must not see it); returns
    (op, block) or (None, None)."""
    b = block
    while b is not None:
        found = None
        for op in b.ops:
            if stop_op is not None and op is stop_op:
                break
            if any(name in ns for ns in op.outputs.values()):
                found = op
        if found is not None:
            return found, b
        b = b.parent_block
    return None, None


def _const_scalar(block, name, stop_op=None):
    op, _ = _defining_op(block, name, stop_op)
    if op is not None and op.type == "fill_constant":
        try:
            return float(op.attrs.get("value", 0.0))
        except (TypeError, ValueError):
            return None
    return None


def _other_writers(block, name, keep_op, skip_op=None):
    """Any op (in `block` or an ancestor) besides keep_op/skip_op that
    writes `name` — an outer loop body mutating a bound constant after
    the inner loop makes the derived trip count unsound."""
    b = block
    while b is not None:
        for op in b.ops:
            if op is keep_op or op is skip_op:
                continue
            if any(name in ns for ns in op.outputs.values()):
                return True
        b = b.parent_block
    return False


def _counter_step(sub, parent, ivar):
    """Constant positive per-iteration increment of `ivar` inside the
    loop body, or None. Recognizes increment(i) and i = i + const."""
    writers = [op for op in sub.ops
               if any(ivar in ns for ns in op.outputs.values())]
    if len(writers) != 1:
        return None
    op = writers[0]
    if op.type == "increment":
        step = float(op.attrs.get("step", 1.0))
        return step if step > 0 else None
    if op.type == "elementwise_add":
        xs = op.inputs.get("X", [])
        ys = op.inputs.get("Y", [])
        for a, b in ((xs, ys), (ys, xs)):
            if a and a[0] == ivar and b:
                c = _const_scalar(sub, b[0])
                if c is None:
                    c = _const_scalar(parent, b[0])
                if c is not None and c > 0:
                    return c
    return None


def _infer_max_trip(program, parent, sub, cond_name, stop_op=None):
    """Static trip bound for the reference decoder idiom: the rebound
    loop condition is less_than/less_equal(i, n) (possibly under
    logical_and, e.g. dygraph_to_static's synthesized `and not brk`)
    with n a build-time constant and i a constant-initialized counter
    incremented by a constant step in the body. Returns int or None.
    The bound stays valid when other conjuncts end the loop earlier —
    the masked lowering handles early exit exactly (reference
    while_op.cc needs no bound; the bound is what makes the loop
    differentiable and capturable here)."""
    import math

    def bound_of(name, depth):
        if depth > 4:
            return None
        op, _ = _defining_op(sub, name)
        if op is None:
            op, _ = _defining_op(parent, name, stop_op)
        if op is None:
            return None
        if op.type in ("logical_and", "assign"):
            cands = [bound_of(ns[0], depth + 1)
                     for s, ns in op.inputs.items() if ns]
            cands = [c for c in cands if c is not None]
            return min(cands) if cands else None
        if op.type not in ("less_than", "less_equal"):
            return None
        xs, ys = op.inputs.get("X", []), op.inputs.get("Y", [])
        if not xs or not ys:
            return None
        ivar, nvar = xs[0], ys[0]
        n_op, n_blk = _defining_op(sub, nvar)
        if n_op is None:
            n_op, n_blk = _defining_op(parent, nvar, stop_op)
        if n_op is None or n_op.type != "fill_constant":
            return None
        try:
            n_val = float(n_op.attrs.get("value", 0.0))
        except (TypeError, ValueError):
            return None
        # the bound must be a true constant: no OTHER writer anywhere in
        # the loop body or the enclosing block chain (an outer loop
        # mutating it after this loop would re-execute that write)
        if _other_writers(sub, nvar, n_op) or \
                _other_writers(parent, nvar, n_op, skip_op=stop_op):
            return None
        i0_op, i0_blk = _defining_op(parent, ivar, stop_op)
        if i0_op is None or i0_op.type != "fill_constant":
            return None
        i0 = float(i0_op.attrs.get("value", 0.0))
        step = _counter_step(sub, parent, ivar)
        if step is None:
            return None
        span = n_val - i0 + (1.0 if op.type == "less_equal" else 0.0)
        if span <= 0:
            return 0
        return int(math.ceil(span / step))

    return bound_of(cond_name, 0)


class While:
    """fluid.layers.While loop builder.

    i = fill_constant([1], 'int64', 0)
    cond = less_than(i, n)
    w = While(cond)
    with w.block():
        ...
        increment(i)
        less_than(i, n, cond=cond)   # rebind the condition var
    """

    def __init__(self, cond, is_test=False, name=None, max_trip_count=None):
        """`max_trip_count` (not in the reference signature): a static
        upper bound on iterations. Setting it makes the loop reverse-mode
        differentiable and capturable (the bounded masked lowering, see
        ops/control_flow_ops.py while_op); without it the bound is
        AUTO-DERIVED from counter-vs-constant loop conditions
        (_infer_max_trip) — reference-style decoder loops differentiate
        with no extra kwarg. Underivable loops read their predicate on
        the host each iteration (forward-only)."""
        self.cond_var = cond
        self.max_trip_count = max_trip_count
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        from ..ops.control_flow_ops import block_writes
        for op in program.blocks[sub.idx].ops:
            if op.type == "write_to_array":
                raise ValueError(
                    "array_write inside a While body is not supported "
                    "(trace-time arrays cannot be loop state); collect "
                    "per-step values with StaticRNN step outputs instead")
        writes = [n for n in block_writes(program, sub.idx)
                  if parent.has_var(n)]
        reads = _outer_reads(program, sub.idx)
        # loop-state writes must also be op inputs: the carry is initialized
        # from them, and grads of the initial values flow out through X@GRAD
        x_names = list(reads)
        for n in writes:
            if n not in x_names and n != self.cond_var.name:
                x_names.append(n)
        max_trip = self.max_trip_count
        auto = False
        if max_trip is None:
            max_trip = _infer_max_trip(program, parent,
                                       program.blocks[sub.idx],
                                       self.cond_var.name)
            auto = max_trip is not None
        attrs = {"sub_block": sub.idx, "cond_name": self.cond_var.name,
                 "x_names": x_names, "out_names": writes}
        if max_trip is not None:
            attrs["max_trip_count"] = int(max_trip)
            if auto:
                # re-validated at lowering time when the program is
                # FINAL: ops appended after this point (e.g. an outer
                # loop mutating the bound) could invalidate the
                # derivation (ops/control_flow_ops.py while_op)
                attrs["max_trip_count_auto"] = True
        parent.append_op(
            type="while",
            inputs={"Condition": [self.cond_var], "X": x_names},
            outputs={"Out": writes},
            attrs=attrs,
            infer_shape=False)


def cond(pred, true_fn=None, false_fn=None, name=None):
    """fluid.layers.cond — returns merged branch outputs (single Variable or
    flat list/tuple of Variables; both branches must match)."""
    helper = LayerHelper("cond", name=name)
    program = helper.main_program
    parent = program.current_block()

    def build(fn):
        blk = program._create_block()
        try:
            out = fn() if fn is not None else None
        finally:
            program._rollback()
        if out is None:
            outs = []
        elif isinstance(out, (list, tuple)):
            outs = list(out)
        else:
            outs = [out]
        return blk, outs

    t_blk, t_outs = build(true_fn)
    f_blk, f_outs = build(false_fn)
    if len(t_outs) != len(f_outs):
        raise ValueError(
            f"cond branches must return the same number of outputs "
            f"({len(t_outs)} vs {len(f_outs)})")

    reads = sorted(set(_outer_reads(program, t_blk.idx)) |
                   set(_outer_reads(program, f_blk.idx)))
    outs = []
    for tv in t_outs:
        outs.append(parent.create_var(
            name=unique_name.generate(f"{helper.name}.out"),
            shape=tv.shape, dtype=tv.dtype))
    parent.append_op(
        type="cond",
        inputs={"Cond": [pred], "X": reads},
        outputs={"Out": outs},
        attrs={"sub_block_true": t_blk.idx, "sub_block_false": f_blk.idx,
               "x_names": reads,
               "true_outs": [v.name for v in t_outs],
               "false_outs": [v.name for v in f_outs]},
        infer_shape=False)
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


class Switch:
    """fluid.layers.Switch — first-true-case semantics via a chain of cond
    ops. Cases communicate by assigning to pre-existing outer variables."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.cases = []          # [(pred_var or None, block)]
        self.inside = False

    def __enter__(self):
        self.inside = True
        return self

    @contextlib.contextmanager
    def case(self, condition):
        program = self.helper.main_program
        blk = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        self.cases.append((condition, blk))

    @contextlib.contextmanager
    def default(self):
        program = self.helper.main_program
        blk = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        self.cases.append((None, blk))

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.inside = False
        if exc_type is not None:
            return False
        program = self.helper.main_program
        parent = program.current_block()
        from ..ops.control_flow_ops import block_writes

        preds = [(p, b) for p, b in self.cases if p is not None]
        defaults = [b for p, b in self.cases if p is None]
        writes = []
        for _, b in self.cases:
            for n in block_writes(program, b.idx):
                if parent.has_var(n) and n not in writes:
                    writes.append(n)
        reads = sorted({n for _, b in self.cases
                        for n in _outer_reads(program, b.idx)} |
                       set(writes))

        def empty_block():
            blk = program._create_block()
            program._rollback()
            return blk

        # fold right: else-branch of case i is a wrapper block holding the
        # cond op for cases i+1...
        rest = defaults[0] if defaults else empty_block()
        if not preds:
            # default-only Switch: run it unconditionally
            from . import tensor as T
            always = T.fill_constant([1], "bool", 1.0)
            parent.append_op(
                type="cond",
                inputs={"Cond": [always], "X": list(reads)},
                outputs={"Out": list(writes)},
                attrs={"sub_block_true": rest.idx,
                       "sub_block_false": empty_block().idx,
                       "x_names": list(reads),
                       "true_outs": list(writes),
                       "false_outs": list(writes)},
                infer_shape=False)
            return False
        for i in reversed(range(len(preds))):
            pred, blk = preds[i]
            if i == 0:
                # outermost: emit into the parent block
                target = parent
            else:
                target = program._create_block()
                program._rollback()
            target.append_op(
                type="cond",
                inputs={"Cond": [pred], "X": list(reads)},
                outputs={"Out": list(writes)},
                attrs={"sub_block_true": blk.idx,
                       "sub_block_false": rest.idx,
                       "x_names": list(reads),
                       "true_outs": list(writes),
                       "false_outs": list(writes)},
                infer_shape=False)
            rest = target
        return False


class StaticRNN:
    """fluid.layers.StaticRNN — fixed-length recurrence: one
    ``recurrent`` op whose step block runs once per step (reference
    recurrent_op.cc ran it through a nested executor with step scopes).

    rnn = StaticRNN()
    with rnn.step():
        w = rnn.step_input(x)         # x time-major [T, B, D]
        h_prev = rnn.memory(init=h0)  # [B, H]
        h = layers.fc(concat([w, h_prev]), H, act='tanh')
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()                        # [T, B, H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._block = None
        self._step_inputs = []    # (outer var, inner var)
        self._memories = []       # [pre_var, post_var|None, boot_var]
        self._step_outputs = []   # inner vars
        self._outputs = None
        self._final_states = None

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent = program.current_block()
        self._block = program._create_block()
        try:
            yield
        except BaseException:
            program._rollback()
            raise
        else:
            program._rollback()
            self._complete()

    def _in_step(self):
        assert self._block is not None and \
            self.helper.main_program.current_block() is self._block, \
            "call inside `with rnn.step():`"

    def step_input(self, x):
        self._in_step()
        assert x.shape is not None and len(x.shape) >= 1, \
            "step_input needs a time-major var with known rank"
        iv = self._block.create_var(
            name=unique_name.generate(f"{self.helper.name}.step_in"),
            shape=x.shape[1:], dtype=x.dtype)
        self._step_inputs.append((x, iv))
        return iv

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._in_step()
        if init is None:
            assert shape is not None and batch_ref is not None, \
                "memory() needs init= or (shape=, batch_ref=)"
            batch = (batch_ref.shape[0]
                     if batch_ref.block is self._block
                     else batch_ref.shape[ref_batch_dim_idx])
            full = [batch] + [int(s) for s in shape[1:]] \
                if len(shape) > 1 else [batch]
            from . import tensor as T
            # boot var lives in the parent block, before the recurrent op
            program = self.helper.main_program
            cur = program.current_block_idx
            program.current_block_idx = self._parent.idx
            try:
                init = T.fill_constant(full, batch_ref.dtype, init_value)
            finally:
                program.current_block_idx = cur
        pre = self._block.create_var(
            name=unique_name.generate(f"{self.helper.name}.mem"),
            shape=init.shape, dtype=init.dtype)
        self._memories.append([pre, None, init])
        return pre

    def update_memory(self, mem, var):
        self._in_step()
        for rec in self._memories:
            if rec[0] is mem:
                rec[1] = var
                return
        raise ValueError("update_memory: unknown memory var")

    def step_output(self, o):
        self._in_step()
        self._step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        program = self.helper.main_program
        parent = self._parent
        assert self._step_inputs, "StaticRNN needs at least one step_input"
        assert all(rec[1] is not None for rec in self._memories), \
            "every memory() needs an update_memory()"
        seq_len = self._step_inputs[0][0].shape[0]

        exclude = [iv.name for _, iv in self._step_inputs] + \
                  [rec[0].name for rec in self._memories]
        reads = _outer_reads(program, self._block.idx, exclude)

        outs = []
        for o in self._step_outputs:
            outs.append(parent.create_var(
                name=unique_name.generate(f"{self.helper.name}.out"),
                shape=(seq_len,) + tuple(o.shape or ()), dtype=o.dtype))
        finals = []
        for rec in self._memories:
            finals.append(parent.create_var(
                name=unique_name.generate(f"{self.helper.name}.final"),
                shape=rec[2].shape, dtype=rec[2].dtype))

        parent.append_op(
            type="recurrent",
            inputs={"X": [x for x, _ in self._step_inputs],
                    "Boot": [rec[2] for rec in self._memories],
                    "P": reads},
            outputs={"Out": outs, "FinalStates": finals},
            attrs={"sub_block": self._block.idx,
                   "step_input_vars": [iv.name
                                       for _, iv in self._step_inputs],
                   "memories": [(rec[0].name, rec[1].name)
                                for rec in self._memories],
                   "p_names": reads,
                   "step_outputs": [o.name for o in self._step_outputs],
                   "is_reverse": False},
            infer_shape=False)
        self._outputs = outs
        self._final_states = finals

    def __call__(self):
        assert self._outputs is not None, "finish `with rnn.step():` first"
        return self._outputs[0] if len(self._outputs) == 1 \
            else list(self._outputs)


# ---- LoDTensorArray helpers ----

def _const_index(block, i, _upto=None):
    """Resolve an array index to a build-time int: the index subgraph
    (fill_constant / increment / assign chains) is folded here, as the
    JAX package folds it (its arrays are trace-time lists)."""
    if isinstance(i, (int, np.integer)):
        return int(i)
    ops = block.ops if _upto is None else block.ops[:_upto]
    for idx in range(len(ops) - 1, -1, -1):
        op = ops[idx]
        if i.name not in op.output_arg_names:
            continue
        if op.type == "fill_constant":
            return int(op.attrs["value"])
        if op.type == "assign":
            src = block.var(op.input("X")[0])
            return _const_index(block, src, _upto=idx)
        if op.type == "increment":
            return _const_index(block, i, _upto=idx) + \
                int(op.attrs.get("step", 1))
        break
    raise ValueError(
        f"tensor-array index {i.name!r} is not a build-time constant "
        f"(only fill_constant/increment/assign chains fold); inside loops "
        f"use StaticRNN step outputs instead of arrays")


def create_array(dtype="float32"):
    helper = LayerHelper("array")
    var = helper.block.create_var(
        name=unique_name.generate("array"), dtype=dtype,
        type=VarType.LOD_TENSOR_ARRAY)
    return var


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    idx = _const_index(helper.block, i)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x]},
                     outputs={},
                     attrs={"array_name": array.name, "index": idx},
                     infer_shape=False)
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    idx = _const_index(helper.block, i)
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={}, outputs={"Out": [out]},
                     attrs={"array_name": array.name, "index": idx},
                     infer_shape=False)
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(type="lod_array_length",
                     inputs={}, outputs={"Out": [out]},
                     attrs={"array_name": array.name}, infer_shape=False)
    return out


class DynamicRNN:
    """fluid.layers.DynamicRNN (reference layers/control_flow.py:2768) in
    masked-dense form. The reference sorts sequences by length
    (lod_rank_table), shrinks the live batch every step, and re-scatters
    outputs; here the batch stays static and a per-step validity mask
    freezes finished rows' memories and zeros their outputs — identical
    results, one recurrent op.

        drnn = layers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lengths)   # x [B, T, D] padded
            h = drnn.memory(shape=[H], value=0.0)
            nh = layers.fc(layers.concat([x_t, h], 1), H, act="tanh")
            drnn.update_memory(h, nh)
            drnn.output(nh)
        out = drnn()                             # [B, T, H] (zeros padded)
    """

    def __init__(self, name=None):
        self._rnn = StaticRNN(name=name)
        self._mask_t = None          # [B, 1] float validity, per step
        self._lengths = None
        self._batch = None

    def block(self):
        return self._rnn.step()

    def step_input(self, x, lengths=None, level=0):
        """x: [B, T, ...] padded batch-major + lengths [B] (the
        masked-dense stand-in for the reference's LoD input; `level` is
        accepted for API parity). Additional step inputs share the first
        one's lengths — passing a different lengths var raises."""
        from . import tensor as T
        from .sequence_lod import sequence_mask
        assert x.shape is not None and len(x.shape) >= 2, \
            "step_input needs [B, T, ...] with known rank"
        if self._mask_t is not None and lengths is not None \
                and lengths is not self._lengths:
            raise ValueError(
                "DynamicRNN: every step_input shares the FIRST one's "
                "lengths; a second lengths= would be silently wrong")
        ndim = len(x.shape)
        # the transpose/mask prep must run BEFORE the recurrent op:
        # emit into the parent block (same trick StaticRNN.memory uses
        # for boot vars)
        program = self._rnn.helper.main_program
        cur = program.current_block_idx
        program.current_block_idx = self._rnn._parent.idx
        try:
            # time-major for the recurrent op: [T, B, ...]
            xt = T.transpose(x, [1, 0] + list(range(2, ndim)))
            mask_in = None
            if self._mask_t is None:
                if lengths is None:
                    raise ValueError(
                        "the FIRST DynamicRNN.step_input needs lengths= "
                        "([B] int sequence lengths; masked-dense design)")
                self._lengths = lengths
                self._batch = int(x.shape[0])
                maxlen = int(x.shape[1])
                mask = sequence_mask(lengths, maxlen=maxlen,
                                     dtype="float32")       # [B, T]
                mask_tm = T.transpose(mask, [1, 0])          # [T, B]
                mask_in = T.reshape(mask_tm, [maxlen, -1, 1])
        finally:
            program.current_block_idx = cur
        iv = self._rnn.step_input(xt)
        if mask_in is not None:
            self._mask_t = self._rnn.step_input(mask_in)     # [B, 1]
        return iv

    def static_input(self, x):
        """Whole-sequence (non-stepped) input: visible unchanged every
        step (the recurrent lowering threads outer reads through)."""
        return x

    def memory(self, init=None, shape=None, value=0.0,
               need_reorder=False, dtype="float32"):
        """Reference signature (layers/control_flow.py:3184): `shape`
        EXCLUDES the batch dim; `value`/`dtype` set the boot constant.
        need_reorder is a no-op — masked-dense never sorts the batch."""
        assert self._mask_t is not None, \
            "call step_input() before memory() (the mask drives updates)"
        if init is None:
            assert shape is not None, "memory() needs init= or shape="
            from . import tensor as T
            program = self._rnn.helper.main_program
            cur = program.current_block_idx
            program.current_block_idx = self._rnn._parent.idx
            try:
                init = T.fill_constant(
                    [self._batch] + [int(s) for s in shape], dtype,
                    value)
            finally:
                program.current_block_idx = cur
        return self._rnn.memory(init=init)

    def _mask_like(self, var):
        """[B, 1] mask broadcast-shaped for `var`'s rank."""
        rank = len(var.shape)
        if rank <= 2:
            return self._mask_t
        from . import tensor as T
        return T.reshape(self._mask_t, [-1] + [1] * (rank - 1))

    def update_memory(self, ex_mem, new_mem):
        """Finished rows (mask 0) keep their memory — the reference
        achieves this by shrinking the live batch instead."""
        from . import math as M
        masked = M.elementwise_add(
            ex_mem,
            M.elementwise_mul(M.elementwise_sub(new_mem, ex_mem),
                              self._mask_like(new_mem)))
        self._rnn.update_memory(ex_mem, masked)

    def output(self, *outputs):
        from . import math as M
        for o in outputs:
            self._rnn.step_output(
                M.elementwise_mul(o, self._mask_like(o)))

    def __call__(self):
        from . import tensor as T
        outs = self._rnn()
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        back = []
        for o in outs:
            nd = len(o.shape)
            back.append(T.transpose(o, [1, 0] + list(range(2, nd))))
        return back[0] if len(back) == 1 else back


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """fluid.layers.Print (reference control_flow.py Print /
    print_op.cc): records a print op; the value flows through."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or ""},
                     infer_shape=False)
    return out


def case(pred_fn_pairs, default=None, name=None):
    """fluid.layers.case (reference control_flow.py:3204): first-true
    semantics via a chain of conds."""
    assert pred_fn_pairs, "case needs at least one (pred, fn) pair"

    def chain(pairs):
        (pred, fn) = pairs[0]
        rest = pairs[1:]
        if not rest:
            if default is None:
                # reference: with no default the last fn runs
                # unconditionally — trace it ONCE (two cond branches
                # would duplicate any parameters it creates)
                return fn()
            return cond(pred, fn, default)
        return cond(pred, fn, lambda: chain(rest))

    return chain(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """fluid.layers.switch_case (reference control_flow.py:3073):
    dispatch on an integer index."""
    from . import math as M
    from . import tensor as T
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = list(enumerate(branch_fns))
    pairs = []
    for idx, fn in items:
        idx_c = T.fill_constant([1], "int64", int(idx))
        pairs.append((M.equal(T.cast(branch_index, "int64"), idx_c), fn))
    if default is None:
        default = items[-1][1]    # reference: last branch is default
    return case(pairs, default=default, name=name)


class IfElse:
    """Old-style fluid.layers.IfElse (reference control_flow.py:1851).
    The reference gathers true/false rows into sub-scopes and merges;
    masked-dense form: both branches compute on the FULL batch and
    outputs merge per-row by the condition mask.

        ie = layers.IfElse(cond_rows)        # cond_rows: [B, 1] bool
        with ie.true_block():
            ie.output(f(x))
        with ie.false_block():
            ie.output(g(x))
        out, = ie()
    """

    def __init__(self, cond, name=None):
        self._cond = cond
        self._outs = {True: [], False: []}
        self._in_branch = None

    @contextlib.contextmanager
    def true_block(self):
        self._in_branch = True
        try:
            yield
        finally:
            self._in_branch = None

    @contextlib.contextmanager
    def false_block(self):
        self._in_branch = False
        try:
            yield
        finally:
            self._in_branch = None

    def input(self, x):
        """The reference slices x to the branch's rows; masked-dense
        keeps the full batch (outputs merge by mask)."""
        assert self._in_branch is not None, \
            "IfElse.input() must be called inside a branch block"
        return x

    def output(self, *outs):
        assert self._in_branch is not None, \
            "IfElse.output() must be called inside a branch block"
        self._outs[self._in_branch].extend(outs)

    def __call__(self):
        from . import tensor as T
        t_outs = self._outs[True]
        f_outs = self._outs[False]
        assert len(t_outs) == len(f_outs), \
            "both IfElse branches must output the same number of vars"
        cond_b = T.cast(self._cond, "bool")
        merged = []
        for tv, fv in zip(t_outs, f_outs):
            merged.append(T.where(cond_b, tv, fv))
        return merged
