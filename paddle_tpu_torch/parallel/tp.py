"""Tensor parallelism over the ``tp`` axis: the per-rank rewrite of a
program (pass ``tp_shard``) and the shards of its state.

The JAX package annotates parameters with ``dist_attr`` and GSPMD splits
them and inserts the collectives. The port runs one process per card, so
:func:`tp_rewrite` does that per rank, Megatron-style:

- each parameter (and optimizer accumulator) annotated on ``tp`` takes
  this rank's shard shape (a :class:`Layout`); a column-split weight
  whose output is cut by ``slice`` ops into equal pieces (the fused
  ``qkv``) is split piece by piece, so each rank holds its heads' columns
  of q, k and v;
- a column-split ``mul`` reads its input through ``c_identity`` (its
  grad sums the ranks' partial input grads), a row-split one sums its
  partial product with ``mp_allreduce_sum`` before the bias;
- a lookup in a vocab-split table becomes ``c_embedding`` (the ids of the
  rank's rows) and ``mp_allreduce_sum``; a ``matmul`` against it (the
  tied head) gives the rank's vocab columns, gathered at once by
  ``c_concat``;
- every op between them runs on the rank's part: the pass tracks which
  dim of which tensor is split and rewrites ``slice`` bounds and
  ``reshape`` shapes to the local sizes (a head count becomes the
  rank's head count); a ``transpose``, an elementwise op, ``einsum``,
  ``flash_attention`` (whole heads a rank) and the elementwise
  optimizers follow the split. An op it has no rule for raises
  ``NotImplementedError`` rather than compute on a part as on a whole;
- a ``pipeline`` op is a replicated region (``parallel.pp``): a split
  input is gathered whole before it by ``c_concat``, its stage runs
  whole on every tp rank and its output is whole.

Every grad op is rewritten with its forward op (``__fwd_op__``), and the
conjugate collectives' grads go in beside it. The rewritten program
type-checks under ``analysis.verify_program``.

State: the startup program makes every value whole; the executor cuts
each rank's shard out of a whole value before a tp program reads it
(:func:`place_shards`, also after a load), and a save gathers the shards
back (:func:`gathered`), so a checkpoint is the single-card format.
"""
import collections
import contextlib

import numpy as np
import torch

from ..framework.core import OP_ROLE_KEY, OpRole, Operator

EMPTY = "@EMPTY@"
TP_ATTRS = {"ring_id": 0, "axis_name": "tp"}

# ops whose every output follows the split of their one split input
_UNARY = {"scale", "gelu", "relu", "tanh", "sigmoid", "cast", "dropout",
          "assign", "exp", "sqrt", "square", "abs", "softmax",
          "sharding_constraint", "silu", "leaky_relu", "clip"}
_ELEMENTWISE = {"elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div", "elementwise_max", "elementwise_min"}
# optimizers that update each element from the same element only
_ELEMENTWISE_OPT = {"sgd", "momentum", "adam", "adamw", "adamax",
                    "adagrad", "rmsprop"}

#: how a persistable is split: dim ``dim`` of the whole ``full_shape``,
#: cut into ``segments`` equal pieces, each cut over the mesh axis
#: ``axis`` (``tp``; ``pp`` for a pipeline's stage slices, ``parallel.pp``)
Layout = collections.namedtuple("Layout", "dim segments full_shape axis",
                                defaults=("tp",))


def local_shape(layout, n):
    """The shape of one of ``n`` shards of ``layout``."""
    shape = list(layout.full_shape)
    shape[layout.dim] //= n
    return tuple(shape)


def not_ported(what):
    from .mesh import not_ported_7b
    return not_ported_7b(f"tensor parallelism: {what}")


# ----------------------------------------------------------------- tensors

def shard_tensor(full, layout, tp, r):
    """Rank ``r``'s shard of the whole tensor ``full``: dim ``layout.dim``
    cut into ``segments`` equal pieces, each cut into ``tp`` blocks, the
    rank's block of every piece in order. A new tensor."""
    d, s = layout.dim, layout.segments
    shape = tuple(full.shape)
    seg = shape[d] // s
    w = seg // tp
    v = full.reshape(shape[:d] + (s, seg) + shape[d + 1:])
    v = v.narrow(d + 1, r * w, w)
    return v.reshape(shape[:d] + (s * w,) + shape[d + 1:]).clone(
        memory_format=torch.contiguous_format)


def gather_tensor(local, layout, mesh):
    """The whole tensor from this rank's shard ``local``: the shards of
    the rank's group on the layout's axis of ``mesh`` gathered and put
    back piece by piece (the inverse of :func:`shard_tensor`)."""
    tp = mesh.axis_size(layout.axis)
    if tp == 1:
        return local
    from ..ops.collective_ops import all_gather
    d, s = layout.dim, layout.segments
    shape = tuple(local.shape)
    w = shape[d] // s
    parts = all_gather(local.unsqueeze(0).contiguous(), layout.axis,
                       mesh=mesh)
    v = parts.reshape((tp,) + shape[:d] + (s, w) + shape[d + 1:])
    return v.movedim(0, d + 1).reshape(layout.full_shape)


# ------------------------------------------------------------------ scopes

def place_shards(scope, layouts, names, mesh):
    """Cut this rank's shard on its layout's axis of ``mesh`` (``tp``, or
    ``pp`` for a stage slice) out of each whole value among ``names``
    that ``layouts`` splits (a value of the full shape: fresh from the
    startup program or a load), in place in ``scope``, which keeps
    ``mesh`` (``tp_mesh``) for its saves."""
    if not layouts:
        return
    held = scope.tp_layouts
    scope.tp_mesh = mesh
    for n in names:
        lay = layouts.get(n)
        if lay is None:
            continue
        val = scope.find_var(n)
        if val is None or not hasattr(val, "shape"):
            continue
        k = mesh.axis_size(lay.axis)
        if k == 1:
            continue
        held[n] = lay
        if tuple(val.shape) == tuple(lay.full_shape):
            scope.set(n, shard_tensor(val, lay, k, mesh.coords()[lay.axis]))
        elif tuple(val.shape) != local_shape(lay, k):
            raise ValueError(
                f"{lay.axis}: {n!r} holds shape {tuple(val.shape)}: "
                f"neither the whole {tuple(lay.full_shape)} nor a "
                f"{lay.axis}={k} shard {local_shape(lay, k)}")


@contextlib.contextmanager
def gathered(scope):
    """``scope`` with every shard it holds (tp shards, pp stage slices)
    replaced by the whole tensor (gathered over the rank's group on the
    layout's axis of the scope's ``tp_mesh``; every rank must enter),
    the shards put back on exit: what a save writes."""
    held = getattr(scope, "tp_layouts", {})
    mesh = getattr(scope, "tp_mesh", None)
    saved = {}
    try:
        for n, lay in held.items() if mesh is not None else ():
            val = scope.find_var(n)
            k = mesh.axis_size(lay.axis)
            if val is None or k == 1 or \
                    tuple(val.shape) != local_shape(lay, k):
                continue
            saved[n] = val
            scope.set(n, gather_tensor(val, lay, mesh))
        yield scope
    finally:
        for n, val in saved.items():
            scope.set(n, val)


# ----------------------------------------------------------------- rewrite

def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _op_key(type_, outputs):
    return (type_, _freeze(outputs))


class _Record:
    """The collectives a forward op's rewrite put around it, for its grad
    op."""

    def __init__(self):
        self.identity_in = {}    # identity output -> (its input, the op)
        self.gathered_out = []   # (slot, local name, concat op)
        self.gathered_in = {}    # concat output -> (its input, the op)


class _Rewriter:
    def __init__(self, program, mesh, tp, r):
        self.program = program
        self.block = program.global_block()
        self.mesh = mesh
        self.tp, self.r = int(tp), int(r)
        self.layouts = {}
        self.split = {}          # var name -> (dim, segments)
        self.records = {}
        self.fwd_index = {}      # original (type, outputs) -> op as run
        self.out = []
        self.counter = 0
        self.report = collections.Counter()

    # -- helpers --------------------------------------------------------
    def var(self, n):
        return self.block.var(n)

    def new_var(self, base, like, tag):
        self.counter += 1
        name = f"{base}@TP_{tag}_{self.counter}"
        v = self.var(like)
        self.block.create_var(name=name, shape=v.shape, dtype=v.dtype,
                              stop_gradient=v.stop_gradient)
        return name

    def emit(self, type_, inputs, outputs, attrs, role):
        op = Operator(self.block, type_, inputs, outputs,
                      dict(attrs, **{OP_ROLE_KEY: role}))
        self.out.append(op)
        return op

    def infer(self, op):
        from ..framework.registry import get_op_def, infer_op_shapes
        if get_op_def(op.type).infer_shape is False:
            return
        infer_op_shapes(self.block, op)

    def fail(self, op, why):
        names = sorted(n for n in op.input_arg_names if n in self.split)
        raise not_ported(f"op {op.type!r} on the tp-split {names}: {why}")

    # -- layouts --------------------------------------------------------
    def plan(self):
        from .mesh import sharding_for
        block = self.block
        for name, v in block.vars.items():
            if getattr(v, "dist_attr", None) is None or not v.persistable:
                continue
            # a pipeline's stage slices (pp) are parallel.pp's, the
            # experts' slices (ep) parallel.ep's
            spec = tuple(None if a in ("pp", "ep") else a
                         for a in sharding_for(self.mesh, v))
            if any(a not in (None, "tp") for a in spec):
                raise not_ported(f"{name!r} is sharded {tuple(spec)}; only "
                                 f"a tp split of parameters is ported")
            dims = [d for d, a in enumerate(spec) if a == "tp"]
            if len(dims) > 1:
                raise not_ported(f"{name!r} split on tp twice")
            if dims:
                self.layouts[name] = Layout(dims[0], 1, tuple(v.shape))
        consumers = collections.defaultdict(list)
        root = {n: n for n in self.layouts}    # a cast's output -> param
        for op in block.ops:
            if "__fwd_op__" in op.attrs:
                continue
            for n in op.input_arg_names:
                consumers[n].append(op)
            if op.type == "cast" and op.input("X")[0] in root:
                root[op.output("Out")[0]] = root[op.input("X")[0]]
        for op in block.ops:
            if op.type != "mul" or "__fwd_op__" in op.attrs:
                continue
            w = root.get(op.input("Y")[0])
            lay = self.layouts.get(w)
            if lay is None or lay.dim != len(lay.full_shape) - 1:
                continue
            width = lay.full_shape[-1]
            outs, members = [op.output("Out")[0]], [w]
            for c in consumers[outs[0]]:
                b = [root.get(n) for n in c.input("Y")]
                if c.type == "elementwise_add" and b and b[0] is not None:
                    outs.append(c.output("Out")[0])
                    members.append(b[0])
            cuts = [c for o in outs for c in consumers[o]
                    if c.type == "slice" and list(c.attrs["axes"]) in
                    ([len(self.var(o).shape) - 1], [-1])]
            spans = {(int(c.attrs["starts"][0]), int(c.attrs["ends"][0]))
                     for c in cuts}
            sizes = {e - s for s, e in spans}
            if len(spans) >= 2 and len(sizes) == 1:
                piece = sizes.pop()
                if piece > 0 and width % piece == 0 and all(
                        s % piece == 0 for s, _ in spans):
                    for m in members:
                        self.layouts[m] = self.layouts[m]._replace(
                            segments=width // piece)
        for op in block.ops:
            p = op.input("Param")
            if not p or p[0] not in self.layouts:
                continue
            lay = self.layouts[p[0]]
            # the parameter's split, pieces included, on its state
            for n in op.input_arg_names + op.output_arg_names:
                v = block.vars.get(n)
                if v is not None and v.persistable and \
                        getattr(v, "dist_attr", None) is not None and \
                        tuple(v.shape) == lay.full_shape:
                    self.layouts[n] = lay
        for name, lay in self.layouts.items():
            piece = lay.full_shape[lay.dim] // lay.segments
            if piece % self.tp:
                raise ValueError(
                    f"tp={self.tp}: {name!r} dim {lay.dim} "
                    f"({lay.full_shape[lay.dim]}, in {lay.segments} "
                    f"piece(s)) does not divide by the tp ranks")
            self.var(name).shape = local_shape(lay, self.tp)
            self.split[name] = (lay.dim, lay.segments)

    # -- forward rules --------------------------------------------------
    def forward(self, op):
        self.key = _op_key(op.type, op.outputs)
        self._forward(op)
        self.fwd_index[self.key] = op

    def record(self):
        """The :class:`_Record` of the forward op being rewritten."""
        return self.records.setdefault(self.key, _Record())

    def _forward(self, op):
        ins = [n for n in op.input_arg_names if n in self.split]
        t = op.type
        if t in ("lookup_table", "lookup_table_v2") and \
                op.input("W")[0] in self.split:
            return self.embedding(op)
        if not ins:
            self.out.append(op)
            for n in op.output_arg_names:
                self.split.pop(n, None)
            return
        rule = getattr(self, "rule_" + t, None)
        if rule is None:
            if t in _UNARY:
                rule = self.rule_unary
            elif t in _ELEMENTWISE:
                rule = self.rule_elementwise
            elif t in _ELEMENTWISE_OPT:
                rule = self.rule_optimizer
            else:
                self.fail(op, "no tp rule for this op")
        rule(op)

    def keep(self, op, outs):
        """Append ``op`` as is, its outputs split as ``outs`` says
        ({name: (dim, segs)}; the rest replicated), shapes re-inferred."""
        self.out.append(op)
        for n in op.output_arg_names:
            self.split.pop(n, None)
        self.split.update(outs)
        self.infer(op)

    def rule_unary(self, op):
        (x,) = [n for n in op.input_arg_names if n in self.split]
        d, s = self.split[x]
        if op.type == "softmax" and int(op.attrs.get("axis", -1)) % len(
                self.var(x).shape) == d:
            self.fail(op, "a softmax over the split dim")
        self.keep(op, {n: (d, s) for n in op.output_arg_names
                       if self.var(n).shape is not None
                       and len(self.var(n).shape) == len(self.var(x).shape)})

    def rule_elementwise(self, op):
        x, y = op.input("X")[0], op.input("Y")[0]
        xs, ys = self.split.get(x), self.split.get(y)
        xnd, ynd = len(self.var(x).shape), len(self.var(y).shape)
        axis = op.attrs.get("axis", -1)
        off = xnd - ynd if axis in (None, -1) else int(axis)
        if xs is None:
            self.fail(op, "a replicated X against a split Y")
        d, s = xs
        if ys is not None:
            if ys[0] + off != d or ys[1] != s:
                self.fail(op, "X and Y split on different dims")
        else:
            j = d - off
            yshape = self.var(y).shape
            if 0 <= j < ynd and yshape[j] not in (1,):
                self.fail(op, "a replicated Y spans the split dim")
        self.keep(op, {op.output("Out")[0]: (d, s)})

    def rule_sum(self, op):
        splits = {self.split.get(n) for n in op.input("X")}
        if len(splits) != 1:
            self.fail(op, "a sum of split and replicated terms")
        self.keep(op, {op.output("Out")[0]: splits.pop()})

    def rule_optimizer(self, op):
        p = op.input("Param")[0]
        if p not in self.split:
            self.fail(op, "a replicated parameter with split state")
        sp = self.split[p]
        shape = self.var(p).shape
        outs = {}
        for n in op.output_arg_names:
            if tuple(self.var(n).shape or ()) == tuple(shape):
                outs[n] = sp
        self.keep(op, outs)

    def rule_squared_l2_norm(self, op):
        # the local sum of squares, summed over the tp ranks
        self.partial_out(op, "Out")

    def partial_out(self, op, slot):
        """Append ``op`` with its ``slot`` output summed over the tp
        ranks by an ``mp_allreduce_sum`` (its grad the identity)."""
        full = op.output(slot)[0]
        part = self.new_var(full, full, "PART")
        op.outputs[slot] = [part]
        self.keep(op, {})
        self.emit("mp_allreduce_sum", {"X": [part]}, {"Out": [full]},
                  TP_ATTRS, op.attrs.get(OP_ROLE_KEY, OpRole.Forward))
        self.report["mp_allreduce_sum"] += 1
        self.split.pop(full, None)
        return part

    def identity_in(self, op, slot):
        """``op`` reads its ``slot`` input through ``c_identity``."""
        x = op.input(slot)[0]
        y = self.new_var(x, x, "IN")
        ident = self.emit("c_identity", {"X": [x]}, {"Out": [y]}, TP_ATTRS,
                          op.attrs.get(OP_ROLE_KEY, OpRole.Forward))
        self.report["c_identity"] += 1
        op.inputs[slot] = [y]
        self.record().identity_in[y] = (x, ident)

    def rule_mul(self, op):
        x, w = op.input("X")[0], op.input("Y")[0]
        xn = int(op.attrs.get("x_num_col_dims", 1))
        yn = int(op.attrs.get("y_num_col_dims", 1))
        ws, xs = self.split.get(w), self.split.get(x)
        wshape = self.var(w).shape
        if ws is not None and len(wshape) == 2 and yn == 1 and xs is None:
            if ws[0] == 1:                       # column split
                self.identity_in(op, "X")
                self.keep(op, {op.output("Out")[0]: (xn, ws[1])})
                return
        if ws is not None and len(wshape) == 2 and yn == 1 and ws[0] == 0 \
                and xs == (len(self.var(x).shape) - 1, 1) and \
                xn == len(self.var(x).shape) - 1 and ws[1] == 1:
            self.partial_out(op, "Out")           # row split
            return
        self.fail(op, "a split other than Megatron's column/row pair")

    def rule_matmul(self, op):
        x, w = op.input("X")[0], op.input("Y")[0]
        ws = self.split.get(w)
        tx = op.attrs.get("transpose_X", op.attrs.get("trans_x", False))
        ty = op.attrs.get("transpose_Y", op.attrs.get("trans_y", False))
        if ws is None or x in self.split or tx or \
                len(self.var(w).shape) != 2 or ws[1] != 1:
            self.fail(op, "only a replicated X times a split 2-D Y")
        n_dim = 0 if ty else 1                    # Y's output-column dim
        if ws[0] != n_dim:
            self.fail(op, "a contraction over the split dim of Y")
        self.identity_in(op, "X")
        full = op.output("Out")[0]
        local = self.new_var(full, full, "LOCAL")
        op.outputs["Out"] = [local]
        self.keep(op, {})
        concat = self.emit("c_concat", {"X": [local]}, {"Out": [full]},
                           dict(TP_ATTRS, axis=-1, nranks=self.tp),
                           op.attrs.get(OP_ROLE_KEY, OpRole.Forward))
        self.report["c_concat"] += 1
        self.split.pop(full, None)
        self.record().gathered_out.append(("Out", local, concat))

    rule_matmul_v2 = rule_matmul

    def embedding(self, op):
        w = op.input("W")[0]
        if self.split[w] != (0, 1):
            self.fail(op, "a table split other than on its rows")
        if op.attrs.get("is_sparse", False):
            self.fail(op, "is_sparse (SelectedRows) grads")
        if any(n in self.split for n in op.input("Ids")):
            self.fail(op, "split ids")
        op.type = "c_embedding"
        op.attrs["start_index"] = self.r * self.var(w).shape[0]
        self.partial_out(op, "Out")

    def rule_slice(self, op):
        x = op.input("Input")[0]
        d, s = self.split[x]
        axes = [int(a) % len(self.var(x).shape) for a in op.attrs["axes"]]
        dec = [int(a) for a in op.attrs.get("decrease_axis", []) or []]
        if d in dec:
            self.fail(op, "a slice that drops the split dim")
        out_d = d - sum(1 for a in dec if a < d)
        if d not in axes:
            self.keep(op, {op.output("Out")[0]: (out_d, s)})
            return
        i = axes.index(d)
        full = self.var(x).shape[d] * self.tp
        piece = full // s
        st, en = int(op.attrs["starts"][i]), int(op.attrs["ends"][i])
        st = st + full if st < 0 else min(st, full)
        en = en + full if en < 0 else min(en, full)
        if st % piece or en % piece or en <= st:
            self.fail(op, f"a slice [{st}, {en}) across the {s} piece(s) "
                          f"of {full}")
        lw = piece // self.tp
        starts, ends = list(op.attrs["starts"]), list(op.attrs["ends"])
        starts[i], ends[i] = st // piece * lw, en // piece * lw
        op.attrs["starts"], op.attrs["ends"] = starts, ends
        self.keep(op, {op.output("Out")[0]: (out_d, (en - st) // piece)})

    def rule_reshape2(self, op):
        x = op.input("X")[0]
        d, s = self.split[x]
        xshape = list(self.var(x).shape)
        gin = list(xshape)
        gin[d] *= self.tp
        attr = list(op.attrs["shape"])
        gout = [gin[i] if a == 0 else a for i, a in enumerate(attr)]
        if s != 1:
            if len(gout) == len(gin) and gout[:d + 1] == gin[:d + 1] \
                    and gout[d] != -1:
                attr[d] = 0 if attr[d] == 0 else attr[d] // self.tp
            else:
                self.fail(op, "a reshape of a piece-wise split dim")
            op.attrs["shape"] = attr
            self.keep(op, {op.output("Out")[0]: (d, s)})
            return
        chunk = int(np.prod(gin[d:]))
        j = None
        for k in range(len(gout)):
            tail = gout[k:]
            if -1 in tail:
                continue
            if int(np.prod(tail)) == chunk and gout[k] % self.tp == 0:
                j = k
                break
        if j is None:
            self.fail(op, f"a reshape {attr} of {gin} that moves the split")
        if attr[j] == 0:
            if j != d:
                self.fail(op, "a copied dim that is not the split one")
        else:
            attr[j] = attr[j] // self.tp
        op.attrs["shape"] = attr
        self.keep(op, {op.output("Out")[0]: (j, 1)})

    rule_reshape = rule_reshape2

    def rule_transpose2(self, op):
        x = op.input("X")[0]
        d, s = self.split[x]
        perm = [int(a) for a in op.attrs["axis"]]
        self.keep(op, {op.output("Out")[0]: (perm.index(d), s)})

    rule_transpose = rule_transpose2

    def rule_flash_attention(self, op, any_bias=False):
        for slot in ("Q", "K", "V"):
            if self.split.get(op.input(slot)[0]) != (1, 1):
                self.fail(op, "q, k and v must be split on their heads")
        b = op.input("Bias")
        if b and (b[0] in self.split or (
                not any_bias and self.var(b[0]).shape[1] != 1)):
            self.fail(op, "a bias that is not a [B, 1, ., S] key bias")
        out = op.output("Out")[0]
        self.out.append(op)
        self.var(out).shape = self.var(op.input("Q")[0]).shape
        self.split[out] = (1, 1)

    def rule_ring_attention(self, op):
        """The sequence-parallel ops take the rank's heads as the flash
        op does; a mask that is per head cannot follow."""
        b = op.input("Bias")
        if b and self.var(b[0]).shape[1] != 1:
            self.fail(op, "a [B, H, S, S] mask under a split of the heads")
        self.rule_flash_attention(op, any_bias=True)

    rule_ulysses_attention = rule_ring_attention

    def rule_pipeline(self, op):
        """A replicated region: every tp rank runs the stage whole, as
        the JAX op's ``shard_map`` does, so a split input is gathered
        whole first (``c_concat``; its grad the rank's slice) and the
        output is whole. The stage sub-block is not rewritten."""
        ins = {}
        for slot, names in op.inputs.items():
            ins[slot] = list(names)
            for i, n in enumerate(names):
                if n not in self.split:
                    continue
                d, segs = self.split[n]
                if segs != 1:
                    self.fail(op, "a piece-wise split input")
                y = self.new_var(n, n, "WHOLE")
                shape = list(self.var(n).shape)
                shape[d] *= self.tp
                self.var(y).shape = tuple(shape)
                concat = self.emit(
                    "c_concat", {"X": [n]}, {"Out": [y]},
                    dict(TP_ATTRS, axis=d, nranks=self.tp),
                    op.attrs.get(OP_ROLE_KEY, OpRole.Forward))
                self.report["c_concat"] += 1
                self.record().gathered_in[y] = (n, concat)
                ins[slot][i] = y
        op.inputs = ins
        self.keep(op, {})

    def rule_einsum(self, op):
        eq = op.attrs["equation"].replace(" ", "")
        lhs, rhs = eq.split("->")
        terms = lhs.split(",")
        names = op.input("Operands")
        letters = set()
        for n, term in zip(names, terms):
            if n in self.split:
                d, s = self.split[n]
                if s != 1 or "." in term:
                    self.fail(op, "a piece-wise split operand")
                letters.add(term[d])
        if len(letters) != 1:
            self.fail(op, "operands split on different letters")
        (L,) = letters
        for n, term in zip(names, terms):
            if L in term and self.split.get(n) != (term.index(L), 1):
                self.fail(op, f"an operand with {L!r} that is not split")
        if L in rhs:
            self.keep(op, {op.output("Out")[0]: (rhs.index(L), 1)})
        else:
            self.partial_out(op, "Out")

    # -- grad ops -------------------------------------------------------
    def grad(self, op):
        fwd = op.attrs["__fwd_op__"]
        key = _op_key(fwd["type"], fwd["outputs"])
        rec = self.records.get(key)
        new = self.fwd_index.get(key)
        touched = any(n in self.split for n in op.input_arg_names)
        if new is None and touched:
            self.fail(op, "a grad op whose forward op is not in the block")
        if new is not None and (touched or rec is not None):
            op.type = new.type + "_grad"
            op.attrs["__fwd_op__"] = new.to_dict()
        idents = rec.identity_in if rec is not None else {}
        wholes = rec.gathered_in if rec is not None else {}
        if rec is not None:
            # the grad op reads what its forward op read (the identity's
            # output: the same values; a gathered input: the whole)
            fin = new.inputs
            for slot, names in op.inputs.items():
                if slot in fin and len(fin[slot]) == len(names):
                    op.inputs[slot] = [y if y in idents or y in wholes
                                       else n
                                       for n, y in zip(names, fin[slot])]
            for slot, local, concat in rec.gathered_out:
                gs = op.inputs.get(slot + "@GRAD")
                if not gs:
                    continue
                g_local = self.new_var(gs[0], local, "GRAD")
                self.emit("c_concat_grad",
                          {"X": [local], "Out@GRAD": [gs[0]]},
                          {"X@GRAD": [g_local]},
                          {"__fwd_op__": concat.to_dict(),
                           "__grad_inputs__": {"X": [True]},
                           "__out_grad_mask__": {"Out": [True]}},
                          OpRole.Backward)
                op.inputs[slot + "@GRAD"] = [g_local]
        elif not touched:
            self.out.append(op)
            for n in op.output_arg_names:
                self.split.pop(n, None)
            return
        fwd = op.attrs["__fwd_op__"]
        self.out.append(op)
        after = []
        for slot, names in fwd["inputs"].items():
            gnames = op.outputs.get(slot + "@GRAD")
            if not gnames:
                continue
            for i, (x, g) in enumerate(zip(names, gnames)):
                if g == EMPTY:
                    continue
                self.var(g).shape = self.var(x).shape
                if x in idents:
                    # the partial grad of the identity's output, summed
                    # over tp into the grad of its input
                    src, ident_op = idents[x]
                    g_part = self.new_var(g, g, "PART")
                    gnames[i] = g_part
                    after.append(Operator(
                        self.block, "c_identity_grad",
                        {"X": [src], "Out@GRAD": [g_part]},
                        {"X@GRAD": [g]},
                        {"__fwd_op__": ident_op.to_dict(),
                         "__grad_inputs__": {"X": [True]},
                         "__out_grad_mask__": {"Out": [True]},
                         OP_ROLE_KEY: OpRole.Backward}))
                    self.split.pop(g, None)
                elif x in wholes:
                    # the whole grad, cut to the rank's slice
                    src, concat = wholes[x]
                    g_whole = self.new_var(g, x, "WHOLE")
                    gnames[i] = g_whole
                    after.append(Operator(
                        self.block, "c_concat_grad",
                        {"X": [src], "Out@GRAD": [g_whole]},
                        {"X@GRAD": [g]},
                        {"__fwd_op__": concat.to_dict(),
                         "__grad_inputs__": {"X": [True]},
                         "__out_grad_mask__": {"Out": [True]},
                         OP_ROLE_KEY: OpRole.Backward}))
                    self.var(g).shape = self.var(src).shape
                    self.split[g] = self.split[src]
                elif x in self.split:
                    self.split[g] = self.split[x]
                else:
                    self.split.pop(g, None)
        self.out.extend(after)

    def run(self):
        self.plan()
        if not self.layouts:
            return {}
        for op in list(self.block.ops):
            if op.type == "recompute_barrier":
                raise not_ported("recompute (RecomputeOptimizer)")
            if op.type != "pipeline" and (
                    op.attrs.get("sub_block") is not None or
                    op.attrs.get("sub_block_true") is not None):
                if any(n in self.split for n in op.input_arg_names):
                    self.fail(op, "a control-flow op")
            if "__fwd_op__" in op.attrs:
                self.grad(op)
            else:
                self.forward(op)
        self.block.ops = self.out
        self.program._bump_version()
        return self.layouts


def tp_rewrite(program, mesh, tp_rank=None):
    """Rewrite ``program`` in place for rank ``tp_rank`` (this rank's tp
    coordinate by default) of ``mesh``'s tp axis; returns ``{name:
    Layout}`` of the split persistables (empty at tp 1)."""
    from .mesh import axis_size
    tp = axis_size(mesh, "tp")
    if tp == 1:
        return {}
    r = mesh.coords()["tp"] if tp_rank is None else int(tp_rank)
    rw = _Rewriter(program, mesh, tp, r)
    layouts = rw.run()
    program._tp_report = dict(rw.report)
    return layouts


__all__ = ["Layout", "gather_tensor", "gathered", "local_shape",
           "place_shards", "shard_tensor", "tp_rewrite"]
