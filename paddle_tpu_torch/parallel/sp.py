"""Sequence parallelism over the ``sp`` axis: the per-rank rewrite of a
program (pass ``sp_shard``).

The JAX package pins activations to ``("dp", "sp", None)``
(``layers.collective.shard``) and GSPMD splits the sequence dim and
gathers it where an op needs it whole. The port runs one process per
card, so :func:`sp_rewrite` does that per rank. It tracks which tensor
holds this rank's chunk of its sequence dim, and on which dim:

- **Where the split starts.** The first ``sharding_constraint`` that
  names ``sp`` becomes ``sp_split``: the rank takes its chunk (index
  ``s`` of ``n``) of that dim. Feeds, embeddings and the attention bias
  stay whole; each rank is fed its dp rows, as without sp.
- **Ops that follow the split** run on the chunk: per-token ops (``mul``
  and fc, elementwise and unary ops, ``layer_norm``, ``dropout``), and
  ``reshape``, ``transpose`` and ``slice`` with the split dim tracked
  through them (a reshape's target shape is rewritten to the local
  size). ``ring_attention`` and ``ulysses_attention`` take split Q/K/V
  (attr ``sp_split``); whole ones are split first, and their output
  gathered.
- **Ops that need the whole sequence.** An ``einsum`` reads its other
  operands gathered where their split letter is not the output's first
  split one (plain attention's scores are ``[B, n, S/sp, S]``);
  ``flash_attention`` reads K and V gathered (K1 with the local queries
  against the whole keys and key bias; causal raises
  ``NotImplementedError``: the kernels take no query offset). Any op
  without a rule reads its split inputs gathered (``sp_gather``): the
  MLM and NSP heads after the encoder, the loss, and a ``pipeline`` op,
  whose stage every sp rank runs whole (``parallel.pp``; the stage
  sub-block is not rewritten).
- **Dropout** in the split region draws the mask of the whole tensor at
  the rank's dp fold and keeps its chunk (attr ``sp_chunk``), so an sp
  run with dropout equals the one-rank run of the same rows; in the
  whole region every sp rank draws the same mask.

**The conjugate collectives and the grad scaling.** Every rank of an sp
group computes the whole loss after the gathers. Chosen so that both
every parameter grad equals the one-card step's and a fetched grad of a
whole tensor equals the JAX package's:

- the grad of ``sp_gather`` (a split tensor gathered) is the
  reduce-scatter (sum) of the ranks' whole grads; so inside the split
  region every cotangent carries a factor ``n``;
- the grad of ``sp_split`` (the chunk of a whole tensor) is the
  all-gather of the chunks' grads divided by ``n``, which takes the
  factor out again: the grad of a whole tensor is the one-card grad on
  every rank;
- a whole tensor that is not a parameter and is read by a split op (a
  broadcast operand, a bias whose grad is wanted) goes through
  ``sp_replicate``: its grad, the ranks' partial grads summed and
  divided by ``n``;
- every parameter grad, a sum of a whole-region part (equal on every sp
  rank) and split-region parts (``n`` times the rank's share), is
  averaged over dp x sp (``with_data_parallel``'s ``dp_grad_allreduce``
  over the ``dp_sp`` axis, scaled ``1/(dp*sp)``).

Every grad op is rewritten with its forward op (``__fwd_op__``), the
conversions' grads go in beside it, and an op the rewrite cannot place
raises ``NotImplementedError``. No parameter or state is split. A
fetched tensor of the split region is the rank's chunk. The pass runs
after ``tp_shard`` (heads split by tp, the sequence by sp).
"""
import collections

import numpy as np

from ..framework.core import OP_ROLE_KEY, OpRole, Operator
from .tp import _op_key

EMPTY = "@EMPTY@"
SP_ATTRS = {"ring_id": 0, "axis_name": "sp"}

# ops whose outputs follow the split of their one split input
_UNARY = {"scale", "gelu", "relu", "tanh", "sigmoid", "cast", "dropout",
          "assign", "exp", "sqrt", "square", "abs", "softmax", "log",
          "sharding_constraint", "silu", "leaky_relu", "clip", "erf",
          "c_identity", "mp_allreduce_sum", "layer_norm", "fill_any_like",
          "fill_zeros_like", "ones_like", "zeros_like", "rsqrt",
          "relu6", "swish", "hard_swish", "softplus", "sin", "cos"}
_ELEMENTWISE = {"elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div", "elementwise_max", "elementwise_min",
                "elementwise_pow"}
_SP_ATTENTION = ("ring_attention", "ulysses_attention")


def not_ported(what):
    from .mesh import not_ported_7b
    return not_ported_7b(f"sequence parallelism: {what}")


class _Record:
    """The conversions a forward op's rewrite put around it, for its
    grad op: ``ins`` {name the op reads: (the name it read, the
    conversion op)}, ``outs`` {name the op wrote: (the name it writes
    now, the conversion op)}."""

    def __init__(self):
        self.ins = {}
        self.outs = {}


class _Rewriter:
    def __init__(self, program, sp, r):
        self.program = program
        self.block = program.global_block()
        self.sp, self.r = int(sp), int(r)
        self.split = {}          # var name -> its split dim
        self.cache = {}          # (name, kind, dim) -> converted name
        self.records = {}
        self.fwd_index = {}      # original (type, outputs) -> op as run
        self.changed = set()     # keys of forward ops rewritten
        self.out = []
        self.counter = 0
        self.report = collections.Counter()
        self.grads_of = set()    # names some grad op computes a grad of

    # -- helpers --------------------------------------------------------
    def var(self, n):
        return self.block.var(n)

    def new_var(self, base, like, tag, shape=None):
        self.counter += 1
        name = f"{base}@SP_{tag}_{self.counter}"
        v = self.var(like)
        self.block.create_var(name=name,
                              shape=v.shape if shape is None else shape,
                              dtype=v.dtype, stop_gradient=v.stop_gradient)
        return name

    def fail(self, op, why):
        names = sorted(n for n in op.input_arg_names if n in self.split)
        raise not_ported(f"op {op.type!r} on the sp-split {names}: {why}")

    def global_shape(self, n):
        shape = list(self.var(n).shape)
        if n in self.split:
            shape[self.split[n]] *= self.sp
        return shape

    def local(self, shape, d):
        shape = list(shape)
        if shape[d] < 0 or shape[d] % self.sp:
            raise ValueError(f"sp={self.sp}: the sequence dim {d} of "
                             f"{tuple(shape)} is not divisible by the sp "
                             f"axis size")
        shape[d] //= self.sp
        return tuple(shape)

    def mark(self, name, d):
        """``name`` (declared whole) now holds the rank's chunk of dim
        ``d``."""
        self.var(name).shape = self.local(self.var(name).shape, d)
        self.split[name] = d

    def emit(self, type_, inputs, outputs, attrs, role):
        op = Operator(self.block, type_, inputs, outputs,
                      dict(attrs, **{OP_ROLE_KEY: role}))
        self.out.append(op)
        return op

    def record(self):
        return self.records.setdefault(self.key, _Record())

    def _convert(self, op, slot, i, kind, dim):
        x = op.inputs[slot][i]
        ck = (x, kind, dim)
        role = op.attrs.get(OP_ROLE_KEY, OpRole.Forward)
        if ck not in self.cache:
            if kind == "sp_split":
                shape = self.local(self.var(x).shape, dim)
            elif kind == "sp_gather":
                shape = self.global_shape(x)
            else:
                shape = None
            y = self.new_var(x, x, kind.upper()[3:], shape)
            attrs = dict(SP_ATTRS, nranks=self.sp)
            if dim is not None:
                attrs["dim"] = dim
            conv = self.emit(kind, {"X": [x]}, {"Out": [y]}, attrs, role)
            self.report[kind] += 1
            self.cache[ck] = (y, conv)
            if kind == "sp_split":
                self.split[y] = dim
        y, conv = self.cache[ck]
        # a new dict: a grad op's __fwd_op__ may share the old one
        names = list(op.inputs[slot])
        names[i] = y
        op.inputs = dict(op.inputs, **{slot: names})
        self.record().ins[y] = (x, conv)
        self.changed.add(self.key)
        return y

    def as_split(self, op, slot, i, dim):
        """``op`` reads input ``slot``[i] split on ``dim``."""
        x = op.inputs[slot][i]
        if x in self.split:
            if self.split[x] != dim:
                self.fail(op, f"{x!r} is split on dim {self.split[x]}, "
                              f"the op wants dim {dim}")
            return x
        return self._convert(op, slot, i, "sp_split", dim)

    def as_whole(self, op, slot, i):
        x = op.inputs[slot][i]
        if x not in self.split:
            return x
        return self._convert(op, slot, i, "sp_gather", self.split[x])

    def replicated(self, op, slot, i):
        """``op`` (a split op) reads the whole input ``slot``[i]: through
        ``sp_replicate`` where its grad is wanted and it is no
        parameter."""
        x = op.inputs[slot][i]
        v = self.var(x)
        if x in self.split or x not in self.grads_of or v.persistable:
            return x
        return self._convert(op, slot, i, "sp_replicate", None)

    def gather_all(self, op):
        for slot, names in op.inputs.items():
            for i in range(len(names)):
                self.as_whole(op, slot, i)

    def keep(self, op, outs):
        """Append ``op``, its outputs split as ``outs`` says ({name:
        dim}; the rest whole) with their local shapes."""
        self.out.append(op)
        for n in op.output_arg_names:
            if n in self.split:       # written again: declared whole
                self.var(n).shape = tuple(self.global_shape(n))
                del self.split[n]
        for n, d in outs.items():
            self.mark(n, d)
        for n in op.output("XShape"):
            # reshape2/transpose2's [0, *X.shape] holder of a split X
            if op.input("X")[0] in self.split:
                self.var(n).shape = (0,) + tuple(
                    self.var(op.input("X")[0]).shape)

    def follow(self, op, d, x):
        """Outputs with ``x``'s whole size on dim ``d`` split on it."""
        size = self.global_shape(x)[d]
        outs = {}
        for n in op.output_arg_names:
            shape = self.var(n).shape
            if shape is not None and len(shape) > d and shape[d] == size:
                outs[n] = d
        self.keep(op, outs)

    # -- forward rules --------------------------------------------------
    def forward(self, op):
        self.key = _op_key(op.type, op.outputs)
        self.fwd_index[self.key] = op
        for n in op.output_arg_names:
            for ck in [ck for ck in self.cache if ck[0] == n]:
                del self.cache[ck]
        t = op.type
        if t in _SP_ATTENTION:
            return self.rule_sp_attention(op)
        if t == "sharding_constraint" and self._sp_dim(op) is not None:
            return self.rule_constraint(op)
        ins = [n for n in op.input_arg_names if n in self.split]
        if not ins:
            self.keep(op, {})
            return
        if t == "pipeline":
            # a replicated region (parallel.pp): every sp rank runs the
            # stage whole, on the whole sequence
            return self.rule_gather(op)
        if op.attrs.get("sub_block") is not None or \
                op.attrs.get("sub_block_true") is not None:
            self.fail(op, "a control-flow op")
        rule = getattr(self, "rule_" + t, None)
        if rule is None:
            if t in _UNARY:
                rule = self.rule_unary
            elif t in _ELEMENTWISE:
                rule = self.rule_elementwise
            else:
                rule = self.rule_gather
        rule(op)

    def rule_gather(self, op):
        """An op with no rule reads its split inputs whole."""
        self.gather_all(op)
        self.keep(op, {})

    def _sp_dim(self, op):
        spec = tuple(op.attrs.get("spec") or ())
        dims = [d for d, a in enumerate(spec) if a == "sp" or (
            isinstance(a, (tuple, list)) and "sp" in a)]
        if len(dims) > 1:
            raise not_ported(f"a sharding_constraint {spec} naming sp "
                             f"twice")
        return dims[0] if dims else None

    def rule_constraint(self, op):
        d = self._sp_dim(op)
        x = op.input("X")[0]
        if x in self.split:
            if self.split[x] != d:
                self.fail(op, f"a constraint on dim {d} of a tensor split "
                              f"on dim {self.split[x]}")
            self.keep(op, {op.output("Out")[0]: d})
            return
        # the split starts here: the rank's chunk of dim d
        op.type = "sp_split"
        op.attrs = {k: v for k, v in op.attrs.items() if k != "spec"}
        op.attrs.update(SP_ATTRS, dim=d, nranks=self.sp)
        self.changed.add(self.key)
        self.report["sp_split"] += 1
        self.keep(op, {op.output("Out")[0]: d})

    def rule_unary(self, op):
        splits = {n: self.split[n] for n in op.input_arg_names
                  if n in self.split}
        x = op.input("X")[0] if op.input("X") else None
        if x not in splits or len(splits) > 1:
            return self.rule_gather(op)
        d = splits[x]
        nd = len(self.var(x).shape)
        if op.type == "softmax" and int(op.attrs.get("axis", -1)) % nd == d:
            return self.rule_gather(op)
        if op.type == "layer_norm" and \
                int(op.attrs.get("begin_norm_axis", 1)) <= d:
            return self.rule_gather(op)
        for slot, names in op.inputs.items():
            for i in range(len(names)):
                if slot != "X":
                    self.replicated(op, slot, i)
        if op.type == "dropout" and not op.attrs.get("is_test", False) \
                and float(op.attrs.get("dropout_prob", 0.5)) > 0.0:
            # the whole tensor's mask at the dp fold, the rank's chunk
            op.attrs["sp_chunk"] = [d, self.sp, self.r]
            self.changed.add(self.key)
        self.follow(op, d, x)

    def rule_elementwise(self, op):
        x, y = op.input("X")[0], op.input("Y")[0]
        xnd, ynd = len(self.var(x).shape), len(self.var(y).shape)
        axis = op.attrs.get("axis", -1)
        off = xnd - ynd if axis in (None, -1) else int(axis)
        if x in self.split:
            d = self.split[x]
            j = d - off
            spans = 0 <= j < ynd and self.global_shape(y)[j] != 1
            if spans:
                self.as_split(op, "Y", 0, j)
            elif y in self.split:
                self.fail(op, "X and Y split on different dims")
            else:
                self.replicated(op, "Y", 0)
        else:
            j = self.split[y]
            d = j + off
            if not (0 <= d < xnd) or self.global_shape(x)[d] == 1:
                return self.rule_gather(op)
            self.as_split(op, "X", 0, d)
        self.keep(op, {op.output("Out")[0]: d})

    def rule_sum(self, op):
        splits = {self.split.get(n) for n in op.input("X")}
        if len(splits) != 1:
            self.fail(op, "a sum of split and whole terms")
        d = splits.pop()
        self.keep(op, {op.output("Out")[0]: d})

    def rule_mul(self, op):
        x, w = op.input("X")[0], op.input("Y")[0]
        xn = int(op.attrs.get("x_num_col_dims", 1))
        if w in self.split or x not in self.split or self.split[x] >= xn:
            return self.rule_gather(op)
        self.keep(op, {op.output("Out")[0]: self.split[x]})

    def rule_matmul(self, op):
        x, w = op.input("X")[0], op.input("Y")[0]
        tx = op.attrs.get("transpose_X", op.attrs.get("trans_x", False))
        xnd = len(self.var(x).shape)
        if w in self.split or x not in self.split or tx or \
                len(self.var(w).shape) != 2 or self.split[x] >= xnd - 1:
            return self.rule_gather(op)
        self.keep(op, {op.output("Out")[0]: self.split[x]})

    rule_matmul_v2 = rule_matmul

    def rule_slice(self, op):
        x = op.input("Input")[0]
        d = self.split[x]
        nd = len(self.var(x).shape)
        axes = [int(a) % nd for a in op.attrs["axes"]]
        dec = [int(a) % nd for a in op.attrs.get("decrease_axis", [])
               or []]
        if d in axes or d in dec:
            return self.rule_gather(op)
        self.keep(op, {op.output("Out")[0]:
                       d - sum(1 for a in dec if a < d)})

    def rule_reshape2(self, op):
        x = op.input("X")[0]
        d = self.split[x]
        gin = self.global_shape(x)
        attr = [int(a) for a in op.attrs["shape"]]
        gout = [gin[i] if a == 0 else a for i, a in enumerate(attr)]
        if -1 in gout:
            known = int(np.prod([a for a in gout if a != -1]))
            gout[gout.index(-1)] = int(np.prod(gin)) // known
        lead = int(np.prod(gin[:d]))
        # the out dim whose leading dims hold what the split dim's did,
        # and whose chunks are the split dim's (it is the split dim
        # merged with trailing dims, or its leading factor)
        j = next((k for k in range(len(gout))
                  if int(np.prod(gout[:k])) == lead and (
                      gout[k] % gin[d] == 0 or (
                          gin[d] % gout[k] == 0 and gout[k] % self.sp == 0))
                  and (attr[k] != 0 or k == d)), None)
        if j is None:
            return self.rule_gather(op)
        if attr[j] > 0:
            attr[j] //= self.sp
            op.attrs["shape"] = attr
            self.changed.add(self.key)
        self.keep(op, {op.output("Out")[0]: j})

    rule_reshape = rule_reshape2

    def rule_transpose2(self, op):
        x = op.input("X")[0]
        perm = [int(a) for a in op.attrs["axis"]]
        self.keep(op, {op.output("Out")[0]: perm.index(self.split[x])})

    rule_transpose = rule_transpose2

    def rule_einsum(self, op):
        eq = op.attrs["equation"].replace(" ", "")
        lhs, rhs = eq.split("->")
        terms = lhs.split(",")
        names = op.input("Operands")
        if "." in eq:
            return self.rule_gather(op)
        # the first split operand whose split letter survives leads
        lead = None
        for n, term in zip(names, terms):
            if n in self.split and term[self.split[n]] in rhs:
                lead = term[self.split[n]]
                break
        if lead is None:
            return self.rule_gather(op)
        for i, (n, term) in enumerate(zip(names, terms)):
            if lead in term:
                if n in self.split and term[self.split[n]] != lead:
                    self.fail(op, f"operand {i} is split on "
                                  f"{term[self.split[n]]!r}, not {lead!r}")
                self.as_split(op, "Operands", i, term.index(lead))
            elif n in self.split:
                self.as_whole(op, "Operands", i)
            else:
                self.replicated(op, "Operands", i)
        self.keep(op, {op.output("Out")[0]: rhs.index(lead)})

    def rule_flash_attention(self, op):
        q = op.input("Q")[0]
        if op.attrs.get("causal", False):
            raise not_ported(
                "a causal flash_attention under sp_shard: the kernels take "
                "no query offset (the rank's queries start at s * S/sp)")
        if q not in self.split:
            return self.rule_gather(op)
        if self.split[q] != 2:
            self.fail(op, "queries split on a dim other than the sequence")
        for slot in ("K", "V", "Bias"):
            if op.inputs.get(slot):
                self.as_whole(op, slot, 0)
        if op.inputs.get("Bias"):
            self.replicated(op, "Bias", 0)
        out = op.output("Out")[0]
        self.keep(op, {out: 2})

    def rule_sp_attention(self, op):
        q = op.input("Q")[0]
        B, H, S, D = self.global_shape(q)
        if S % self.sp or (op.type == "ulysses_attention" and H % self.sp):
            what = "S" if op.type == "ring_attention" else \
                "S and n_head"
            raise ValueError(
                f"{op.type}: {what} ({S}, {H} heads) must be divisible by "
                f"the sp axis size {self.sp} (pad the sequence or resize "
                f"the mesh)")
        split_in = any(op.input(s)[0] in self.split for s in "QKV")
        for slot in "QKV":
            self.as_split(op, slot, 0, 2)
        if op.inputs.get("Bias"):
            self.as_whole(op, "Bias", 0)
            self.replicated(op, "Bias", 0)
        op.attrs["sp_split"] = True
        self.changed.add(self.key)
        out = op.output("Out")[0]
        if split_in:
            self.keep(op, {out: 2})
            return
        # whole Q/K/V: the chunks in, the output gathered
        local = self.new_var(out, out, "LOCAL")
        op.outputs = dict(op.outputs, Out=[local])
        self.keep(op, {local: 2})
        conv = self.emit("sp_gather", {"X": [local]}, {"Out": [out]},
                         dict(SP_ATTRS, nranks=self.sp, dim=2),
                         op.attrs.get(OP_ROLE_KEY, OpRole.Forward))
        self.report["sp_gather"] += 1
        self.split.pop(out, None)
        self.record().outs[out] = (local, conv)

    # -- grad ops -------------------------------------------------------
    def grad(self, op):
        fwd = op.attrs["__fwd_op__"]
        key = _op_key(fwd["type"], fwd["outputs"])
        new = self.fwd_index.get(key)
        rec = self.records.get(key)
        touched = any(n in self.split for n in op.input_arg_names)
        if new is None:
            if touched:
                self.fail(op, "a grad op whose forward op is not in the "
                              "block")
            self.keep(op, {})
            return
        if key not in self.changed and not touched:
            self.keep(op, {})
            return
        role = op.attrs.get(OP_ROLE_KEY, OpRole.Backward)
        if key in self.changed:
            op.type = new.type + "_grad"
            op.attrs["__fwd_op__"] = new.to_dict()
        rec = rec or _Record()
        # the grad op reads what its forward op reads now
        for slot, names in fwd["inputs"].items():
            now = new.inputs.get(slot, names)
            got = op.inputs.get(slot)
            if got is None or len(got) != len(names):
                continue
            op.inputs = dict(op.inputs, **{slot: [
                b if b != a else g for a, b, g in zip(names, now, got)]})
        # a forward output now made by a conversion: its grad back to
        # the op's own output first
        for slot, names in fwd["outputs"].items():
            gs = list(op.inputs.get(slot + "@GRAD") or ())
            if not gs:
                continue
            op.inputs = dict(op.inputs, **{slot + "@GRAD": gs})
            mask = (op.attrs.get("__out_grad_mask__") or {}).get(
                slot, [True] * len(names))
            with_grad = [n for n, m in zip(names, mask) if m]
            for i, (n, g) in enumerate(zip(with_grad, gs)):
                if n not in rec.outs:
                    continue
                local, conv = rec.outs[n]
                g_local = self.new_var(g, local, "GRAD")
                self.grad_of(conv, local, g, g_local, role)
                self.split[g_local] = self.split[local]
                gs[i] = g_local
        self.out.append(op)
        after = []
        for slot, names in new.inputs.items():
            gnames = list(op.outputs.get(slot + "@GRAD") or ())
            if not gnames:
                continue
            op.outputs = dict(op.outputs, **{slot + "@GRAD": gnames})
            for i, (x, g) in enumerate(zip(names, gnames)):
                if g == EMPTY:
                    continue
                if x in rec.ins:
                    src, conv = rec.ins[x]
                    g_now = self.new_var(g, x, "GRAD")
                    gnames[i] = g_now
                    self.split.pop(g_now, None)
                    if x in self.split:
                        self.split[g_now] = self.split[x]
                    after.append((conv, src, g_now, g))
                    self.var(g).shape = self.var(src).shape
                    self.track(g, src)
                else:
                    self.var(g).shape = self.var(x).shape
                    self.track(g, x)
        for conv, src, g_now, g in after:
            self.grad_of(conv, src, g_now, g, role, after_op=True)

    def track(self, g, x):
        if x in self.split:
            self.split[g] = self.split[x]
        else:
            self.split.pop(g, None)

    def grad_of(self, conv, x, g_out, g_x, role, after_op=False):
        """The grad op of conversion ``conv`` (which read ``x``): ``g_x``
        from ``g_out``."""
        self.out.append(Operator(
            self.block, conv.type + "_grad",
            {"X": [x], "Out@GRAD": [g_out]}, {"X@GRAD": [g_x]},
            {"__fwd_op__": conv.to_dict(),
             "__grad_inputs__": {"X": [True]},
             "__out_grad_mask__": {"Out": [True]}, OP_ROLE_KEY: role}))

    def run(self):
        for op in self.block.ops:
            if "__fwd_op__" not in op.attrs:
                continue
            for slot, names in op.attrs["__fwd_op__"]["inputs"].items():
                gs = op.outputs.get(slot + "@GRAD") or []
                self.grads_of.update(n for n, g in zip(names, gs)
                                     if g != EMPTY)
        for op in list(self.block.ops):
            if op.type == "recompute_barrier":
                raise not_ported("recompute (RecomputeOptimizer)")
            if "__fwd_op__" in op.attrs:
                self.grad(op)
            else:
                self.forward(op)
        self.block.ops = self.out
        self.program._bump_version()
        return dict(self.report)


def sp_rewrite(program, mesh, sp_rank=None):
    """Rewrite ``program`` in place for rank ``sp_rank`` (this rank's sp
    coordinate by default) of ``mesh``'s sp axis; returns the count of
    each conversion op put in (empty at sp 1)."""
    from .mesh import axis_size
    sp = axis_size(mesh, "sp")
    if sp == 1:
        return {}
    r = mesh.coords()["sp"] if sp_rank is None else int(sp_rank)
    return _Rewriter(program, sp, r).run()


__all__ = ["sp_rewrite"]
