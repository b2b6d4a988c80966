"""Program IR: Program / Block / Operator / Variable.

A trimmed copy of ``paddle_tpu/framework/core.py``: the same Python
structure and the same ``to_dict()`` form, so a program built here is
the program the JAX package builds, op for op. What differs is what
runs it: ``framework/executor.py`` interprets a block op by op on torch
tensors instead of lowering it to one XLA module. A var's ``dist_attr``
(one mesh-axis name or None per dim) is kept and round-trips through
``to_dict``/``from_dict`` as there; pass ``tp_shard`` reads it.
"""
import contextlib
import copy

import numpy as np
import torch

from . import unique_name
from .dtype import convert_dtype

# Op role attribute (reference OpRole), read by clone(for_test=True).
OP_ROLE_KEY = "op_role"


class EnforceNotMet(RuntimeError):
    """fluid.core's enforcement-failure type (a copy of the JAX
    package's ``resilience.EnforceNotMet``)."""


class OpRole:
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 5
    Loss = 0x100
    Collective = 6


_op_role_stack = [OpRole.Forward]


@contextlib.contextmanager
def op_role_guard(role):
    """Ops created inside take ``role`` as their default op role."""
    _op_role_stack.append(role)
    try:
        yield
    finally:
        _op_role_stack.pop()


class VarType:
    LOD_TENSOR = "dense"
    LOD_TENSOR_ARRAY = "tensor_array"


class Variable:
    """A named tensor slot in a Block. ``shape`` may hold -1 for dynamic
    dims; concrete shapes come from the feed at run time."""

    def __init__(self, block, name, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, is_data=False,
                 type=VarType.LOD_TENSOR, lod_level=0, trainable=True,
                 initializer=None, dist_attr=None, **kwargs):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None \
            else None
        self.dist_attr = tuple(dist_attr) if dist_attr is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.lod_level = lod_level
        self.trainable = trainable
        self.initializer = initializer
        self.is_parameter = False
        self.error_clip = None

    def _set_error_clip(self, clip):
        """Clip this var's backward error signal
        (``clip.ErrorClipByValue``); ``append_backward`` applies it when
        the grad is finalized."""
        from ..clip import BaseErrorClipAttr
        if not isinstance(clip, BaseErrorClipAttr):
            raise TypeError(
                "error_clip must be a BaseErrorClipAttr instance")
        self.error_clip = clip

    def __repr__(self):
        return (f"Var(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    __str__ = __repr__

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype, "persistable": self.persistable,
            "stop_gradient": self.stop_gradient, "is_data": self.is_data,
            "type": self.type, "lod_level": self.lod_level,
            "trainable": self.trainable,
            "dist_attr": list(self.dist_attr) if self.dist_attr else None,
            "is_parameter": self.is_parameter,
        }


class Parameter(Variable):
    """A persistable, trainable Variable with an initializer."""

    def __init__(self, block, name, shape, dtype, initializer=None,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True, **kwargs):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         trainable=trainable, initializer=initializer,
                         **kwargs)
        self.regularizer = regularizer
        self.do_model_average = do_model_average
        self.need_clip = need_clip
        self.is_parameter = True
        self.optimize_attr = {"learning_rate":
                              kwargs.get("learning_rate", 1.0)}


class Operator:
    """One op invocation: type + named input/output var-name lists +
    attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        for k, v in self.attrs.items():
            if isinstance(v, Variable) or (
                    isinstance(v, (list, tuple))
                    and any(isinstance(e, Variable) for e in v)):
                raise TypeError(
                    f"op {type!r} attr {k!r} contains a Variable; op "
                    f"attributes are build-time constants")
        self.attrs.setdefault(OP_ROLE_KEY, _op_role_stack[-1])

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def set_attr(self, name, val):
        self.attrs[name] = val
        if self.block is not None:
            self.block.program._bump_version()

    def to_dict(self):
        attrs = {k: v.tolist() if isinstance(v, np.ndarray) else v
                 for k, v in self.attrs.items()}
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": attrs}

    def __repr__(self):
        return f"Op(type={self.type}, in={self.inputs}, out={self.outputs})"


class Block:
    """Ordered op list + var table; a control-flow op's sub-block names
    its enclosing block by ``parent_idx``, and a name it does not hold is
    looked up along that chain."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name=None, **kwargs):
        name = name or unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kwargs)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype, **kwargs):
        param = Parameter(self, name, shape, dtype, **kwargs)
        self.program.global_block().vars[name] = param
        return param

    def var(self, name):
        v = self.vars.get(name)
        if v is not None:
            return v
        if self.parent_block is not None:
            return self.parent_block.var(name)
        raise ValueError(f"Variable {name!r} not found in block {self.idx}")

    def has_var(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return True
            b = b.parent_block
        return False

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        return self._insert_op(len(self.ops), type, inputs, outputs, attrs,
                               infer_shape)

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None,
                   infer_shape=True):
        op = Operator(self, type, inputs=_normalize_io(inputs),
                      outputs=_normalize_io(outputs), attrs=attrs)
        self._assign_rng_seed(op)
        self.ops.insert(index, op)
        self.program._bump_version()
        if infer_shape:
            from .registry import infer_op_shapes
            infer_op_shapes(self, op)
        return op

    def _remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def _assign_rng_seed(self, op):
        """Every stochastic op gets a unique per-program seed; grad ops
        read the forward op's seed through ``__fwd_op__``, so forward and
        backward draw the same mask."""
        if "__rng_seed__" in op.attrs:
            return
        from .registry import OPS
        opdef = OPS.get(op.type)     # grad ops are not in OPS: no seed
        if opdef is not None and opdef.needs_rng:
            self.program._seed_counter += 1
            op.attrs["__rng_seed__"] = self.program._seed_counter

    def to_dict(self):
        return {
            "idx": self.idx, "parent_idx": self.parent_idx,
            "vars": {n: v.to_dict() for n, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }


def _normalize_io(io):
    """{slot: Variable | name | list of either} -> {slot: [names]}."""
    out = {}
    for slot, vals in (io or {}).items():
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        names = [v.name if isinstance(v, Variable) else str(v)
                 for v in vals if v is not None]
        if names:
            out[slot] = names
    return out


class Program:
    """A whole computation; block 0 is global. The two-program
    convention holds: the startup program initializes persistables, the
    main program trains. ``_uid`` (never reused, unlike ``id()``) and
    ``version`` (bumped by every op insertion, removal, attr set, clone
    and pass) key the executor's memo of optimized programs."""

    _uid_counter = 0

    def __init__(self):
        Program._uid_counter += 1
        self._uid = Program._uid_counter
        self._version = 0
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._seed_counter = 0
        self._params_grads = []
        self._is_test = False

    def _bump_version(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        """A new block under ``parent_idx`` (the current block by
        default), made current; :meth:`_rollback` returns to its
        parent."""
        parent_idx = (self.current_block_idx
                      if parent_idx is None else parent_idx)
        b = Block(self, len(self.blocks), parent_idx=parent_idx)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def clone(self, for_test=False):
        """Deep-copy the program. With ``for_test=True`` keep only
        Forward-role ops, set ``is_test`` attrs, and drop the vars no
        kept op references."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for name, var in blk.vars.items():
                nv = copy.copy(var)
                nv.block = nb
                nb.vars[name] = nv
            for op in blk.ops:
                if for_test and (op.attrs.get(OP_ROLE_KEY, 0) & 0xFF) \
                        not in (OpRole.Forward, OpRole.Dist,
                                OpRole.Collective):
                    continue
                nop = Operator(nb, op.type, op.inputs, op.outputs,
                               copy.deepcopy(op.attrs))
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p._seed_counter = self._seed_counter
        p.current_block_idx = 0
        p._is_test = for_test
        if for_test:
            p._drop_unreferenced_vars()
        p._bump_version()
        return p

    def _prune(self, targets, feeds=()):
        """Keep only the global-block ops needed to compute ``targets``
        from ``feeds`` (used by ``io.save_inference_model``; JAX
        ``Program._prune``): the graph is cut at the feed boundary, a
        kept control-flow op keeps its whole sub-block and every op
        producing what the sub-block reads, and vars no kept op
        references are dropped."""
        # what an op reads through its sub-blocks; dangling or cyclic
        # sub_block attrs are skipped (the verifier reports them)
        from .analysis import op_reads
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        feeds_set = {f.name if isinstance(f, Variable) else f for f in feeds}
        needed = {t.name if isinstance(t, Variable) else t for t in targets}
        keep = []
        for op in reversed(self.global_block().ops):
            if any(n in needed and n not in feeds_set
                   for n in op.output_arg_names):
                keep.append(op)
                needed.update(n for n in op_reads(self, op)
                              if n not in feeds_set)
        kept_ids = {id(o) for o in keep}
        p = self.clone()
        nb = p.global_block()
        # clone keeps op order, so ops match by position
        nb.ops = [nop for sop, nop in zip(self.global_block().ops, nb.ops)
                  if id(sop) in kept_ids]
        p._drop_unreferenced_vars(extra_keep=feeds_set | needed)
        p._bump_version()
        return p

    def _drop_unreferenced_vars(self, extra_keep=()):
        """Remove vars no op references, keeping ``extra_keep`` (feed
        and target names)."""
        from .analysis import has_sub_block
        referenced = set(extra_keep)
        for blk in self.blocks:
            for op in blk.ops:
                referenced.update(op.input_arg_names)
                referenced.update(op.output_arg_names)
                if has_sub_block(op):
                    # names a control-flow op binds inside its sub-block
                    for m in op.attrs.get("memories", ()):
                        referenced.update(m)
                    referenced.update(op.attrs.get("step_input_vars", ()))
                    referenced.update(op.attrs.get("x_names", ()))
        for blk in self.blocks:
            blk.vars = {n: v for n, v in blk.vars.items()
                        if n in referenced}

    def to_dict(self):
        return {"blocks": [b.to_dict() for b in self.blocks],
                "random_seed": self.random_seed}

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for name, vd in bd["vars"].items():
                vd = dict(vd)
                if vd.pop("is_parameter", False):
                    vd.pop("persistable", None)
                    var = Parameter(b, vd.pop("name"), vd.pop("shape"),
                                    vd.pop("dtype"),
                                    trainable=vd.pop("trainable", True))
                    for k, v in vd.items():
                        setattr(var, k, v)
                    var.dist_attr = (tuple(var.dist_attr)
                                     if var.dist_attr else None)
                else:
                    var = Variable(b, **vd)
                b.vars[name] = var
            for od in bd["ops"]:
                op = Operator(b, od["type"], od["inputs"], od["outputs"],
                              od["attrs"])
                b.ops.append(op)
                p._seed_counter = max(p._seed_counter,
                                      op.attrs.get("__rng_seed__", 0))
            p.blocks.append(b)
        return p

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append(f"-- block {blk.idx} (parent {blk.parent_idx}) --")
            lines.extend("  " + repr(op) for op in blk.ops)
        return "\n".join(lines)


# ---- default programs + guards ----
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


# ---- places: which torch device an Executor runs on ----
class CPUPlace:
    device = torch.device("cpu")

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace:
    def __init__(self, device_id=0):
        self.device_id = device_id
        self.device = torch.device("cuda", device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class CUDAPinnedPlace:
    """A label only: pinned host staging is torch's own affair."""

    def __repr__(self):
        return "CUDAPinnedPlace"


def grad_var_name(name):
    return name + "@GRAD"


@contextlib.contextmanager
def name_scope(prefix=None):
    """A prefix for the names of the vars and ops made inside; the
    counters stay shared with the enclosing generator, so names stay
    unique across scopes. It changes names only, never execution."""
    from . import unique_name as un
    old = un.generator
    new = un.UniqueNameGenerator(
        f"{old.prefix}{prefix}/" if prefix else old.prefix)
    new.ids = old.ids
    un.generator = new
    try:
        yield
    finally:
        un.generator = old


def require_version(min_version, max_version=None):
    """Raise unless ``min_version <= __version__ <= max_version``."""
    if not isinstance(min_version, str):
        raise TypeError("min_version must be str")
    if max_version is not None and not isinstance(max_version, str):
        raise TypeError("max_version must be str or None")

    def parse(v):
        parts = v.split(".")
        if not all(p.isdigit() for p in parts) or not 1 <= len(parts) <= 4:
            raise ValueError(f"invalid version string {v!r}")
        return tuple(int(p) for p in parts) + (0,) * (4 - len(parts))

    from .. import __version__
    installed = parse(__version__)
    if installed < parse(min_version):
        raise Exception(
            f"installed version {__version__} is lower than the "
            f"required min_version {min_version}")
    if max_version is not None and installed > parse(max_version):
        raise Exception(
            f"installed version {__version__} is higher than the "
            f"required max_version {max_version}")
