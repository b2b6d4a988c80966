"""Pipeline stage builder, the user surface of the ``pipeline`` op (a
copy of ``paddle_tpu/layers/pipeline.py:27-130``).

One UNIFORM stage sub-block stands for every stage; each parameter
created inside it is re-stacked to a leading ``[num_stages]`` dim with
``dist_attr ("pp",)`` (its startup init too, whose bounds stay
per-stage), and the op runs the GPipe schedule of
``ops/pipeline_ops.py`` over the ``pp`` axis, or the stages in turn
without one.

    pipe = layers.Pipeline(num_stages=4, num_microbatches=8)
    with pipe.stage():
        h = pipe.stage_input(x)           # x: [B, ...], B % M == 0
        y = layers.fc(h, d, act="relu")   # stage params auto-stacked
        pipe.stage_output(y)              # same shape/dtype as input
    out = pipe()                          # [B, ...]
"""
import contextlib

from ..framework import unique_name
from ..framework.core import Parameter, default_startup_program
from .control_flow import _outer_reads
from .layer_helper import LayerHelper


class Pipeline:
    def __init__(self, num_stages, num_microbatches, name=None):
        assert num_stages >= 1 and num_microbatches >= 1
        self.num_stages = int(num_stages)
        self.num_microbatches = int(num_microbatches)
        self.helper = LayerHelper("pipeline", name=name)
        self._block = None
        self._input = None       # (outer var, inner var)
        self._out_inner = None
        self._out_var = None

    @contextlib.contextmanager
    def stage(self):
        program = self.helper.main_program
        self._parent = program.current_block()
        params_before = set(program.global_block().vars)
        self._block = program._create_block()
        try:
            yield
        except BaseException:
            program._rollback()
            raise
        else:
            program._rollback()
            self._complete(params_before)

    def stage_input(self, x):
        assert self._block is not None, "call inside `with pipe.stage():`"
        assert x.shape and x.shape[0] not in (None, -1), \
            "pipeline needs a static batch dim"
        assert x.shape[0] % self.num_microbatches == 0, \
            f"batch {x.shape[0]} % num_microbatches " \
            f"{self.num_microbatches} != 0"
        assert self._input is None, "pipeline takes ONE stage_input"
        mb = x.shape[0] // self.num_microbatches
        iv = self._block.create_var(
            name=unique_name.generate(f"{self.helper.name}.stage_in"),
            shape=(mb,) + tuple(x.shape[1:]), dtype=x.dtype)
        self._input = (x, iv)
        return iv

    def stage_output(self, o):
        assert self._block is not None, "call inside `with pipe.stage():`"
        assert self._out_inner is None, "pipeline takes ONE stage_output"
        self._out_inner = o

    def _stack_param(self, program, param):
        """Give a stage-created param a leading [S] dim sharded over pp and
        patch its startup init ops (bounds were computed from the per-stage
        shape, so each stage slice keeps the right fan-in/out init). The
        ops' attrs are replaced, never mutated: a copied op may share
        them."""
        S = self.num_stages
        old_shape = tuple(param.shape)
        param.shape = (S,) + old_shape
        param.dist_attr = ("pp",)
        startup = default_startup_program().global_block()
        sv = startup.vars.get(param.name)
        if sv is not None:
            sv.shape = (S,) + old_shape
            sv.dist_attr = ("pp",)
        for op in startup.ops:
            if param.name in op.output_arg_names and "shape" in op.attrs:
                op.attrs = dict(op.attrs, shape=[S] + list(old_shape))

    def _complete(self, params_before):
        program = self.helper.main_program
        parent = self._parent
        assert self._input is not None, "pipeline needs stage_input(x)"
        assert self._out_inner is not None, "pipeline needs stage_output(y)"
        x, iv = self._input
        out_inner = self._out_inner
        if tuple(out_inner.shape or ()) != tuple(iv.shape or ()) or \
                out_inner.dtype != iv.dtype:
            raise ValueError(
                f"pipeline stage must preserve shape/dtype (uniform chain): "
                f"in {iv.shape}/{iv.dtype} vs out "
                f"{out_inner.shape}/{out_inner.dtype}")

        gblock = program.global_block()
        new_params = [v for n, v in gblock.vars.items()
                      if n not in params_before and isinstance(v, Parameter)]
        reads = _outer_reads(program, self._block.idx,
                             exclude=[iv.name])
        p_names = [p.name for p in new_params]
        r_names = [n for n in reads if n not in p_names]
        for p in new_params:
            self._stack_param(program, p)

        out = parent.create_var(
            name=unique_name.generate(f"{self.helper.name}.out"),
            shape=x.shape, dtype=x.dtype)
        parent.append_op(
            type="pipeline",
            inputs={"X": [x], "P": p_names, "R": r_names},
            outputs={"Out": [out]},
            attrs={"sub_block": self._block.idx,
                   "num_stages": self.num_stages,
                   "num_microbatches": self.num_microbatches,
                   "x_name": iv.name, "out_name": out_inner.name,
                   "p_names": p_names, "r_names": r_names},
            infer_shape=False)
        self._out_var = out

    def __call__(self):
        assert self._out_var is not None, "finish `with pipe.stage():` first"
        return self._out_var
