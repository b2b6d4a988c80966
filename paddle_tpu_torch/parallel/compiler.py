"""CompiledProgram: a program made data-, tensor-, sequence-, pipeline-
and expert-parallel, and multi-slice, over the process world.

Counterpart of ``paddle_tpu/parallel/compiler.py`` (reference
python/paddle/fluid/compiler.py:158 and the C++ ParallelExecutor,
parallel_executor.cc:442). The JAX package attaches a mesh and lets
GSPMD insert the gradient all-reduces into one program over the global
batch. The port runs one process per card (``parallel.mesh``):
``with_data_parallel`` rewrites a clone of the program, never the
user's, so that N ranks, each fed its own rows of a global batch, end
every step with the same state the JAX package's one step over the whole
batch computes:

- every training ``batch_norm`` becomes ``sync_batch_norm`` (statistics
  over every rank's rows: what ``jnp.mean`` over a sharded batch is under
  GSPMD), with or without ``BuildStrategy.sync_batch_norm``;
- every parameter grad is summed over the ranks and scaled by 1/N after
  its last producer (pass ``dp_grad_allreduce``, in coalesced buckets),
  before anything reads it.

Over a ``dp`` x ``tp`` mesh (``make_mesh(MeshConfig(dp=2, tp=2))``) the
program is first rewritten for the rank's tp coordinate (pass
``tp_shard``, ``parallel.tp``): each parameter annotated on ``tp`` and
its optimizer state become the rank's shard, Megatron's collectives go
in around the split matmuls; the grads are then summed over the rank's
dp group only and scaled by 1/dp. The executor cuts each rank's shard
out of a whole value before a run reads it (``_place_shards``: the
startup's values, a load's), and a save gathers them back.

Over a mesh with an ``sp`` axis (``MeshConfig(dp=2, sp=2)``) pass
``sp_shard`` then splits the activations' sequence dim per rank from the
first ``sp`` constraint (``parallel.sp``); the grads are summed over the
rank's dp x sp group (``dp_sp``, the ranks of its tp coordinate) and
scaled by 1/(dp*sp). No state is split by sp.

Over a mesh with a ``pp`` axis (``MeshConfig(pp=4)`` or ``pp=2, dp=2``)
pass ``pp_shard`` gives each rank its stage's ``[1, ...]`` slice of
every ``layers.Pipeline`` parameter and accumulator (``parallel.pp``),
cut and gathered by the executor as tp shards are; the ``pipeline`` op
runs the rank's stage of the GPipe schedule. Every op outside the
pipeline runs on every pp rank alike, so the grads are summed over the
rank's dp group only and scaled by 1/dp (the stage slices differ from
pp rank to pp rank; the replicated grads are already equal on them).
Beside ``tp`` or ``sp`` (``MeshConfig(pp=2, tp=2)``) every tp and sp
rank of a pp coordinate runs its stage whole, so the stage slices'
grads are equal across tp and sp and are averaged over dp only, while
the grads outside the pipeline follow the tp and sp rules above.

Over a mesh with an ``ep`` axis (``MeshConfig(ep=4)`` or ``ep=2,
dp=2``) pass ``ep_shard`` gives each rank its ``[E / ep, ...]`` slice of
every ``switch_moe``'s experts and their accumulators
(``parallel.ep``), cut and gathered by the executor as tp shards are;
the ``switch_moe`` op routes the global batch's tokens to them
(``ops.moe_ops``). The ep ranks of one dp coordinate are fed the same
rows, so the grads are summed over the rank's dp group only and scaled
by 1/dp. Beside ``tp``, ``sp`` or ``pp`` (``MeshConfig(ep=2, tp=2)``)
``switch_moe`` is a replicated region: its input is whole (gathered
under sp, as for any op without a split rule), every tp and sp rank of a
(dp, ep) coordinate routes the same tokens over its ``dp_ep`` group, and
the expert slices stay whole across tp, sp and pp; the other grads
follow the tp, sp and pp rules above. A ``switch_moe`` inside a pipeline
stage under ep raises ``NotImplementedError`` (the JAX package refuses
it too).

Over a mesh with a ``dcn_dp`` axis (``MeshConfig(dcn_dp=2, dp=2)``: two
slices of two cards, the batch split over ``dcn_dp`` x ``dp``
dcn-major) pass ``hier_grad_sync`` puts one ``hier_allreduce`` after
each grad the optimizer reads, its readers rewired to ``<grad>@HIER``,
and ``dp_grad_allreduce`` leaves those grads alone: they are averaged
over ``dcn_dp`` x the ring they have without it (dp, dp x sp, or dp for
the stage slices). On a pure ``dcn_dp`` x ``dp`` mesh with
``FLAGS_dcn_hierarchical`` on the op decomposes (reduce-scatter over
dp, all-reduce of the 1/dp shard over dcn_dp, all-gather over dp);
beside tp, sp, pp or ep, or with the flag off, it is one all-reduce
over ``dcn_dp`` x the ring (the flat A/B baseline of the same program).
A mesh may span part of the world (``make_mesh(devices=...)``, the
narrower mesh after a slice is lost): its first run broadcasts from its
first rank over its ranks.

The executor runs such a program on each rank (``Executor.run``,
``run_steps`` as a captured CUDA graph with the all-reduces inside,
``train_from_dataset``): its first run on a scope broadcasts every
persistable it reads from rank 0 (``BCastParamsToDevices``), stochastic
ops fold the rank's data coordinate ``c * dp + d`` into their seeds (so
the pp ranks of one dp coordinate draw alike, and dcn_dp 2 x dp 2 draws
dp 4's masks), and the non-finite guard's counts are
all-reduced over the world so every rank commits or rolls back alike. Fetches are
the rank's own (a loss is the mean over its rows).
"""
import copy
import warnings
import weakref

from .mesh import (DATA_AXIS, DATA_GRAD_AXIS, GRAD_AXIS, activate,
                   axis_size, check_device, default_mesh, get_mesh,
                   init_parallel_env, rank)


class BuildStrategy:
    """Reference details/build_strategy.h:37. ``sync_batch_norm`` is
    accepted and changes nothing (a data-parallel program always
    synchronizes its batch norms); the rest warn when changed (see
    :meth:`CompiledProgram.with_data_parallel`)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_all_optimizer_ops = False
        self.fuse_elewise_add_act_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.num_trainers = 1
        self.trainer_id = 0
        self.sync_batch_norm = False


class ExecutionStrategy:
    """Reference details/execution_strategy.h:22 — retained for parity."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


# knobs the port does not honor: (default, why), warned when changed
_NOT_HONORED = {
    "reduce_strategy": (
        BuildStrategy.ReduceStrategy.AllReduce,
        "every rank all-reduces every grad; Reduce-mode parameter "
        "placement is not ported"),
    "fuse_all_reduce_ops": (
        True, "the grads are always all-reduced in coalesced buckets"),
    "fuse_all_optimizer_ops": (
        False, "the executor's fuse_optimizer pass (FLAGS_program_passes) "
        "fuses the optimizer ops"),
    "fuse_elewise_add_act_ops": (
        False, "the elementwise-add + activation fusion is not ported"),
    "enable_inplace": (
        True, "buffer reuse is the caching allocator's; the executor drops "
        "each var after its last reader"),
    "memory_optimize": (
        True, "the executor drops each var after its last reader"),
}


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self.program = program_or_graph
        self.mesh = None
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = None
        self.loss_name = None
        self._data_parallel = False
        self._synced = weakref.WeakSet()
        self._tp_layouts = {}

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, mesh=None):
        """Make the program data-parallel over the process world (joined
        here from the launcher's environment when no one joined it yet):
        a rewritten clone, as the module docstring says. ``places`` are
        the rank's own cards and do not size the world."""
        from ..framework.passes import apply_passes, get_pass
        self.loss_name = loss_name
        if build_strategy is not None:
            self.build_strategy = build_strategy
        self.exec_strategy = exec_strategy
        n = init_parallel_env()
        self.mesh = mesh or get_mesh() or default_mesh()
        if not self.mesh.partial and self.mesh.size != n:
            raise ValueError(f"{self.mesh} over a world of {n} ranks")
        if rank() not in self.mesh:
            raise ValueError(f"rank {rank()} is not in {self.mesh}")
        dp, tp = axis_size(self.mesh, "dp"), axis_size(self.mesh, "tp")
        sp, pp = axis_size(self.mesh, "sp"), axis_size(self.mesh, "pp")
        dcn = axis_size(self.mesh, "dcn_dp")
        bs = self.build_strategy
        if bs.gradient_scale_strategy != \
                BuildStrategy.GradientScaleStrategy.CoeffNumDevice:
            warnings.warn(
                "gradient_scale_strategy One/Customized is not honored: "
                "the grads are averaged over the ranks (CoeffNumDevice), "
                "which for a batch-mean loss is the global batch's grad; "
                "rescale the loss in the program instead", stacklevel=2)
        for knob, (default, why) in _NOT_HONORED.items():
            if getattr(bs, knob, default) != default:
                warnings.warn("BuildStrategy.%s=%r has no effect: %s"
                              % (knob, getattr(bs, knob), why),
                              stacklevel=2)
        prog = self.program.clone()
        activate(self.mesh)       # the verifier sizes c_concat by it
        passes = []
        if tp > 1:
            passes.append(get_pass("tp_shard", mesh=self.mesh))
        if sp > 1:
            passes.append(get_pass("sp_shard", mesh=self.mesh))
        if pp > 1:
            passes.append(get_pass("pp_shard", mesh=self.mesh))
        if axis_size(self.mesh, "ep") > 1:
            passes.append(get_pass("ep_shard", mesh=self.mesh))
        if any(op.type == "batch_norm"
               for blk in prog.blocks for op in blk.ops):
            passes.append("sync_batch_norm")
        if dcn > 1:
            # the grads the optimizer reads: hier_allreduce over dcn_dp x
            # the ring below; a stage slice's grad over dcn_dp x dp
            passes.append(get_pass(
                "hier_grad_sync", inner_axis=GRAD_AXIS if sp > 1 else "dp",
                stage_ring="dp" if sp > 1 else None))
        # a stage slice's grad is equal on the sp ranks: over dp alone
        # (and what no hier_allreduce syncs over dcn_dp x dp)
        ring, grad_ring = ("dp", GRAD_AXIS) if dcn == 1 else \
            (DATA_AXIS, DATA_GRAD_AXIS)
        passes.append(get_pass(
            "dp_grad_allreduce", nranks=dcn * dp * sp,
            axis_name=grad_ring if sp > 1 else (None if dcn == 1 else ring),
            stage_ring=(ring, dcn * dp) if sp > 1 else None))
        self.program = prog = apply_passes(prog, passes)
        self._tp_layouts = dict(getattr(prog, "_tp_layouts", {}),
                                **getattr(prog, "_pp_layouts", {}),
                                **getattr(prog, "_ep_layouts", {}))
        self._data_parallel = True
        return self

    def with_inference_optimize(self, config=None):
        self.program = self.program.clone(for_test=True)
        return self

    def _compile(self, *args, **kwargs):
        return self

    def _prepare(self, device):
        """The program to run on ``device`` (checked against the world's
        backend for a data-parallel program, whose collectives then
        resolve their axes against its mesh)."""
        if self._data_parallel:
            check_device(device)
        activate(self.mesh if self._data_parallel else None)
        return self.program

    def _for_test(self):
        """This program's inference clone over the same mesh, state and
        first-run broadcast."""
        out = copy.copy(self)
        out.program = self.program.clone(for_test=True)
        return out

    def _sync_once(self, scope, names):
        """Broadcast ``names`` (the scope state a step reads) from rank 0,
        on the first run of this program on ``scope``; the run seed
        too, so every rank's checkpoints agree. A whole value goes from
        world rank 0 (before the ranks take their tp shards and pp
        slices), a shard a scope already holds from the first rank of
        the ranks that hold the same one (its dcn_dp x dp group, or its
        dcn_dp x dp x sp group). On a mesh over part of the world, from
        the mesh's first rank over its ranks."""
        from .mesh import is_initialized
        if not (self._data_parallel and is_initialized()) \
                or scope in self._synced:
            return
        import torch
        from ..framework.executor import RNG_STATE_NAME
        from ..ops.collective_ops import broadcast_
        same = DATA_GRAD_AXIS if self.mesh.sp > 1 else DATA_AXIS
        for n in names:
            val = scope.find_var(n)
            if isinstance(val, torch.Tensor):
                lay = self._tp_layouts.get(n)
                whole = lay is None or tuple(val.shape) == \
                    tuple(lay.full_shape)
                broadcast_(val, 0, None if whole else same, self.mesh)
        seed = scope.find_var(RNG_STATE_NAME)
        if seed is not None:
            dev = next((v.device for v in (scope.find_var(n)
                                           for n in names)
                        if isinstance(v, torch.Tensor)), None)
            t = torch.tensor([int(seed)], dtype=torch.int64, device=dev)
            scope.set(RNG_STATE_NAME,
                      int(broadcast_(t, 0, None, self.mesh)[0]))
        self._synced.add(scope)

    def _place_shards(self, scope, names):
        """Each whole value among ``names`` that the tp rewrite split,
        replaced in ``scope`` by this rank's shard (every run: a load
        puts whole values back)."""
        if self._tp_layouts:
            from .tp import place_shards
            place_shards(scope, self._tp_layouts, names, self.mesh)


class ParallelExecutor:
    """Legacy multi-device executor front (reference
    parallel_executor.py ParallelExecutor, itself a wrapper over
    CompiledProgram since 1.6): a data-parallel CompiledProgram run
    through an internal Executor on this rank's card (the CPU with
    ``use_cuda=False``)."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from ..framework.core import CPUPlace, default_main_program
        from ..framework.executor import Executor, global_scope
        program = main_program or default_main_program()
        self._compiled = CompiledProgram(
            program, build_strategy=build_strategy).with_data_parallel(
                loss_name=loss_name, exec_strategy=exec_strategy,
                share_vars_from=getattr(share_vars_from, "_compiled",
                                        share_vars_from))
        self._exe = Executor(None if use_cuda else CPUPlace())
        self._scope = scope or global_scope()

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        return self._exe.run(self._compiled,
                             feed=feed if feed is not None else feed_dict,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)

    def drop_local_exe_scopes(self):
        """Reference ParallelExecutor.drop_local_exe_scopes: a rank has no
        local scopes to drop."""


__all__ = ["BuildStrategy", "CompiledProgram", "ExecutionStrategy",
           "ParallelExecutor"]
