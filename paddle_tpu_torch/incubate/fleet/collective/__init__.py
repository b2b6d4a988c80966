"""Fleet collective mode (counterpart of
``paddle_tpu/incubate/fleet/collective/__init__.py``; reference
python/paddle/fluid/incubate/fleet/collective/__init__.py — Collective
:64, CollectiveOptimizer :384, DistributedStrategy :334;
fleet_base.py:34).

One trainer process per card, as in the reference:
``fleet.init(role_maker)`` joins the process world
(``parallel.mesh.init_parallel_env``: NCCL on the card, gloo with the
launcher's ``--device=cpu``; rendezvous at trainer 0's endpoint).
``distributed_optimizer(opt).minimize(loss)`` builds the program as
usual, and ``fleet.main_program`` is its data-parallel
``CompiledProgram`` (the grad all-reduce the reference's transpiler
inserted as ``c_allreduce_sum`` ops, transpiler/collective.py:209, and
sync batch norm). ``fleet.startup_program`` is the startup program with
a ``c_broadcast`` from rank 0 of every persistable it initializes
appended, as the reference's collective transpiler ends it. Each trainer
feeds its own rows; a fetched loss is its rows' mean. Checkpoints are
written once, by rank 0, while every rank waits (``io``).
"""
from ..base.role_maker import PaddleCloudRoleMaker, RoleMakerBase


class DistributedStrategy:
    """Reference collective/__init__.py:334. ``forward_recompute`` (with
    ``recompute_checkpoints``) wraps the optimizer in
    ``RecomputeOptimizer``; the other knobs are kept for parity."""

    def __init__(self):
        self.mode = "collective"
        self.collective_mode = "grad_allreduce"
        self.nccl_comm_num = 1
        self.use_local_sgd = False
        self.local_sgd_steps = 1
        self.forward_recompute = False
        self.recompute_checkpoints = []
        self.use_amp = False
        self.amp_loss_scaling = 2 ** 15


class TrainStatus:
    """Reference collective/__init__.py:49 — the tiny restart token saved
    next to a checkpoint (recovery = reload last checkpoint + status)."""

    def __init__(self, epoch_no=-1):
        self._epoch_no = int(epoch_no)

    def next(self):
        return self._epoch_no + 1

    def __eq__(self, other):
        return isinstance(other, TrainStatus) and \
            self._epoch_no == other._epoch_no

    def __ne__(self, other):
        return not self == other


class Collective:
    def __init__(self):
        self._role_maker = None
        self._compiled = None
        self._origin_program = None
        self._startup = None
        self._strategy = None
        self._inited = False

    # -- lifecycle (fleet_base.py:34 contract) ---------------------------
    def init(self, role_maker=None):
        from ....parallel.mesh import init_parallel_env
        if role_maker is None:
            role_maker = PaddleCloudRoleMaker(is_collective=True)
        assert isinstance(role_maker, RoleMakerBase)
        self._role_maker = role_maker
        init_parallel_env(role_maker)
        self._inited = True

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def init_worker(self):
        pass

    def stop_worker(self):
        pass

    def distributed_optimizer(self, optimizer, strategy=None):
        assert self._inited, "call fleet.init(role) first"
        self._strategy = strategy or DistributedStrategy()
        return CollectiveOptimizer(self, optimizer, self._strategy)

    @property
    def main_program(self):
        assert self._compiled is not None, \
            "call distributed_optimizer(...).minimize(loss) first"
        return self._compiled

    @property
    def startup_program(self):
        """The startup program with rank 0's value of every persistable
        it initializes broadcast at its end (the minimized program's
        startup; the default startup before ``minimize``)."""
        if self._startup is not None:
            return self._startup
        from ....framework.core import default_startup_program
        return _with_broadcast(default_startup_program())

    def save_persistables(self, executor, dirname, main_program=None):
        from .... import io
        io.save_persistables(executor, dirname,
                             main_program or self._origin_program)

    # -- checkpoint-restart recovery (reference collective/__init__.py
    # :166 save_checkpoint/load_checkpoint with TrainStatus) -------------
    _KEEP_UNSET = object()

    def _saver(self, path, max_to_keep=_KEEP_UNSET):
        from .... import io
        # one saver per path: repeated async saves share the number
        # reservation and checkpoint_wait() joins every pending write;
        # only a save may change retention policy
        savers = getattr(self, "_savers", None)
        if savers is None:
            savers = self._savers = {}
        saver = savers.get(path)
        if saver is None:
            keep = None if max_to_keep is self._KEEP_UNSET else max_to_keep
            saver = savers[path] = io.CheckpointSaver(
                path, max_to_keep=keep, prefix="__paddle_checkpoint__")
        elif max_to_keep is not self._KEEP_UNSET:
            saver.max_to_keep = (None if max_to_keep is None
                                 else int(max_to_keep))
        return saver

    def save_checkpoint(self, executor, path, train_status,
                        main_program=None, fs=None, local_cache_path=None,
                        remain_all_checkpoint=True, max_to_keep=_KEEP_UNSET,
                        async_save=False):
        """Numbered atomic checkpoint (``io.CheckpointSaver``) with the
        train status beside it, written by rank 0 while every rank
        waits. ``async_save`` snapshots now and writes on a background
        thread — call ``checkpoint_wait()`` before exiting.
        ``max_to_keep`` prunes old checkpoints (``remain_all_checkpoint=
        False`` is the legacy spelling of ``max_to_keep=1``)."""
        if not remain_all_checkpoint:
            max_to_keep = 1
        saver = self._saver(path, max_to_keep=max_to_keep)
        extra = {"train_status.json":
                 {"epoch_no": train_status._epoch_no}}
        kwargs = dict(main_program=main_program or self._origin_program,
                      extra_files=extra)
        if async_save:
            return saver.save_async(executor, **kwargs)
        return saver.save(executor, **kwargs)

    def checkpoint_wait(self):
        """Join pending async checkpoint writes (re-raises failures)."""
        for saver in getattr(self, "_savers", {}).values():
            saver.wait()

    def load_checkpoint(self, executor, path, trainer_id=0,
                        main_program=None, fs=None, local_cache_path=None,
                        ignore_empty=True):
        """Load the newest checkpoint on every rank; returns its
        ``TrainStatus`` (epoch -1 when there is none and
        ``ignore_empty``)."""
        import json
        import os
        from .... import io
        saver = self._saver(path)
        no, ckpt = saver.latest()
        if no is None:
            if ignore_empty:
                return TrainStatus(-1)
            raise RuntimeError(f"no checkpoint under {path}")
        io.load_checkpoint(executor, ckpt,
                           main_program=main_program or
                           self._origin_program)
        io._verify_against_manifest(ckpt, "train_status.json",
                                    io._read_manifest(ckpt))
        with open(os.path.join(ckpt, "train_status.json")) as f:
            return TrainStatus(json.load(f)["epoch_no"])

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from .... import io
        io.save_inference_model(dirname, feeded_var_names, target_vars,
                                executor,
                                main_program or self._origin_program)


def _with_broadcast(startup):
    """A clone of ``startup`` ending with one ``c_broadcast`` from rank 0
    per persistable it writes."""
    from ....framework.core import OP_ROLE_KEY, OpRole
    prog = startup.clone()
    block = prog.global_block()
    written = []
    for op in block.ops:
        for n in op.output_arg_names:
            if block.has_var(n) and block.var(n).persistable \
                    and n not in written:
                written.append(n)
    for n in written:
        block.append_op(type="c_broadcast", inputs={"X": [n]},
                        outputs={"Out": [n]},
                        attrs={"ring_id": 0, "root": 0,
                               OP_ROLE_KEY: OpRole.Forward},
                        infer_shape=False)
    return prog


class CollectiveOptimizer:
    """Reference CollectiveOptimizer (collective/__init__.py:384):
    minimize, then compile the program for the process world."""

    def __init__(self, fleet_obj, inner, strategy):
        self._fleet = fleet_obj
        self._inner = inner
        self._strategy = strategy

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ....framework.core import default_startup_program
        from ....optimizer import RecomputeOptimizer
        from ....parallel.compiler import CompiledProgram

        inner = self._inner
        if self._strategy.forward_recompute:
            inner = RecomputeOptimizer(inner)
            inner._set_checkpoints(self._strategy.recompute_checkpoints)
        result = inner.minimize(loss, startup_program, parameter_list,
                                no_grad_set)
        program = loss.block.program
        self._fleet._origin_program = program
        self._fleet._startup = _with_broadcast(
            startup_program or default_startup_program())
        self._fleet._compiled = CompiledProgram(program).with_data_parallel(
            loss_name=loss.name)
        return result

    def __getattr__(self, item):
        return getattr(self._inner, item)


fleet = Collective()

# virtual subclasses of the fleet ABC contract (base/fleet_base.py)
from ..base.fleet_base import Fleet as _Fleet  # noqa: E402
from ..base.fleet_base import DistributedOptimizer as _DO  # noqa: E402
_Fleet.register(Collective)
_DO.register(CollectiveOptimizer)
