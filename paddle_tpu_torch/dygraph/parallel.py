"""dygraph.DataParallel (counterpart of ``paddle_tpu/dygraph/parallel.py``;
reference python/paddle/fluid/dygraph/parallel.py:223).

One process per card, as in the reference (``imperative/nccl_context.h:
61``): ``prepare_context`` joins the process world
(``parallel.mesh.init_parallel_env``, from the launcher's environment),
``DataParallel`` broadcasts the wrapped layer's parameters from rank 0
when it is made, folds the rank into the tracer's seed stream (each
rank's rows get their own dropout masks), and its
``apply_collective_grads`` packs the parameter grads into one flat
buffer per dtype, all-reduces it (sum) and puts each grad back. The
step is the reference's: ``loss = model.scale_loss(loss)`` (loss / N),
``loss.backward()``, ``model.apply_collective_grads()``, then the
optimizer, so each grad is the mean over the ranks. Under
``dygraph.jit_step`` the all-reduce is captured in the step's CUDA graph.

The JAX package's ``apply_collective_grads`` is a ``psum`` that is the
identity outside a mapped axis (``paddle_tpu/dygraph/parallel.py:61-71``);
the port all-reduces across the ranks of a launched world, as that
docstring and the reference intend. Outside a world (a world of 1
without a process group) it changes nothing.
"""
import os

from ..framework.lowering import fold_rank
from ..parallel import mesh
from .layers import Layer


class ParallelStrategy:
    def __init__(self):
        self.nranks = 1
        self.local_rank = 0
        self.trainer_endpoints = []
        self.current_endpoint = ""


def _endpoints():
    return [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                      "").split(",") if e]


def prepare_context(strategy=None):
    """Join the process world (once) and describe it."""
    mesh.init_parallel_env()
    if strategy is None:
        strategy = ParallelStrategy()
        strategy.nranks = mesh.world_size()
        strategy.local_rank = mesh.rank()
        strategy.trainer_endpoints = _endpoints()
        strategy.current_endpoint = os.environ.get(
            "PADDLE_CURRENT_ENDPOINT", "")
    return strategy


class Env:
    """The launcher's view of this rank (reference dygraph/parallel.py
    ParallelEnv)."""

    @property
    def nranks(self):
        return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    @property
    def dev_id(self):
        return int(os.environ.get("FLAGS_selected_gpus", "0"))

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def trainer_endpoints(self):
        return _endpoints()


class DataParallel(Layer):
    def __init__(self, layers, strategy=None):
        super().__init__()
        self._layers = layers
        self._strategy = strategy or prepare_context()
        if mesh.is_initialized():
            from ..ops.collective_ops import broadcast_
            from .base import _current_tracer
            tracer = _current_tracer()
            if tracer is not None:
                mesh.check_device(tracer.device)
                tracer._key = fold_rank(tracer._key, mesh.rank())
            for p in self._layers.parameters():
                if p.value is not None:
                    broadcast_(p.value, 0)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    @property
    def nranks(self):
        return max(1, self._strategy.nranks)

    def scale_loss(self, loss):
        if self.nranks <= 1:
            return loss
        from ..layers import math as M
        return M.scale(loss, 1.0 / self.nranks)

    def apply_collective_grads(self):
        """Sum every parameter grad over the ranks: one all-reduce of a
        flat buffer per dtype. Nothing outside a world."""
        if not mesh.is_initialized():
            return
        import torch
        from ..framework.selected_rows import SelectedRows
        from ..framework.passes import SPARSE_DP_ITEM
        from ..ops.collective_ops import all_reduce
        groups = {}
        for p in self._layers.parameters():
            g = p._grad
            if g is None:
                continue
            if isinstance(g, SelectedRows):
                raise NotImplementedError(f"paddle_tpu_torch: "
                                          f"{SPARSE_DP_ITEM}: {p.name}")
            groups.setdefault(g.dtype, []).append(p)
        for ps in groups.values():
            flat = torch.cat([p._grad.reshape(-1) for p in ps])
            all_reduce(flat, "sum")
            off = 0
            for p in ps:
                n = p._grad.numel()
                p._grad = flat[off:off + n].view(p._grad.shape)
                off += n

    # delegate module API
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, include_sublayers=True, prefix=""):
        return self._layers.named_parameters(include_sublayers, prefix)

    def state_dict(self, include_sublayers=True):
        return self._layers.state_dict(include_sublayers)

    def set_dict(self, state, include_sublayers=True,
                 use_structured_name=True):
        return self._layers.set_dict(state, include_sublayers)
    load_dict = set_dict
