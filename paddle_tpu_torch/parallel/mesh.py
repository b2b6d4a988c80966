"""The process world of data parallelism.

Counterpart of ``paddle_tpu/parallel/mesh.py``. The JAX package is one
controller: a ``jax.sharding.Mesh`` over every device with named axes,
and GSPMD inserting the collectives. The port is one process per card,
as the reference's collective trainers are: ``torch.distributed`` with
the NCCL backend on the card (``gloo`` on the CPU), the world's ranks
forming the one ``dp`` axis. :func:`init_parallel_env` joins the world
once, from a role maker or the launcher's ``PADDLE_*`` environment
(``paddle_tpu_torch.distributed.launch``): the rendezvous is at trainer
0's endpoint, and on the card ``torch.cuda.set_device(
FLAGS_selected_gpus)`` makes ``device=None`` the rank's own card. A
process that was not launched is a world of 1 and needs no process
group; a launched one has a group, whatever its size.

A :class:`Mesh` here is the ``dp`` axis over the world's ranks. Any
other axis (``tp``, ``pp``, ``sp``, ``ep``, ``dcn_dp``),
``set_param_dist_attr``, ``partition_spec`` and ``sharding_for`` raise
``NotImplementedError``: model parallelism is ROADMAP.md Queue 1 item
7b.
"""
import inspect
import os
from dataclasses import dataclass

import torch

AXIS_ORDER = ("dcn_dp", "pp", "dp", "ep", "sp", "tp")
ITEM_7B = ("model parallelism and multi-slice are not ported "
           "(ROADMAP.md Queue 1 item 7b)")

_current_mesh = None


def not_ported_7b(what):
    return NotImplementedError(f"paddle_tpu_torch: {what}: {ITEM_7B}")


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def is_initialized():
    """Whether this process is in a process group (a launched world)."""
    dist = _dist()
    return dist is not None and dist.is_initialized()


def world_size():
    return _dist().get_world_size() if is_initialized() else 1


def rank():
    return _dist().get_rank() if is_initialized() else 0


def dp_group():
    """The process group of the ``dp`` axis: the whole world (None, the
    default group), or None outside a world."""
    return None


def backend():
    """``"nccl"``, ``"gloo"`` or None outside a world."""
    return _dist().get_backend() if is_initialized() else None


def _endpoints(value):
    return [e for e in (value or "").split(",") if e]


def init_parallel_env(role_maker=None):
    """Join the process world (once; later calls return its size). The
    rank, size and endpoints come from ``role_maker`` or from the
    launcher's environment (``PADDLE_TRAINER_ID``,
    ``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``); the backend
    from ``PADDLE_DISTRI_BACKEND`` (``nccl``, the default, or ``gloo``,
    which the launcher's ``--device=cpu`` sets). Without endpoints this
    is a world of 1 and no group is made; NCCL without a card raises.
    Returns the world size."""
    if is_initialized():
        return world_size()
    if role_maker is not None:
        rk = int(role_maker.worker_index())
        n = int(role_maker.worker_num())
        eps = [e for e in role_maker.get_trainer_endpoints() if e]
    else:
        rk = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        eps = _endpoints(os.environ.get("PADDLE_TRAINER_ENDPOINTS"))
        n = int(os.environ.get("PADDLE_TRAINERS_NUM", str(len(eps) or 1)))
    if not eps:
        if n > 1:
            raise RuntimeError(
                f"a world of {n} ranks needs PADDLE_TRAINER_ENDPOINTS "
                f"(trainer 0's endpoint is the rendezvous); start the ranks "
                f"with python -m paddle_tpu_torch.distributed.launch")
        return 1
    dist = _dist()
    if dist is None:
        raise RuntimeError("this PyTorch has no torch.distributed")
    name = os.environ.get("PADDLE_DISTRI_BACKEND", "nccl").lower()
    kwargs = {}
    if name == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the nccl backend needs a CUDA device; launch with "
                "--device=cpu for gloo on the CPU")
        idx = int(os.environ.get("FLAGS_selected_gpus",
                                 str(rk % torch.cuda.device_count())))
        torch.cuda.set_device(idx)
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kwargs["device_id"] = torch.device("cuda", idx)
    elif name != "gloo":
        raise ValueError(f"PADDLE_DISTRI_BACKEND={name!r}: the port runs "
                         f"nccl (the card) or gloo (the CPU)")
    dist.init_process_group(name, init_method=f"tcp://{eps[0]}",
                            world_size=n, rank=rk, **kwargs)
    return n


def barrier():
    """Every rank waits here (nothing outside a world)."""
    if not is_initialized():
        return
    dist = _dist()
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def any_failed(failed):
    """Whether ``failed`` holds on any rank: a max all-reduce of it, which
    every rank must reach (so it is a barrier too). ``failed`` itself
    outside a world."""
    if not is_initialized():
        return bool(failed)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if backend() == "nccl" else torch.device("cpu")
    flag = torch.tensor([int(bool(failed))], dtype=torch.int32, device=dev)
    _dist().all_reduce(flag, op=_dist().ReduceOp.MAX)
    return bool(flag.item())


def check_device(device):
    """Raise when ``device`` (an executor's or tracer's) is not the
    world's: NCCL ranks run on their own card, gloo ranks on the CPU."""
    if not is_initialized():
        return
    device = torch.device(device)
    want = "cuda" if backend() == "nccl" else "cpu"
    if device.type != want:
        raise RuntimeError(
            f"the process world runs {backend()} on the "
            f"{'card' if want == 'cuda' else 'CPU'}, the executor runs on "
            f"{device}: launch with --device=cpu for CPUPlace, without it "
            f"for the GPU")
    if want == "cuda" and device.index not in (None,
                                               torch.cuda.current_device()):
        raise RuntimeError(f"rank {rank()} runs on cuda:"
                           f"{torch.cuda.current_device()}, the executor "
                           f"on {device}")


@dataclass
class MeshConfig:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    dcn_dp: int = 1

    def axis_sizes(self):
        return {"dcn_dp": self.dcn_dp, "pp": self.pp, "dp": self.dp,
                "ep": self.ep, "sp": self.sp, "tp": self.tp}


class Mesh:
    """The ``dp`` axis over the world's ranks: ``axis_names`` ("dp",)
    and ``shape`` {"dp": world size}, as a JAX mesh reports them."""

    def __init__(self, dp):
        self.axis_names = ("dp",)
        self.shape = {"dp": int(dp)}
        self.size = int(dp)

    def __repr__(self):
        return f"Mesh(dp={self.size})"


def make_mesh(config=None, devices=None, **axes):
    """A ``dp``-only mesh over the world (``config.dp`` must be the
    world size; 1 by default means the whole world). Any other axis
    raises: item 7b."""
    if config is None:
        config = MeshConfig(**{k: v for k, v in axes.items() if v})
    sizes = config.axis_sizes()
    other = [a for a in AXIS_ORDER if a != "dp" and sizes[a] > 1]
    if other:
        raise not_ported_7b(f"mesh axes {other}")
    if devices is not None:
        raise not_ported_7b("a mesh over an explicit device list")
    n = world_size()
    dp = sizes["dp"]
    if dp not in (1, n):
        raise ValueError(f"a dp={dp} mesh needs {dp} ranks; the world has "
                         f"{n} (one process per card: launch "
                         f"--nproc_per_node={dp})")
    return Mesh(n)


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh
    return mesh


def get_mesh():
    return _current_mesh


def default_mesh(n_devices=None):
    """The world's ranks on one dp axis (the ParallelExecutor
    default)."""
    n = world_size()
    if n_devices not in (None, n):
        raise ValueError(f"{n_devices} devices asked for; the world has "
                         f"{n} ranks, one card each")
    return Mesh(n)


def axis_size(mesh, name):
    return mesh.shape[name] if mesh is not None and name in mesh.axis_names \
        else 1


def set_param_dist_attr(program, name, spec):
    raise not_ported_7b("set_param_dist_attr")


def partition_spec(mesh, spec, shape=None):
    raise not_ported_7b("partition_spec")


def sharding_for(mesh, var):
    raise not_ported_7b("sharding_for")


__all__ = ["AXIS_ORDER", "Mesh", "MeshConfig", "any_failed", "axis_size",
           "backend", "barrier", "check_device", "default_mesh", "dp_group",
           "get_mesh", "init_parallel_env", "is_initialized", "make_mesh",
           "partition_spec", "rank", "set_mesh", "set_param_dist_attr",
           "sharding_for", "world_size"]
