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

A :class:`Mesh` lays the world's ranks out on a ``dp`` and a ``tp``
axis, ``tp`` innermost (``AXIS_ORDER`` puts it last), so the ranks of
one tensor-parallel group are consecutive: rank ``r`` sits at ``dp``
coordinate ``r // tp`` and ``tp`` coordinate ``r % tp``. Building a
mesh with ``tp > 1`` in a launched world makes one process group per
``tp`` group and per ``dp`` group, on every rank in the same order (the
collectives of ``ops.collective_ops`` run over them), and a gloo group
beside each ``tp`` group for objects on the host (``axis_group("tp",
host=True)``: the tensor-parallel server's descriptors,
``serving.tp``). The other axes
(``pp``, ``sp``, ``ep``, ``dcn_dp``) raise ``NotImplementedError``: the
rest of ROADMAP.md Queue 1 item 7b.

A collective names an axis, never a mesh: the helpers below resolve it
against the mesh they are given, else the layout :func:`activate`
installed (:func:`world_mesh`; the whole world on ``dp`` when none is).
Whatever runs collectives brings its own mesh: the executor activates
a ``CompiledProgram``'s mesh for each of its runs (and the whole world
for a plain program), a tp ``GPT`` passes its mesh to every collective
it calls, and a scope that holds tp shards keeps the mesh they were cut
for. So a mesh made for one purpose (a tp generator) never changes the
groups of another (a data-parallel program).

``set_param_dist_attr`` annotates a parameter, :func:`partition_spec`
sanitises a spec as the JAX package does, and :func:`sharding_for`
gives the sanitised spec of an annotated variable. The JAX package lets
GSPMD split the annotated state; here pass ``tp_shard``
(``framework.passes``) rewrites the program per rank and the executor
holds each rank's shard (``parallel.tp``, the one place that slices a
layout).
"""
import inspect
import math
import os
from dataclasses import dataclass
from datetime import timedelta

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
    default group) unless the world's layout has a ``tp`` axis."""
    return axis_group("dp")


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


class PartitionSpec(tuple):
    """One mesh axis name (or None, or a tuple of names) per dim: the
    port's stand-in for ``jax.sharding.PartitionSpec`` (equal specs
    compare equal as tuples)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """The world's ranks on named axes: ``axis_names`` and ``shape``
    ({axis: size}) as a JAX mesh reports them, the axes of size > 1 in
    ``AXIS_ORDER`` (``("dp",)`` when there is none). ``groups`` maps an
    axis to this rank's process group on it (None: the whole world, or
    no world); a mesh made outside a world has none and is only a
    shape (``partition_spec`` over it)."""

    def __init__(self, dp=1, tp=1):
        dp, tp = int(dp), int(tp)
        used = [(a, n) for a, n in (("dp", dp), ("tp", tp)) if n > 1]
        if not used:
            used = [("dp", dp)]
        self.axis_names = tuple(a for a, _ in used)
        self.shape = dict(used)
        self.size = dp * tp
        self.dp, self.tp = dp, tp
        self.groups = {}
        # a gloo group beside each tp group: host-side objects (the
        # serving leader's step descriptors) never wait behind device
        # work on the NCCL one
        self.host_groups = {}

    def coords(self, r=None):
        """``{"dp": i, "tp": j}`` of rank ``r`` (this rank by default)."""
        r = rank() if r is None else int(r)
        return {"dp": r // self.tp, "tp": r % self.tp}

    def axis_ranks(self, axis, r=None):
        """The world ranks of rank ``r``'s group on ``axis``, in axis
        order."""
        c = self.coords(r)
        if axis == "tp":
            return [c["dp"] * self.tp + j for j in range(self.tp)]
        return [i * self.tp + c["tp"] for i in range(self.dp)]

    def __repr__(self):
        return "Mesh(" + ", ".join(f"{a}={n}" for a, n in
                                   self.shape.items()) + ")"


_built = {}            # (dp, tp) -> Mesh, groups made once per world
_active = None         # the layout the collectives resolve axes against


def _make_groups(mesh):
    """One process group per tp group and per dp group, and a gloo (host)
    group beside each tp group, every rank making them all in the same
    order (``new_group`` is collective)."""
    dist = _dist()
    r = rank()
    for axis, count in (("tp", mesh.dp), ("dp", mesh.tp)):
        if count == mesh.size:         # groups of one rank: no traffic
            continue
        for k in range(count):
            members = mesh.axis_ranks(
                axis, k * mesh.tp if axis == "tp" else k)
            g = dist.new_group(members)
            # a follower of an idle server waits on it for as long as
            # the server runs (a dead peer still fails it at once)
            host = dist.new_group(members, backend="gloo",
                                  timeout=timedelta(days=365)) \
                if axis == "tp" else None
            if r in members:
                mesh.groups[axis] = g
                if host is not None:
                    mesh.host_groups[axis] = host


def make_mesh(config=None, devices=None, **axes):
    """The world's ranks on a ``dp`` x ``tp`` mesh. ``tp`` must divide
    the world; ``dp`` 1 (the default) means the rest of it, any other
    ``dp`` must make ``dp * tp`` the world size. Any other axis raises:
    item 7b."""
    if config is None:
        config = MeshConfig(**{k: v for k, v in axes.items() if v})
    sizes = config.axis_sizes()
    other = [a for a in AXIS_ORDER if a not in ("dp", "tp")
             and sizes[a] > 1]
    if other:
        raise not_ported_7b(f"mesh axes {other}")
    if devices is not None:
        raise not_ported_7b("a mesh over an explicit device list")
    n = world_size()
    tp = max(int(sizes["tp"]), 1)
    dp = int(sizes["dp"])
    if dp == 1:
        dp = n // tp if n % tp == 0 else 0
    if dp * tp != n:
        want = (dp or 1) * tp
        raise ValueError(f"a dp={sizes['dp']} tp={tp} mesh needs {want} "
                         f"ranks; the world has {n} (one process per "
                         f"card: launch --nproc_per_node={want})")
    mesh = _built.get((dp, tp))
    if mesh is None:
        mesh = Mesh(dp, tp)
        if tp > 1 and is_initialized():
            _make_groups(mesh)
        _built[(dp, tp)] = mesh
    return mesh


def activate(mesh):
    """Install ``mesh`` as the layout the collectives of a running
    program resolve their axes against (None: the whole world on
    ``dp``); returns it. The executor calls it for each run."""
    global _active
    _active = mesh
    return mesh


def world_mesh(mesh=None):
    """``mesh``, else the active layout, else the whole world on
    ``dp``."""
    if mesh is not None:
        return mesh
    if _active is not None:
        return _active
    return Mesh(world_size())


def axis_group(axis, mesh=None, host=False):
    """This rank's process group on ``axis`` of ``mesh`` (default: the
    active layout; None: the default group, the whole world). ``host``:
    the gloo group beside the ``tp`` group, for objects on the host
    (None when the mesh has no tp group)."""
    if axis not in ("dp", "tp"):
        raise not_ported_7b(f"the {axis!r} axis")
    m = world_mesh(mesh)
    return m.host_groups.get(axis) if host else m.groups.get(axis)


def axis_world_size(axis, mesh=None):
    """The size of ``axis`` in ``mesh`` (default: the active layout;
    ``tp`` is 1 without a tp mesh, ``dp`` then the world)."""
    m = world_mesh(mesh)
    return m.tp if axis == "tp" else m.dp


def axis_rank(axis, mesh=None):
    """This rank's coordinate on ``axis`` of ``mesh`` (default: the
    active layout)."""
    return world_mesh(mesh).coords()[axis]


def axis_global_rank(axis, index, mesh=None):
    """The world rank of index ``index`` of this rank's ``axis`` group
    in ``mesh`` (default: the active layout)."""
    return world_mesh(mesh).axis_ranks(axis)[int(index)]


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
    return make_mesh(MeshConfig(dp=n))


def axis_size(mesh, name):
    return mesh.shape[name] if mesh is not None and name in mesh.axis_names \
        else 1


def set_param_dist_attr(program, name, spec):
    """Annotate a program variable with a mesh-axis sharding spec (the
    helper behind bert/gpt ``apply_tp_sharding``). Call BEFORE
    ``optimizer.minimize()``: accumulators copy the parameter's
    ``dist_attr`` when they are made."""
    var = program.global_block().vars.get(name)
    if var is not None:
        var.dist_attr = tuple(spec)


def partition_spec(mesh, spec, shape=None):
    """Sanitise a raw axis-name spec against ``mesh``, as the JAX
    package does: unknown axes replicate, and (when ``shape`` is given)
    an axis that does not divide its dim drops; a dim sharded jointly
    over several axes keeps the known ones and must divide by the
    product of their sizes."""
    spec = tuple(spec or ())
    if shape is not None:
        spec = spec[:len(shape)] + (None,) * (len(shape) - len(spec))
    out = []
    for i, a in enumerate(spec):
        if isinstance(a, (tuple, list)):
            sub = tuple(x for x in a if x in mesh.axis_names)
            prod = math.prod(int(mesh.shape[x]) for x in sub) if sub else 1
            if not sub or (shape is not None and shape[i] % prod != 0):
                out.append(None)
            else:
                out.append(sub if len(sub) > 1 else sub[0])
            continue
        if a is None or a not in mesh.axis_names:
            out.append(None)
        elif shape is not None and shape[i] % mesh.shape[a] != 0:
            out.append(None)
        else:
            out.append(a)
    return PartitionSpec(*out)


def sharding_for(mesh, var):
    """The sanitised spec of ``var``'s ``dist_attr`` over ``mesh`` (all
    None, replicated, without one)."""
    shape = getattr(var, "shape", None)
    if var is None or getattr(var, "dist_attr", None) is None:
        return PartitionSpec(*([None] * len(shape or ())))
    return partition_spec(mesh, var.dist_attr, shape)


__all__ = ["AXIS_ORDER", "Mesh", "MeshConfig", "PartitionSpec",
           "activate", "any_failed", "axis_global_rank", "axis_group",
           "axis_rank", "axis_size", "axis_world_size", "backend", "barrier",
           "check_device", "default_mesh", "dp_group", "get_mesh",
           "init_parallel_env", "is_initialized", "make_mesh",
           "partition_spec", "rank", "set_mesh", "set_param_dist_attr",
           "sharding_for", "world_mesh", "world_size"]
