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

A :class:`Mesh` lays the world's ranks out on a ``dcn_dp``, a ``pp``,
a ``dp``, an ``ep``, an ``sp`` and a ``tp`` axis in ``AXIS_ORDER``:
``tp`` innermost, then ``sp``, then ``ep``, then ``dp``, then ``pp``,
``dcn_dp`` outermost, so the ranks of one tensor-parallel group are
consecutive and mesh index ``i`` sits at ``i = ((((c * pp + p) * dp +
d) * ep + e) * sp + s) * tp + t``. A mesh spans the whole world, or the
world ranks ``make_mesh(devices=[...])`` names (the narrower mesh of a
multi-slice run after a slice is lost, ``train.slices``), index ``i``
being ``devices[i]``. ``dcn_dp`` is the data-parallel axis across
slices: the batch is split over ``dcn_dp`` x ``dp`` jointly, dcn-major,
so a rank's data coordinate is ``c * dp + d`` (the joint axis
``dcn_dp+dp``, ``DATA_AXIS``). Building a mesh whose axes are not all
``dp`` makes one process group per group of every axis that has more
than one rank (``tp``, ``sp``, ``ep``, ``dp``, the joint ``dp_sp``, the
ranks of one ``tp`` coordinate over ``dp`` x ``sp``, where the grads of
a sequence-parallel program are averaged, the joint ``dp_ep``, the
ranks over ``dcn_dp`` x ``dp`` x ``ep`` in global row order, where
``switch_moe`` counts its tokens, ``pp``, ``dcn_dp``, ``dcn_dp+dp`` and
``dcn_dp+dp_sp``, the flat grad sync of a multi-slice program), one
group per set of members, on every rank in the same order (the
collectives of ``ops.collective_ops`` run over them), one over the
mesh's ranks when it spans part of the world, and a gloo group beside
each ``tp`` group for objects on the host (``axis_group("tp",
host=True)``: the tensor-parallel server's descriptors,
``serving.tp``).

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
layout), pass ``sp_shard`` splits the activations' sequence dim
per rank (``parallel.sp``; no state is split on ``sp``), and pass
``pp_shard`` gives each ``pp`` rank its stage's slice of a
``layers.Pipeline``'s stacked parameters (``parallel.pp``), and pass
``ep_shard`` each ``ep`` rank its slice of the experts
(``parallel.ep``).
"""
import inspect
import math
import os
from dataclasses import dataclass
from datetime import timedelta

import torch

AXIS_ORDER = ("dcn_dp", "pp", "dp", "ep", "sp", "tp")
#: the joint axis over dp x sp, one group per tp coordinate: where the
#: parameter grads of a sequence-parallel program are averaged
GRAD_AXIS = "dp_sp"
#: the joint axis over dcn_dp x dp x ep in global row order (index
#: (c * dp + d) * ep + e): where switch_moe counts the tokens of the
#: global batch
TOKEN_AXIS = "dp_ep"
#: the joint axis over dcn_dp x dp (index c * dp + d): every data
#: replica of a rank's model coordinate, the feed's split and the flat
#: grad sync of a multi-slice program
DATA_AXIS = "dcn_dp+dp"
#: the joint axis over dcn_dp x dp x sp: the flat grad sync of a
#: multi-slice sequence-parallel program
DATA_GRAD_AXIS = "dcn_dp+dp_sp"
#: the axes a collective may name
AXES = ("dp", "sp", "tp", "pp", "ep", "dcn_dp", GRAD_AXIS, TOKEN_AXIS,
        DATA_AXIS, DATA_GRAD_AXIS)
ITEM_7B = "not ported (ROADMAP.md Queue 1 item 7b)"

_current_mesh = None
_card = [None]          # this rank's card, set by init_parallel_env


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
    default group) unless the world's layout has a ``tp``, an ``sp``, an
    ``ep`` or a ``pp`` axis."""
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
        _card[0] = idx
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kwargs["device_id"] = torch.device("cuda", idx)
    elif name != "gloo":
        raise ValueError(f"PADDLE_DISTRI_BACKEND={name!r}: the port runs "
                         f"nccl (the card) or gloo (the CPU)")
    dist.init_process_group(name, init_method=f"tcp://{eps[0]}",
                            world_size=n, rank=rk, **kwargs)
    return n


def _own_card():
    """This rank's card (set when it joined the world), whichever thread
    asks."""
    return _card[0] if _card[0] is not None else torch.cuda.current_device()


def barrier(mesh=None):
    """Every rank waits here (nothing outside a world); with ``mesh``,
    every rank of ``mesh``."""
    if not is_initialized():
        return
    dist = _dist()
    group = None if mesh is None else mesh.world_group
    if backend() == "nccl":
        dist.barrier(group=group, device_ids=[_own_card()])
    else:
        dist.barrier(group=group)


def any_failed(failed, mesh=None):
    """Whether ``failed`` holds on any rank (with ``mesh``: any rank of
    ``mesh``): a max all-reduce of it, which every such rank must reach
    (so it is a barrier too). ``failed`` itself outside a world."""
    if not is_initialized():
        return bool(failed)
    dev = torch.device("cuda", _own_card()) \
        if backend() == "nccl" else torch.device("cpu")
    flag = torch.tensor([int(bool(failed))], dtype=torch.int32, device=dev)
    _dist().all_reduce(flag, op=_dist().ReduceOp.MAX,
                       group=None if mesh is None else mesh.world_group)
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
    ``AXIS_ORDER`` (``("dp",)`` when there is none). ``ranks`` are the
    world ranks it spans, index ``i`` of the mesh on ``ranks[i]`` (the
    whole world unless ``make_mesh`` was given ``devices``). ``groups``
    maps an axis to this rank's process group on it (None: the whole
    world, or no world), ``world_group`` is the group of ``ranks`` (None
    when they are the whole world); a mesh made outside a world has none
    and is only a shape (``partition_spec`` over it). Besides the named
    axes, the joint axes: ``dp_sp`` (``GRAD_AXIS``), the ranks of one
    ``dcn_dp``, ``pp``, ``ep`` and ``tp`` coordinate over ``dp`` x
    ``sp``; ``dp_ep`` (``TOKEN_AXIS``), the ranks of one ``pp``, ``sp``
    and ``tp`` coordinate over ``dcn_dp`` x ``dp`` x ``ep``, index ``(c
    * dp + d) * ep + e``; ``dcn_dp+dp`` (``DATA_AXIS``), index ``c * dp
    + d``, and ``dcn_dp+dp_sp`` (``DATA_GRAD_AXIS``), index ``(c * dp +
    d) * sp + s``."""

    def __init__(self, dp=1, tp=1, sp=1, pp=1, ep=1, dcn_dp=1, ranks=None):
        dp, tp, sp, pp, ep = int(dp), int(tp), int(sp), int(pp), int(ep)
        dcn = int(dcn_dp)
        used = [(a, n) for a, n in (("dcn_dp", dcn), ("pp", pp), ("dp", dp),
                                    ("ep", ep), ("sp", sp), ("tp", tp))
                if n > 1]
        if not used:
            used = [("dp", dp)]
        self.axis_names = tuple(a for a, _ in used)
        self.shape = dict(used)
        self.size = dcn * dp * sp * tp * pp * ep
        self.dp, self.sp, self.tp, self.pp, self.ep = dp, sp, tp, pp, ep
        self.dcn_dp = dcn
        #: whether the mesh spans the world ranks ``make_mesh`` was
        #: given rather than the whole world
        self.partial = ranks is not None
        self.ranks = list(range(self.size)) if ranks is None \
            else [int(r) for r in ranks]
        if len(self.ranks) != self.size:
            raise ValueError(f"a mesh of {self.size} ranks over the world "
                             f"ranks {self.ranks}")
        self._index = {r: i for i, r in enumerate(self.ranks)}
        self.groups = {}
        self.world_group = None
        # a gloo group beside each tp group: host-side objects (the
        # serving leader's step descriptors) never wait behind device
        # work on the NCCL one
        self.host_groups = {}

    def __contains__(self, r):
        return int(r) in self._index

    def coords(self, r=None):
        """``{"dcn_dp": c, "pp": p, "dp": d, "ep": e, "sp": s, "tp": t}``
        of world rank ``r`` (this rank by default) with its indices on the
        joint axes (``dp_sp``, ``dp_ep``, ``dcn_dp+dp``,
        ``dcn_dp+dp_sp``)."""
        r = rank() if r is None else int(r)
        if r not in self._index:
            raise ValueError(f"rank {r} is not in {self} (world ranks "
                             f"{self.ranks})")
        i = self._index[r]
        t, i = i % self.tp, i // self.tp
        s, i = i % self.sp, i // self.sp
        e, i = i % self.ep, i // self.ep
        d, i = i % self.dp, i // self.dp
        p, c = i % self.pp, i // self.pp
        data = c * self.dp + d
        return {"dcn_dp": c, "pp": p, "dp": d, "ep": e, "sp": s, "tp": t,
                GRAD_AXIS: d * self.sp + s, TOKEN_AXIS: data * self.ep + e,
                DATA_AXIS: data, DATA_GRAD_AXIS: data * self.sp + s}

    def rank_of(self, dp, sp, tp, pp=0, ep=0, dcn_dp=0):
        i = ((((int(dcn_dp) * self.pp + int(pp)) * self.dp + int(dp))
              * self.ep + int(ep)) * self.sp + int(sp)) * self.tp + int(tp)
        return self.ranks[i]

    def axis_ranks(self, axis, r=None):
        """The world ranks of rank ``r``'s group on ``axis``, in axis
        order."""
        c = self.coords(r)
        k, p, d, e, s, t = (c["dcn_dp"], c["pp"], c["dp"], c["ep"], c["sp"],
                            c["tp"])
        at = self.rank_of
        if axis == "tp":
            return [at(d, s, j, p, e, k) for j in range(self.tp)]
        if axis == "sp":
            return [at(d, j, t, p, e, k) for j in range(self.sp)]
        if axis == "pp":
            return [at(d, s, t, j, e, k) for j in range(self.pp)]
        if axis == "ep":
            return [at(d, s, t, p, j, k) for j in range(self.ep)]
        if axis == "dcn_dp":
            return [at(d, s, t, p, e, j) for j in range(self.dcn_dp)]
        if axis == GRAD_AXIS:
            return [at(i, j, t, p, e, k) for i in range(self.dp)
                    for j in range(self.sp)]
        if axis == TOKEN_AXIS:
            return [at(i, s, t, p, j, m) for m in range(self.dcn_dp)
                    for i in range(self.dp) for j in range(self.ep)]
        if axis == DATA_AXIS:
            return [at(i, s, t, p, e, m) for m in range(self.dcn_dp)
                    for i in range(self.dp)]
        if axis == DATA_GRAD_AXIS:
            return [at(i, j, t, p, e, m) for m in range(self.dcn_dp)
                    for i in range(self.dp) for j in range(self.sp)]
        return [at(i, s, t, p, e, k) for i in range(self.dp)]

    def axis_size(self, axis):
        """The size of ``axis`` (a joint axis: the product of its
        parts)."""
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp, "pp": self.pp,
                "ep": self.ep, "dcn_dp": self.dcn_dp,
                GRAD_AXIS: self.dp * self.sp,
                TOKEN_AXIS: self.dcn_dp * self.dp * self.ep,
                DATA_AXIS: self.dcn_dp * self.dp,
                DATA_GRAD_AXIS: self.dcn_dp * self.dp * self.sp}[axis]

    def __repr__(self):
        out = "Mesh(" + ", ".join(f"{a}={n}" for a, n in
                                  self.shape.items())
        if self.partial:
            out += f", ranks={self.ranks}"
        return out + ")"


_built = {}            # (sizes, ranks) -> Mesh, groups made once per world
_active = None         # the layout the collectives resolve axes against
_GROUP_AXES = ("tp", "sp", "ep", "dp", GRAD_AXIS, TOKEN_AXIS, "pp",
               "dcn_dp", DATA_AXIS, DATA_GRAD_AXIS)


def _make_groups(mesh):
    """One process group per set of members of every axis in
    ``_GROUP_AXES`` (an axis whose members are another's shares its
    group), one over the mesh's ranks when they are not the whole
    world, and a gloo (host) group beside each tp group, every world
    rank making them all in the same order (``new_group`` is collective
    over the world, members or not)."""
    dist = _dist()
    r = rank()
    made = {}
    for axis in _GROUP_AXES:
        if mesh.axis_size(axis) == 1:     # groups of one rank: no traffic
            continue
        for q in mesh.ranks:
            members = tuple(mesh.axis_ranks(axis, q))
            if members not in made:
                made[members] = dist.new_group(list(members))
                # a follower of an idle server waits on it for as long
                # as the server runs (a dead peer still fails it at once)
                host = dist.new_group(list(members), backend="gloo",
                                      timeout=timedelta(days=365)) \
                    if axis == "tp" else None
                if r in members and host is not None:
                    mesh.host_groups[axis] = host
            if r in members:
                mesh.groups[axis] = made[members]
    if mesh.ranks != list(range(world_size())):
        g = made.get(tuple(mesh.ranks)) or dist.new_group(mesh.ranks)
        if r in mesh:
            mesh.world_group = g


def make_mesh(config=None, devices=None, **axes):
    """The world's ranks on a ``dcn_dp`` x ``pp`` x ``dp`` x ``ep`` x
    ``sp`` x ``tp`` mesh. ``devices``: the world ranks it spans (one
    card each; default the whole world, in order), as the JAX package's
    device list. ``dcn_dp``, ``tp``, ``sp``, ``ep`` and ``pp`` must
    divide them; ``dp`` 1 (the default) means the rest of them, any
    other ``dp`` must make the product of the axes their number. Every
    world rank must make every mesh, in the same order: its process
    groups are made then."""
    if config is None:
        config = MeshConfig(**{k: v for k, v in axes.items() if v})
    sizes = config.axis_sizes()
    n = world_size()
    if devices is not None:
        devices = [int(d) for d in devices]
        if len(set(devices)) != len(devices) or \
                any(not 0 <= d < n for d in devices):
            raise ValueError(f"devices {devices}: distinct ranks of the "
                             f"world of {n} (one card each)")
        n = len(devices)
    tp = max(int(sizes["tp"]), 1)
    sp = max(int(sizes["sp"]), 1)
    pp = max(int(sizes["pp"]), 1)
    ep = max(int(sizes["ep"]), 1)
    dcn = max(int(sizes["dcn_dp"]), 1)
    dp = int(sizes["dp"])
    model = tp * sp * pp * ep * dcn
    if dp == 1:
        dp = n // model if n % model == 0 else 0
    if dp * model != n:
        want = (dp or 1) * model
        names = (f"dcn_dp={dcn} " if dcn > 1 else "") + \
            (f"pp={pp} " if pp > 1 else "") + f"dp={sizes['dp']} " + \
            (f"ep={ep} " if ep > 1 else "") + \
            (f"sp={sp} " if sp > 1 else "") + f"tp={tp}"
        where = f"{n} devices given" if devices is not None else \
            f"the world has {n}"
        raise ValueError(f"a {names} mesh needs {want} "
                         f"ranks; {where} (one process per "
                         f"card: launch --nproc_per_node={want})")
    ranks = tuple(devices) if devices is not None else None
    if ranks == tuple(range(world_size())):
        ranks = None
    key = (dcn, dp, tp, sp, pp, ep, ranks)
    mesh = _built.get(key)
    if mesh is None:
        mesh = Mesh(dp, tp, sp, pp, ep, dcn, ranks)
        if is_initialized() and (model > 1 or ranks is not None):
            _make_groups(mesh)
        _built[key] = mesh
    return mesh


def activate(mesh):
    """Install ``mesh`` as the layout the collectives of a running
    program resolve their axes against (None: the whole world on
    ``dp``); returns it. The executor calls it for each run."""
    global _active
    _active = mesh
    return mesh


def active_mesh():
    """The layout :func:`activate` installed (a data-parallel program's
    mesh while it runs), or None."""
    return _active


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
    active layout; None: the default group, the whole world; axis None:
    the group of the mesh's ranks). ``host``: the gloo group beside the
    ``tp`` group, for objects on the host (None when the mesh has no tp
    group)."""
    m = world_mesh(mesh)
    if axis is None:
        return m.world_group
    if axis not in AXES:
        raise not_ported_7b(f"the {axis!r} axis")
    return m.host_groups.get(axis) if host else m.groups.get(axis)


def axis_world_size(axis, mesh=None):
    """The size of ``axis`` in ``mesh`` (default: the active layout;
    ``tp``, ``sp``, ``pp``, ``ep`` and ``dcn_dp`` are 1 without such a
    mesh, ``dp`` then the world; axis None: the mesh's ranks)."""
    if axis is None:
        return world_mesh(mesh).size
    if axis not in AXES:
        raise not_ported_7b(f"the {axis!r} axis")
    return world_mesh(mesh).axis_size(axis)


def axis_rank(axis, mesh=None):
    """This rank's coordinate on ``axis`` of ``mesh`` (default: the
    active layout)."""
    return world_mesh(mesh).coords()[axis]


def axis_global_rank(axis, index, mesh=None):
    """The world rank of index ``index`` of this rank's ``axis`` group
    in ``mesh`` (default: the active layout; axis None: of the mesh's
    ranks)."""
    m = world_mesh(mesh)
    return m.ranks[int(index)] if axis is None \
        else m.axis_ranks(axis)[int(index)]


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


__all__ = ["AXES", "AXIS_ORDER", "DATA_AXIS", "DATA_GRAD_AXIS",
           "GRAD_AXIS", "TOKEN_AXIS", "Mesh", "MeshConfig", "PartitionSpec",
           "activate", "active_mesh", "any_failed", "axis_global_rank", "axis_group",
           "axis_rank", "axis_size", "axis_world_size", "backend", "barrier",
           "check_device", "default_mesh", "dp_group", "get_mesh",
           "init_parallel_env", "is_initialized", "make_mesh",
           "partition_spec", "rank", "set_mesh", "set_param_dist_attr",
           "sharding_for", "world_mesh", "world_size"]
