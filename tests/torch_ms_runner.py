"""Worker of the port's multi-slice CPU tests (``test_torch_multislice.py``):
one rank of a gloo world of 4 started by ``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=4 --device=cpu``.
Slices are blocks of 2 ranks (ranks 0, 1 slice 0; ranks 2, 3 slice 1).
It runs

- ``op``: one ``hier_allreduce`` op over fed ``[3, 5]`` blocks (15
  elements: a padded tail over dp 2) at dcn_dp 2 x dp 2, decomposed and
  flat;
- ``ab``: ``mlp`` (JAX ``tests/test_multislice.py``'s tiny MLP and SGD)
  over ``MeshConfig(dcn_dp=2, dp=2)``, a ``run_steps`` slab of 4 steps
  of the global batch of 16 split dcn-major, with
  ``FLAGS_dcn_hierarchical`` on (the decomposed sync) and off (the flat
  one; the same compiled program), and over ``dp=4``; each run's gate
  report; the same with dropout at dcn_dp 2 x dp 2 and dp 4 (the same
  masks);
- ``mix``: ``torch_ep_mix_runner``'s model at dcn_dp 2 beside tp 2, ep 2
  and a pp 2 pipeline;
- the ``SliceSupervisor`` drills: ``shrink`` (slice 1's beats dropped
  from the second slab boundary on: dcn_dp 1 on ranks 0, 1 after the
  window, then the control that checkpoints a healthy wide run at that
  boundary and resumes it narrow), ``regrow`` (the beats back at the
  sixth boundary), ``dcn_fault`` (``train.allreduce_dcn`` failing every
  slab: the restart budget spent, a slice shrunk away) and
  ``transient`` (one failure, absorbed by a restart).

What a rank saw goes to ``<out>/ms.<rank>.npz`` (``__flags__``: a JSON
of its booleans and numbers). ``mlp`` takes either package's ``fluid``;
this module imports the port only.

    python torch_ms_runner.py <args.json>
"""
import json
import os
import sys

import numpy as np

FEAT, BATCH, K = 4, 16, 4
PER_SLICE = 2


def mlp(fluid, rows, dropout=0.0, seed=7):
    """(main, startup, loss): ``fc(8, relu) -> fc(1)`` and an MSE loss,
    SGD 0.1 (JAX ``tests/test_multislice.py``'s ``_build``), optionally
    a dropout after the first fc."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[rows, FEAT], dtype="float32")
        y = fluid.data(name="y", shape=[rows, 1], dtype="float32")
        h = L.fc(x, size=8, act="relu")
        if dropout:
            h = L.dropout(h, dropout,
                          dropout_implementation="upscale_in_train")
        loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def slabs(n=4, k=2, batch=BATCH, seed=0):
    """``n`` global feed slabs of ``k`` steps (JAX ``_slabs``)."""
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(k, batch, FEAT).astype(np.float32),
             "y": rng.randn(k, batch, 1).astype(np.float32)}
            for _ in range(n)]


def local(slab, mesh, data_axis):
    """The rows of global ``slab`` ``[K, B, ...]`` that ``mesh`` feeds
    this rank (data coordinate ``c * dp + d``)."""
    n = mesh.axis_size(data_axis)
    c = mesh.coords()[data_axis]
    return {k: v[:, c * (v.shape[1] // n):(c + 1) * (v.shape[1] // n)]
            for k, v in slab.items()}


def op_blocks():
    rng = np.random.default_rng(5)
    return rng.standard_normal((4, 3, 5)).astype(np.float32)


# ------------------------------------------------------------- the rank

class Ctx:
    def __init__(self, args):
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.parallel import mesh
        self.fluid, self.mesh = fluid, mesh
        self.args = args
        mesh.init_parallel_env()
        self.rank = mesh.rank()
        self.place = fluid.CPUPlace()
        self.arrays, self.flags = {}, {}

    def start_scope(self, exe, startup):
        """A scope with the JAX startup's values of ``mlp``."""
        from paddle_tpu_torch.framework.executor import scope_from_arrays
        scope = self.fluid.Scope()
        exe.run(startup, scope=scope)
        with np.load(self.args["ab_start"]) as z:
            scope_from_arrays(scope, {k: z[k] for k in z.files})
        return scope

    def flag(self, **kv):
        self.fluid.set_flags({f"FLAGS_{k}": v for k, v in kv.items()})


def run_op(c):
    fluid, mesh = c.fluid, c.mesh
    grid = mesh.make_mesh(mesh.MeshConfig(dcn_dp=2, dp=2))
    x = op_blocks()[grid.coords()[mesh.DATA_AXIS]]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        v = fluid.data("hx", [3, 5], "float32")
        out = main.global_block().create_var(name="hx@HIER", shape=(3, 5),
                                             dtype="float32")
        main.global_block().append_op(
            type="hier_allreduce", inputs={"X": [v]},
            outputs={"Out": [out]},
            attrs={"inner_axis": "dp", "outer_axis": "dcn_dp",
                   "mean": True}, infer_shape=False)
    comp = fluid.CompiledProgram(main).with_data_parallel(mesh=grid)
    exe = fluid.Executor(c.place)
    for hier in (True, False):
        c.flag(dcn_hierarchical=hier)
        got, = exe.run(comp, feed={"hx": x}, fetch_list=[out],
                       scope=fluid.Scope())
        c.arrays[f"op/{'hier' if hier else 'flat'}"] = np.asarray(got)
    c.flag(dcn_hierarchical=True)


def run_ab(c):
    """The A/B over one compiled program, and dp 4."""
    fluid, mesh = c.fluid, c.mesh
    slab = slabs(n=1, k=K)[0]
    exe = fluid.Executor(c.place)
    for name, cfg, drop in (("dcn2dp2", {"dcn_dp": 2, "dp": 2}, 0.0),
                            ("dp4", {"dp": 4}, 0.0),
                            ("drop_dcn2dp2", {"dcn_dp": 2, "dp": 2}, 0.3),
                            ("drop_dp4", {"dp": 4}, 0.3)):
        grid = mesh.make_mesh(mesh.MeshConfig(**cfg))
        main, startup, loss = mlp(fluid, BATCH // 4, drop)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        mine = local(slab, grid, mesh.DATA_AXIS)
        modes = (True, False) if name == "dcn2dp2" else (True,)
        for hier in modes:
            c.flag(dcn_hierarchical=hier)
            scope = c.start_scope(exe, startup)
            got = exe.run_steps(comp, feed=mine, fetch_list=[loss],
                                scope=scope)[0]
            tag = name + ("" if hier else "_flat")
            c.flags[tag] = {
                "losses": [float(v) for v in np.ravel(got)],
                "hier_ops": sum(op.type == "hier_allreduce" for op in
                                comp.program.global_block().ops),
                "report": getattr(comp, "hier_report", None)}
            for p in main.all_parameters():
                c.arrays[f"{tag}/{p.name}"] = \
                    scope.find_var(p.name).numpy().copy()
            if hier and name == "dcn2dp2":
                # the single-step run decomposes too
                s1 = c.start_scope(exe, startup)
                one = {k: v[0] for k, v in mine.items()}
                c.flags[tag]["run_loss"] = float(np.ravel(exe.run(
                    comp, feed=one, fetch_list=[loss], scope=s1)[0])[0])
            comp.hier_report = None
        c.flag(dcn_hierarchical=True)


def run_mix(c):
    import torch_ep_mix_runner as M
    fluid, mesh = c.fluid, c.mesh
    for name in M.DCN_GRIDS:
        with np.load(c.args["mix_start"][name]) as z:
            start = {k: z[k] for k in z.files}
        out, fl = M.train(fluid, mesh, c.place, name, start)
        c.arrays.update({f"mix/{name}/{k}": v for k, v in out.items()})
        c.flags[f"mix/{name}"] = fl


# ------------------------------------------------------------- the drills

def make_build(c, scopes):
    """The SliceSupervisor's ``build``: the MLP over ``dcn_dp=width`` x
    ``dp=2`` on ``devices``; the last scope is kept in ``scopes``."""
    fluid, mesh = c.fluid, c.mesh

    def build(width, devices):
        grid = mesh.make_mesh(mesh.MeshConfig(dcn_dp=width, dp=PER_SLICE),
                              devices=devices)
        main, startup, loss = mlp(fluid, -1)
        comp = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=grid)
        scopes.append(fluid.Scope())
        return {"executor": fluid.Executor(c.place), "program": comp,
                "startup_program": startup, "scope": scopes[-1]}
    return build


def drill(c, name, n_slabs, dead_rounds, ckdir, **kw):
    """One SliceSupervisor run over ``n_slabs`` global slabs of 2 steps,
    checkpoints every slab; slice 1's beats are dropped at the exchanges
    whose round is in ``dead_rounds``. Returns (result, flags, the last
    scope)."""
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.train import SliceSupervisor
    scopes, widths, losses, seen = [], [], [], []
    box = []

    def on_slab_end(slab_idx, step, fetches):
        widths.append(box[0].width)
        seen.append(slab_idx)
        losses.append(float(np.ravel(fetches[0])[0]))

    kw.setdefault("cooldown_s", 0.0)
    sup = SliceSupervisor(make_build(c, scopes), ckdir, slices=2,
                          heartbeat_timeout_s=1.5, window=2,
                          clock=lambda: box[0].rounds if box else 0, steps_per_run=2,
                          checkpoint_every_n_slabs=1,
                          on_slab_end=on_slab_end, **kw)
    box.append(sup)

    def drop(point, ctx):
        if sup.slice == 1 and ctx["round"] in dead_rounds:
            return resilience.FaultInjected("slice 1 is down")
        return None

    with resilience.fault_injection("train.slice_heartbeat", exc=drop,
                                    times=-1):
        res = sup.run_slabs(slabs(n=n_slabs), fetch_list=["mean_0.tmp_0"])
    fl = {"dcn_dp": res["dcn_dp"], "idle": bool(res.get("idle")),
          "slabs": res.get("slabs"), "restarts": res.get("restarts"),
          "events": res["slice_events"], "widths": widths,
          "seen": seen, "losses": losses, "rounds": sup.rounds}
    c.flags[name] = fl
    return res, fl, scopes[-1] if scopes else None


def weights(scope):
    return {n: scope.find_var(n).numpy().copy() for n in scope.keys()
            if n.endswith((".w_0", ".b_0"))}


def run_drills(c):
    from paddle_tpu_torch import resilience, train
    fluid, mesh = c.fluid, c.mesh
    out = c.args["out"]
    res, fl, last = drill(c, "shrink", 8, range(2, 99),
                          os.path.join(out, "elastic"))
    # the control: a healthy wide run preempted at the same boundary,
    # resumed by a never-failed narrow supervisor on ranks 0, 1
    n_pre = _agree(c, sum(1 for w in fl["widths"] if w == 2))
    ck = os.path.join(out, "control")
    scopes = []
    build = make_build(c, scopes)
    parts = build(2, None)

    def preempt(slab_idx, step, fetches):
        if slab_idx == n_pre:
            train.request_preemption("drill")

    wide = train.TrainingSupervisor(
        parts["executor"], parts["program"], ck,
        startup_program=parts["startup_program"], scope=parts["scope"],
        steps_per_run=2, checkpoint_every_n_slabs=1, on_slab_end=preempt)
    g = parts["program"].mesh
    try:
        wide.run_slabs([local(s, g, mesh.DATA_AXIS) for s in slabs(n=8)],
                       fetch_list=["mean_0.tmp_0"])
        preempted = False
    except train.PreemptedError:
        preempted = True
    train.clear_preemption()
    parts["executor"].close()
    mesh.barrier()
    ctl = {"preempted": preempted, "n_pre": n_pre}
    if c.rank < 2:
        narrow = build(1, [0, 1])
        ctl_losses = []
        sup_n = train.TrainingSupervisor(
            narrow["executor"], narrow["program"], ck,
            startup_program=narrow["startup_program"],
            scope=narrow["scope"], steps_per_run=2,
            checkpoint_every_n_slabs=1,
            on_slab_end=lambda i, s, f: ctl_losses.append(
                float(np.ravel(f[0])[0])))
        ctl["resumed"] = sup_n.resume() is not None
        m = narrow["program"].mesh
        sup_n.run_slabs([local(s, m, mesh.DATA_AXIS) for s in slabs(n=8)],
                        fetch_list=["mean_0.tmp_0"])
        a, b = weights(last), weights(narrow["scope"])
        ctl["weights_bitwise"] = sorted(a) == sorted(b) and all(
            np.array_equal(a[n], b[n]) for n in a)
        ctl["losses_bitwise"] = fl["losses"][n_pre:] == ctl_losses
        ctl["post"] = len(ctl_losses)
        with open(os.path.join(out, "elastic", "states.json"), "w") as f:
            json.dump(_states(os.path.join(out, "elastic")), f)
    c.flags["control"] = ctl
    mesh.barrier()
    drill(c, "regrow", 10, range(2, 6), os.path.join(out, "regrow"))
    mesh.barrier()
    with resilience.fault_injection("train.allreduce_dcn",
                                    exc=ConnectionError, times=-1):
        drill(c, "dcn_fault", 3, (), os.path.join(out, "fault"),
              restart_budget=1, cooldown_s=1000.0)
    mesh.barrier()
    with resilience.fault_injection("train.allreduce_dcn",
                                    exc=ConnectionError, times=1):
        drill(c, "transient", 3, (), os.path.join(out, "transient"),
              restart_budget=3, cooldown_s=1000.0)
    mesh.barrier()


def _agree(c, value):
    """``value`` from rank 0 on every rank."""
    import torch
    t = torch.tensor([int(value)])
    from paddle_tpu_torch.ops.collective_ops import broadcast_
    c.mesh.activate(None)
    return int(broadcast_(t, 0, None)[0])


def _states(ckdir):
    from paddle_tpu_torch import train
    out = []
    for root, _, files in os.walk(ckdir):
        if train.TRAIN_STATE_FILE in files:
            with open(os.path.join(root, train.TRAIN_STATE_FILE)) as f:
                out.append(json.load(f))
    return out


def main(path):
    with open(path) as f:
        args = json.load(f)
    c = Ctx(args)
    run_op(c)
    run_ab(c)
    run_mix(c)
    run_drills(c)
    c.arrays["__flags__"] = np.array(json.dumps(c.flags, default=str))
    np.savez(os.path.join(args["out"], f"ms.{c.rank}.npz"), **c.arrays)
    c.mesh.barrier()


if __name__ == "__main__":
    main(sys.argv[1])
