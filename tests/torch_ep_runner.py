"""Worker of the port's expert-parallel CPU tests
(``test_torch_expert_parallel.py``): one rank of a gloo world of 4
started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node=4 --device=cpu``. On each grid of ``GRIDS`` (ep 2 x dp
2: ranks 0, 1 dp 0 and ranks 2, 3 dp 1; ep 4) it runs

- ``op``: one ``switch_moe`` op over fed inputs at a capacity factor
  small enough that experts overflow across ranks, each rank fed its dp
  rows of one global batch and its ep slice of the experts, and the
  ``alltoall`` op over ``ep`` on rank-stamped blocks;
- ``train``: ``model`` (an fc, a ``switch_moe``, an fc; MSE plus 0.01 x
  the aux loss; Adam) at the capacity factors of ``CAPACITY``, 3 steps
  eagerly and by a ``run_steps`` slab from the JAX startup's values,
  then, at ep 2 x dp 2, a save that gathers the expert slices whole
  (``<out>/save_ep2``), a load of it into a fresh scope and one more
  step from each scope.

Rank 0 also trains the one-process program on the whole batch. What a
rank saw goes to ``<out>/<scenario>.<rank>.npz`` (``__flags__``: a
JSON of its booleans and numbers). The builders take either package's
``fluid``, so the test builds the JAX references from the same
functions; this module imports the port only.

    python torch_ep_runner.py <args.json>
"""
import json
import os
import sys

import numpy as np

B, D, E, H = 32, 8, 4, 16
STEPS, LR, AUX_W = 3, 0.01, 0.01
OP_CF = 0.5
CAPACITY = {"cf2": 2.0, "cf05": 0.5}
GRIDS = {"ep2dp2": {"ep": 2, "dp": 2}, "ep4": {"ep": 4}}


def model(fluid, rows, cf, seed=9):
    """(main, startup, loss): x -> fc(tanh) -> switch_moe -> fc, the
    loss MSE + 0.01 x AuxLoss, Adam at ``LR``."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [rows, D], dtype="float32")
        y = L.data("y", [rows, D], dtype="float32")
        h = L.fc(x, D, act="tanh")
        out, aux = L.switch_moe(h, num_experts=E, d_hidden=H,
                                capacity_factor=cf)
        o = L.fc(out, D)
        loss = L.elementwise_add(L.mean(L.square_error_cost(o, y)),
                                 L.scale(aux, AUX_W))
        fluid.optimizer.Adam(LR).minimize(loss)
    return main, startup, loss


def feeds(steps=STEPS, seed=40):
    out = []
    for i in range(steps):
        rng = np.random.default_rng(seed + i)
        x = rng.standard_normal((B, D)).astype(np.float32)
        out.append({"x": x, "y": np.tanh(x[:, ::-1] * 1.5).astype(
            np.float32)})
    return out


def rows(feed, d, n):
    b = next(iter(feed.values())).shape[0] // n
    return {k: v[d * b:(d + 1) * b] for k, v in feed.items()}


def op_inputs(seed=3):
    """The op case's global inputs (X of the whole batch, whole
    experts)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"X": rng.standard_normal((B, D)).astype(f),
            "GateW": rng.standard_normal((D, E)).astype(f),
            "W1": (0.3 * rng.standard_normal((E, D, H))).astype(f),
            "B1": (0.1 * rng.standard_normal((E, H))).astype(f),
            "W2": (0.3 * rng.standard_normal((E, H, D))).astype(f),
            "B2": (0.1 * rng.standard_normal((E, D))).astype(f)}


def op_program(fluid, ins, cf=OP_CF):
    """One ``switch_moe`` op over data vars shaped as ``ins``: (main,
    startup, out, aux)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        block = main.global_block()
        v = {s: L.data(s, list(a.shape), "float32") for s, a in ins.items()}
        out = block.create_var(name="moe_out", shape=ins["X"].shape,
                               dtype="float32")
        aux = block.create_var(name="moe_aux", shape=(), dtype="float32")
        block.append_op(type="switch_moe", inputs={s: [v[s]] for s in v},
                        outputs={"Out": [out], "AuxLoss": [aux]},
                        attrs={"capacity_factor": float(cf)},
                        infer_shape=False)
    return main, startup, out, aux


# ------------------------------------------------------------- the rank

def _losses(vals):
    return [float(np.ravel(v)[0]) for v in vals]


def run_op(c, name):
    """The op case and the alltoall op on grid ``name``."""
    fluid, mesh = c.fluid, c.mesh
    grid = mesh.make_mesh(mesh.MeshConfig(**GRIDS[name]))
    co = grid.coords()
    d, e, dp, ep = co["dp"], co["ep"], grid.dp, grid.ep
    g = op_inputs()
    k = E // ep
    mine = {"X": rows({"X": g["X"]}, d, dp)["X"], "GateW": g["GateW"]}
    for s in ("W1", "B1", "W2", "B2"):
        mine[s] = np.ascontiguousarray(g[s][e * k:(e + 1) * k])
    main, _, out, aux = op_program(fluid, mine)
    comp = fluid.CompiledProgram(main).with_data_parallel(mesh=grid)
    exe = fluid.Executor(c.place)
    o, a = exe.run(comp, feed=mine, fetch_list=[out, aux],
                   scope=fluid.Scope())
    # alltoall over ep: block j of rank (d, e) stamped 100 * rank + j
    L = fluid.layers
    m2, s2 = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(m2, s2):
        x = L.data("a2a_x", [ep * 2, 3], "float32", stop_gradient=False)
        y = m2.global_block().create_var(name="a2a_y", shape=(ep * 2, 3),
                                         dtype="float32")
        m2.global_block().append_op(
            type="alltoall", inputs={"X": [x]}, outputs={"Out": [y]},
            attrs={"ring_id": 0, "axis_name": "ep"}, infer_shape=False)
        cot = L.data("a2a_cot", [ep * 2, 3], "float32")
        (gx,) = fluid.gradients([L.reduce_sum(L.elementwise_mul(y, cot))],
                                [x])
    r = mesh.rank()
    xv = np.repeat((100 * r + np.arange(ep)).astype(np.float32), 2)
    xv = np.repeat(xv[:, None], 3, 1)
    cv = xv + 0.5
    a2a, ga = exe.run(fluid.CompiledProgram(m2).with_data_parallel(
        mesh=grid), feed={"a2a_x": xv, "a2a_cot": cv},
        fetch_list=[y, gx], scope=fluid.Scope())
    return {"out": np.asarray(o), "aux": np.asarray(a),
            "a2a": np.asarray(a2a), "a2a_grad": np.asarray(ga)}, \
        {"coords": co}


def _scope(fluid, exe, startup, start):
    from paddle_tpu_torch.framework.executor import scope_from_arrays
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    scope_from_arrays(scope, start)
    return scope


def train(c, name, cap):
    fluid, mesh = c.fluid, c.mesh
    from paddle_tpu_torch.parallel.tp import gathered
    grid = mesh.make_mesh(mesh.MeshConfig(**GRIDS[name]))
    co = grid.coords()
    d, dp = co["dp"], grid.dp
    main, startup, loss = model(fluid, B // dp, CAPACITY[cap])
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=grid)
    exe = fluid.Executor(c.place)
    start = c.start(cap)
    fs = [rows(f, d, dp) for f in feeds()]
    sA, sB = (_scope(fluid, exe, startup, start) for _ in range(2))
    eager = _losses(exe.run(comp, feed=f, fetch_list=[loss], scope=sA)[0]
                    for f in fs)
    slab = exe.run_steps(comp, feed=fs, fetch_list=[loss], scope=sB)[0]
    flags = {"coords": co, "losses": eager}
    flags["slab_bitwise"] = bool(np.array_equal(
        np.asarray(eager, np.float32), np.ravel(slab))) and all(
        np.array_equal(v.numpy(), sB.find_var(k).numpy())
        for k, v in sA.items() if hasattr(v, "numpy"))
    params = [p.name for p in main.all_parameters()]
    flags["experts"] = [p for p in params
                        if main.global_block().var(p).dist_attr == ("ep",)]
    flags["slices"] = sorted(getattr(comp.program, "_ep_layouts", {}))
    out = {f"local/{p}": sA.find_var(p).numpy() for p in params}
    with gathered(sA):
        for p in params:
            out[f"whole/{p}"] = sA.find_var(p).numpy().copy()
    if name == "ep2dp2" and cap == "cf2":
        path = os.path.join(c.args["out"], "save_ep2")
        fluid.io.save_persistables(exe, path, main_program=main, scope=sA)
        flags["slices_kept"] = all(
            sA.find_var(p).shape[0] == E // grid.ep
            for p in flags["experts"])
        sC = fluid.Scope()
        exe.run(startup, scope=sC)
        fluid.io.load_persistables(exe, path, main_program=main, scope=sC)
        nxt = rows(feeds(1, seed=90)[0], d, dp)
        a = exe.run(comp, feed=nxt, fetch_list=[loss], scope=sA)[0]
        b = exe.run(comp, feed=nxt, fetch_list=[loss], scope=sC)[0]
        flags["resumed_bitwise"] = bool(np.array_equal(a, b)) and all(
            np.array_equal(sA.find_var(p).numpy(), sC.find_var(p).numpy())
            for p in params)
    return out, flags


def plain(c, cap):
    """The one-process program of the whole batch (no mesh)."""
    fluid = c.fluid
    main, startup, loss = model(fluid, B, CAPACITY[cap])
    exe = fluid.Executor(c.place)
    scope = _scope(fluid, exe, startup, c.start(cap))
    losses = _losses(exe.run(main, feed=f, fetch_list=[loss],
                             scope=scope)[0] for f in feeds())
    return {p.name: scope.find_var(p.name).numpy()
            for p in main.all_parameters()}, losses


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

    def start(self, key):
        with np.load(self.args["start"][key]) as z:
            return {k: z[k] for k in z.files}


def main(path):
    with open(path) as f:
        args = json.load(f)
    c = Ctx(args)
    arrays, flags = {}, {}
    for name in GRIDS:
        out, fl = run_op(c, name)
        arrays.update({f"op/{name}/{k}": v for k, v in out.items()})
        flags[f"op/{name}"] = fl
        for cap in CAPACITY:
            out, fl = train(c, name, cap)
            arrays.update({f"{name}/{cap}/{k}": v for k, v in out.items()})
            flags[f"{name}/{cap}"] = fl
    if c.rank == 0:
        for cap in CAPACITY:
            params, losses = plain(c, cap)
            arrays.update({f"plain/{cap}/{k}": v
                           for k, v in params.items()})
            flags[f"plain/{cap}"] = {"losses": losses}
    arrays["__flags__"] = np.array(json.dumps(flags))
    np.savez(os.path.join(args["out"], f"ep.{c.rank}.npz"), **arrays)
    c.mesh.barrier()


if __name__ == "__main__":
    main(sys.argv[1])
