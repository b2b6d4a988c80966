"""Worker of the port's CPU tests of expert parallelism beside tensor,
sequence and pipeline parallelism (``test_torch_ep_mix.py``,
``test_torch_ep_tp_dp.py``): one rank of a gloo world started by
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node=N
--device=cpu``. It trains ``model`` (a Megatron fc pair, a
``switch_moe``, an fc; under ``pp`` the fc pair sits in a
``layers.Pipeline`` of 2 stages and the MoE outside it) on each grid of
``args["grids"]`` (``GRIDS``: ep 2 x tp 2, ep 2 x sp 2 and pp 2 x ep 2
on 4 ranks; ep 2 x tp 2 x dp 2 on 8; ``DCN_GRIDS``, two slices beside
tp, ep or a pipeline, from the multi-slice runner), 3 Adam steps
eagerly and by a
``run_steps`` slab from the JAX startup's values, at a capacity factor
that drops tokens. Each rank writes its losses, its gathered parameters
and whether the slab was bitwise its eager steps to
``<out>/mix.<rank>.npz`` (``__flags__``: a JSON of its booleans and
numbers). ``model`` takes either package's ``fluid``, so the test
builds the JAX references on the same meshes from the same function;
this module imports the port only.

    python torch_ep_mix_runner.py <args.json>
"""
import json
import os
import sys

import numpy as np

B, S, D, E, H = 8, 8, 8, 4, 16
STEPS, LR, AUX_W, CF = 3, 0.01, 0.01, 0.5
# grid -> (mesh axes, what the model carries: tp annotations, an sp
# constraint, a pipeline of 2 stages)
GRIDS = {"ep2tp2": ({"ep": 2, "tp": 2}, {"tp": True}),
         "ep2sp2": ({"ep": 2, "sp": 2}, {"sp": True}),
         "pp2ep2": ({"pp": 2, "ep": 2}, {"pipe": True})}
GRIDS8 = {"ep2tp2dp2": ({"ep": 2, "tp": 2, "dp": 2}, {"tp": True})}
# two slices beside tp, ep or a pipeline (test_torch_multislice.py's
# launch runs them through ``train``)
DCN_GRIDS = {"dcn2tp2": ({"dcn_dp": 2, "tp": 2}, {"tp": True}),
             "dcn2ep2": ({"dcn_dp": 2, "ep": 2}, {}),
             "dcn2pp2": ({"dcn_dp": 2, "pp": 2}, {"pipe": True})}
ALL_GRIDS = dict(GRIDS, **GRIDS8, **DCN_GRIDS)
MICRO = 2


def model(fluid, rows, tp=False, sp=False, pipe=False, cf=CF, seed=9):
    """(main, startup, loss): x ``[rows, S, D]`` -> fc 2D (tanh; column
    split under ``tp``) -> fc D (row split) -> ``switch_moe`` over the
    ``[rows * S, D]`` tokens -> fc D, the loss MSE + 0.01 x AuxLoss,
    Adam. ``sp``: x pinned to ``("dp", "sp", None)``; ``pipe``: the fc
    pair is the one stage body of a 2-stage ``layers.Pipeline`` (its
    weights stacked ``[2, ...]``) and Adam goes through
    ``PipelineOptimizer``."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [rows, S, D], dtype="float32")
        y = L.data("y", [rows, S, D], dtype="float32")
        if sp:
            x = L.collective.shard(x, "dp", "sp", None)

        def pair(h):
            h = L.fc(h, 2 * D, num_flatten_dims=2, act="tanh")
            return L.fc(h, D, num_flatten_dims=2)

        if pipe:
            pl = L.Pipeline(num_stages=2, num_microbatches=MICRO)
            with pl.stage():
                pl.stage_output(pair(pl.stage_input(x)))
            h = pl()
        else:
            h = pair(x)
        out, aux = L.switch_moe(L.reshape(h, [-1, D]), num_experts=E,
                                d_hidden=H, capacity_factor=cf)
        o = L.fc(L.reshape(out, [rows, S, D]), D, num_flatten_dims=2)
        loss = L.elementwise_add(L.mean(L.square_error_cost(o, y)),
                                 L.scale(aux, AUX_W))
        if tp:
            mesh = fluid.parallel.mesh
            mesh.set_param_dist_attr(main, "fc_0.w_0", (None, "tp"))
            mesh.set_param_dist_attr(main, "fc_0.b_0", ("tp",))
            mesh.set_param_dist_attr(main, "fc_1.w_0", ("tp", None))
        opt = fluid.optimizer.Adam(LR)
        if pipe:
            opt = fluid.optimizer.PipelineOptimizer(opt,
                                                    num_microbatches=MICRO)
        opt.minimize(loss)
    return main, startup, loss


def feeds(steps=STEPS, seed=40):
    out = []
    for i in range(steps):
        rng = np.random.default_rng(seed + i)
        x = rng.standard_normal((B, S, D)).astype(np.float32)
        out.append({"x": x, "y": np.tanh(x[..., ::-1] * 1.5).astype(
            np.float32)})
    return out


def rows(feed, d, n):
    b = next(iter(feed.values())).shape[0] // n
    return {k: v[d * b:(d + 1) * b] for k, v in feed.items()}


# ------------------------------------------------------------- the rank

def train(fluid, mesh, place, name, start):
    from paddle_tpu_torch.framework.executor import scope_from_arrays
    from paddle_tpu_torch.parallel.tp import gathered
    axes, flags = ALL_GRIDS[name]
    grid = mesh.make_mesh(mesh.MeshConfig(**axes))
    co = grid.coords()
    # the batch is split over dcn_dp x dp, dcn-major
    d, dp = co[mesh.DATA_AXIS], grid.axis_size(mesh.DATA_AXIS)
    main, startup, loss = model(fluid, B // dp, **flags)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=grid)
    exe = fluid.Executor(place)
    fs = [rows(f, d, dp) for f in feeds()]
    scopes = []
    for _ in range(2):
        sc = fluid.Scope()
        exe.run(startup, scope=sc)
        scope_from_arrays(sc, start)
        scopes.append(sc)
    sA, sB = scopes
    eager = [float(np.ravel(exe.run(comp, feed=f, fetch_list=[loss],
                                    scope=sA)[0])[0]) for f in fs]
    slab = exe.run_steps(comp, feed=fs, fetch_list=[loss], scope=sB)[0]
    bitwise = bool(np.array_equal(np.asarray(eager, np.float32),
                                  np.ravel(slab))) and all(
        np.array_equal(v.numpy(), sB.find_var(k).numpy())
        for k, v in sA.items() if hasattr(v, "numpy"))
    params = [p.name for p in main.all_parameters()]
    out = {}
    with gathered(sA):
        for p in params:
            out[p] = sA.find_var(p).numpy().copy()
    return out, {"coords": co, "losses": eager, "slab_bitwise": bitwise,
                 "experts": sorted(getattr(comp.program, "_ep_layouts",
                                           {})),
                 "tp_shards": sorted(getattr(comp.program, "_tp_layouts",
                                             {}))}


def main(path):
    import torch
    torch.set_num_threads(1)
    with open(path) as f:
        args = json.load(f)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import mesh
    mesh.init_parallel_env()
    r = mesh.rank()
    arrays, flags = {}, {}
    for name in args["grids"]:
        with np.load(args["start"][name]) as z:
            start = {k: z[k] for k in z.files}
        out, fl = train(fluid, mesh, fluid.CPUPlace(), name, start)
        arrays.update({f"{name}/{k}": v for k, v in out.items()})
        flags[name] = fl
    arrays["__flags__"] = np.array(json.dumps(flags))
    np.savez(os.path.join(args["out"], f"mix.{r}.npz"), **arrays)
    mesh.barrier()


if __name__ == "__main__":
    main(sys.argv[1])
