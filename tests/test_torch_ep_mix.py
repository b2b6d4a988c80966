"""Expert parallelism beside tensor, sequence and pipeline parallelism in
the port, against the JAX package on the same meshes, on the CPU.

One launch of 4 gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=4 --device=cpu
tests/torch_ep_mix_runner.py``) trains ``torch_ep_mix_runner.model`` (a
Megatron fc pair, a ``switch_moe`` of 4 experts at capacity factor 0.5,
which drops at least half of the tokens, an fc; Adam) at ep 2 x tp 2,
ep 2 x sp 2 and pp 2 x ep 2 (the fc pair in a 2-stage pipeline, the MoE
outside it); the JAX package trains the same program on the same
``MeshConfig`` on its 8-device CPU mesh meanwhile. The losses and every
gathered parameter must match the JAX run's within rtol 2e-4 (JAX
``tests/test_moe.py``'s tolerance; parameters within 2e-4 of max
|ref|), the ranks of one data coordinate must fetch the same losses, and
each slab must be bitwise its eager steps. A ``switch_moe`` inside a
pipeline stage under ep is refused by both packages.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.parallel.mesh import MeshConfig, make_mesh

import paddle_tpu_torch as tfluid

import torch_ep_mix_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
JAX_RNG = "@RNG_KEY@"
RTOL = 2e-4


def jax_start(path, startup):
    """Write the values of the JAX package's ``startup`` program to
    ``path`` (what the ranks start from); returns ``path``."""
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    np.savez(path, **{k: np.array(v) for k, v in scope.items()
                      if k != JAX_RNG})
    return path


def jax_reference(name):
    """(losses, final parameters) of the JAX run of the whole batch on
    the grid's mesh."""
    axes, flags = R.ALL_GRIDS[name]
    main, startup, loss = R.model(jfluid, R.B, **flags)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=make_mesh(MeshConfig(**axes)))
    losses = [float(np.ravel(exe.run(prog, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in R.feeds()]
    final = {p.name: np.array(scope.find_var(p.name))
             for p in main.all_parameters()}
    return losses, final


def launch(grids, n, tmp, timeout=240):
    """The runner on ``n`` gloo ranks over ``grids``, from the JAX
    startup's values, with the JAX references (:func:`jax_reference`)
    computed while the ranks run: ``{"refs", "ranks": [(arrays, flags)
    by rank], "seconds"}``."""
    refs = {}
    paths = {g: jax_start(os.path.join(tmp, f"start_{g}.npz"),
                          R.model(jfluid, R.B, **R.ALL_GRIDS[g][1])[1])
             for g in grids}
    args = os.path.join(tmp, "args.json")
    with open(args, "w") as f:
        json.dump({"out": tmp, "start": paths, "grids": list(grids)}, f)
    pp = [REPO, HERE] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pp))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={n}", "--device=cpu",
         os.path.join(HERE, "torch_ep_mix_runner.py"), args],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        for g in grids:
            refs[g] = jax_reference(g)
        # a mismatch in the collectives shows only as a hang
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err.decode()[-6000:]
    ranks = []
    for r in range(n):
        with np.load(os.path.join(tmp, f"mix.{r}.npz")) as z:
            ranks.append(({k: z[k] for k in z.files if k != "__flags__"},
                          json.loads(str(z["__flags__"]))))
    return {"refs": refs, "ranks": ranks,
            "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return launch(list(R.GRIDS), 4, str(tmp_path_factory.mktemp("mix")))


def check_losses(world, grid):
    jl, _ = world["refs"][grid]
    per_data = {}
    for _, flags in world["ranks"]:
        f = flags[grid]
        per_data.setdefault(f["coords"]["dcn_dp+dp"], []).append(
            f["losses"])
    for d, runs in per_data.items():
        # every tp, sp, ep and pp rank of a data coordinate fetches the
        # same loss
        assert all(r == runs[0] for r in runs), (grid, d, runs)
    mean = np.mean([runs[0] for runs in per_data.values()], axis=0)
    np.testing.assert_allclose(mean, jl, rtol=RTOL)


def check_params(world, grid):
    _, jfinal = world["refs"][grid]
    top = max(float(np.abs(v).max()) for v in jfinal.values())
    for r, (arrays, flags) in enumerate(world["ranks"]):
        for n, want in jfinal.items():
            got = arrays[f"{grid}/{n}"]
            assert got.shape == want.shape, (grid, n, got.shape)
            err = float(np.abs(got.astype(np.float64) - want).max())
            assert err <= RTOL * top, (grid, r, n, err / top)


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_losses_match_jax_on_the_same_mesh(world, grid):
    check_losses(world, grid)


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_parameters_match_jax_on_the_same_mesh(world, grid):
    check_params(world, grid)


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_run_steps_slab_is_bitwise_its_eager_steps(world, grid):
    for r, (_, flags) in enumerate(world["ranks"]):
        assert flags[grid]["slab_bitwise"], (grid, r)


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_experts_are_cut_over_ep_only(world, grid):
    """Each rank holds E/ep experts, the same slice on the tp, sp and pp
    ranks of its ep coordinate; only the tp grid's fc pair is split."""
    by_ep = {}
    for _, flags in world["ranks"]:
        f = flags[grid]
        assert len([n for n in f["experts"] if "moment" not in n
                    and "pow" not in n]) == 4, f["experts"]
        by_ep.setdefault(f["coords"]["ep"], set()).add(tuple(f["experts"]))
        assert bool(f["tp_shards"]) == (grid == "ep2tp2"), f["tp_shards"]
    assert all(len(v) == 1 for v in by_ep.values())
    # the capacity (C x E slots) is below the global tokens: tokens drop
    assert int(R.CF * R.B * R.S / R.E) * R.E < R.B * R.S


def test_ep_mix_launch_stays_short(world, record_property):
    record_property("launch_seconds", world["seconds"])
    print(f"ep mix launch: {world['seconds']:.1f} s")
    assert len(world["ranks"]) == 4


def test_switch_moe_in_a_stage_is_refused_by_both_packages():
    """The JAX package cannot shard a switch_moe's experts on ep inside
    a pipeline stage's shard_map (its ``shard_ep`` names a manual axis);
    the port refuses the same program with a typed error that names the
    JAX package's."""
    from paddle_tpu_torch.framework.passes import apply_passes, get_pass
    from paddle_tpu_torch.parallel.mesh import Mesh

    def build(fluid):
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = L.data("x", [R.B, R.D], dtype="float32")
            pl = L.Pipeline(num_stages=2, num_microbatches=2)
            with pl.stage():
                h = pl.stage_input(x)
                out, aux = L.switch_moe(h, num_experts=R.E, d_hidden=R.H)
                pl.stage_output(L.elementwise_add(out, h))
            loss = L.mean(pl())
            fluid.optimizer.PipelineOptimizer(
                fluid.optimizer.Adam(R.LR), num_microbatches=2).minimize(loss)
        return main, startup, loss

    main, _, _ = build(tfluid)
    for name in ("pp_shard", "ep_shard"):
        with pytest.raises(NotImplementedError,
                           match="JAX package refuses it as well"):
            apply_passes(main.clone(), [get_pass(name,
                                                 mesh=Mesh(1, pp=2, ep=2))])
    jmain, jstart, jloss = build(jfluid)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(jstart, scope=scope)
    prog = jfluid.CompiledProgram(jmain).with_data_parallel(
        loss_name=jloss.name, mesh=make_mesh(MeshConfig(pp=2, ep=2)))
    x = np.random.default_rng(0).standard_normal((R.B, R.D)).astype(
        np.float32)
    with pytest.raises(ValueError, match="manual axes"):
        exe.run(prog, feed={"x": x}, fetch_list=[jloss], scope=scope)
