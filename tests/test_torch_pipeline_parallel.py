"""Pipeline parallelism of the port across processes (the ``pp`` axis of
the mesh, pass ``pp_shard``, the ``pipeline`` op's GPipe schedule and
its hand-written backward) against the JAX package, on the CPU.

One launch of 4 gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=4 --device=cpu
tests/torch_pp_runner.py``) trains a narrow 4-layer GPT with its
decoder layers in a ``layers.Pipeline`` at pp 4, pp 2 x dp 2, on a pp 4
mesh under a 2-stage pipeline (the sequential path), at pp 2 x tp 2 (the
word embedding and tied head split on tp outside the pipeline) and at
pp 2 x sp 2 (the pipeline's input split on the sequence, gathered whole
before it); the tests then read what each rank wrote, and the JAX
references (the single-device runs of the 4- and 2-stage programs on
the whole batch, and the JAX runs of the tp and sp grids' programs on
the same meshes) are computed here while it runs:

- the losses within 1e-5 relative of the JAX package's and of the
  port's one-process run (each dp rank fetches the mean over its rows;
  their mean is the batch's);
- after 3 Adam steps every rank's stage slice within 1e-5 of max |ref|
  of the matching slice of JAX's stacked parameter, and the replicated
  parameters equal on every rank;
- a ``run_steps`` slab bitwise its eager steps (losses and scope);
- a save that gathers the slices to whole ``[S, ...]`` tensors and loads
  into the JAX package;
- ``num_stages`` != pp: the sequential path, the state whole, on every
  rank.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import gpt as jgpt

import torch_pp_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 4
JAX_RNG = "@RNG_KEY@"


def jax_program(stages):
    return R.program(jfluid, jgpt, R.B, stages, 4)


def jax_start(stages):
    main, startup, _ = jax_program(stages)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    return {n: np.array(v) for n, v in scope.items() if n != JAX_RNG}


def jax_train(stages):
    """(losses, final parameters, program) of the JAX single-device run
    of the whole batch."""
    main, startup, loss = jax_program(stages)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in R.feeds(jgpt)]
    final = {p.name: np.array(scope.find_var(p.name))
             for p in main.all_parameters()}
    return losses, final, main


def jax_mesh_losses(grid, n=None):
    """The losses of the JAX package's run of ``grid``'s program on its
    mesh (the 8-device CPU mesh), on the whole batch."""
    from paddle_tpu.parallel.mesh import MeshConfig, make_mesh
    main, startup, loss = R.grid_program(jfluid, jgpt, grid, R.B)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    comp = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name,
        mesh=make_mesh(MeshConfig(**R.ALL_GRIDS[grid][0])))
    return [float(np.ravel(exe.run(comp, feed=f, fetch_list=[loss],
                                   scope=scope)[0])[0])
            for f in R.feeds(jgpt)]


# the grids with tp or sp beside pp: each tp and sp rank runs its stage
MODEL_GRIDS = ("pp2tp2", "pp2sp2")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pp"))
    paths = {}
    for stages in (4, 2):
        paths[f"s{stages}"] = os.path.join(tmp, f"start_s{stages}.npz")
        np.savez(paths[f"s{stages}"], **jax_start(stages))
    args = os.path.join(tmp, "args.json")
    with open(args, "w") as f:
        json.dump({"out": tmp, "start": paths}, f)
    pp = [REPO, HERE] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pp))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={N}", "--device=cpu",
         os.path.join(HERE, "torch_pp_runner.py"), args],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        # the JAX references while the ranks run
        refs = {stages: jax_train(stages) for stages in (4, 2)}
        refs["mesh"] = {g: jax_mesh_losses(g) for g in MODEL_GRIDS}
        # a mismatch in the schedule's collectives shows only as a hang
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err.decode()[-6000:]
    ranks = []
    for r in range(N):
        with np.load(os.path.join(tmp, f"train.{r}.npz")) as z:
            ranks.append(({k: z[k] for k in z.files if k != "__flags__"},
                          json.loads(str(z["__flags__"]))))
    return {"tmp": tmp, "refs": refs, "ranks": ranks,
            "seconds": time.perf_counter() - t0}


def _stages(grid):
    return R.GRIDS[grid][1]


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_losses_match_jax_and_one_process(world, grid):
    jlosses = world["refs"][_stages(grid)][0]
    plain = world["ranks"][0][1][f"plain{_stages(grid)}"]["losses"]
    np.testing.assert_allclose(plain, jlosses, rtol=1e-5)
    per_dp = {}
    for arrays, flags in world["ranks"]:
        per_dp.setdefault(flags[grid]["coords"]["dp"],
                          []).append(flags[grid]["losses"])
    for d, runs in per_dp.items():
        # the pp ranks of one dp coordinate fetch the same loss
        assert all(r == runs[0] for r in runs), (grid, d, runs)
    mean = np.mean([runs[0] for runs in per_dp.values()], axis=0)
    np.testing.assert_allclose(mean, jlosses, rtol=1e-5)
    np.testing.assert_allclose(mean, plain, rtol=1e-5)


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_stage_slices_match_jax_stacked_params(world, grid):
    _, jfinal, _ = world["refs"][_stages(grid)]
    top = max(float(np.abs(v).max()) for v in jfinal.values())
    pipelined = grid != "pp4_stages2"
    for r, (arrays, flags) in enumerate(world["ranks"]):
        f = flags[grid]
        p = f["coords"]["pp"]
        assert sorted(f["stacked"]) == sorted(
            n for n in jfinal if n.startswith("decoder_layer_"))
        assert bool(f["slices"]) == pipelined
        tp = R.GRIDS[grid][0].get("tp", 1)
        for n, want in jfinal.items():
            got = arrays[f"{grid}/local/{n}"]
            if n in f["stacked"] and pipelined:
                assert got.shape == (1,) + want.shape[1:], (n, got.shape)
                want = want[p:p + 1]
            elif n == "word_embedding" and tp > 1:
                # the rank's vocab rows (tp_shard), outside the pipeline
                v = want.shape[0] // tp
                t = f["coords"]["tp"]
                assert got.shape == (v,) + want.shape[1:], got.shape
                want = want[t * v:(t + 1) * v]
            else:
                assert got.shape == want.shape, (grid, n, got.shape)
            err = float(np.abs(got.astype(np.float64) - want).max())
            assert err <= 1e-5 * top, (grid, r, n, err / top)
            # the gathered state equals on every rank
            np.testing.assert_array_equal(
                arrays[f"{grid}/whole/{n}"],
                world["ranks"][0][0][f"{grid}/whole/{n}"])


@pytest.mark.parametrize("grid", MODEL_GRIDS)
def test_pp_with_tp_or_sp_matches_jax_on_the_same_mesh(world, grid):
    """pp 2 x tp 2 and pp 2 x sp 2: the losses within 1e-5 relative of
    the JAX package's run on the same mesh, and every rank of a pp
    coordinate holds its stage slices bit for bit alike (each runs the
    stage whole)."""
    per_dp = world["ranks"][0][1][grid]["losses"]
    np.testing.assert_allclose(per_dp, world["refs"]["mesh"][grid],
                               rtol=1e-5)
    by_pp = {}
    for arrays, flags in world["ranks"]:
        f = flags[grid]
        assert f["losses"] == per_dp
        for n in f["stacked"]:
            by_pp.setdefault((f["coords"]["pp"], n), []).append(
                arrays[f"{grid}/local/{n}"])
    for key, slices in by_pp.items():
        assert len(slices) == 2, key
        np.testing.assert_array_equal(slices[0], slices[1], err_msg=key)


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_run_steps_slab_is_bitwise_its_eager_steps(world, grid):
    for r, (_, flags) in enumerate(world["ranks"]):
        assert flags[grid]["slab_bitwise"], (grid, r)


def test_gathered_save_loads_in_jax(world):
    _, jfinal, jmain = world["refs"][4]
    for _, flags in world["ranks"]:
        assert flags["pp4"]["slices_kept"]
    exe, scope = jfluid.Executor(), jfluid.Scope()
    jfluid.io.load_params(exe, os.path.join(world["tmp"], "save_pp4"),
                          main_program=jmain, scope=scope)
    top = max(float(np.abs(v).max()) for v in jfinal.values())
    for n, want in jfinal.items():
        got = np.array(scope.find_var(n))
        assert got.shape == want.shape, n
        assert float(np.abs(got - want).max()) <= 1e-5 * top, n


def test_pp_launch_stays_short(world, record_property):
    """The one launch trained every grid on every rank inside its own
    deadline; its wall time is reported, not held."""
    record_property("launch_seconds", world["seconds"])
    print(f"pp launch: {world['seconds']:.1f} s")
    assert len(world["ranks"]) == N
