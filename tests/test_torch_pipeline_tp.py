"""Pipeline parallelism beside tensor and data parallelism across 8
processes (pp 2 x tp 2 x dp 2) against the JAX package, on the CPU.

One launch of 8 gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=8 --device=cpu
tests/torch_pp_runner.py``, grid ``pp2tp2dp2``) trains the narrow
4-layer GPT of ``test_torch_pipeline_parallel.py`` with its decoder
layers in a 2-stage ``layers.Pipeline``, the word embedding and the tied
head split on tp outside it, 4 rows a dp rank; every tp rank of a stage
runs it whole. The JAX references, computed here while it runs: the
JAX package's run of the same program on the same mesh (its 8-device
CPU mesh) and the sequential single-device run, both on the whole
batch:

- the mean of the dp ranks' losses within 1e-5 relative of both, the
  ranks of one dp coordinate fetching the same loss;
- every rank's stage slices and its tp shard of the word embedding
  within 1e-5 of max |ref| of the JAX run's parameters, the stage
  slices bit for bit alike on the tp ranks of a stage;
- a ``run_steps`` slab bitwise its eager steps.
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
from paddle_tpu.parallel.mesh import MeshConfig, make_mesh

import torch_pp_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 8
GRID = "pp2tp2dp2"
JAX_RNG = "@RNG_KEY@"


def jax_run(mesh):
    """(losses, final parameters) of the JAX run of the grid's program on
    the whole batch, on ``mesh`` (None: one device, the sequential
    path)."""
    main, startup, loss = R.grid_program(jfluid, jgpt, GRID, R.B)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    prog = main if mesh is None else jfluid.CompiledProgram(
        main).with_data_parallel(loss_name=loss.name, mesh=mesh)
    losses = [float(np.ravel(exe.run(prog, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in R.feeds(jgpt)]
    return losses, {p.name: np.array(scope.find_var(p.name))
                    for p in main.all_parameters()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pptp"))
    main, startup, _ = R.grid_program(jfluid, jgpt, GRID, R.B)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    start = os.path.join(tmp, "start_s2.npz")
    np.savez(start, **{n: np.array(v) for n, v in scope.items()
                       if n != JAX_RNG})
    args = os.path.join(tmp, "args.json")
    with open(args, "w") as f:
        json.dump({"out": tmp, "start": {"s2": start}, "grids": [GRID],
                   "plain": False}, f)
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
        refs = {"mesh": jax_run(make_mesh(MeshConfig(
            **R.ALL_GRIDS[GRID][0]))), "sequential": jax_run(None)}
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
                          json.loads(str(z["__flags__"]))[GRID]))
    return {"refs": refs, "ranks": ranks,
            "seconds": time.perf_counter() - t0}


@pytest.mark.parametrize("ref", ["mesh", "sequential"])
def test_losses_match_jax(world, ref):
    per_dp = {}
    for _, f in world["ranks"]:
        per_dp.setdefault(f["coords"]["dp"], []).append(f["losses"])
    for d, runs in per_dp.items():
        assert all(r == runs[0] for r in runs), (d, runs)
    mean = np.mean([runs[0] for runs in per_dp.values()], axis=0)
    np.testing.assert_allclose(mean, world["refs"][ref][0], rtol=1e-5)


def test_slices_and_shards_match_jax(world):
    jfinal = world["refs"]["mesh"][1]
    top = max(float(np.abs(v).max()) for v in jfinal.values())
    by_pp = {}
    for arrays, f in world["ranks"]:
        c = f["coords"]
        assert f["slices"], "no stage slice was cut"
        for n, want in jfinal.items():
            got = arrays[f"{GRID}/local/{n}"]
            if n in f["stacked"]:
                want = want[c["pp"]:c["pp"] + 1]
                by_pp.setdefault((c["pp"], n), []).append(got)
            elif n == "word_embedding":
                v = want.shape[0] // 2
                want = want[c["tp"] * v:(c["tp"] + 1) * v]
            assert got.shape == want.shape, (n, got.shape)
            err = float(np.abs(got.astype(np.float64) - want).max())
            assert err <= 1e-5 * top, (c, n, err / top)
    for key, slices in by_pp.items():
        assert len(slices) == 4, key
        for s in slices[1:]:
            np.testing.assert_array_equal(s, slices[0], err_msg=str(key))


def test_run_steps_slab_is_bitwise_its_eager_steps(world):
    for r, (_, f) in enumerate(world["ranks"]):
        assert f["slab_bitwise"], r


def test_pp_tp_dp_launch_stays_short(world, record_property):
    """The one 8-rank launch trained the grid inside its own deadline;
    its wall time is reported, not held."""
    record_property("launch_seconds", world["seconds"])
    print(f"pp x tp x dp launch: {world['seconds']:.1f} s")
    assert len(world["ranks"]) == N
