"""Expert parallelism of the port (the ``ep`` axis of the mesh, the
``switch_moe`` op's global-order dispatch and its hand-written grad,
pass ``ep_shard``, the ``alltoall`` op) against the JAX package, on the
CPU.

One launch of 4 gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=4 --device=cpu
tests/torch_ep_runner.py``) runs every scenario at ep 2 x dp 2 and at
ep 4; the tests then read what each rank wrote, and the JAX references
are computed here while it runs (the JAX package's ``MeshConfig(ep=2,
dp=2)`` run on its 8-device CPU mesh, on the global batch):

- the op at a capacity factor where experts overflow across ranks: each
  rank's Out (its dp rows) and AuxLoss equal to the JAX op's on the
  global batch within 1e-5 of max |ref|; the data is such that a
  rank-local cumsum keeps another set of tokens, so only the global
  order passes;
- ``alltoall`` over ep: block j of rank i lands at block i of rank j,
  its grad the same exchange (against numpy);
- the MoE model trained 3 Adam steps at capacity factors 2.0 and 0.5:
  the losses within rtol 2e-4 (JAX ``tests/test_moe.py``'s tolerance)
  of the JAX ep 2 x dp 2 run and of the port's one-process run, every
  rank's expert slice and replicated parameter within 1e-5 of max |ref|
  of the JAX run's, a ``run_steps`` slab bitwise its eager steps;
- a save at ep 2 x dp 2 gathers the experts whole: it loads into the
  JAX package and into the port's one-process program, and a load at
  ep 2 x dp 2 resumes bit for bit.
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

import torch_ep_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 4
JAX_RNG = "@RNG_KEY@"
TOL = 1e-5


def jax_start(cap):
    main, startup, _ = R.model(jfluid, R.B, R.CAPACITY[cap])
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    return {n: np.array(v) for n, v in scope.items() if n != JAX_RNG}


def jax_train(cap, mesh):
    """(losses, final parameters, program) of the JAX run of the whole
    batch, on ``mesh`` (None: one device)."""
    main, startup, loss = R.model(jfluid, R.B, R.CAPACITY[cap])
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    prog = main if mesh is None else jfluid.CompiledProgram(
        main).with_data_parallel(loss_name=loss.name, mesh=mesh)
    losses = [float(np.ravel(exe.run(prog, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0])
              for f in R.feeds()]
    final = {p.name: np.array(scope.find_var(p.name))
             for p in main.all_parameters()}
    return losses, final, main


def jax_op():
    """(Out, AuxLoss) of the JAX op on the op case's global batch."""
    main, startup, out, aux = R.op_program(jfluid, R.op_inputs())
    exe = jfluid.Executor()
    o, a = exe.run(main, feed=R.op_inputs(), fetch_list=[out, aux],
                   scope=jfluid.Scope())
    return np.asarray(o), np.asarray(a)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ep"))
    paths = {}
    for cap in R.CAPACITY:
        paths[cap] = os.path.join(tmp, f"start_{cap}.npz")
        np.savez(paths[cap], **jax_start(cap))
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
         os.path.join(HERE, "torch_ep_runner.py"), args],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        # the JAX references while the ranks run
        mesh = make_mesh(MeshConfig(ep=2, dp=2))
        refs = {cap: {"ep2dp2": jax_train(cap, mesh)}
                for cap in R.CAPACITY}
        refs["op"] = jax_op()
        # a mismatch in the collectives shows only as a hang
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err.decode()[-6000:]
    ranks = []
    for r in range(N):
        with np.load(os.path.join(tmp, f"ep.{r}.npz")) as z:
            ranks.append(({k: z[k] for k in z.files if k != "__flags__"},
                          json.loads(str(z["__flags__"]))))
    return {"tmp": tmp, "refs": refs, "ranks": ranks,
            "seconds": time.perf_counter() - t0}


def _keep(np_x, gate_w, C, chunks):
    """Which tokens a cumsum keeps when each of ``chunks`` equal chunks
    of the batch counts its queue positions from 0 (1: the global
    order)."""
    logits = np_x.astype(np.float64) @ gate_w
    expert = np.argmax(logits, axis=-1)
    keep = np.zeros(len(expert), bool)
    for part in np.split(np.arange(len(expert)), chunks):
        seen = {}
        for i in part:
            seen[expert[i]] = seen.get(expert[i], 0) + 1
            keep[i] = seen[expert[i]] <= C
    return keep


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_switch_moe_keeps_the_global_order(world, grid):
    want_out, want_aux = world["refs"]["op"]
    g = R.op_inputs()
    C = max(int(R.OP_CF * R.B / R.E), 1)
    glob = _keep(g["X"], g["GateW"], C, 1)
    # the data makes a rank-local count keep other tokens
    assert not np.array_equal(glob, _keep(g["X"], g["GateW"], C, N))
    np.testing.assert_array_equal(~np.all(want_out == 0.0, axis=1), glob)
    top = float(np.abs(want_out).max())
    for arrays, flags in world["ranks"]:
        co = flags[f"op/{grid}"]["coords"]
        dp = R.GRIDS[grid].get("dp", 1)
        rows = R.rows({"o": want_out}, co["dp"], dp)["o"]
        got = arrays[f"op/{grid}/out"]
        assert float(np.abs(got - rows).max()) <= TOL * top, (grid, co)
        np.testing.assert_allclose(float(arrays[f"op/{grid}/aux"]),
                                   float(want_aux), rtol=TOL)


@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_alltoall_exchanges_blocks_in_index_order(world, grid):
    ep = R.GRIDS[grid]["ep"]
    for r, (arrays, flags) in enumerate(world["ranks"]):
        co = flags[f"op/{grid}"]["coords"]
        peers = [r - co["ep"] + j for j in range(ep)]
        # block j from peer j, which stamped it 100 * peer + my index
        want = np.repeat(np.array([100 * p + co["ep"] for p in peers],
                                  np.float32), 2)
        np.testing.assert_array_equal(arrays[f"op/{grid}/a2a"][:, 0], want)
        # the grad of sum(y * cot), cot = x + 0.5: the same exchange
        np.testing.assert_array_equal(arrays[f"op/{grid}/a2a_grad"][:, 0],
                                      want + 0.5)


@pytest.mark.parametrize("cap", list(R.CAPACITY))
@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_losses_match_jax_ep_mesh_and_one_process(world, grid, cap):
    jl = world["refs"][cap]["ep2dp2"][0]
    plain = world["ranks"][0][1][f"plain/{cap}"]["losses"]
    np.testing.assert_allclose(plain, jl, rtol=2e-4)
    per_dp = {}
    for _, flags in world["ranks"]:
        f = flags[f"{grid}/{cap}"]
        per_dp.setdefault(f["coords"]["dp"], []).append(f["losses"])
    for d, runs in per_dp.items():
        # the ep ranks of one dp coordinate fetch the same loss
        assert all(r == runs[0] for r in runs), (grid, cap, d, runs)
    mean = np.mean([runs[0] for runs in per_dp.values()], axis=0)
    np.testing.assert_allclose(mean, jl, rtol=2e-4)
    np.testing.assert_allclose(mean, plain, rtol=2e-4)


@pytest.mark.parametrize("cap", list(R.CAPACITY))
@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_expert_slices_match_jax_after_training(world, grid, cap):
    _, jfinal, _ = world["refs"][cap]["ep2dp2"]
    top = max(float(np.abs(v).max()) for v in jfinal.values())
    ep = R.GRIDS[grid]["ep"]
    k = R.E // ep
    for r, (arrays, flags) in enumerate(world["ranks"]):
        f = flags[f"{grid}/{cap}"]
        e = f["coords"]["ep"]
        assert len(f["experts"]) == 4
        # the experts, their Adam moments and beta-pows
        assert set(f["experts"]) <= set(f["slices"])
        assert all(any(n.startswith(p) for p in f["experts"])
                   for n in f["slices"]), f["slices"]
        for n, want in jfinal.items():
            got = arrays[f"{grid}/{cap}/local/{n}"]
            if n in f["experts"]:
                assert got.shape == (k,) + want.shape[1:], (n, got.shape)
                want = want[e * k:(e + 1) * k]
            else:
                assert got.shape == want.shape, (grid, n, got.shape)
            err = float(np.abs(got.astype(np.float64) - want).max())
            assert err <= TOL * top, (grid, cap, r, n, err / top)
            np.testing.assert_array_equal(
                arrays[f"{grid}/{cap}/whole/{n}"],
                world["ranks"][0][0][f"{grid}/{cap}/whole/{n}"])


@pytest.mark.parametrize("cap", list(R.CAPACITY))
@pytest.mark.parametrize("grid", list(R.GRIDS))
def test_run_steps_slab_is_bitwise_its_eager_steps(world, grid, cap):
    for r, (_, flags) in enumerate(world["ranks"]):
        assert flags[f"{grid}/{cap}"]["slab_bitwise"], (grid, cap, r)


def test_gathered_save_loads_in_jax_and_at_ep1(world):
    _, jfinal, jmain = world["refs"]["cf2"]["ep2dp2"]
    for _, flags in world["ranks"]:
        assert flags["ep2dp2/cf2"]["slices_kept"]
        assert flags["ep2dp2/cf2"]["resumed_bitwise"]
    path = os.path.join(world["tmp"], "save_ep2")
    top = max(float(np.abs(v).max()) for v in jfinal.values())
    exe, scope = jfluid.Executor(), jfluid.Scope()
    jfluid.io.load_params(exe, path, main_program=jmain, scope=scope)
    tmain, tstart, _ = R.model(tfluid, R.B, R.CAPACITY["cf2"])
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tstart, scope=tscope)
    tfluid.io.load_params(texe, path, main_program=tmain, scope=tscope)
    whole = world["ranks"][0][0]
    for n, want in jfinal.items():
        got = np.array(scope.find_var(n))
        assert got.shape == want.shape, n
        assert float(np.abs(got - want).max()) <= TOL * top, n
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      whole[f"ep2dp2/cf2/whole/{n}"])


def test_ep_launch_stays_short(world, record_property):
    """The one launch ran every grid on every rank inside its own
    deadline; its wall time is reported, not held."""
    record_property("launch_seconds", world["seconds"])
    print(f"ep launch: {world['seconds']:.1f} s")
    assert len(world["ranks"]) == N


def test_ep_shard_cuts_the_experts_and_refuses_other_axes():
    """Pass ``ep_shard`` over an ep 2 mesh in a world of 1 (a look at the
    rewrite): each expert parameter, its Adam moments and its grad take
    the ``[E / ep, ...]`` slice, the rest stays whole; beside tp, sp or
    pp the experts are cut per ep coordinate only (the same slice); an
    expert count the ep ranks do not divide raises."""
    from paddle_tpu_torch.framework.passes import apply_passes, get_pass
    from paddle_tpu_torch.parallel.mesh import Mesh
    main, _, _ = R.model(tfluid, R.B, 2.0)
    prog = apply_passes(main.clone(), [get_pass("ep_shard",
                                                mesh=Mesh(1, ep=2))])
    gb = prog.global_block()
    lay = prog._ep_layouts
    w1 = next(n for n in lay if gb.var(n).shape == (2, R.D, R.H))
    assert lay[w1].axis == "ep" and lay[w1].full_shape == (R.E, R.D, R.H)
    assert gb.var(w1 + "@GRAD").shape == (2, R.D, R.H)
    assert len([n for n in lay if n.startswith(w1 + "_moment")]) == 2
    assert gb.var("fc_0.w_0").shape == (R.D, R.D)
    assert main.global_block().var(w1).shape == (R.E, R.D, R.H)
    for mesh in (Mesh(1, tp=2, ep=2), Mesh(1, sp=2, ep=2),
                 Mesh(1, pp=2, ep=2), Mesh(2, tp=2, ep=2)):
        other = apply_passes(main.clone(), [get_pass("ep_shard",
                                                     mesh=mesh)])
        assert sorted(other._ep_layouts) == sorted(lay)
        assert other.global_block().var(w1).shape == (2, R.D, R.H)
        assert other.global_block().var("fc_0.w_0").shape == (R.D, R.D)
    with pytest.raises(ValueError, match="do not divide"):
        apply_passes(main.clone(), [get_pass("ep_shard",
                                             mesh=Mesh(1, ep=3))])
