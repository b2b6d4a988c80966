"""Data parallelism of the port (``CompiledProgram.with_data_parallel``,
``ParallelExecutor``, the collective ops, sync batch norm, the launcher)
against the JAX package, on the CPU.

One launch of 4 gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=4 --device=cpu
tests/torch_dp_runner.py``) runs every scenario of this file; the tests
then read what each rank wrote. Each rank is fed its rows of one global
batch of 8 and starts from the JAX package's startup values. The JAX
reference is the same program's single-device run on the whole global
batch (under GSPMD a data-parallel run computes over global arrays, so
it is that run):

- the fc + batch_norm classifier, 3 Momentum steps, with and without
  ``BuildStrategy.sync_batch_norm`` (both take the global batch's
  statistics), and a narrow ResNet: every parameter within 1e-5 of max
  |ref| of the JAX run, every rank's state bitwise rank 0's, the mean of
  the ranks' losses within rtol 2e-4 of the JAX loss;
- ``run_steps`` through a ``CompiledProgram`` bitwise its eager steps on
  each rank (``test_run_steps.py::test_run_steps_dp_mesh_parity``);
  ``train_from_dataset`` (slabs of 2) bitwise one run per batch;
  ``ParallelExecutor.run``;
- each collective op against numpy over the 4 ranks (and its grad), and
  each the identity in a world of 1, as the JAX op is outside a mapped
  axis;
- ``save_persistables``, a fresh scope, ``load_persistables`` and 2 more
  steps bitwise the uninterrupted run (``test_io.py:202`` without its tp
  axis), one copy written; a ``TrainCheckpoint`` round trip; a save
  that fails on rank 0 raises on every rank, and the next one works;
- ranks whose startups had other seeds end equal (the first run
  broadcasts rank 0's state);
- a NaN in one rank's rows rolls the step back on every rank;
- ``SelectedRows`` grads under data parallelism and sharded embedding
  tables: Wide&Deep at ``tests/test_models.py::test_widedeep_sharded_tables``'s
  shape, 3 Adam steps at dp 4 and at dp 2 x mp 2 (``table_dist_attr=
  ("mp", None)``, ``mp`` the port's ``tp``), plain and lazy, against
  the JAX package's run of the same program on its CPU mesh (dp 4, and
  a raw ``Mesh(devs, ("dp", "mp"))``): every parameter within 1e-5 of
  the model's max |ref|, every Adam moment within 1e-3 of its own (and
  at dcn_dp 2 x dp 2: the dense grads' ``hier_allreduce``, the sparse
  ones all-gathered over the joint data axis), the
  mean of the dp ranks' losses within rtol 3e-4, every rank's gathered
  state bitwise rank 0's; one ``c_allgather_selected_rows`` a table,
  the lookups ``c_embedding`` over a 32-row shard under mp; lazy Adam
  leaves each row no step names bitwise as it started, and a shard
  whose rows no later step names (every id of steps 2 and 3 in the
  other shard) bitwise as step 1 left it; the dp 2 x mp 2 save loads
  whole in the JAX package and at one card;
- a rank that raises mid-step ends the launch non-zero within 60 s.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid

import torch_dp_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 4
SCENARIOS = ["bn", "resnet", "run_steps", "parallel_executor",
             "collectives", "ckpt", "ckpt_fault", "seeds", "nonfinite",
             "dataset", "wd"]
JAX_RNG = "@RNG_KEY@"


def launch(tmp, scenarios, start, timeout=120):
    """Run ``scenarios`` on N gloo ranks through the port's launcher;
    returns the CompletedProcess."""
    args = os.path.join(tmp, "args.json")
    with open(args, "w") as f:
        json.dump({"out": tmp, "scenarios": scenarios, "start": start}, f)
    pp = [REPO, HERE] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pp))
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={N}", "--device=cpu",
         os.path.join(HERE, "torch_dp_runner.py"), args],
        env=env, capture_output=True, timeout=timeout, cwd=tmp)


def read(tmp, name):
    """[(arrays, flags)] of each rank's ``name`` scenario."""
    out = []
    for r in range(N):
        with np.load(os.path.join(tmp, f"{name}.{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files if k != "__flags__"}
            flags = json.loads(str(z["__flags__"]))
        out.append((arrays, flags))
    return out


def jax_run(build, feeds, seed=7):
    """The JAX package's single-device run of ``build`` on each global
    feed: (startup arrays, losses, final arrays)."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = seed
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        loss = build(jfluid)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    start = {n: np.array(v) for n, v in scope.items() if n != JAX_RNG}
    losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0]) for f in feeds]
    final = {n: np.array(v) for n, v in scope.items() if n != JAX_RNG}
    return start, losses, final


def save_start(tmp, name, arrays):
    path = os.path.join(tmp, f"start_{name}.npz")
    np.savez(path, **arrays)
    return path


def jax_wd_run(axes, lazy, dist, kind, seed=7):
    """The JAX package's Wide&Deep run of ``R.WD_CASES``' case on its CPU
    mesh (``axes`` {"dp": 4}: ``MeshConfig(dp=4)``; {"dp": 2, "tp": 2}:
    a raw ``Mesh(devs, ("dp", "mp"))``, as its test builds it), fed the
    global batches: (losses, final arrays, step 1's arrays). Beside
    ``dcn_dp`` it is the one-device run: the JAX package's multi-slice
    grad sync fails on a ``SelectedRows`` grad (a ``ValueError`` from
    broadcasting its values against the table), where the port
    all-gathers it over the joint data axis."""
    import jax
    from jax.sharding import Mesh
    from paddle_tpu.models import widedeep as jwd
    from paddle_tpu.parallel.compiler import CompiledProgram
    from paddle_tpu.parallel.mesh import MeshConfig, make_mesh
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = seed
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        loss = R.wide_deep(jfluid, jwd, lazy, dist)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    if "tp" in axes:
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("dp", "mp"))
    elif "dcn_dp" in axes:
        mesh = None
    else:
        mesh = make_mesh(MeshConfig(**axes))
    prog = main if mesh is None else CompiledProgram(
        main).with_data_parallel(loss_name=loss.name, mesh=mesh)
    losses, step1 = [], None
    for f in R.wd_feeds(jwd, kind):
        losses.append(float(np.ravel(exe.run(prog, feed=f,
                                             fetch_list=[loss],
                                             scope=scope)[0])[0]))
        if step1 is None:
            step1 = {n: np.array(v) for n, v in scope.items()
                     if n != JAX_RNG}
    final = {n: np.array(v) for n, v in scope.items() if n != JAX_RNG}
    return losses, final, step1, main


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp"))
    from paddle_tpu.models import widedeep as jwd
    refs = {"bn": jax_run(R.bn_classifier, R.classifier_feeds()),
            "resnet": jax_run(R.narrow_resnet, R.image_feeds()),
            "wd": jax_run(lambda fl: R.wide_deep(fl, jwd), [])}
    start = {k: save_start(tmp, k, v[0]) for k, v in refs.items()}
    refs["wd_cases"] = {name: jax_wd_run(axes, lazy, dist, kind)
                        for name, axes, lazy, dist, kind, _ in R.WD_CASES}
    t0 = time.perf_counter()
    proc = launch(tmp, SCENARIOS, start)
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    return {"tmp": tmp, "refs": refs, "seconds": time.perf_counter() - t0}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def assert_ranks_bitwise(ranks, keys=None):
    ref = ranks[0][0]
    keys = keys or [k for k in ref if not k.startswith("losses")]
    for r, (arrays, _) in enumerate(ranks[1:], 1):
        for k in keys:
            assert np.array_equal(arrays[k], ref[k]), \
                f"rank {r}'s {k!r} differs from rank 0's"


def assert_params_close(arrays, final, prefix="", tol=1e-5, model=False):
    """Every array of ``final`` within ``tol`` of its own max |ref|, or,
    with ``model``, of the largest value of all of them."""
    top = max(float(np.abs(v).max()) for v in final.values() if v.size)
    for name, want in final.items():
        got = arrays[prefix + name]
        err = _rel(got, want)
        if model:
            err *= max(float(np.abs(want).max()), 1e-30) / top
        assert err <= tol, f"{name}: {err:.3g} of max |ref|"


def assert_mean_loss(ranks, losses, key="losses"):
    mean = np.mean([a[key] for a, _ in ranks], axis=0)
    np.testing.assert_allclose(mean, losses, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("sync", [False, True])
def test_bn_classifier_matches_jax_global_batch(world, sync):
    ranks = read(world["tmp"], "bn")
    _, losses, final = world["refs"]["bn"]
    flags = ranks[0][1]
    # every training batch_norm syncs, with the flag or without it
    assert flags[f"sync_bn_ops_{sync}"] == 1
    assert flags[f"allreduce_ops_{sync}"] == 1
    keys = [k for k in ranks[0][0] if k.startswith(f"{sync}/")]
    assert_ranks_bitwise(ranks, keys)
    assert_params_close(ranks[0][0], final, prefix=f"{sync}/")
    assert_mean_loss(ranks, losses, key=f"losses_{sync}")


def test_narrow_resnet_matches_jax_global_batch(world):
    ranks = read(world["tmp"], "resnet")
    _, losses, final = world["refs"]["resnet"]
    assert_ranks_bitwise(ranks)
    assert_params_close(ranks[0][0], final)
    assert_mean_loss(ranks, losses)


def test_run_steps_bitwise_eager_steps_on_every_rank(world):
    ranks = read(world["tmp"], "run_steps")
    for r, (_, flags) in enumerate(ranks):
        assert flags["fetch_bitwise"] and flags["scope_bitwise"], (r, flags)
    assert_ranks_bitwise(ranks)
    _, losses, final = world["refs"]["bn"]
    assert_params_close(ranks[0][0], final)
    assert_mean_loss(ranks, losses)


def test_train_from_dataset_bitwise_its_runs(world):
    ranks = read(world["tmp"], "dataset")
    for r, (_, flags) in enumerate(ranks):
        assert flags == {"batches": 5, "bitwise": True}, (r, flags)
    assert_ranks_bitwise(ranks)


def test_parallel_executor_run(world):
    ranks = read(world["tmp"], "parallel_executor")
    _, losses, final = world["refs"]["bn"]
    assert_ranks_bitwise(ranks)
    assert_params_close(ranks[0][0], final)
    assert_mean_loss(ranks, losses)


def _collective_ref(op, xs, cot2, r):
    s = np.sum(xs, axis=0)
    return {"c_allreduce_sum": s, "allreduce": s,
            "c_allreduce_max": np.max(xs, axis=0),
            "c_allreduce_min": np.min(xs, axis=0),
            "c_allreduce_prod": np.prod(xs, axis=0),
            "c_allgather": np.concatenate(xs),
            "c_reducescatter": s[r:r + 1],
            "c_broadcast": xs[2], "broadcast": xs[1],
            "c_sync_calc_stream": xs[r],
            "c_sync_comm_stream": xs[r]}[op]


@pytest.mark.parametrize("op", ["c_allreduce_sum", "c_allreduce_max",
                                "c_allreduce_min", "c_allreduce_prod",
                                "allreduce", "c_allgather",
                                "c_reducescatter", "c_broadcast",
                                "broadcast", "c_sync_calc_stream",
                                "c_sync_comm_stream"])
def test_collective_op_matches_numpy_over_ranks(world, op):
    ranks = read(world["tmp"], "collectives")
    feeds = [R.collective_feed(r, N) for r in range(N)]
    xs = np.stack([f["x"] for f in feeds])
    for r, (arrays, _) in enumerate(ranks):
        np.testing.assert_allclose(
            arrays[op], _collective_ref(op, xs, feeds[0]["cot2"], r),
            rtol=1e-6, atol=1e-6, err_msg=f"{op} on rank {r}")


def test_collective_grads_over_ranks(world):
    """The grad of c_allreduce_sum is an all-reduce sum of the upstream
    grad; c_allgather's is the reduce-scatter of it."""
    ranks = read(world["tmp"], "collectives")
    feeds = [R.collective_feed(r, N) for r in range(N)]
    cots = np.stack([f["cot"] for f in feeds])
    for r, (arrays, _) in enumerate(ranks):
        # every rank holds the same cot2: its slice summed over the ranks
        np.testing.assert_allclose(
            arrays["grad"],
            cots.sum(axis=0) + N * feeds[0]["cot2"][4 * r:4 * r + 4],
            rtol=1e-5, atol=1e-6)


def test_collectives_are_identities_in_a_world_of_one():
    """Outside a launched world each collective op and its grads equal
    the JAX package's (which are identities outside a mapped axis)."""
    got = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            outs, g = R.collective_program(fluid, 1)
        exe = fluid.Executor() if pkg == "jax" else \
            fluid.Executor(fluid.CPUPlace())
        names = sorted(outs)
        vals = exe.run(main, feed=R.collective_feed(0, 1),
                       fetch_list=[outs[n] for n in names] + [g])
        got[pkg] = [np.asarray(v) for v in vals]
    for a, b in zip(got["jax"], got["port"]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    x = R.collective_feed(0, 1)["x"]
    np.testing.assert_array_equal(got["port"][0], x)


def test_checkpoint_resume_under_the_world(world):
    ranks = read(world["tmp"], "ckpt")
    for r, (_, flags) in enumerate(ranks):
        assert flags["loaded_equal"] and flags["resume_bitwise"] and \
            flags["scope_bitwise"], (r, flags)
        assert flags["tc_restored"] == flags["tc_no"] == 0, flags
        assert flags["tc_state"] == 4 and flags["tc_bitwise"], flags
    # one copy, by rank 0: the directory holds each file once
    files = sorted(os.listdir(os.path.join(world["tmp"], "ckpt")))
    assert "_manifest.json" in files and \
        len(files) == ranks[0][1]["files"], files
    assert os.listdir(os.path.join(world["tmp"], "tc")) == \
        ["__train_checkpoint__0"]


def test_failed_save_on_rank_0_raises_on_every_rank(world):
    ranks = read(world["tmp"], "ckpt_fault")
    flags = [f for _, f in ranks]
    assert flags[0]["raised"].startswith("OSError"), flags[0]
    for r, f in enumerate(flags[1:], 1):
        assert f["raised"].startswith("RuntimeError") and \
            "failed on rank 0" in f["raised"], (r, f)
    # the next save works everywhere: one number, one committed copy
    assert len({f["no"] for f in flags}) == 1 and flags[0]["no"] is not None
    for f in flags:
        assert f["numbers"] == [f["no"]], f


def test_ranks_with_other_startup_seeds_end_equal(world):
    ranks = read(world["tmp"], "seeds")
    before = [k for k in ranks[0][0] if k.startswith("before/")]
    assert any(not np.array_equal(ranks[1][0][k], ranks[0][0][k])
               for k in before), "the startups drew the same weights"
    after = [k for k in ranks[0][0] if not k.startswith("before/")]
    assert_ranks_bitwise(ranks, after)
    assert len({flags["run_seed"] for _, flags in ranks}) == 1


def test_nonfinite_on_one_rank_rolls_back_every_rank(world):
    ranks = read(world["tmp"], "nonfinite")
    for r, (_, flags) in enumerate(ranks):
        assert flags["run_vs_steps"] and flags["rolled_back"], (r, flags)
    assert_ranks_bitwise(ranks)


def _wd_ids(feeds, slot):
    return np.unique(np.concatenate([f[f"C{slot}"].ravel() for f in feeds]))


@pytest.mark.parametrize("case", R.WD_CASES, ids=[c[0] for c in R.WD_CASES])
def test_selected_rows_grads_raise_under_data_parallelism(world, case):
    """Once a refusal (``SelectedRows`` grads under data parallelism),
    now the parity case: Wide&Deep's sparse tables at dp 4 and dp 2 x
    mp 2 against the JAX package's run on its mesh."""
    from paddle_tpu.models import widedeep as jwd
    name, axes, lazy, dist, kind, how = case
    jlosses, jfinal, jstep1, jmain = world["refs"]["wd_cases"][name]
    ranks = read(world["tmp"], "wd")
    ref = {k[len(name) + 1:]: v for k, v in ranks[0][0].items()
           if k.startswith(name + "/") and "/step1/" not in k}
    for r, (arrays, _) in enumerate(ranks[1:], 1):
        for k, v in ref.items():
            if k != "losses":       # each dp rank's rows' mean
                assert np.array_equal(arrays[f"{name}/{k}"], v), (r, k)
    params = [p.name for p in jmain.all_parameters()]
    top = max(float(np.abs(jfinal[n]).max()) for n in params)
    for n in params:
        err = float(np.abs(ref[n].astype(np.float64) - jfinal[n]).max())
        assert err / top <= 1e-5, f"{name} {n}: {err / top:.3g}"
    moments = [k for k in jfinal if "_moment" in k]
    assert len(moments) == 2 * len(params)
    for k in moments:
        assert _rel(ref[k], jfinal[k]) <= 1e-3, (name, k)
    by_dp = {}
    for arrays, flags in ranks:
        by_dp.setdefault(flags[name]["data"], arrays[f"{name}/losses"])
    np.testing.assert_allclose(np.mean(list(by_dp.values()), axis=0),
                               jlosses, rtol=3e-4, atol=1e-6)
    slots = R.WD["num_slots"]
    vocab = R.WD["vocab_size"]
    sharded = "tp" in axes
    if how == "steps":
        # the captured steps passed the multi-slice gate, whose ledger
        # holds each table's all-gather over the joint data axis: every
        # rank's ids as int64 rows and fp32 values (deep and wide)
        b = R.WD_B // N
        per_rank = slots * b * ((8 + 4 * R.WD["embed_dim"]) + (8 + 4))
        for _, flags in ranks:
            gate = flags[f"{name}/gate"]
            assert gate["violations"] == []
            row = gate["rows"]["all-gather@dcn_dp+dp"]
            assert (row["count"], row["payload_bytes"]) == \
                (2 * slots, N * per_rank)
            assert gate["sparse"] == 0.75 * N * per_rank
            assert gate["cross"] < gate["flat"]
    for _, flags in ranks:
        mine = flags[name]
        assert mine["allgathers"] == 2 * slots
        if "dcn_dp" in axes:
            # the dense grads' hier_allreduce; the sparse ones all-gathered
            assert mine["hier"] == len(params) - 2 * slots
        assert mine["c_embedding"] == (2 * slots if sharded else 0)
        rows = vocab // 2 if sharded else vocab
        assert mine["table_local"] == [rows, R.WD["embed_dim"]]
        assert mine["moment_local"] == [rows, R.WD["embed_dim"]]
    if lazy:
        # a row no step names keeps its start value and zero moments
        start = world["refs"]["wd"][0]
        feeds = R.wd_feeds(jwd, kind)
        for i in range(slots):
            untouched = np.setdiff1d(np.arange(vocab), _wd_ids(feeds, i))
            assert untouched.size
            for t in (f"embedding_{i}.w", f"wide_embedding_{i}.w"):
                assert np.array_equal(ref[t][untouched], start[t][untouched])
                for m in ("moment1", "moment2"):
                    mom = next(k for k in ref if k.startswith(f"{t}_{m}"))
                    assert not ref[mom][untouched].any(), (t, m)
    if kind == "oob":
        # the second shard's rows: no id of steps 2 and 3 is in them
        half = vocab // 2
        step1 = {k[len(name) + 7:]: v for k, v in ranks[0][0].items()
                 if k.startswith(name + "/step1/")}
        for i in range(slots):
            for t in (f"embedding_{i}.w", f"wide_embedding_{i}.w"):
                for k in [t] + [k for k in ref if k.startswith(t + "_moment")]:
                    assert step1[k][half:].any() or "moment" not in k
                    assert np.array_equal(ref[k][half:], step1[k][half:]), k
                    assert np.array_equal(jfinal[k][half:],
                                          jstep1[k][half:]), k


def test_widedeep_sharded_save_loads_at_one_card_and_in_jax(world):
    """The dp 2 x mp 2 save holds every table whole: the JAX package and a
    port program at one card load it to the gathered state."""
    from paddle_tpu.models import widedeep as jwd
    from paddle_tpu_torch.models import widedeep as twd
    ranks = read(world["tmp"], "wd")
    ckpt = ranks[0][1]["ckpt"]
    want = {k[len("dp2mp2/"):]: v for k, v in ranks[0][0].items()
            if k.startswith("dp2mp2/") and "/step1/" not in k}
    for fl, wd, place in ((jfluid, jwd, None),
                          (tfluid, twd, tfluid.CPUPlace())):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            R.wide_deep(fl, wd)
        exe = fl.Executor(place) if place is not None else fl.Executor()
        scope = fl.Scope()
        exe.run(startup, scope=scope)
        fl.io.load_persistables(exe, ckpt, main_program=main, scope=scope)
        for v in main.list_vars():
            if v.persistable and v.name in want:
                got = scope.find_var(v.name)
                got = got.numpy() if hasattr(got, "numpy") else \
                    np.asarray(got)
                assert got.shape == want[v.name].shape, v.name
                assert np.array_equal(got, want[v.name]), v.name


def test_rank_raising_mid_step_ends_the_launch(tmp_path):
    tmp = str(tmp_path)
    start, _, _ = jax_run(R.bn_classifier, [])
    t0 = time.perf_counter()
    proc = launch(tmp, ["crash"], {"bn": save_start(tmp, "bn", start)},
                  timeout=60)
    assert proc.returncode != 0
    assert time.perf_counter() - t0 < 60
    assert b"rank 2 fails mid-step" in proc.stderr


def test_mesh_axes_other_than_dp_raise():
    """Every axis of JAX's ``AXIS_ORDER`` builds a mesh (here, a world of
    1, only at size 1; a tp 2, an sp 2, a pp 2, an ep 2 or a dcn_dp 2
    mesh needs 2 ranks) and ``partition_spec`` works, ``("pp",)``,
    ``("ep",)`` and the joint ``(("dcn_dp", "dp"),)`` included. The ep
    axis sits between dp and sp, dcn_dp outermost: rank ``((((c * pp +
    p) * dp + d) * ep + e) * sp + s) * tp + t``."""
    from paddle_tpu_torch.parallel import mesh
    for axis in ("tp", "sp", "pp", "ep", "dcn_dp"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            mesh.make_mesh(mesh.MeshConfig(**{axis: 2}))
    assert mesh.make_mesh(mesh.MeshConfig(sp=1)).shape == {"dp": 1}
    assert mesh.make_mesh(mesh.MeshConfig(tp=1)).shape == {"dp": 1}
    assert mesh.make_mesh(mesh.MeshConfig(pp=1)).shape == {"dp": 1}
    assert mesh.make_mesh(mesh.MeshConfig(ep=1)).shape == {"dp": 1}
    m = mesh.Mesh(2, ep=2)
    assert m.axis_names == ("dp", "ep") and m.size == 4
    assert [m.coords(r)["ep"] for r in range(4)] == [0, 1, 0, 1]
    assert [m.coords(r)["dp"] for r in range(4)] == [0, 0, 1, 1]
    assert m.axis_ranks("ep", 2) == [2, 3] and m.axis_ranks("dp", 1) == \
        [1, 3]
    assert m.axis_ranks("dp_ep", 3) == [0, 1, 2, 3]
    assert [m.coords(r)["dp_ep"] for r in range(4)] == [0, 1, 2, 3]
    big = mesh.Mesh(2, tp=2, sp=2, pp=2, ep=2)
    r = big.rank_of(1, 1, 0, 1, 1)
    assert r == (((1 * 2 + 1) * 2 + 1) * 2 + 1) * 2 + 0
    assert {k: big.coords(r)[k] for k in ("pp", "dp", "ep", "sp", "tp")} \
        == {"pp": 1, "dp": 1, "ep": 1, "sp": 1, "tp": 0}
    assert mesh.partition_spec(m, ("ep",), (4, 3)) == ("ep", None)
    assert mesh.partition_spec(m, ("ep",), (3, 3)) == (None, None)
    assert mesh.partition_spec(mesh.Mesh(1, pp=2), ("pp",), (2, 3)) == \
        ("pp", None)
    assert mesh.partition_spec(mesh.Mesh(1, pp=2), ("pp",), (3, 3)) == \
        (None, None)
    assert mesh.partition_spec(mesh.Mesh(2, 2), ("dp", "tp"), (4, 6)) == \
        ("dp", "tp")
    assert mesh.make_mesh(mesh.MeshConfig(dp=1)).shape == {"dp": 1}
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh.make_mesh(mesh.MeshConfig(dp=4))
    assert mesh.make_mesh(mesh.MeshConfig(dcn_dp=1)).shape == {"dp": 1}
    dcn = mesh.Mesh(2, dcn_dp=2)
    assert dcn.axis_names == ("dcn_dp", "dp") and dcn.size == 4
    assert [dcn.coords(r)["dcn_dp"] for r in range(4)] == [0, 0, 1, 1]
    assert [dcn.coords(r)["dcn_dp+dp"] for r in range(4)] == [0, 1, 2, 3]
    assert dcn.axis_ranks("dcn_dp", 1) == [1, 3]
    assert dcn.axis_ranks("dp", 2) == [2, 3]
    assert dcn.axis_ranks("dcn_dp+dp", 2) == [0, 1, 2, 3]
    wide = mesh.Mesh(2, tp=2, dcn_dp=2)
    assert wide.rank_of(1, 0, 1, dcn_dp=1) == ((1 * 2 + 1) * 2 + 1)
    assert mesh.partition_spec(dcn, (("dcn_dp", "dp"),), (16, 4)) == \
        (("dcn_dp", "dp"), None)
    assert mesh.partition_spec(dcn, (("dcn_dp", "dp"),), (6, 4)) == \
        (None, None)
    part = mesh.Mesh(2, ranks=[2, 3])
    assert 2 in part and 0 not in part and part.coords(3)["dp"] == 1
    with pytest.raises(ValueError, match="is not in"):
        part.coords(0)


def test_rewrite_runs_on_a_clone_and_keeps_the_op_order():
    """with_data_parallel leaves the user's program as built; the clone
    holds one sync_batch_norm per batch_norm and the bucketed grad
    all-reduce after the last grad producer, before the optimizer."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = R.narrow_resnet(tfluid)
    before = [op.type for op in main.global_block().ops]
    comp = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    assert [op.type for op in main.global_block().ops] == before
    types = [op.type for op in comp.program.global_block().ops]
    assert types.count("sync_batch_norm") == before.count("batch_norm")
    assert types.count("sync_batch_norm_grad") == \
        before.count("batch_norm_grad")
    i = types.index("c_coalesced_allreduce_sum")
    assert i > max(k for k, t in enumerate(types) if t.endswith("_grad"))
    assert i < types.index("momentum")


def test_unfused_all_reduce_warns_and_still_buckets():
    """fuse_all_reduce_ops=False has no effect, with a warning, as in the
    JAX package: the grads still go in coalesced buckets."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = R.narrow_resnet(tfluid)
    bs = tfluid.BuildStrategy()
    bs.fuse_all_reduce_ops = False
    with pytest.warns(UserWarning, match="fuse_all_reduce_ops=False has "
                      "no effect"):
        comp = tfluid.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel(loss_name=loss.name)
    synced = _grad_readers_follow_the_allreduce(comp.program)
    assert len(synced) == len(main.all_parameters())
    assert "c_allreduce_sum" not in \
        [op.type for op in comp.program.global_block().ops]


def test_gradient_scale_strategy_warns():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = R.bn_classifier(tfluid)
    bs = tfluid.BuildStrategy()
    bs.gradient_scale_strategy = \
        tfluid.BuildStrategy.GradientScaleStrategy.One
    with pytest.warns(UserWarning, match="CoeffNumDevice"):
        tfluid.CompiledProgram(main, build_strategy=bs).with_data_parallel(
            loss_name=loss.name)


def _grad_readers_follow_the_allreduce(program):
    """Every parameter grad is all-reduced once; after that no op writes
    it, and every op that reads it without writing it comes after."""
    block = program.global_block()
    synced = {n: i for i, op in enumerate(block.ops)
              if op.type == "c_coalesced_allreduce_sum"
              for n in op.input("X")}
    assert synced
    for n, i in synced.items():
        for k, op in enumerate(block.ops):
            if k == i:
                continue
            writes = n in op.output_arg_names
            assert not (writes and k > i), f"{op.type} rewrites {n}"
            assert writes or n not in op.input_arg_names or k > i, \
                f"{op.type} reads {n} before its all-reduce"
    return synced


@pytest.mark.parametrize("wrap", ["amp_dynamic_clip", "gradient_merge",
                                  "recompute"])
def test_allreduce_precedes_every_grad_reader(wrap):
    """AMP's unscale and finite check, a global-norm clip, a gradient
    merge's accumulate and a recompute backward all read the averaged
    grads."""
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 16], "float32")
        y = fluid.data("y", [-1, 1], "int64")
        h = fluid.layers.fc(x, 32, bias_attr=False)
        h = fluid.layers.batch_norm(h, act="relu")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, 4), y))
        if wrap == "amp_dynamic_clip":
            opt = fluid.optimizer.Momentum(
                0.1, 0.9, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))
            opt = fluid.contrib.mixed_precision.decorate(
                opt, use_dynamic_loss_scaling=True)
        elif wrap == "gradient_merge":
            opt = fluid.optimizer.GradientMergeOptimizer(
                fluid.optimizer.SGD(0.1), k_steps=2)
        else:
            opt = fluid.optimizer.RecomputeOptimizer(
                fluid.optimizer.SGD(0.1))
            opt._set_checkpoints([h])
        opt.minimize(loss)
    comp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    synced = _grad_readers_follow_the_allreduce(comp.program)
    assert len(synced) == len(main.all_parameters())
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = R.rows(R.classifier_feeds(1)[0], 0, 1)
    for _ in range(2):
        lv, = exe.run(comp, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all()
