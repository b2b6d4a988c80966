"""Multi-slice data parallelism of the port (the ``dcn_dp`` axis, the
``hier_allreduce`` op, pass ``hier_grad_sync``, the pre-run gate of
``parallel.dcn`` and ``train.SliceSupervisor``) against the JAX package,
on the CPU; the port's counterpart of ``tests/test_multislice.py``.

Without a launch: the pass against JAX's ``CompiledProgram`` op for op,
its idempotence, no ``hier_allreduce`` without ``dcn_dp``, the joint
batch spec, the gate on programs and a shape-only mesh, and the
``SliceSupervisor``'s control loop in a world of 1 on a fake clock
(JAX's drills: shrink, regrow, cooldown, the ``min_slices`` floor,
heartbeat chaos, the width stamp, a mismatched width, recovery charged
to goodput).

One launch of 4 gloo ranks (``tests/torch_ms_runner.py``; slices of 2
ranks) then runs the op at dcn_dp 2 x dp 2 against JAX's op under
``shard_map``; JAX's tiny MLP at dcn_dp 2 x dp 2 with the decomposed and
the flat sync against JAX's ``MeshConfig(dcn_dp=2, dp=2)`` run and the
port's dp 4 run (rank-mean losses and parameters within 1e-5 of max
|ref|); dropout masks equal to dp 4's; the gate's reports; dcn_dp 2
beside tp 2, ep 2 and a pp 2 pipeline against JAX on the same meshes
(rtol 2e-4); and the ``SliceSupervisor`` under the launch: a slice lost
and the run resumed at dcn_dp 1 bitwise a never-failed narrow run from
the same checkpoint, a slice regrown, a failing collective across slices
shrunk away, a transient one absorbed. The JAX references run in the
test process meanwhile.
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
from paddle_tpu_torch import resilience, train
from paddle_tpu_torch.framework.passes import apply_passes, get_pass
from paddle_tpu_torch.parallel import dcn
from paddle_tpu_torch.parallel.mesh import Mesh, partition_spec

import test_torch_ep_mix as MIX
import torch_ep_mix_runner as MR
import torch_ms_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 4
TOL = 1e-5
LOSS = "mean_0.tmp_0"


def jax_ab():
    """(losses, parameters) of JAX's run_steps slab of 4 on
    ``MeshConfig(dcn_dp=2, dp=2)`` over the global batch."""
    main, startup, loss = R.mlp(jfluid, -1)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    comp = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=make_mesh(MeshConfig(dcn_dp=2, dp=2)))
    got = exe.run_steps(comp, feed=R.slabs(n=1, k=R.K)[0],
                        fetch_list=[loss], scope=scope)[0]
    return np.ravel(np.asarray(got)), {
        p.name: np.array(scope.find_var(p.name))
        for p in main.all_parameters()}


def jax_op():
    """JAX's hier_allreduce under shard_map on dcn_dp 2 x dp 2: each
    device's block of the output."""
    import jax
    from jax.sharding import PartitionSpec as P
    from paddle_tpu.ops.collective_ops import hier_allreduce
    mesh = make_mesh(MeshConfig(dcn_dp=2, dp=2))

    class Ctx:
        pass
    ctx = Ctx()
    ctx.mesh = mesh
    attrs = {"inner_axis": "dp", "outer_axis": "dcn_dp", "mean": True}
    try:
        shard_map = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map
    f = shard_map(lambda x: hier_allreduce(ctx, {"X": [x[0]]}, attrs)
                  ["Out"][None], mesh=mesh,
                  in_specs=P(("dcn_dp", "dp")),
                  out_specs=P(("dcn_dp", "dp")))
    return np.asarray(f(R.op_blocks()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ms"))
    paths = {g: MIX.jax_start(os.path.join(tmp, f"mix_{g}.npz"),
                              MR.model(jfluid, MR.B, **MR.ALL_GRIDS[g][1])
                              [1])
             for g in MR.DCN_GRIDS}
    ab_start = MIX.jax_start(os.path.join(tmp, "ab_start.npz"),
                             R.mlp(jfluid, -1)[1])
    args = os.path.join(tmp, "args.json")
    with open(args, "w") as f:
        json.dump({"out": tmp, "mix_start": paths, "ab_start": ab_start},
                  f)
    pp = [REPO, HERE] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pp))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={N}", "--device=cpu",
         os.path.join(HERE, "torch_ms_runner.py"), args],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        refs = {"op": jax_op(), "ab": jax_ab()}
        refs.update({g: MIX.jax_reference(g) for g in MR.DCN_GRIDS})
        # a mismatch in the collectives shows only as a hang
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out.decode()[-3000:]
                                  + err.decode()[-6000:])
    ranks = []
    for r in range(N):
        with np.load(os.path.join(tmp, f"ms.{r}.npz")) as z:
            ranks.append(({k: z[k] for k in z.files if k != "__flags__"},
                          json.loads(str(z["__flags__"]))))
    return {"tmp": tmp, "refs": refs, "ranks": ranks,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the pass, the batch spec and the gate, without a launch


def _hier_program():
    main, _, _ = R.mlp(tfluid, -1)
    return main, apply_passes(main.clone(), [get_pass("hier_grad_sync")])


def test_pass_inserts_hier_allreduce_and_rewires():
    """One hier_allreduce per parameter grad, JAX's attrs, every sgd op
    reading the synced grad; the op sequence is JAX's CompiledProgram's
    on a dcn_dp mesh, op for op."""
    main, prog = _hier_program()
    block = prog.global_block()
    hier = [op for op in block.ops if op.type == "hier_allreduce"]
    assert len(hier) == 4
    for op in hier:
        assert op.attrs["inner_axis"] == "dp"
        assert op.attrs["outer_axis"] == "dcn_dp"
        assert op.attrs["mean"] is True
        assert op.output("Out") == [op.input("X")[0] + "@HIER"]
    synced = {op.output("Out")[0] for op in hier}
    for op in block.ops:
        if op.type == "sgd":
            assert op.input("Grad")[0] in synced
    jmain, _, jloss = R.mlp(jfluid, -1)
    jprog = jfluid.CompiledProgram(jmain).with_data_parallel(
        loss_name=jloss.name,
        mesh=make_mesh(MeshConfig(dcn_dp=2, dp=4))).program
    want = [(op.type, sorted(op.input_arg_names),
             sorted(op.output_arg_names))
            for op in jprog.global_block().ops]
    got = [(op.type, sorted(op.input_arg_names),
            sorted(op.output_arg_names)) for op in block.ops]
    assert got == want
    # the user's program is left as built
    assert not any(op.type == "hier_allreduce"
                   for op in main.global_block().ops)


def test_pass_is_idempotent():
    _, prog = _hier_program()
    n = len(prog.global_block().ops)
    apply_passes(prog, ["hier_grad_sync"])
    assert len(prog.global_block().ops) == n


def test_rewired_readers_get_new_input_lists():
    """The pass gives a rewired op new input lists (the op's dicts are
    shared with ``Operator.to_dict``): the clone it came from keeps the
    raw grads."""
    main, _, _ = R.mlp(tfluid, -1)
    clone = main.clone()
    before = {id(op): op.inputs for op in clone.global_block().ops}
    apply_passes(clone, [get_pass("hier_grad_sync")])
    for op in clone.global_block().ops:
        if op.type == "sgd":
            assert op.inputs is not before[id(op)]
    assert all(not g.endswith("@HIER") for op in main.global_block().ops
               for g in op.input_arg_names)


def test_no_dcn_mesh_no_hier_ops():
    main, _, loss = R.mlp(tfluid, -1)
    comp = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    assert not any(op.type == "hier_allreduce"
                   for op in comp.program.global_block().ops)


def test_batch_pspec_joint_over_dcn_and_dp():
    mesh = Mesh(4, dcn_dp=2)
    spec = partition_spec(mesh, (("dcn_dp", "dp"),), (16, R.FEAT))
    assert tuple(spec)[0] == ("dcn_dp", "dp")
    assert mesh.axis_size("dcn_dp+dp") == 8


def test_gate_accepts_the_decomposed_sync():
    _, prog = _hier_program()
    mesh = Mesh(2, dcn_dp=2)
    rep = dcn.hier_sync_report(prog, mesh, hierarchical=True)
    assert rep["violations"] == []
    kinds = {(r["kind"], r["group"]) for r in rep["rows"].values()}
    assert kinds == {("reduce-scatter", "dp"), ("all-reduce", "dcn_dp"),
                     ("all-gather", "dp")}
    # each grad's hop across slices carries its 1/dp shard; the flat
    # all-reduce over 4 would move 2 * 3/4 of every grad: 3x the bytes
    g = rep["grad_bytes"]
    assert rep["cross_slice_wire_bytes"] <= g / 2 + 4 * 4
    np.testing.assert_allclose(rep["flat_estimate_wire_bytes"], 1.5 * g)
    assert dcn.check_hier_sync(prog, mesh) is not None or True


def test_gate_flags_the_flat_sync_and_nothing_else():
    _, prog = _hier_program()
    rep = dcn.hier_sync_report(prog, Mesh(2, dcn_dp=2), hierarchical=False)
    assert rep["violations"]
    assert all("1/2 shard" in v or "do not beat" in v
               for v in rep["violations"]), rep["violations"]
    assert set(rep["rows"]) == {"all-reduce@dcn_dp+dp"}


def test_gate_rejects_a_double_synced_program():
    """dp_grad_allreduce before hier_grad_sync: the optimizer reads
    ``<grad>@HIER`` of a grad that a bucketed all-reduce already
    summed, a second full all-reduce a step."""
    main, _, _ = R.mlp(tfluid, -1)
    prog = apply_passes(main.clone(), [
        get_pass("dp_grad_allreduce", nranks=4, axis_name="dcn_dp+dp"),
        get_pass("hier_grad_sync")])
    with pytest.raises(resilience.HierarchicalCommsError) as ei:
        dcn.check_hier_sync(prog, Mesh(2, dcn_dp=2))
    assert any("synced 2 times" in v for v in ei.value.violations)
    assert ei.value.ledger["rows"]


def test_gate_rejects_a_program_without_the_sync():
    main, _, _ = R.mlp(tfluid, -1)
    with pytest.raises(resilience.HierarchicalCommsError) as ei:
        dcn.check_hier_sync(main, Mesh(2, dcn_dp=2))
    assert "hier_grad_sync" in str(ei.value)
    assert any("no collective across slices" in v
               for v in ei.value.violations)


# ---------------------------------------------------------------------------
# the SliceSupervisor's control loop in a world of 1 (fake clock)


def _slice_build(width, devices):
    main, startup, loss = R.mlp(tfluid, -1)
    _slice_build.scope = tfluid.Scope()
    return {"executor": tfluid.Executor(tfluid.CPUPlace()),
            "program": main, "startup_program": startup,
            "scope": _slice_build.scope}


def _drill(tmp_path, n_slabs, beat1_when, cooldown_s=0.0, **kw):
    """JAX's ``_drill``: a fake clock advancing 1 s a slab, slice 0
    always beating, slice 1 when ``beat1_when(slab_idx)``."""
    t = [0.0]
    box, widths = [], []

    def on_slab_end(slab_idx, step, fetches):
        t[0] += 1.0
        widths.append(box[0].width)
        box[0].beat(0, now=t[0])
        if beat1_when(slab_idx):
            box[0].beat(1, now=t[0])

    sup = train.SliceSupervisor(
        _slice_build, str(tmp_path), slices=2, heartbeat_timeout_s=1.5,
        window=2, cooldown_s=cooldown_s, clock=lambda: t[0],
        steps_per_run=2, checkpoint_every_n_slabs=1,
        on_slab_end=on_slab_end, **kw)
    box.append(sup)
    res = sup.run_slabs(R.slabs(n=n_slabs), fetch_list=[LOSS])
    return res, widths


def test_slice_loss_shrinks_width(tmp_path):
    res, widths = _drill(tmp_path, 8, lambda i: i < 2)
    assert res["dcn_dp"] == 1
    assert [e["event"] for e in res["slice_events"]] == ["slice_lost"]
    ev = res["slice_events"][0]
    assert ev["slice"] == 1 and ev["dcn_dp"] == 1 and ev["recovery_s"] > 0
    assert res["slabs"] == 8 and res["restarts"] == 0
    assert widths == [2] * 4 + [1] * 4


def test_slice_recovery_regrows_width(tmp_path):
    res, widths = _drill(tmp_path, 10, lambda i: i < 2 or i >= 6)
    assert res["dcn_dp"] == 2
    assert [e["event"] for e in res["slice_events"]] == \
        ["slice_lost", "slice_rejoined"]
    assert res["slice_events"][1]["dcn_dp"] == 2 and res["slabs"] == 10
    assert widths[0] == 2 and 1 in widths and widths[-1] == 2


def test_cooldown_blocks_immediate_regrow(tmp_path):
    res, _ = _drill(tmp_path, 10, lambda i: i < 2 or i >= 6,
                    cooldown_s=1000.0)
    assert res["dcn_dp"] == 1
    assert [e["event"] for e in res["slice_events"]] == ["slice_lost"]


def test_min_slices_floor_blocks_shrink(tmp_path):
    res, _ = _drill(tmp_path, 6, lambda i: False, min_slices=2)
    assert res["dcn_dp"] == 2 and res["slice_events"] == []


def test_heartbeat_chaos_drops_and_delays_beats():
    sup = train.SliceSupervisor(_slice_build, "/nonexistent", slices=2,
                                heartbeat_timeout_s=1.5, window=2)
    with resilience.fault_injection("train.slice_heartbeat",
                                    exc=resilience.FaultInjected, times=1):
        assert sup.beat(0) is False      # a dead slice: the beat dropped
    assert sup.beat(0) is True
    before = time.monotonic()
    with resilience.chaos(["train.slice_heartbeat"], delay=0.05):
        assert sup.beat(1) is True       # a straggler: the beat is late
    assert sup._beats[1] >= before + 0.05
    resilience.clear_faults()


def test_checkpoints_stamp_dcn_width(tmp_path):
    res, _ = _drill(tmp_path, 8, lambda i: i < 2)
    assert res["dcn_dp"] == 1
    states = []
    for p in sorted(tmp_path.rglob(train.TRAIN_STATE_FILE)):
        with open(p) as f:
            states.append(json.load(f))
    assert states and all("dcn_dp" in st for st in states)
    assert {st["dcn_dp"] for st in states} <= {1, 2}
    assert 1 in {st["dcn_dp"] for st in states}


def test_restored_width_mismatch_raises_typed():
    main, startup, _ = R.mlp(tfluid, -1)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    name = next(n for n in scope.keys() if n.endswith(".w_0"))
    good = scope.find_var(name)
    import torch
    scope.set(name, torch.zeros((good.shape[0] + 1,) + tuple(
        good.shape[1:])))
    with pytest.raises(resilience.SliceWidthError) as ei:
        train.validate_restored_widths(scope, main, width=2)
    assert ei.value.var == name and "dcn_dp" in str(ei.value)


def test_recovery_attributed_to_goodput_ledger(tmp_path):
    from paddle_tpu_torch.observability import render_metrics
    _drill(tmp_path, 8, lambda i: i < 2)
    text = render_metrics()
    assert 'train_slice_events_total{event="slice_lost"}' in text
    assert 'train_slices_count{state="active"} 1' in text
    recov = [ln for ln in text.splitlines()
             if ln.startswith("train_time_seconds_total")
             and 'category="recovery"' in ln]
    assert recov and float(recov[0].rsplit(" ", 1)[1]) > 0


# ---------------------------------------------------------------------------
# under the launch


def _rank_mean(world, tag):
    return np.mean([f[tag]["losses"] for _, f in world["ranks"]], axis=0)


@pytest.mark.parametrize("mode", ["hier", "flat"])
def test_op_matches_jax_under_shard_map(world, mode):
    want = world["refs"]["op"]
    for r, (arrays, _) in enumerate(world["ranks"]):
        got = arrays[f"op/{mode}"]
        # every rank holds the mean of the four blocks
        np.testing.assert_allclose(got, want[r], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, R.op_blocks().mean(0), atol=1e-6)


@pytest.mark.parametrize("tag", ["dcn2dp2", "dcn2dp2_flat", "dp4"])
def test_training_matches_jax_dcn_mesh(world, tag):
    jl, jparams = world["refs"]["ab"]
    top = max(float(np.abs(v).max()) for v in jparams.values())
    mean = _rank_mean(world, tag)
    assert float(np.abs(mean - jl).max()) <= TOL * max(np.abs(jl).max(), 1)
    for r, (arrays, _) in enumerate(world["ranks"]):
        for n, want in jparams.items():
            err = float(np.abs(arrays[f"{tag}/{n}"] - want).max())
            assert err <= TOL * top, (tag, r, n, err / top)


def test_hier_equals_flat_and_dp4(world):
    for tag in ("dcn2dp2_flat", "dp4"):
        np.testing.assert_allclose(_rank_mean(world, "dcn2dp2"),
                                   _rank_mean(world, tag), rtol=1e-5,
                                   atol=1e-6)
    a = world["ranks"][0][0]
    for k in a:
        if k.startswith("dcn2dp2/"):
            n = k.split("/", 1)[1]
            np.testing.assert_allclose(a[k], a[f"dp4/{n}"], rtol=1e-5,
                                       atol=1e-6)
    # one compiled program: the same 4 hier_allreduce ops either way
    for _, f in world["ranks"]:
        assert f["dcn2dp2"]["hier_ops"] == f["dcn2dp2_flat"]["hier_ops"] \
            == 4 and f["dp4"]["hier_ops"] == 0
        # Executor.run decomposes too: step 0 of the slab
        assert f["dcn2dp2"]["run_loss"] == f["dcn2dp2"]["losses"][0]


def test_dropout_draws_the_masks_of_dp4(world):
    np.testing.assert_allclose(_rank_mean(world, "drop_dcn2dp2"),
                               _rank_mean(world, "drop_dp4"), rtol=1e-5)
    for _, f in world["ranks"]:
        np.testing.assert_allclose(f["drop_dcn2dp2"]["losses"][0],
                                   f["drop_dp4"]["losses"][0], rtol=1e-6)


def test_gate_reports_of_the_run(world):
    """The executor's gate passed the decomposed run and left its byte
    table; the flat run's table flags only its one all-reduce across
    slices, 3x the decomposed run's bytes across slices."""
    for _, f in world["ranks"]:
        hier, flat = f["dcn2dp2"]["report"], f["dcn2dp2_flat"]["report"]
        assert hier["hierarchical"] and hier["violations"] == []
        assert not flat["hierarchical"]
        assert all("1/2 shard" in v or "do not beat" in v
                   for v in flat["violations"])
        ratio = flat["cross_slice_wire_bytes"] / \
            hier["cross_slice_wire_bytes"]
        assert 2.5 < ratio <= 3.0, ratio


@pytest.mark.parametrize("grid", list(MR.DCN_GRIDS))
def test_dcn_beside_tp_ep_pp_matches_jax(world, grid):
    sub = {"ranks": [({k.split("/", 1)[1]: v for k, v in a.items()
                       if k.startswith("mix/")},
                      {k.split("/", 1)[1]: v for k, v in f.items()
                       if k.startswith("mix/")})
                     for a, f in world["ranks"]],
           "refs": world["refs"]}
    MIX.check_losses(sub, grid)
    MIX.check_params(sub, grid)
    for _, f in sub["ranks"]:
        assert f[grid]["slab_bitwise"]


def test_shrink_resume_bitwise_vs_never_failed_narrow(world):
    for r, (_, f) in enumerate(world["ranks"]):
        s = f["shrink"]
        assert s["dcn_dp"] == 1
        assert [e["event"] for e in s["events"]] == ["slice_lost"]
        assert s["events"][0]["slice"] == 1
        if r < 2:
            assert s["widths"] == [2] * 4 + [1] * 4
            assert s["seen"] == list(range(1, 9)) and s["slabs"] == 8
            ctl = f["control"]
            assert ctl["preempted"] and ctl["resumed"]
            assert ctl["n_pre"] == 4 and ctl["post"] == 4
            assert ctl["weights_bitwise"] and ctl["losses_bitwise"]
        else:
            # the lost slice's ranks stayed in the loop without training
            assert s["idle"] and s["widths"] == [2] * 4
    ev = world["ranks"][0][1]["shrink"]["events"][0]
    for k in ("drain_s", "checkpoint_s", "rebuild_s", "restore_s",
              "capture_s"):
        assert ev[k] is not None and ev[k] >= 0, (k, ev)


def test_checkpoints_of_the_launch_stamp_dcn_width(world):
    with open(os.path.join(world["tmp"], "elastic", "states.json")) as f:
        states = json.load(f)
    assert states and {st["dcn_dp"] for st in states} <= {1, 2}
    assert 1 in {st["dcn_dp"] for st in states}


def test_slice_regrows_under_the_launch(world):
    for r, (_, f) in enumerate(world["ranks"]):
        g = f["regrow"]
        assert g["dcn_dp"] == 2 and not g["idle"]
        assert [e["event"] for e in g["events"]] == \
            ["slice_lost", "slice_rejoined"]
        assert g["widths"][0] == 2 and g["widths"][-1] == 2
        if r < 2:
            # every slab trained once, in order
            assert g["seen"] == list(range(1, 11)) and 1 in g["widths"]
        else:
            assert 1 not in g["widths"]


def test_dcn_fault_shrinks_and_transient_is_absorbed(world):
    for _, f in world["ranks"]:
        d = f["dcn_fault"]
        assert d["dcn_dp"] == 1
        assert [e["event"] for e in d["events"]] == ["slice_lost"]
        if not d["idle"]:
            assert d["slabs"] == 3
        t = f["transient"]
        assert t["dcn_dp"] == 2 and t["events"] == [] and t["restarts"] >= 1
    assert sum(not f["dcn_fault"]["idle"] for _, f in world["ranks"]) == 2


def test_ms_launch_stays_short(world, record_property):
    record_property("launch_seconds", world["seconds"])
    print(f"multi-slice launch: {world['seconds']:.1f} s")
    assert len(world["ranks"]) == N


def test_bert_split_batch_rebases_masked_positions():
    """A data-parallel rank of ``count`` is fed its rows of a global BERT
    batch: its masked positions index its own rows' tokens, the same
    tokens the global positions index; the parts put back together are
    the global batch (a slab's batch axis is 1)."""
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig.tiny()
    feed = bert.random_batch(cfg, 8, 16, 3, rng=np.random.default_rng(1))
    parts = [bert.split_batch(feed, i, 4) for i in range(4)]
    flat = feed["src_ids"].reshape(-1)
    for p in parts:
        assert p["src_ids"].shape == (2, 16) and p["mask_pos"].shape == (6,)
        assert p["mask_pos"].max() < 2 * 16
    np.testing.assert_array_equal(
        np.concatenate([p["src_ids"].reshape(-1)[p["mask_pos"]]
                        for p in parts]), flat[feed["mask_pos"]])
    for k in feed:
        if k != "mask_pos":
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), feed[k])
    slab = {k: np.stack([v, v]) for k, v in feed.items()}
    got = bert.split_batch(slab, 1, 2, axis=1)
    np.testing.assert_array_equal(got["mask_pos"][0],
                                  bert.split_batch(feed, 1, 2)["mask_pos"])
