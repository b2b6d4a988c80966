"""Sequence parallelism of the port (the ``sp`` axis of the mesh, the
split ``ring_attention``/``ulysses_attention`` ops and their bespoke
reverse-ring and all-to-all grads, pass ``sp_shard``, BERT's
``sp_shard``) against the JAX package, on the CPU.

One launch of 4 gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=4 --device=cpu
tests/torch_sp_runner.py``) runs every scenario on sp 4, dp 2 x sp 2
and tp 2 x sp 2 meshes; the tests then read what each rank wrote, and
the JAX references are computed here while it runs (each dp rank is fed
its rows of one global batch, and the JAX reference is the
single-device run on the whole batch):

- the op cases of ``tests/test_ring_attention.py`` (whole q, k, v fed
  to a program split by ``sp_shard``: a padding key mask at sp 4 and dp
  2 x sp 2, a ``[B, H, S, S]`` mask, a head-broadcast causal mask,
  ``causal=True`` at sp 4 and dp 2 x sp 2, a finite key bias whose grad
  is read): out and the grads of q, k, v (and the bias) within the JAX
  sharded tests' rtol 3e-4 / atol 1e-5 on every rank; at sp 4 the split
  op's own dK/dV on rank r are block r's grads summed over every rank's
  queries (the reverse ring carries them home), JAX's ``gk``/``gv`` at
  block r times sp;
- an S or a head count that the sp axis does not divide raises
  ``ValueError`` "divisible";
- ``test_long_sequence_trains_through_ring``'s model at sp 4 falls below
  half its first loss in 25 steps, its first loss the JAX package's;
- BERT-tiny with ``sp_shard=True`` under each mechanism (einsum, flash,
  ring, Ulysses) on each mesh, 3 Adam steps: the losses within rtol
  3e-4 of JAX's single-device run (``test_sp_matches_single_device``),
  every parameter within 1e-5 of the model's max |ref| of it and of the
  port's one-rank run;
- dropout 0.1 at sp 4 equals the one-rank run of the same rows: the
  split region's masks are chunks of the whole tensor's draw.

The no-launch cases: the ``sp_shard`` program through
``verify_program`` (with and after ``tp_shard``), the mesh's
coordinates, and the boundaries (a causal flash op under the split).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import bert as tbert

import torch_sp_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 4
SCENARIOS = ["ops", "long_seq", "bert", "dropout"]
JAX_RNG = "@RNG_KEY@"


def read(tmp, name):
    out = []
    for r in range(N):
        with np.load(os.path.join(tmp, f"{name}.{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files if k != "__flags__"}
            flags = json.loads(str(z["__flags__"]))
        out.append((arrays, flags))
    return out


def jax_program(build, seed=7):
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = seed
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        got = build(jfluid)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    return main, got, exe, scope


def jax_start(build, seed=7):
    _, _, _, scope = jax_program(build, seed)
    return {n: np.array(v) for n, v in scope.items() if n != JAX_RNG}


def jax_train(build, feeds, seed=7):
    """(losses, final arrays, program) of the JAX single-device run."""
    main, loss, exe, scope = jax_program(build, seed)
    losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])[0]) for f in feeds]
    final = {n: np.array(v) for n, v in scope.items() if n != JAX_RNG}
    return losses, final, main


def jax_op_case(mech, bias, causal, bias_grad):
    def build(fl):
        return R.build_attention(fl, mech, R.BIAS_SHAPES[bias], causal,
                                 bias_grad=bias_grad)
    main, (out, grads), exe, scope = jax_program(build)
    return [np.asarray(v) for v in exe.run(
        main, feed=R.attention_feed(bias), fetch_list=[out] + list(grads),
        scope=scope)]


def _bert_build(mech):
    return lambda fl: R.build_bert(fl, jbert, R.BERT["B"], mech)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp"))
    start = {"bert": jax_start(_bert_build(None)),
             "long_seq": jax_start(R.long_seq_model, seed=1)}
    paths = {}
    for k, v in start.items():
        paths[k] = os.path.join(tmp, f"start_{k}.npz")
        np.savez(paths[k], **v)
    args = os.path.join(tmp, "args.json")
    with open(args, "w") as f:
        json.dump({"out": tmp, "scenarios": SCENARIOS, "start": paths}, f)
    pp = [REPO, HERE] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pp))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={N}", "--device=cpu",
         os.path.join(HERE, "torch_sp_runner.py"), args],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        # the JAX references while the ranks run
        refs = {"ops": {name: jax_op_case(m, b, c, bg)
                        for name, m, b, c, _, bg in R.OP_CASES},
                "long_seq": jax_train(R.long_seq_model, [R.long_seq_feed()],
                                      seed=1)[0],
                "bert": {m: jax_train(_bert_build(m),
                                      R.bert_feeds(jbert)) for m in R.MECHS}}
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err.decode()[-6000:]
    return {"tmp": tmp, "refs": refs, "seconds": time.perf_counter() - t0}


@pytest.mark.parametrize("case", R.OP_CASES, ids=[c[0] for c in R.OP_CASES])
def test_split_op_equals_jax(world, case):
    name, mech, bias, causal, grid, bias_grad = case
    want = world["refs"]["ops"][name]
    n = 2 if grid == "dp2sp2" else 1
    tags = ("out", "gq", "gk", "gv", "gbias")[:len(want)]
    for r, (arrays, _) in enumerate(read(world["tmp"], "ops")):
        d = r // 2 if n == 2 else 0
        for tag, w in zip(tags, want):
            np.testing.assert_allclose(arrays[f"{name}/{tag}"],
                                       R._rows(w, d, n), rtol=3e-4,
                                       atol=1e-5,
                                       err_msg=f"rank {r} {name} {tag}")


@pytest.mark.parametrize("case", [c for c in R.OP_CASES
                                  if c[4] == "sp4"],
                         ids=[c[0] for c in R.OP_CASES if c[4] == "sp4"])
def test_each_rank_holds_its_blocks_whole_kv_grads(world, case):
    """The split op's own dK/dV on rank r (the reverse ring's
    accumulators after sp shifts, or Ulysses' all-to-all back) are block
    r's grads summed over every rank's queries: JAX's whole ``gk``/``gv``
    at block r, times sp (the cotangents of the split carry the factor
    sp; the chunk's grad takes it out)."""
    name = case[0]
    want = world["refs"]["ops"][name]
    L = R.S // N
    for r, (arrays, _) in enumerate(read(world["tmp"], "ops")):
        for tag, w in (("dk_local", want[2]), ("dv_local", want[3])):
            got = arrays[f"{name}/{tag}"]
            assert got.shape == (R.B, R.H, L, R.D)
            np.testing.assert_allclose(
                got / N, w[:, :, r * L:(r + 1) * L], rtol=3e-4, atol=1e-5,
                err_msg=f"rank {r} {name} {tag}")


def test_split_ring_runs_the_split_op(world):
    """The whole q, k, v are chunked into the ring op and its output
    gathered; its grad op is the op's own."""
    arrays, _ = read(world["tmp"], "ops")[1]
    types = list(arrays["ring_key_sp4/types"])
    assert types.count("sp_split") == 3
    assert "ring_attention" in types and "ring_attention_grad" in types
    assert types.count("sp_gather") == 1
    assert types.count("sp_split_grad") == 3
    assert types.count("sp_gather_grad") == 1


def test_divisibility_errors(world):
    _, flags = read(world["tmp"], "ops")[0]
    for mech, msg in flags["errors"].items():
        assert "divisible" in msg, (mech, msg)


def test_long_sequence_trains_through_ring(world):
    want = world["refs"]["long_seq"]
    for r, (arrays, _) in enumerate(read(world["tmp"], "long_seq")):
        losses = arrays["losses"]
        assert losses[-1] < 0.5 * losses[0], (r, losses[::8])
        np.testing.assert_allclose(losses[0], want[0], rtol=3e-4)


def _max_err(got, want, names):
    top = max(float(np.abs(want[n]).max()) for n in names)
    return max(float(np.abs(got[n].astype(np.float64) - want[n]).max())
               for n in names) / top


@pytest.mark.parametrize("grid", list(R.GRIDS))
@pytest.mark.parametrize("mech", R.MECHS, ids=[m or "einsum"
                                               for m in R.MECHS])
def test_bert_sp_shard_matches_single_device(world, mech, grid):
    ranks = read(world["tmp"], "bert")
    jlosses, jfinal, jmain = world["refs"]["bert"][mech]
    tag = mech or "none"
    names = [p.name for p in jmain.all_parameters()]
    plain = {n: ranks[0][0][f"{tag}/plain/{n}"] for n in names}
    n = 2 if grid == "dp2sp2" else 1
    per_dp = {}
    for r, (arrays, flags) in enumerate(ranks):
        got = {k: arrays[f"{tag}/{grid}/{k}"] for k in names}
        assert _max_err(got, jfinal, names) <= 1e-5, (r, mech, grid)
        assert _max_err(got, plain, names) <= 1e-5, (r, mech, grid)
        d = flags[f"{tag}/{grid}"]["coords"]["dp"]
        per_dp.setdefault(d, arrays[f"{tag}/{grid}/losses"])
        assert flags[f"{tag}/{grid}"]["report"]["sp_split"] == 1
    # each dp rank fetches the mean over its rows
    mean = np.mean([per_dp[d] for d in range(n)], axis=0)
    np.testing.assert_allclose(mean, jlosses, rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(ranks[0][0][f"{tag}/plain/losses"], jlosses,
                               rtol=3e-4, atol=1e-6)


def test_dropout_masks_are_chunks_of_the_whole_draw(world):
    ranks = read(world["tmp"], "dropout")
    for r, (arrays, flags) in enumerate(ranks):
        names = [k[3:] for k in arrays if k.startswith("sp/")
                 and k != "sp/losses"]
        got = {k: arrays["sp/" + k] for k in names}
        want = {k: arrays["plain/" + k] for k in names}
        assert _max_err(got, want, names) <= 1e-5, r
        np.testing.assert_allclose(arrays["sp/losses"],
                                   arrays["plain/losses"], rtol=3e-5)
        # the split region's dropouts keep chunk r of 4 of the sequence
        chunks = [c for c in flags["chunks"] if c]
        assert chunks and all(c[1:] == [4, r] for c in chunks), flags


def test_sp_launch_stays_short(world, record_property):
    """The one launch ran every scenario on every rank inside its own
    deadline; its wall time is reported, not held."""
    record_property("launch_seconds", world["seconds"])
    print(f"sp launch: {world['seconds']:.1f} s")
    for name in SCENARIOS:
        for r in range(N):
            assert os.path.exists(os.path.join(world["tmp"],
                                               f"{name}.{r}.npz")), (name, r)


# ------------------------------------------------------ cases with no launch

def _bert_program(mech, tp=False, causal_flash=False):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        cfg = R.bert_cfg(tbert, mech)
        out = tbert.bert_pretrain(cfg, 2, 16, 3, sp_shard=True)
        if tp:
            tbert.apply_tp_sharding(main, cfg)
        tfluid.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
    if causal_flash:
        for op in main.global_block().ops:
            if op.type == "flash_attention":
                op.attrs["causal"] = True
    return main, out["loss"]


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("mech", R.MECHS, ids=[m or "einsum"
                                               for m in R.MECHS])
def test_sp_shard_program_passes_the_verifier(mech, tp):
    from paddle_tpu_torch.framework.analysis import verify_program
    from paddle_tpu_torch.framework.passes import apply_passes, get_pass
    from paddle_tpu_torch.parallel.mesh import Mesh
    main, loss = _bert_program(mech, tp=tp > 1)
    mesh = Mesh(1, tp, 2)
    for r in range(2):
        prog = main.clone()
        passes = [get_pass("sp_shard", mesh=mesh, sp_rank=r)]
        if tp > 1:
            passes.insert(0, get_pass("tp_shard", mesh=mesh, tp_rank=r))
        apply_passes(prog, passes)
        verify_program(prog, fetch_names=[loss.name], check_shapes=True)
        gb = prog.global_block()
        first = next(o for o in gb.ops if o.type == "sp_split")
        assert first.attrs["dim"] == 1
        assert gb.var(first.output("Out")[0]).shape[1] == 8
        # no parameter is split by sp
        for p in main.all_parameters():
            assert gb.var(p.name).shape == \
                tuple(main.global_block().var(p.name).shape) or tp > 1
        att = [o for o in gb.ops if o.type in ("ring_attention",
                                               "ulysses_attention")]
        assert all(o.attrs["sp_split"] for o in att)
    # the user's program is left whole
    assert not any(o.type.startswith("sp_")
                   for o in main.global_block().ops)


def test_causal_flash_under_sp_raises():
    from paddle_tpu_torch.framework.passes import apply_passes, get_pass
    from paddle_tpu_torch.parallel.mesh import Mesh
    main, _ = _bert_program("flash", causal_flash=True)
    with pytest.raises(NotImplementedError, match="query offset"):
        apply_passes(main.clone(), [get_pass("sp_shard", mesh=Mesh(1, 1, 2),
                                             sp_rank=0)])


def test_mesh_puts_tp_innermost_then_sp():
    from paddle_tpu_torch.parallel.mesh import Mesh
    m = Mesh(2, 2, 2)
    assert m.axis_names == ("dp", "sp", "tp")
    for r in range(8):
        c = m.coords(r)
        assert r == (c["dp"] * 2 + c["sp"]) * 2 + c["tp"]
        assert c["dp_sp"] == c["dp"] * 2 + c["sp"]
    assert m.axis_ranks("sp", 5) == [5, 7]
    assert m.axis_ranks("tp", 5) == [4, 5]
    assert m.axis_ranks("dp", 5) == [1, 5]
    assert m.axis_ranks("dp_sp", 5) == [1, 3, 5, 7]
