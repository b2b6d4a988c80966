"""Tensor parallelism of the port (the ``tp`` axis of the mesh,
``apply_tp_sharding``, pass ``tp_shard``, the tp collectives, the
sharded state and its checkpoint, ``GPTGenerator(tp=)``) against the JAX
package, on the CPU.

One launch of 4 gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node=4 --device=cpu
tests/torch_tp_runner.py``) on a dp 2 x tp 2 mesh runs every scenario;
the tests then read what each rank wrote. Each dp rank is fed its rows
of one global batch and starts from the JAX package's startup values.
The JAX reference is the same program's single-device run on the whole
global batch, as ``tests/test_sharding.py::test_tp_matches_single_device``
holds the JAX package's own tp run to it:

- BERT-tiny (dropout 0) and GPT-tiny ``gpt_pretrain``, 3 Adam steps:
  every parameter, gathered, within 1e-5 of the model's max |ref| of the
  JAX run (as ``test_torch_fleet.py`` holds BERT: Adam scales a grad
  that is rounding noise, such as a key bias's, to the learning rate),
  the losses within rtol 3e-4, every rank's gathered state bitwise rank
  0's, and a rank's Adam moment of ``qkv`` holding its half of the width
  (JAX ``test_tp_param_actually_sharded``);
- dropout on: the parameters that tp does not split are bitwise equal
  across the ranks of a tp group;
- a save under tp, a load into a fresh scope and two more steps bitwise
  the uninterrupted run (JAX ``tests/test_io.py:202``), and the saved
  directory loads in the JAX package and in a port run at tp 1 to the
  same arrays;
- ``GPTGenerator(tp=2)``'s greedy tokens, dense and paged, equal to the
  JAX package's ``GPTGenerator(tp=2)`` and ``tp=1``
  (``tests/test_serving_podscale.py:75-93``); tp 3 raises "divide
  num_heads", and with the split patched out (``gpt.tp_layouts``, the
  port's ``_annotate_tp``) the compile gate raises
  ``TPCompileGateError`` "replicated large";
- after that generator, a data-parallel program with no mesh given
  (``with_data_parallel()``) still spans the world on ``dp``: its
  parameters are the plain run's on the global batch, every rank's
  seed fold is its own rank, and the generator's tokens are unchanged.

The unit cases need no launch: ``partition_spec`` against the JAX
package's, ``sharding_constraint`` a value identity, ``dist_attr``
through ``to_dict``/``from_dict`` both ways, and the ``tp_shard``
program through ``verify_program``.
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
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt

import torch_tp_runner as R

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N = 4
SCENARIOS = ["bert", "gpt", "dropout", "ckpt", "generate", "dp_after_tp"]
JAX_RNG = "@RNG_KEY@"


def launch(tmp, scenarios, start, timeout=150):
    args = os.path.join(tmp, "args.json")
    with open(args, "w") as f:
        json.dump({"out": tmp, "scenarios": scenarios, "start": start}, f)
    pp = [REPO, HERE] + ([os.environ["PYTHONPATH"]]
                         if os.environ.get("PYTHONPATH") else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(pp))
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={N}", "--device=cpu",
         os.path.join(HERE, "torch_tp_runner.py"), args],
        env=env, capture_output=True, timeout=timeout, cwd=tmp)


def read(tmp, name):
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
    return start, losses, final, main


def jax_tiny_gpt():
    """The JAX package's tiny GPT generation scope: (its arrays, the
    scope)."""
    cfg = jgpt.GPTConfig.tiny()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        jgpt.gpt_logits(cfg)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor().run(startup)
    return {n: np.asarray(v) for n, v in scope.items()
            if not n.startswith("@")}, scope


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    refs = {
        "bert": jax_run(lambda fl: R.build_bert(fl, jbert, R.BERT["B"],
                                                tp=False),
                        R.bert_feeds(jbert)),
        "gpt": jax_run(lambda fl: R.build_gpt(fl, jgpt, R.GPT["B"],
                                              tp=False),
                       R.gpt_feeds(jgpt)),
    }
    refs["gen"] = jax_tiny_gpt()
    start = {}
    for k, v in refs.items():
        start[k] = os.path.join(tmp, f"start_{k}.npz")
        np.savez(start[k], **v[0])
    start["gpt_gen"] = start.pop("gen")
    t0 = time.perf_counter()
    proc = launch(tmp, SCENARIOS, start)
    assert proc.returncode == 0, proc.stderr.decode()[-6000:]
    return {"tmp": tmp, "refs": refs, "seconds": time.perf_counter() - t0}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _params(main):
    return [p.name for p in main.all_parameters()]


@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_tp_training_matches_jax_single_device(world, model):
    ranks = read(world["tmp"], model)
    _, losses, final, jmain = world["refs"][model]
    ref = ranks[0][0]
    for r, (arrays, _) in enumerate(ranks[1:], 1):
        for k in final:
            assert np.array_equal(arrays[k], ref[k]), (r, k)
    names = _params(jmain)
    top = max(float(np.abs(final[n]).max()) for n in names)
    for name in names:
        assert ref[name].shape == final[name].shape, name
        err = float(np.abs(ref[name].astype(np.float64)
                           - final[name]).max()) / top
        assert err <= 1e-5, f"{name}: {err:.3g} of the model's max |ref|"
    # Adam's moments, gathered, are the single-card run's (qkv's pieces
    # in place)
    moments = [k for k in final if "_moment" in k]
    assert moments
    for k in moments:
        err = _rel(ref[k], final[k])
        assert err <= 1e-3, f"{k}: {err:.3g} of max |ref|"
    # the loss each dp rank fetches is the mean over its rows; the two
    # halves' mean is the global batch's
    mean = np.mean([ranks[0][0]["losses"], ranks[2][0]["losses"]], axis=0)
    np.testing.assert_allclose(mean, losses, rtol=3e-4, atol=1e-6)
    # the ranks of one tp group fetch the same loss
    assert np.array_equal(ranks[0][0]["losses"], ranks[1][0]["losses"])


def test_tp_shards_the_parameters_and_their_moments(world):
    ranks = read(world["tmp"], "bert")
    arrays, flags = ranks[1]
    cfg = R.bert_cfg(tbert)
    h = cfg.hidden_size
    qkv = arrays["local/encoder_layer_0_multi_head_att_qkv.w_0"]
    assert qkv.shape == (h, 3 * h // R.TP)
    assert arrays[flags["moment"]].shape == (h, 3 * h // R.TP)
    assert arrays["local/word_embedding"].shape == \
        (cfg.vocab_size // R.TP, h)
    # rank 1's qkv shard is its heads' columns of each of q, k and v
    full = arrays["encoder_layer_0_multi_head_att_qkv.w_0"]
    w = h // R.TP
    want = np.concatenate([full[:, i * h + w:i * h + 2 * w]
                           for i in range(3)], axis=1)
    assert np.array_equal(qkv, want)
    # one conjugate pair per matmul pair, the masked lookup's sum and
    # the head's identity and gather
    layers = cfg.num_layers
    assert flags["report"] == {"c_identity": 2 * layers + 1,
                               "mp_allreduce_sum": 2 * layers + 1,
                               "c_concat": 1}


def test_tp_dropout_keeps_replicated_parameters_equal(world):
    ranks = read(world["tmp"], "dropout")
    split = {"encoder_layer_0_multi_head_att_qkv", "word_embedding"}
    for a, b in ((0, 1), (2, 3)):
        ra, rb = ranks[a][0], ranks[b][0]
        replicated = [k for k in ra if k.startswith("local/")
                      and ra[k].shape == rb[k].shape
                      and not any(s in k for s in split)
                      and not k.split("/", 1)[1].startswith(
                          ("encoder_layer_0_multi_head_att_qkv",
                           "encoder_layer_1_multi_head_att_qkv"))]
        assert replicated
        for k in replicated:
            sharded = any(t in k for t in (
                "_qkv.", "_output_fc.w_0", "_ffn_fc_0.", "_ffn_fc_1.w_0",
                "word_embedding"))
            if not sharded:
                assert np.array_equal(ra[k], rb[k]), (a, b, k)
        assert np.array_equal(ra["losses"], rb["losses"])


def test_tp_checkpoint_resumes_bitwise_and_loads_anywhere(world):
    ranks = read(world["tmp"], "ckpt")
    for r, (_, flags) in enumerate(ranks):
        assert flags["resume_bitwise"] and flags["state_bitwise"], \
            (r, flags)
    saved = {k.split("/", 1)[1]: v for k, v in ranks[0][0].items()
             if k.startswith("saved/")}
    ckpt = ranks[0][1]["dir"]
    # the JAX package's load of the directory
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 7
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        R.build_bert(jfluid, jbert, R.BERT["B"] // 2, dropout=0.1)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    jfluid.io.load_persistables(exe, ckpt, main_program=main, scope=scope)
    for name in _params(main):
        assert np.array_equal(np.asarray(scope.find_var(name)),
                              saved[name]), name
    # a port run at tp 1 (no mesh) loads it to the same arrays
    tmain, tstart = tfluid.Program(), tfluid.Program()
    tmain.random_seed = tstart.random_seed = 7
    with tfluid.unique_name.guard(), tfluid.program_guard(tmain, tstart):
        R.build_bert(tfluid, tbert, R.BERT["B"] // 2, dropout=0.1,
                     tp=False)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(tstart, scope=tscope)
    tfluid.io.load_persistables(texe, ckpt, main_program=tmain,
                                scope=tscope)
    for v in tmain.list_vars():
        if v.persistable and v.name in saved:
            assert np.array_equal(tscope.find_var(v.name).numpy(),
                                  saved[v.name]), v.name


@pytest.mark.parametrize("paged", [False, True])
def test_tp_generator_greedy_tokens_equal_jax(world, paged):
    from paddle_tpu.models.generation import GPTGenerator as JGenerator
    from paddle_tpu.parallel.mesh import get_mesh, set_mesh
    _, scope = world["refs"]["gen"]
    cfg = jgpt.GPTConfig.tiny()
    prompts = R.gen_prompts(cfg.vocab_size)
    prev = get_mesh()
    try:
        want = {}
        for tp in (1, 2):
            gen = JGenerator(cfg, scope, max_len=R.GEN["max_len"],
                             bucket_min=R.GEN["bucket_min"], tp=tp)
            want[tp] = gen.generate(prompts, max_new_tokens=R.GEN["new"],
                                    seed=0, paged=paged)
    finally:
        set_mesh(prev)
    kind = "paged" if paged else "dense"
    for r, (arrays, _) in enumerate(read(world["tmp"], "generate")):
        for i in range(len(prompts)):
            for tp in (1, 2):
                got = arrays[f"tp{tp}/{kind}/{i}"]
                np.testing.assert_array_equal(got, want[2][i])
                np.testing.assert_array_equal(got, want[1][i])


def test_tp_generator_shards_and_typed_errors(world):
    cfg = tgpt.GPTConfig.tiny()
    for r, (_, flags) in enumerate(read(world["tmp"], "generate")):
        assert flags["heads"] == cfg.num_heads // 2
        assert flags["pool_heads"] == cfg.num_heads // 2
        assert flags["qkv"] == [cfg.hidden_size, 3 * cfg.hidden_size // 2]
        assert flags["errors"], r


@pytest.mark.parametrize("kind", ["none", "default"])
def test_dp_program_after_tp_generator_spans_the_world(world, kind):
    """``kind``: ``with_data_parallel()`` with no mesh, or with
    ``mesh=default_mesh()``."""
    ranks = read(world["tmp"], "dp_after_tp")
    ref = ranks[0][0]
    names = [k.split("/", 1)[1] for k in ref if k.startswith("plain/")]
    assert names
    top = max(float(np.abs(ref["plain/" + k]).max()) for k in names)
    for r, (arrays, flags) in enumerate(ranks):
        mine = flags[kind]
        assert (mine["dp"], mine["tp"]) == (N, 1), mine
        assert mine["step_ranks"] == [r], mine
        assert flags["tokens_same"], r
        for k in names:
            got = arrays[f"{kind}/{k}"]
            assert np.array_equal(got, ref[f"{kind}/{k}"]), (r, k)
            err = float(np.abs(got.astype(np.float64)
                               - arrays["plain/" + k]).max()) / top
            assert err <= 1e-5, f"{k}: {err:.3g} of the model's max |ref|"
    # each rank fetches the loss of its one row; their mean is the
    # global batch's
    mean = np.mean([a[f"{kind}/losses"] for a, _ in ranks], axis=0)
    np.testing.assert_allclose(mean, ref["plain_losses"], rtol=3e-4,
                               atol=1e-6)


def test_tp_launch_stays_short(world, record_property):
    """The one launch ran every scenario on every rank inside its own
    deadline (``launch``'s timeout). Its wall time is reported, not
    held: a loaded host stretches it."""
    record_property("launch_seconds", world["seconds"])
    print(f"tp launch: {world['seconds']:.1f} s")
    for name in SCENARIOS:
        for r in range(N):
            assert os.path.exists(os.path.join(world["tmp"],
                                               f"{name}.{r}.npz")), (name, r)


# ------------------------------------------------------ cases with no launch

@pytest.mark.parametrize("spec,shape", [
    (("bogus", "tp"), (4, 5)), (("dp", "tp"), (4, 5)),
    (("dp", "tp"), (4, 6)), (("dp",), (4, 6)), ((("dp", "tp"), None),
                                                (8, 3)),
    ((("dp", "tp"), None), (6, 3)), ((None, "tp"), None)])
def test_partition_spec_equals_jax(spec, shape):
    from paddle_tpu.parallel import mesh as jmesh
    from paddle_tpu_torch.parallel import mesh as tmesh
    want = jmesh.partition_spec(
        jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=2)), spec, shape)
    got = tmesh.partition_spec(tmesh.Mesh(2, 2), spec, shape)
    assert tuple(got) == tuple(want)


def test_sharding_constraint_is_a_value_identity():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.data("x", [-1, 6], "float32")
        y = tfluid.layers.collective.shard(x, "dp", "tp")
        loss = tfluid.layers.mean(tfluid.layers.scale(y, 2.0))
    op = next(o for o in main.global_block().ops
              if o.type == "sharding_constraint")
    assert op.attrs["spec"] == ("dp", "tp")
    xv = np.arange(24, dtype=np.float32).reshape(4, 6)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got, l = exe.run(main, feed={"x": xv}, fetch_list=[y, loss],
                     scope=tfluid.Scope())
    assert np.array_equal(got, xv)
    # a pp entry is a hint, as in the JAX package: the value itself
    with tfluid.program_guard(main, startup):
        w = tfluid.layers.collective.shard(x, "pp", None)
    assert w.block.ops[-1].attrs["spec"] == ("pp", None)
    got_w, = exe.run(main, feed={"x": xv}, fetch_list=[w],
                     scope=tfluid.Scope())
    assert np.array_equal(got_w, xv)
    # an ep entry is a hint too (the experts' split is switch_moe's), and
    # so is a dcn_dp one (each rank is fed its rows)
    with tfluid.program_guard(main, startup):
        e = tfluid.layers.collective.shard(x, "ep", None)
    assert e.block.ops[-1].attrs["spec"] == ("ep", None)
    got_e, = exe.run(main, feed={"x": xv}, fetch_list=[e],
                     scope=tfluid.Scope())
    assert np.array_equal(got_e, xv)
    with tfluid.program_guard(main, startup):
        c = tfluid.layers.collective.shard(x, ("dcn_dp", "dp"), None)
    assert c.block.ops[-1].attrs["spec"] == (("dcn_dp", "dp"), None)
    got_c, = exe.run(main, feed={"x": xv}, fetch_list=[c],
                     scope=tfluid.Scope())
    assert np.array_equal(got_c, xv)
    with pytest.raises(NotImplementedError, match="item 7b"):
        with tfluid.program_guard(main, startup):
            tfluid.layers.collective.shard(x, "bogus", None)
    with tfluid.program_guard(main, startup):
        z = tfluid.layers.collective.shard(x, "sp", None)
    assert z.block.ops[-1].attrs["spec"] == ("sp", None)


def test_dist_attr_round_trips_with_jax():
    def build(fl, model, cfg):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            out = model.gpt_pretrain(cfg, 2, 8)
            model.apply_tp_sharding(main, cfg)
            fl.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
        return main
    jd = build(jfluid, jgpt, jgpt.GPTConfig.tiny()).to_dict()
    td = build(tfluid, tgpt, tgpt.GPTConfig.tiny()).to_dict()
    assert td == jd
    annotated = {n: v["dist_attr"] for n, v in td["blocks"][0]["vars"].items()
                 if v["dist_attr"]}
    assert annotated["decoder_layer_0_qkv.w_0"] == [None, "tp"]
    assert any("moment1" in n and a == [None, "tp"]
               for n, a in annotated.items())
    for d, pkg in ((jd, tfluid), (td, jfluid)):
        back = pkg.Program.from_dict(d).global_block().vars
        for n, a in annotated.items():
            assert tuple(back[n].dist_attr) == tuple(a), (pkg, n)


@pytest.mark.parametrize("model", ["bert", "bert_flash", "gpt"])
def test_tp_shard_program_passes_the_verifier(model):
    from paddle_tpu_torch.framework.analysis import verify_program
    from paddle_tpu_torch.framework.passes import apply_passes, get_pass
    from paddle_tpu_torch.parallel.mesh import Mesh
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        if model.startswith("bert"):
            cfg = tbert.BertConfig.tiny()
            cfg.attn_mechanism = "flash" if model == "bert_flash" else None
            out = tbert.bert_pretrain(cfg, 2, 16, 4)
            tbert.apply_tp_sharding(main, cfg)
        else:
            cfg = tgpt.GPTConfig.tiny()
            out = tgpt.gpt_pretrain(cfg, 2, 16)
            tgpt.apply_tp_sharding(main, cfg)
        tfluid.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
    for r in range(2):
        prog = main.clone()
        apply_passes(prog, [get_pass("tp_shard", mesh=Mesh(1, 2),
                                     tp_rank=r)])
        verify_program(prog, fetch_names=[out["loss"].name],
                       check_shapes=True)
        gb = prog.global_block()
        emb = next(o for o in gb.ops if o.type == "c_embedding")
        assert emb.attrs["start_index"] == r * cfg.vocab_size // 2
        assert gb.var("word_embedding").shape == \
            (cfg.vocab_size // 2, cfg.hidden_size)
    # the user's program is left whole
    assert main.global_block().var("word_embedding").shape == \
        (cfg.vocab_size, cfg.hidden_size)
