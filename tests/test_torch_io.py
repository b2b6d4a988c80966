"""The port's ``io`` against the JAX package's, on the CPU: what either
package writes, the other reads.

- ``save_inference_model`` (the per-var ``.npy`` layout, the program in
  ``__model__`` with its feed specs): the JAX package saves and the port
  loads, and the port saves and the JAX package loads, for an MLP,
  ResNet-18 (class_dim 4, 32x32, B8) and tiny BERT with flash attention
  (``tests/torch_served_models.py``); the outputs agree within 1e-5
  (MLP) and 1e-4 (ResNet, BERT) of max |ref|, and the loaded program
  carries the saved ``_feed_specs``.
- ``save_persistables``/``load_persistables`` in the ``.npy`` and the
  ``filename=`` ``.npz`` layouts, and ``save``/``load`` with ``.pdparams``,
  ``.pdopt`` and ``.pdmodel``, both ways, every value bitwise; a bf16
  var round-trips bitwise (stored as its uint16 view) both ways.
- A flipped byte, a missing file and a torn (truncated) file raise each
  package's ``CheckpointCorruptError`` naming the file, whichever
  package wrote the directory.
- The RNG extra: the JAX key saved under ``@RNG_KEY@`` folds into one
  port seed deterministically (the same key, the same seed and the same
  dropout mask); the port's own seed round-trips and the JAX package
  ignores it.
- ``Program.to_dict``/``from_dict`` across the packages (both write
  ``dist_attr``), ``_prune`` (the served ops only; a dangling
  sub_block attr skipped as the JAX package skips it), and the
  checkpoint entry points work (``tests/test_torch_checkpoint.py`` holds
  them to the JAX package) while the supervisor side of ``train``
  raises.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as J
from paddle_tpu import resilience as jres

import paddle_tpu_torch as T
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework.executor import RNG_STATE_NAME
from paddle_tpu_torch.resilience import CheckpointCorruptError

import torch_served_models as M

JAX_RNG = "@RNG_KEY@"
B = 8


def cpu_exe():
    return T.Executor(T.CPUPlace())


def jax_dict(program):
    d = program.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            assert v["dist_attr"] is None
    return d


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """kind -> (dir, feed, JAX outputs): the JAX package's saved
    inference model over seeded weights, and its outputs on a seeded B8
    batch (each built on first use)."""
    cache = {}

    def get(kind):
        if kind not in cache:
            d = str(tmp_path_factory.mktemp(f"jax_{kind}"))
            main, _, feeds, targets = M.build(J, kind)
            exe, scope = J.Executor(), J.Scope()
            for n, a in M.weights(main, np.random.default_rng(0)).items():
                scope.set(n, jnp.asarray(a))
            with J.scope_guard(scope):
                J.io.save_inference_model(d, feeds, targets, exe,
                                          main_program=main)
            feed = M.feeds(kind, B, np.random.default_rng(1))
            pred = J.inference.create_predictor(
                J.inference.AnalysisConfig(d))
            cache[kind] = (d, feed, pred.run([feed[n] for n in feeds]))
        return cache[kind]
    return get


@pytest.mark.parametrize("kind", M.KINDS)
def test_inference_model_jax_to_port(jax_saved, kind):
    d, feed, ref = jax_saved(kind)
    scope = T.Scope()
    prog, feeds, fetches = T.load_inference_model(d, cpu_exe(), scope=scope)
    with open(os.path.join(d, "__model__")) as f:
        assert prog._feed_specs == json.load(f)["feed_specs"]
    outs = cpu_exe().run(prog, feed=feed, fetch_list=fetches, scope=scope)
    assert len(outs) == len(ref)
    for got, want in zip(outs, ref):
        assert got.shape == want.shape
        assert M.close(got, want, kind)


@pytest.mark.parametrize("kind", M.KINDS)
def test_inference_model_port_to_jax(tmp_path, kind):
    d = str(tmp_path)
    main, startup, feeds, targets = M.build(T, kind)
    exe, scope = cpu_exe(), T.Scope()
    exe.run(startup, scope=scope)
    names = T.save_inference_model(d, feeds, targets, exe,
                                   main_program=main, scope=scope)
    assert names == [t.name for t in targets]
    feed = M.feeds(kind, B, np.random.default_rng(2))
    ref = exe.run(main.clone(for_test=True), feed=feed, fetch_list=targets,
                  scope=scope)
    jscope = J.Scope()
    with J.scope_guard(jscope):
        prog, jfeeds, jfetches = J.io.load_inference_model(d, J.Executor())
        outs = J.Executor().run(prog, feed=feed, fetch_list=jfetches)
    assert jfeeds == feeds
    assert prog._feed_specs == {
        n: {"shape": list(main.global_block().var(n).shape),
            "dtype": main.global_block().var(n).dtype} for n in feeds}
    for got, want in zip(outs, ref):
        assert M.close(np.asarray(got), want, kind)


def _adam_mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [-1, 16], "float32")
        y = pkg.data("y", [-1, 1], "int64")
        h = pkg.layers.dropout(pkg.layers.fc(x, 32, act="relu"), 0.5)
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _mlp_batch():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    return {"x": x, "y": x[:, :4].argmax(1)[:, None].astype(np.int64)}


def _jax_state(scope, program):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in program.list_vars()
            if tio.is_persistable(v) and scope.find_var(v.name) is not None}


@pytest.fixture(scope="module")
def jax_trained():
    """An MLP with dropout after one JAX Adam step: (main, scope,
    persistable arrays)."""
    main, startup, loss = _adam_mlp(J)
    exe, scope = J.Executor(), J.Scope()
    with J.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=_mlp_batch(), fetch_list=[loss])
    return main, scope, _jax_state(scope, main)


def _port_state(scope, names):
    return {n: scope.find_var(n).numpy() for n in names}


@pytest.mark.parametrize("filename", [None, "params.npz"])
def test_persistables_cross_package(tmp_path, jax_trained, filename):
    jmain, jscope, jstate = jax_trained
    d1, d2 = str(tmp_path / "jax"), str(tmp_path / "port")
    J.io.save_persistables(J.Executor(), d1, main_program=jmain,
                           filename=filename, scope=jscope)
    tmain, tstart, _ = _adam_mlp(T)
    exe, scope = cpu_exe(), T.Scope()
    exe.run(tstart, scope=scope)
    T.load_persistables(exe, d1, main_program=tmain, filename=filename,
                        scope=scope)
    got = _port_state(scope, jstate)
    for n, a in jstate.items():
        assert got[n].dtype == np.dtype(tmain.global_block().var(n).dtype)
        np.testing.assert_array_equal(got[n], a.astype(got[n].dtype))
    key = np.asarray(jscope.find_var(JAX_RNG))
    assert scope.find_var(RNG_STATE_NAME) == tio.fold_jax_key(key)

    T.save_persistables(exe, d2, main_program=tmain, filename=filename,
                        scope=scope)
    back = J.Scope()
    J.io.load_persistables(J.Executor(), d2, main_program=jmain,
                           filename=filename, scope=back)
    for n, a in jstate.items():
        np.testing.assert_array_equal(
            np.asarray(back.find_var(n)).astype(got[n].dtype), got[n])
    assert back.find_var(JAX_RNG) is None       # the port's extra is not
    # the port reads its own seed back
    again = T.Scope()
    T.load_persistables(exe, d2, main_program=tmain, filename=filename,
                        scope=again)
    assert again.find_var(RNG_STATE_NAME) == scope.find_var(RNG_STATE_NAME)


def test_pd_save_load_cross_package(tmp_path, jax_trained):
    jmain, jscope, jstate = jax_trained
    J.io.save(jmain, str(tmp_path / "jax" / "model"), scope=jscope)
    for sfx in (".pdparams", ".pdopt", ".pdmodel"):
        assert (tmp_path / "jax" / f"model{sfx}").exists()
    tmain, tstart, _ = _adam_mlp(T)
    exe, scope = cpu_exe(), T.Scope()
    exe.run(tstart, scope=scope)
    T.load(tmain, str(tmp_path / "jax" / "model"), exe, scope=scope)
    got = _port_state(scope, jstate)
    for n, a in jstate.items():
        np.testing.assert_array_equal(got[n], a.astype(got[n].dtype))
    T.save(tmain, str(tmp_path / "port" / "model"), scope=scope)
    back = J.Scope()
    J.io.load(jmain, str(tmp_path / "port" / "model"), scope=back)
    for n in jstate:
        np.testing.assert_array_equal(
            np.asarray(back.find_var(n)).astype(got[n].dtype), got[n])
    # the saved program is the JAX program
    with open(tmp_path / "port" / "model.pdmodel") as f:
        assert json.load(f) == json.loads(json.dumps(jax_dict(jmain)))


def _bf16_program(pkg):
    prog = pkg.Program()
    prog.global_block().create_var(name="w_bf16", shape=[3, 5],
                                   dtype="bfloat16", persistable=True)
    return prog


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_var_roundtrips_bitwise(tmp_path, writer):
    bits = np.random.default_rng(4).integers(0, 1 << 16, (3, 5),
                                             dtype=np.uint16)
    bits[bits & 0x7F80 == 0x7F80] = 0x3F80      # no NaN / inf patterns
    d = str(tmp_path)
    if writer == "jax":
        prog = _bf16_program(J)
        scope = J.Scope()
        scope.set("w_bf16", jnp.asarray(bits.view(jnp.bfloat16)))
        J.io.save_vars(J.Executor(), d, main_program=prog,
                       predicate=tio.is_persistable, scope=scope)
        back = T.Scope()
        T.io.load_vars(cpu_exe(), d, main_program=_bf16_program(T),
                       predicate=tio.is_persistable, scope=back)
        t = back.find_var("w_bf16")
        assert t.dtype == torch.bfloat16
        got = t.view(torch.int16).numpy().view(np.uint16)
    else:
        scope = T.Scope()
        scope.set("w_bf16", torch.from_numpy(bits.view(np.int16))
                  .view(torch.bfloat16))
        T.io.save_vars(cpu_exe(), d, main_program=_bf16_program(T),
                       predicate=tio.is_persistable, scope=scope)
        back = J.Scope()
        J.io.load_vars(J.Executor(), d, main_program=_bf16_program(J),
                       predicate=tio.is_persistable, scope=back)
        a = np.asarray(back.find_var("w_bf16"))
        assert str(a.dtype) == "bfloat16"
        got = a.view(np.uint16)
    np.testing.assert_array_equal(got, bits)


def _damage(path, how):
    if how == "missing":
        os.remove(path)
        return
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if how == "flip":
            data[-1] ^= 0xFF
            f.seek(0)
            f.write(data)
        else:                                   # torn: cut in half
            f.truncate(len(data) // 2)


@pytest.mark.parametrize("how", ["flip", "missing", "torn"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_damaged_file_raises_corrupt_in_both(tmp_path, jax_trained, writer,
                                             how):
    jmain, jscope, _ = jax_trained
    tmain, tstart, _ = _adam_mlp(T)
    exe, scope = cpu_exe(), T.Scope()
    exe.run(tstart, scope=scope)
    d = str(tmp_path)
    if writer == "jax":
        J.io.save_persistables(J.Executor(), d, main_program=jmain,
                               scope=jscope)
    else:
        T.save_persistables(exe, d, main_program=tmain, scope=scope)
    victim = os.path.join(d, "fc_0.w_0.npy")
    _damage(victim, how)
    # as in the JAX package, a var file gone from disk makes the restore
    # incomplete (RuntimeError naming the var); a flipped or torn one
    # fails its manifest check
    terr, jerr = ((RuntimeError, RuntimeError) if how == "missing" else
                  (CheckpointCorruptError, jres.CheckpointCorruptError))
    with pytest.raises(terr, match="fc_0.w_0") as ei:
        T.load_persistables(exe, d, main_program=tmain, scope=T.Scope())
    with pytest.raises(jerr, match="fc_0.w_0") as ej:
        J.io.load_persistables(J.Executor(), d, main_program=jmain,
                               scope=J.Scope())
    assert type(ei.value).__name__ == type(ej.value).__name__
    if how != "missing":
        assert ei.value.path == ej.value.path == victim
    with pytest.raises(CheckpointCorruptError, match="fc_0.w_0.npy"):
        tio.verify_checkpoint(d)
    with pytest.raises(jres.CheckpointCorruptError, match="fc_0.w_0.npy"):
        J.io.verify_checkpoint(d)


def test_corrupt_model_file_raises_before_parse(tmp_path):
    main, startup, feeds, targets = M.build(T, "mlp")
    exe, scope = cpu_exe(), T.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path)
    T.save_inference_model(d, feeds, targets, exe, main_program=main,
                           scope=scope)
    assert set(tio.verify_checkpoint(d)["files"]) == {
        "__model__", "__meta__.json", "fc_0.w_0.npy", "fc_0.b_0.npy",
        "fc_1.w_0.npy", "fc_1.b_0.npy"}
    _damage(os.path.join(d, "__model__"), "torn")
    with pytest.raises(CheckpointCorruptError, match="__model__"):
        T.load_inference_model(d, exe, scope=T.Scope())
    with pytest.raises(jres.CheckpointCorruptError, match="__model__"):
        J.io.load_inference_model(d, J.Executor(), scope=J.Scope())


def test_jax_key_folds_into_one_seed_and_one_mask(tmp_path, jax_trained):
    jmain, jscope, _ = jax_trained
    key = np.asarray(jscope.find_var(JAX_RNG))
    assert key.dtype == np.uint32
    seed = tio.fold_jax_key(key)
    assert seed == tio.fold_jax_key(key.copy())
    assert seed != tio.fold_jax_key(key ^ np.uint32(1))
    assert 0 <= seed < 2 ** 63
    d = str(tmp_path)
    J.io.save_persistables(J.Executor(), d, main_program=jmain,
                           scope=jscope)
    tmain, tstart, loss = _adam_mlp(T)
    losses = []
    for _ in range(2):
        exe, scope = cpu_exe(), T.Scope()
        exe.run(tstart, scope=scope)
        T.load_persistables(exe, d, main_program=tmain, scope=scope)
        assert scope.find_var(RNG_STATE_NAME) == seed
        losses.append(exe.run(tmain, feed=_mlp_batch(), fetch_list=[loss],
                              scope=scope)[0])
    np.testing.assert_array_equal(losses[0], losses[1])


def test_program_dict_crosses_both_ways():
    tmain, _, _, _ = M.build(T, "resnet")
    jmain, _, _, _ = M.build(J, "resnet")
    from paddle_tpu.framework.core import Program as JProgram
    from paddle_tpu_torch.framework.core import Program as TProgram
    assert jax_dict(JProgram.from_dict(tmain.to_dict())) == tmain.to_dict()
    assert TProgram.from_dict(jmain.to_dict()).to_dict() == jax_dict(jmain)


def test_prune_keeps_the_served_ops_only():
    main, _, feeds, targets = M.build(T, "resnet")
    jmain, _, _, jtargets = M.build(J, "resnet")
    pruned = main.clone(for_test=True)._prune([t.name for t in targets],
                                              feeds)
    jpruned = jmain.clone(for_test=True)._prune(
        [t.name for t in jtargets], feeds)
    assert pruned.to_dict() == jax_dict(jpruned)
    types = {op.type for op in pruned.global_block().ops}
    assert "softmax_with_cross_entropy" not in types
    assert "label" not in pruned.global_block().vars
    assert "image" in pruned.global_block().vars
    assert all(op.attrs.get("is_test") for op in pruned.global_block().ops
               if op.type == "batch_norm")
    # a dangling sub_block attr is skipped, as the JAX package skips it
    # (the verifier is where it is reported)
    for prog in (main, jmain):
        prog.global_block().ops[-1].attrs["sub_block"] = 1
    target = main.global_block().ops[-1].output_arg_names[0]
    assert main._prune([target], feeds).to_dict() == \
        jax_dict(jmain._prune([target], feeds))


def test_unported_checkpoint_entry_points_raise(tmp_path):
    """``save_checkpoint``, ``load_checkpoint`` and ``CheckpointSaver``
    work (a round trip, every persistable bitwise, the train state and
    the run seed back); ``train.TrainingSupervisor`` builds over a
    checkpoint directory; ``train.SliceSupervisor`` raises."""
    main, startup, feeds, targets = M.build(T, "mlp")
    exe, scope = cpu_exe(), T.Scope()
    exe.run(startup, scope=scope)
    scope.set(RNG_STATE_NAME, 12345)
    d = str(tmp_path / "ck")
    tio.save_checkpoint(exe, d, main_program=main, scope=scope,
                        train_state={"slab": 3})
    fresh = T.Scope()
    assert tio.load_checkpoint(exe, d, main_program=main,
                               scope=fresh) == {"slab": 3}
    assert fresh.find_var(RNG_STATE_NAME) == 12345
    for n in scope.keys():
        if n != RNG_STATE_NAME:
            assert torch.equal(fresh.find_var(n), scope.find_var(n)), n
    saver = tio.CheckpointSaver(str(tmp_path / "s"), max_to_keep=1)
    assert [saver.save(exe, main_program=main, scope=scope)
            for _ in range(2)] == [0, 1]
    assert saver.checkpoint_numbers() == [1]
    assert T.train.TrainingSupervisor(exe, main, str(tmp_path)) \
        .checkpoint.latest_no() is None
    with pytest.raises(NotImplementedError, match="Queue 1 item 7b"):
        T.train.SliceSupervisor(exe, main, str(tmp_path))


def test_missing_var_leaves_the_scope_untouched(tmp_path):
    main, startup, feeds, targets = M.build(T, "mlp")
    exe, scope = cpu_exe(), T.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path)
    T.save_params(exe, d, main_program=main, scope=scope)
    os.remove(os.path.join(d, "fc_1.b_0.npy"))
    os.remove(os.path.join(d, "_manifest.json"))      # no manifest to ask
    fresh = T.Scope()
    with pytest.raises(RuntimeError, match="fc_1.b_0"):
        T.load_params(exe, d, main_program=main, scope=fresh)
    assert not list(fresh.keys())
