"""The GRU seq2seq (``models.seq2seq``) in the port against the JAX
package, on the CPU, at ``tests/test_seq2seq.py``'s small widths: source
vocab 12, target vocab 10, embedding 8, hidden 16, source 5 and target 6
steps, B4, beam 3.

- Both programs (teacher-forced training with Adam, and the beam
  decode) and their startups equal the JAX package's op for op
  (``to_dict()``: types, slots, attrs, blocks, var names and shapes).
  Var dtypes compare with int64 read as int32: the JAX package runs
  without 64-bit ints, so its shape inference records int32 where the
  port keeps the IR's int64.
- ``params_from_jax`` names the 12 parameters the two programs share and
  carries them bit for bit; a missing one raises.
- Three Adam steps from the JAX startup's values on one seeded batch:
  the losses within 1e-5 of max |ref|, every param@GRAD of the first
  step within 1e-4 of its max |ref|, every parameter and Adam slot after
  the third within rtol 1e-5, atol 1e-5.
- ``Executor.run_steps`` over a slab of 3 batches is bitwise 3
  sequential ``Executor.run`` calls (losses and every scope tensor).
- The beam decode over the JAX-trained parameters: sequences and
  parents exact, scores within 1e-5 of max |ref|.
- ``save_inference_model`` of the decode program: ``_prune`` keeps what
  the JAX package keeps (the encoder's ``recurrent`` op with its
  sub-block and every op that feeds it); a model saved by either package
  loads in the other and gives the same sequences.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jfluid
from paddle_tpu.models import seq2seq as jseq

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.models import seq2seq as tseq

JAX_RNG = "@RNG_KEY@"
SV, TV, E, H = 12, 10, 8, 16
T_SRC, T_TGT, B, BEAM = 5, 6, 4, 3
STEPS = 3


def build(fluid, s2s, decode=False, opt=True):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 8
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if decode:
            out = s2s.seq2seq_beam_decode(SV, TV, E, H, T_SRC, max_len=T_TGT,
                                          beam_size=BEAM)
        else:
            out = s2s.seq2seq_train(SV, TV, E, H, T_SRC, T_TGT, B)
            if opt:
                fluid.optimizer.Adam(1e-2).minimize(out["loss"])
    return main, startup, out


def canon(d):
    """A program dict with dist_attr dropped and int64 var dtypes read as
    int32 (see the module note)."""
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            v.pop("dist_attr", None)
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return d


def batch(rng):
    src = rng.integers(3, SV, (T_SRC, B)).astype(np.int64)
    tgt_in = rng.integers(3, TV, (T_TGT, B)).astype(np.int64)
    tgt_out = np.roll(tgt_in, -1, axis=0)
    return {"src": src, "tgt_in": tgt_in, "tgt_out": tgt_out}


def arrays(jscope):
    return {n: np.array(v) for n, v in jscope.items() if n != JAX_RNG}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module")
def trained():
    """Both packages' training programs, STEPS Adam steps each from the
    JAX startup's values on one seeded batch: losses, first-step grads,
    scopes and the start arrays."""
    jmain, jstart, jout = build(jfluid, jseq)
    tmain, tstart, tout = build(tfluid, tseq)
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    start = arrays(jscope)
    scope_from_arrays(tscope, start)
    feed = batch(np.random.default_rng(0))
    grads = [p.name + "@GRAD" for p in jmain.all_parameters()]
    jl, tl, jg, tg = [], [], None, None
    for i in range(STEPS):
        fetch = [jout["loss"].name] + (grads if i == 0 else [])
        jv = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        tv = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        jl.append(float(jv[0]))
        tl.append(float(tv[0]))
        if i == 0:
            jg, tg = jv[1:], tv[1:]
    return dict(jmain=jmain, tmain=tmain, jscope=jscope, tscope=tscope,
                jl=jl, tl=tl, jg=jg, tg=tg, grads=grads, start=start,
                feed=feed, texe=texe, tout=tout, tstart=tstart)


@pytest.mark.parametrize("decode", [False, True], ids=["train", "decode"])
def test_programs_equal_jax(decode):
    jmain, jstart, _ = build(jfluid, jseq, decode)
    tmain, tstart, _ = build(tfluid, tseq, decode)
    assert canon(tmain.to_dict()) == canon(jmain.to_dict())
    assert canon(tstart.to_dict()) == canon(jstart.to_dict())
    kinds = [op.type for op in tmain.global_block().ops]
    if decode:
        assert kinds.count("beam_search") == T_TGT
        assert kinds.count("gather_tree") == 1
        assert kinds.count("recurrent") == 1
    else:
        assert kinds.count("recurrent") == 2
        assert kinds.count("recurrent_grad") == 2
        assert len(tmain.blocks) == 3


def test_params_from_jax_names_the_shared_parameters(trained):
    shapes = tseq.param_shapes(SV, TV, E, H)
    assert len(shapes) == 12
    for decode in (False, True):
        main, _, _ = build(tfluid, tseq, decode, opt=False)
        assert {p.name: tuple(p.shape) for p in main.all_parameters()} \
            == shapes
    got = tseq.params_from_jax(trained["start"], SV, TV, E, H)
    assert set(got) == set(shapes)
    for n, t in got.items():
        assert np.array_equal(t.numpy(), trained["start"][n])
    short = {n: a for n, a in trained["start"].items()
             if n != "seq2seq.out.b"}
    with pytest.raises(ValueError, match="seq2seq.out.b"):
        tseq.params_from_jax(short, SV, TV, E, H)


def test_losses_grads_and_adam_state_match_jax(trained):
    r = trained
    assert rel_err(r["tl"], r["jl"]) <= 1e-5, (r["tl"], r["jl"])
    assert r["tl"][-1] < r["tl"][0]
    for name, g, want in zip(r["grads"], r["tg"], r["jg"]):
        assert rel_err(g, want) <= 1e-4, name
    jstate = arrays(r["jscope"])
    for name, want in jstate.items():
        got = r["tscope"].find_var(name).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_run_steps_is_bitwise_sequential_runs(trained):
    r = trained
    rng = np.random.default_rng(3)
    feeds = [batch(rng) for _ in range(3)]
    main, loss, exe = r["tmain"], r["tout"]["loss"], r["texe"]
    seq, fused = tfluid.Scope(), tfluid.Scope()
    exe.run(r["tstart"], scope=seq)
    exe.run(r["tstart"], scope=fused)
    scope_from_arrays(seq, r["start"])
    scope_from_arrays(fused, r["start"])
    eager = [exe.run(main, feed=f, fetch_list=[loss], scope=seq)[0]
             for f in feeds]
    slab = exe.run_steps(main, feed=feeds, fetch_list=[loss], scope=fused)[0]
    assert np.array_equal(slab, np.stack(eager))
    assert set(seq.keys()) == set(fused.keys())
    for n in seq.keys():
        a, b = seq.find_var(n), fused.find_var(n)
        assert (np.array_equal(a.numpy(), b.numpy())
                if hasattr(a, "numpy") else a == b), n


def _decode_program(fluid, params):
    """``fluid``'s decode program over ``params``: (program, outputs,
    executor, scope)."""
    main, startup, dec = build(fluid, jseq if fluid is jfluid else tseq,
                               decode=True)
    jax = fluid is jfluid
    exe = fluid.Executor() if jax else fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for n, a in params.items():
        scope.set(n, jnp.asarray(a) if jax else torch.from_numpy(np.array(a)))
    return main, dec, exe, scope


def _decode_both(params):
    """Both packages' decode over ``params`` on one seeded sentence:
    (JAX outputs, port outputs, the feed)."""
    feed = {"src": np.random.default_rng(5).integers(3, SV, (T_SRC, 1))
            .astype(np.int64)}
    out = []
    for fluid in (jfluid, tfluid):
        main, dec, exe, scope = _decode_program(fluid, params)
        out.append(exe.run(main, feed=feed, fetch_list=[
            dec["sequences"], dec["scores"]], scope=scope))
    return out[0], out[1], feed


@pytest.fixture(scope="module")
def decoded(trained):
    """The JAX-trained parameters and both packages' decode of one
    seeded sentence over them."""
    params = {n: a for n, a in arrays(trained["jscope"]).items()
              if n in tseq.param_shapes(SV, TV, E, H)}
    return (params,) + _decode_both(params)


def test_beam_decode_matches_jax_exactly(decoded):
    _, (jseqs, jscores), (tseqs, tscores), _ = decoded
    assert tseqs.shape == (T_TGT, 1, BEAM)
    assert np.array_equal(np.asarray(tseqs), np.asarray(jseqs))
    assert rel_err(tscores, jscores) <= 1e-5
    # the beams are score-sorted
    assert np.all(np.diff(np.asarray(tscores), axis=1) <= 0)


def test_prune_keeps_the_encoder_sub_block_as_jax():
    jmain, _, jdec = build(jfluid, jseq, decode=True)
    tmain, _, tdec = build(tfluid, tseq, decode=True)
    jp = jmain._prune([jdec["sequences"].name], ["src"])
    tp = tmain._prune([tdec["sequences"].name], ["src"])
    assert canon(tp.to_dict()) == canon(jp.to_dict())
    kinds = [op.type for op in tp.global_block().ops]
    assert "recurrent" in kinds and "gather_tree" in kinds
    rec = next(op for op in tp.global_block().ops if op.type == "recurrent")
    assert [op.type for op in tp.blocks[rec.attrs["sub_block"]].ops] == \
        ["gru_cell_fused"]
    # the scores are not a target: nothing downstream of the last
    # beam_search's scores survives, and the fill of beam 0's score does
    assert "assign_value" in kinds


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_decode_model_crosses_packages(tmp_path, decoded, writer):
    params, (jseqs, _), _, feed = decoded
    d = str(tmp_path / writer)
    fluid = jfluid if writer == "jax" else tfluid
    main, dec, exe, scope = _decode_program(fluid, params)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["src"], [dec["sequences"]], exe,
                                      main_program=main)
    jpred = jfluid.inference.create_predictor(
        jfluid.inference.AnalysisConfig(d))
    cfg = tinf.AnalysisConfig(d)
    cfg.disable_gpu()
    tpred = tinf.create_predictor(cfg)
    jout = jpred.run([feed["src"]])[0]
    tout = tpred.run([feed["src"]])[0]
    assert np.array_equal(np.asarray(tout), np.asarray(jout))
    assert np.array_equal(np.asarray(tout), np.asarray(jseqs))
