"""GPT causal training in the port against the JAX package, on the CPU.

The same program is built on both sides (GPTConfig.tiny(): 1 layer, h32,
B4 S16, dropout 0). The JAX startup's parameters, Adam moments,
beta-pows and learning rate are carried into the port's scope (the JAX
package's threefry init cannot be reproduced in torch), and both run 4
Adam steps on one seeded batch: both packages unoptimized
(``FLAGS_program_passes="0"``; tests/test_torch_passes.py runs the same
steps through the default pipeline), the port through
``Executor(CPUPlace())``, where the flash-attention op takes the kernels'
plain versions. Tolerances: losses rtol 1e-4 and state atol 1e-4 (float32
sums in another order over 4 steps); single ops 1e-5.

The test session turns ``FLAGS_verify_passes`` on (tests/conftest.py),
for both packages: every program the port's executor runs is verified,
and every pass's output validated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.framework import lowering as jlowering
from paddle_tpu.framework import registry as jregistry
from paddle_tpu.framework import unique_name as j_unique_name
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import lowering as tlowering
from paddle_tpu_torch.framework import registry as tregistry
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.models import gpt as tgpt

B, S = 4, 16
JAX_RNG = "@RNG_KEY@"


def _build(fluid, gpt, unique_name):
    cfg = gpt.GPTConfig.tiny()
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard():
        with fluid.program_guard(main, startup):
            out = gpt.gpt_pretrain(cfg, B, S)
            fluid.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
    return cfg, main, startup, out["loss"].name


@pytest.fixture
def no_jax_passes():
    """Both packages run the programs as built."""
    old = jfluid.get_flags("FLAGS_program_passes")
    told = tfluid.get_flags("FLAGS_program_passes")
    jfluid.set_flags({"FLAGS_program_passes": "0"})
    tfluid.set_flags({"FLAGS_program_passes": "0"})
    try:
        yield
    finally:
        jfluid.set_flags(old)
        tfluid.set_flags(told)


@pytest.fixture(scope="module")
def built():
    return (_build(jfluid, jgpt, j_unique_name),
            _build(tfluid, tgpt, tfluid.unique_name))


def _carried_scopes(jprog, tprog):
    """JAX startup run, then its arrays carried into a port scope over
    the port's own startup run."""
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jfluid.Executor().run(jprog, scope=jscope)
    tfluid.Executor(tfluid.CPUPlace()).run(tprog, scope=tscope)
    scope_from_arrays(tscope, {n: np.asarray(v) for n, v in jscope.items()
                               if n != JAX_RNG})
    return jscope, tscope


def test_four_adam_steps_match_jax(built, no_jax_passes):
    (cfg, jmain, jstart, loss), (_, tmain, tstart, tloss) = built
    assert loss == tloss
    jscope, tscope = _carried_scopes(jstart, tstart)
    feed = jgpt.random_batch(cfg, B, S, rng=np.random.default_rng(0))
    assert all(np.array_equal(feed[k], v) for k, v in tgpt.random_batch(
        cfg, B, S, rng=np.random.default_rng(0)).items())
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    grads = ["word_embedding@GRAD", "decoder_layer_0_qkv.w_0@GRAD"]
    losses = []
    for step in range(4):
        jl, *jg = jexe.run(jmain, feed=feed, fetch_list=[loss] + grads,
                           scope=jscope)
        tl, *tg = texe.run(tmain, feed=feed, fetch_list=[loss] + grads,
                           scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"step {step}")
        for name, a, b in zip(grads, tg, jg):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5,
                                       err_msg=f"{name} step {step}")
        losses.append(float(np.ravel(tl)[0]))
    assert abs(losses[0] - np.log(cfg.vocab_size)) < 1.0
    assert losses[-1] < losses[0]
    names = [n for n in jscope.keys() if n != JAX_RNG]
    assert any("moment1" in n for n in names) and \
        any("beta2_pow" in n for n in names)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-4, err_msg=n)


def test_scope_from_arrays_refuses_missing_and_misshaped(built):
    _, (_, _, tstart, _) = built
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(tstart, scope=scope)
    arrays = {n: v.numpy() for n, v in scope.items()
              if isinstance(v, torch.Tensor)}
    with pytest.raises(ValueError, match="missing"):
        scope_from_arrays(scope, {k: v for k, v in arrays.items()
                                  if k != "word_embedding"})
    with pytest.raises(ValueError, match="unknown"):
        scope_from_arrays(scope, {**arrays, "nope": np.zeros(1)})
    bad = dict(arrays, word_embedding=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        scope_from_arrays(scope, bad)


# -- single ops: port lowering and grad vs JAX lowering and jax.vjp -------

FORWARD_OPS = ["lookup_table", "elementwise_add", "dropout", "layer_norm",
               "mul", "slice", "reshape2", "transpose2", "flash_attention",
               "gelu", "matmul", "softmax_with_cross_entropy",
               "elementwise_mul", "reduce_sum", "fill_constant",
               "elementwise_div"]


def test_forward_op_types_are_the_parametrized_list(built):
    (_, jmain, _, _), _ = built
    fwd = {op.type for op in jmain.global_block().ops
           if op.attrs.get("op_role", 0) == 0}
    assert fwd == set(FORWARD_OPS)


def _inputs(block, names, rng, vocab):
    """Seeded numpy values for var names: ints in [0, vocab), floats
    normal."""
    out = {}
    for n in names:
        v = block.var(n)
        if v.dtype.startswith("int"):
            out[n] = rng.integers(0, vocab, v.shape).astype(v.dtype)
        else:
            out[n] = rng.normal(size=v.shape).astype(np.float32)
    return out


def _lower_both(jprog, tprog, i, vals):
    jop, top = jprog.global_block().ops[i], tprog.global_block().ops[i]
    jctx = jlowering.LowerCtx(jprog, jprog.global_block(), {},
                              jax.random.PRNGKey(0))
    tctx = tlowering.LowerCtx(tprog, tprog.global_block(), {}, "cpu")
    jins = {s: [jnp.asarray(vals[n]) for n in ns]
            for s, ns in jop.inputs.items()}
    tins = {s: [torch.from_numpy(vals[n].copy()) for n in ns]
            for s, ns in top.inputs.items()}
    jout = jregistry.normalize_outs(
        jop.outputs, jregistry.get_op_def(jop.type).lower(jctx, jins,
                                                          jop.attrs))
    tout = tregistry.normalize_outs(
        tregistry.get_op_def(top.type).lower(tctx, tins, top.attrs))
    return jout, tout


def _assert_outs_close(jout, tout, what):
    assert set(tout) == set(jout), what
    for slot, jv in jout.items():
        for a, b in zip(tout[slot], jv):
            if a is None or b is None:
                assert a is None and b is None, (what, slot)
                continue
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape, (what, slot)
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{what} {slot}")


@pytest.mark.parametrize("op_type", FORWARD_OPS)
def test_op_lowering_and_grad_match_jax(built, op_type):
    (cfg, jmain, _, _), (_, tmain, _, _) = built
    ops = jmain.global_block().ops
    i = next(k for k, op in enumerate(ops) if op.type == op_type)
    rng = np.random.default_rng(i)
    block = jmain.global_block()
    vals = _inputs(block, ops[i].input_arg_names, rng, cfg.vocab_size)
    _assert_outs_close(*_lower_both(jmain, tmain, i, vals), op_type)

    fwd_outs = ops[i].output_arg_names
    gi = [k for k, op in enumerate(ops) if op.type == op_type + "_grad"
          and op.attrs["__fwd_op__"]["outputs"] == ops[i].outputs]
    if op_type == "fill_constant":
        assert not gi                        # not differentiable
        return
    assert len(gi) == 1
    gop = ops[gi[0]]
    gvals = dict(vals)
    gvals.update(_inputs(block, [n for n in gop.input_arg_names
                                 if n not in vals], rng, cfg.vocab_size))
    assert all(n not in gop.input_arg_names for n in fwd_outs)
    _assert_outs_close(*_lower_both(jmain, tmain, gi[0], gvals),
                       op_type + "_grad")


def test_dropout_grad_uses_the_forward_mask():
    """Through the executor: dropout(x, 0.5) forward and its grad op draw
    the same keep mask, so x@GRAD = w * keep / 0.5 exactly where the
    forward output kept x (and 0 elsewhere)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [64, 32], "float32",
                               stop_gradient=False)
        w = tfluid.layers.data("w", [64, 32], "float32")
        out = tfluid.layers.dropout(
            x, 0.5, dropout_implementation="upscale_in_train")
        loss = tfluid.layers.reduce_sum(
            tfluid.layers.elementwise_mul(out, w))
        tfluid.append_backward(loss)
    rng = np.random.default_rng(3)
    feed = {"x": rng.normal(size=(64, 32)).astype(np.float32) + 5.0,
            "w": rng.normal(size=(64, 32)).astype(np.float32)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    masks = []
    for _ in range(2):
        o, gx = exe.run(main, feed=feed, fetch_list=[out, "x@GRAD"],
                        scope=scope)
        keep = o != 0                          # x + 5 is never 0
        assert 0.3 < keep.mean() < 0.7
        np.testing.assert_allclose(o[keep], feed["x"][keep] / 0.5,
                                   rtol=1e-6)
        np.testing.assert_allclose(gx, np.where(keep, feed["w"] / 0.5, 0),
                                   rtol=1e-6)
        masks.append(keep)
    # each run draws a new mask (the run seed advances)
    assert not np.array_equal(masks[0], masks[1])


def test_mul_bespoke_grad_matches_generic_vjp(built):
    """``mul_grad`` is registered by hand (no forward recompute); it
    equals the generic torch.func.vjp grad of the ``mul`` lowering."""
    _, (cfg, tmain, _, _) = built
    ops = tmain.global_block().ops
    gop = next(op for op in ops if op.type == "mul_grad")
    block = tmain.global_block()
    vals = _inputs(block, gop.input_arg_names, np.random.default_rng(5),
                   cfg.vocab_size)
    ins = {s: [torch.from_numpy(vals[n]) for n in ns]
           for s, ns in gop.inputs.items()}
    ctx = tlowering.LowerCtx(tmain, block, {}, "cpu")
    got = tregistry.get_op_def("mul_grad").lower(ctx, ins, gop.attrs)
    want = tregistry.generic_grad_lower(ctx, ins, gop.attrs,
                                        tregistry.OPS["mul"])
    assert set(got) == set(want) == {"X@GRAD", "Y@GRAD"}
    for k in got:
        np.testing.assert_allclose(got[k][0].numpy(), want[k][0].numpy(),
                                   rtol=1e-5, atol=1e-6)
