"""bf16 mixed precision in the port against the JAX package, on the CPU.

``contrib.mixed_precision`` of both packages on the GPT tiny train
program (1 layer, h32, B4 S16, dropout 0): ``rewrite_program`` gives the
same ``to_dict()``; four AMP Adam steps, static scale 1.0 and dynamic
loss scaling, from the JAX startup's values carried into the port's
scope, agree within bf16 tolerances (losses rtol 2e-2; the loss scale
and its counters exactly); and an overflow (a loss scale so large that
the scaled loss is inf, so every grad is inf or nan) rolls back every
persistable the optimizer writes, bit for bit, while the scale falls and
the counters move as the JAX package's do.

The session turns ``FLAGS_verify_passes`` on (tests/conftest.py), for
both packages: every program the port's executor runs is verified, and
every pass's output validated."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import unique_name as j_unique_name
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.models import gpt as tgpt

B, S = 4, 16
JAX_RNG = "@RNG_KEY@"
LOSS_RTOL = 2e-2


def build(fluid, gpt, unique_name, mp, **amp):
    cfg = gpt.GPTConfig.tiny()
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = gpt.gpt_pretrain(cfg, B, S)
        opt = mp.decorate(fluid.optimizer.AdamOptimizer(1e-3), **amp)
        opt.minimize(out["loss"])
    scale = opt.get_loss_scaling().name
    counters = [opt._num_good_steps.name, opt._num_bad_steps.name] \
        if amp.get("use_dynamic_loss_scaling", True) else []
    return cfg, main, startup, out["loss"].name, [scale] + counters


def both(**amp):
    return (build(jfluid, jgpt, j_unique_name, jmp, **amp),
            build(tfluid, tgpt, tfluid.unique_name, tmp, **amp))


def jax_dict(program):
    d = program.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            assert v["dist_attr"] is None
    return d


def test_rewrite_program_equals_jax():
    progs = []
    for fluid, gpt, un, mp in ((jfluid, jgpt, j_unique_name, jmp),
                               (tfluid, tgpt, tfluid.unique_name, tmp)):
        main, startup = fluid.Program(), fluid.Program()
        with un.guard(), fluid.program_guard(main, startup):
            gpt.gpt_pretrain(gpt.GPTConfig.tiny(), B, S)
        mp.rewrite_program(main, mp.AutoMixedPrecisionLists())
        progs.append(main)
    jd, td = jax_dict(progs[0]), progs[1].to_dict()
    assert td == jd
    ops = progs[1].global_block().ops
    casts = [op for op in ops if op.type == "cast"]
    assert casts and all(op.attrs["out_dtype"] in ("bfloat16", "float32")
                         for op in casts)
    fa = next(op for op in ops if op.type == "flash_attention")
    assert progs[1].global_block().var(fa.input("Q")[0]).dtype == "bfloat16"


def test_amp_bf16_pass_is_rewrite_program():
    from paddle_tpu_torch.framework import passes
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        tgpt.gpt_pretrain(tgpt.GPTConfig.tiny(), B, S)
    ref = main.clone()
    tmp.rewrite_program(ref, tmp.AutoMixedPrecisionLists())
    passes.apply_passes(main, ["amp_bf16"])
    assert main.to_dict() == ref.to_dict()


def _carried_scopes(jprog, tprog):
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jfluid.Executor().run(jprog, scope=jscope)
    tfluid.Executor(tfluid.CPUPlace()).run(tprog, scope=tscope)
    scope_from_arrays(tscope, {n: np.asarray(v) for n, v in jscope.items()
                               if n != JAX_RNG})
    return jscope, tscope


@pytest.mark.parametrize("dynamic", [False, True])
def test_four_amp_adam_steps_match_jax(dynamic):
    amp = {} if dynamic else dict(init_loss_scaling=1.0,
                                  use_dynamic_loss_scaling=False)
    (cfg, jmain, jstart, loss, jstate), (_, tmain, tstart, tloss,
                                        tstate) = both(**amp)
    assert (loss, jstate) == (tloss, tstate)
    jscope, tscope = _carried_scopes(jstart, tstart)
    feed = jgpt.random_batch(cfg, B, S, rng=np.random.default_rng(0))
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    losses = []
    for step in range(4):
        jl, *js = jexe.run(jmain, feed=feed, fetch_list=[loss] + jstate,
                           scope=jscope)
        tl, *ts = texe.run(tmain, feed=feed, fetch_list=[loss] + tstate,
                           scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
        for name, a, b in zip(tstate, ts, js):
            assert np.array_equal(a, np.asarray(b)), (name, step, a, b)
        losses.append(float(np.ravel(tl)[0]))
    assert all(np.isfinite(losses))
    assert abs(losses[0] - np.log(cfg.vocab_size)) < 1.0
    assert losses[-1] < losses[0]
    if dynamic:       # four clean steps: the good counter counts them
        good = tscope.find_var(tstate[1]).numpy()
        assert good.tolist() == [4.0]


def test_overflow_rolls_back_every_persistable_as_jax():
    amp = dict(init_loss_scaling=3e38, decr_every_n_nan_or_inf=1)
    (cfg, jmain, jstart, loss, jstate), (_, tmain, tstart, _,
                                        tstate) = both(**amp)
    jscope, tscope = _carried_scopes(jstart, tstart)
    before = {n: v.clone() for n, v in tscope.items()
              if isinstance(v, torch.Tensor)}
    written = {n for op in tmain.global_block().ops if op.type == "adam"
               for n in op.output_arg_names}
    assert len(written) == 16 * 5
    feed = jgpt.random_batch(cfg, B, S, rng=np.random.default_rng(0))
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    for step in range(2):
        jl, *js = jexe.run(jmain, feed=feed, fetch_list=[loss] + jstate,
                           scope=jscope)
        tl, *ts = texe.run(tmain, feed=feed, fetch_list=[loss] + tstate,
                           scope=tscope)
        for name, a, b in zip(tstate, ts, js):
            assert np.array_equal(a, np.asarray(b)), (name, step, a, b)
    scale, good, bad = (tscope.find_var(n).numpy() for n in tstate)
    want = np.float32(np.float32(3e38) * np.float32(0.8)) * np.float32(0.8)
    assert scale.tolist() == [float(want)]
    assert good.tolist() == [0.0] and bad.tolist() == [0.0]
    for n in written:
        assert torch.equal(tscope.find_var(n), before[n]), n
