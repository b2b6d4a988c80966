"""Recompute and gradient merge in the port against the JAX package, on
the CPU.

- ``RecomputeOptimizer``'s program (ops, op types, var names, attrs)
  equals the JAX package's, op for op, for a 6-layer MLP checkpointed
  every second layer (``tests/test_recompute_gradmerge.py``'s
  ``_deep_mlp``) and for ``BertConfig.tiny()`` (2 layers) at B2 S16 P4
  with flash attention, noam Adam and the layer outputs as checkpoints,
  as ``__graft_entry__._build(with_opt=True)`` composes it;
- 4 steps with and without recompute give the same losses (rtol 1e-6),
  also with dropout 0.1 (the recomputed dropout draws its forward's
  mask), and the MLP's equal the JAX losses (rtol 1e-5) from the JAX
  startup's state;
- nothing of a recomputed segment is kept for the grad ops across the
  forward (``LowerCtx.saved``): the grad ops of a recomputed flash op
  take what the recomputed op saved, and none runs the forward again;
- ``cse`` and ``dce`` keep the barrier and the recomputed flash ops;
- ``GradientMergeOptimizer(k_steps=2)`` builds the JAX program, updates
  the parameters on every second step only, and matches the JAX losses
  and parameters (rtol 1e-5, atol 1e-5: Adam's normalized step turns a
  1e-7 grad difference into 2e-6) over 4 steps;
- ``append_backward``'s callbacks warn but ``clip.error_clip_callback``,
  which is accepted, and a var's error clip puts the JAX package's
  ``clip`` op on its grad; ``RecomputeOptimizer.load`` raises, and other
  attributes are the wrapped optimizer's."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.framework import unique_name as j_unique_name
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework.core import OP_ROLE_KEY, OpRole
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.framework.lowering import LowerCtx, run_op
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import attention_ops

from test_torch_bert import jax_dict

JAX_RNG = "@RNG_KEY@"
JAX = (jfluid, jbert, j_unique_name)
PORT = (tfluid, tbert, tfluid.unique_name)
B, S, P = 2, 16, 4


def deep_mlp(pkg, recompute, gradmerge=0, every=2, n_layers=6):
    """``_deep_mlp`` of tests/test_recompute_gradmerge.py (SGD 0.1;
    ``gradmerge=k`` wraps Adam in GradientMergeOptimizer instead)."""
    fluid, _, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 64], "float32")
        y = fluid.data("y", [-1, 1], "float32")
        h = x
        ckpts = []
        for _ in range(n_layers):
            h = fluid.layers.fc(h, 64, act="relu")
            ckpts.append(h)
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square(pred - y))
        opt = fluid.optimizer.SGDOptimizer(0.1)
        if gradmerge:
            opt = fluid.optimizer.GradientMergeOptimizer(
                fluid.optimizer.AdamOptimizer(0.01), k_steps=gradmerge)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts[every - 1::every])
        opt.minimize(loss)
    return main, startup, loss.name


def bert_graft(pkg, recompute, dropout=0.0):
    """BERT pretraining as ``__graft_entry__._build(with_opt=True)``:
    noam_decay(h, 100, 1.0) Adam under RecomputeOptimizer over the layer
    outputs."""
    fluid, bert, unique_name = pkg
    cfg = bert.BertConfig.tiny()
    cfg.attn_mechanism = "flash"
    cfg.hidden_dropout = cfg.attn_dropout = dropout
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        lr = fluid.layers.noam_decay(cfg.hidden_size, 100,
                                     learning_rate=1.0)
        opt = fluid.optimizer.AdamOptimizer(learning_rate=lr)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(out["checkpoints"])
        opt.minimize(out["loss"])
    return cfg, main, startup, out


def mlp_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(8, 64).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}


def carried(jstart, tstart):
    """The JAX startup's state, in a JAX scope and a port scope."""
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jfluid.Executor().run(jstart, scope=jscope)
    tfluid.Executor(tfluid.CPUPlace()).run(tstart, scope=tscope)
    scope_from_arrays(tscope, {n: np.asarray(v) for n, v in jscope.items()
                               if n != JAX_RNG})
    return jscope, tscope


def copy_scope(scope):
    out = tfluid.Scope()
    for n, v in scope.items():
        out.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("model", ["mlp", "bert"])
def test_program_equals_jax(model, recompute):
    if model == "mlp":
        jmain, jstart, _ = deep_mlp(JAX, recompute)
        tmain, tstart, _ = deep_mlp(PORT, recompute)
    else:
        _, jmain, jstart, _ = bert_graft(JAX, recompute)
        _, tmain, tstart, _ = bert_graft(PORT, recompute)
    assert tmain.to_dict() == jax_dict(jmain)
    assert tstart.to_dict() == jax_dict(jstart)
    types = [op.type for op in tmain.global_block().ops]
    assert ("recompute_barrier" in types) == recompute
    if recompute and model == "bert":
        # 2 forward + 2 recomputed flash ops, 2 barriers (the trailing
        # segment, the heads, is not recomputed)
        assert types.count("flash_attention") == 4
        assert types.count("recompute_barrier") == 2
        names = {n for op in tmain.global_block().ops
                 for n in op.output_arg_names}
        assert any(n.endswith("@RECOMPUTE") for n in names)
        assert any("@RC_IN@" in n for n in names)


def test_mlp_losses_match_jax_with_and_without_recompute():
    losses = {}
    for rc in (False, True):
        jmain, jstart, jloss = deep_mlp(JAX, rc)
        tmain, tstart, tloss = deep_mlp(PORT, rc)
        jscope, tscope = carried(jstart, tstart)
        jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
        feed = mlp_feed()
        losses[rc] = [
            (float(np.asarray(jexe.run(jmain, feed=feed, fetch_list=[jloss],
                                       scope=jscope)[0])),
             float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                            scope=tscope)[0]))
            for _ in range(4)]
        j, t = np.array(losses[rc]).T
        np.testing.assert_allclose(t, j, rtol=1e-5)
        assert t[-1] < t[0]
    np.testing.assert_allclose(np.array(losses[True])[:, 1],
                               np.array(losses[False])[:, 1], rtol=1e-6)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_bert_recompute_losses_equal_without(dropout):
    """Same start state and feeds; with dropout the recomputed segment
    redraws its forward's masks (same ``__rng_seed__``), so the losses
    still agree."""
    runs = {}
    scope0 = None
    for rc in (False, True):
        cfg, main, startup, out = bert_graft(PORT, rc, dropout)
        exe = tfluid.Executor(tfluid.CPUPlace())
        if scope0 is None:
            scope0 = tfluid.Scope()
            exe.run(startup, scope=scope0)
        scope = copy_scope(scope0)
        rng = np.random.default_rng(0)
        runs[rc] = [float(exe.run(main, feed=tbert.random_batch(
            cfg, B, S, P, rng=rng), fetch_list=[out["loss"]],
            scope=scope)[0]) for _ in range(4)]
    np.testing.assert_allclose(runs[True], runs[False], rtol=1e-6)


def _forward_then_backward(main, scope, feed):
    """Run ``main`` op by op; returns (ctx.saved keys when the forward
    ends, ctx.saved keys at the end)."""
    block = main.global_block()
    env = {n: torch.from_numpy(np.ascontiguousarray(v))
           for n, v in feed.items()}
    for n, v in scope.items():
        env.setdefault(n, v)
    ctx = LowerCtx(main, block, env, "cpu", run_seed=0)
    after_fwd = None
    with torch.no_grad():
        for op in block.ops:
            if after_fwd is None and \
                    op.attrs.get(OP_ROLE_KEY) == OpRole.Backward:
                after_fwd = set(ctx.saved)
            run_op(ctx, op)
    return after_fwd, set(ctx.saved)


def test_recomputed_segments_save_nothing_across_the_forward(monkeypatch):
    fallbacks = []
    real = attention_ops.flash_attention_fwd
    monkeypatch.setattr(attention_ops, "flash_attention_fwd",
                        lambda *a: fallbacks.append(1) or real(*a))
    kept = {}
    for rc in (False, True):
        cfg, main, startup, out = bert_graft(PORT, rc)
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
        feed = tbert.random_batch(cfg, B, S, P,
                                  rng=np.random.default_rng(0))
        kept[rc] = _forward_then_backward(main, scope, feed)
    fwd_outs = {op.output("Out")[0] for op in main.global_block().ops
                if op.type == "flash_attention"}
    # without recompute the two flash ops keep (out, lse2) for their
    # grads; with it the forward keeps nothing, the recomputed ops do
    assert len(kept[False][0]) == 2
    assert kept[True][0] == set()
    assert not kept[True][0] & fwd_outs
    assert kept[False][1] == kept[True][1] == set()
    assert not fallbacks          # every flash grad found its saved pair


def test_passes_keep_the_barrier_and_the_recomputed_ops():
    from paddle_tpu_torch.framework.passes import optimize_program
    _, main, _, out = bert_graft(PORT, True)
    opt = optimize_program(main, [out["loss"].name])
    types = [op.type for op in opt.global_block().ops]
    assert types.count("recompute_barrier") == 2
    assert types.count("flash_attention") == 4


def test_gradient_merge_applies_every_second_step_and_matches_jax():
    jmain, jstart, jloss = deep_mlp(JAX, False, gradmerge=2)
    tmain, tstart, tloss = deep_mlp(PORT, False, gradmerge=2)
    assert tmain.to_dict() == jax_dict(jmain)
    jscope, tscope = carried(jstart, tstart)
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    params = [p.name for p in tmain.global_block().all_parameters()]
    before = {n: tscope.find_var(n).clone() for n in params}
    for i in range(4):
        feed = mlp_feed(i)
        jl = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        tl = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl[0], np.asarray(jl[0]), rtol=1e-5)
        moved = [not torch.equal(tscope.find_var(n), before[n])
                 for n in params]
        assert all(moved) if i % 2 else not any(moved)
        before = {n: tscope.find_var(n).clone() for n in params}
        for n in params:
            np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                       np.asarray(jscope.find_var(n)),
                                       rtol=1e-5, atol=1e-5)


def test_callbacks_warn_and_error_clipping_raises():
    """Other callbacks warn; ``error_clip_callback`` is accepted without
    a warning, and a var's ``ErrorClipByValue`` clips its grad with the
    ops the JAX package emits."""
    import warnings

    def other(block, context):
        pass

    def build(fluid, cb, error_clip):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data("x", [-1, 4], "float32")
            h = fluid.layers.fc(x, 2)
            if error_clip:
                h._set_error_clip(fluid.clip.ErrorClipByValue(max=1e-3))
            loss = fluid.layers.mean(fluid.layers.fc(h, 1))
            grads = fluid.append_backward(loss, callbacks=[cb])
        return main, grads
    with pytest.warns(UserWarning, match="is not invoked"):
        build(tfluid, other, False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        main, grads = build(tfluid, tfluid.clip.error_clip_callback, True)
    jmain, _ = build(jfluid, jfluid.clip.error_clip_callback, True)
    ops = [(o.type, o.inputs, o.outputs) for o in main.global_block().ops]
    assert ops == [(o.type, o.inputs, o.outputs)
                   for o in jmain.global_block().ops]
    clip = next(o for o in main.global_block().ops if o.type == "clip")
    assert (clip.attrs["min"], clip.attrs["max"]) == (-1e-3, 1e-3)
    assert grads
    opt = tfluid.optimizer.RecomputeOptimizer(tfluid.optimizer.SGD(0.1))
    with pytest.raises(NotImplementedError):
        opt.load({})
    assert opt._learning_rate == 0.1         # the wrapped optimizer's
