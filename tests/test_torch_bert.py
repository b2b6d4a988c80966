"""BERT pretraining in the port against the JAX package, on the CPU.

``BertConfig.tiny()`` (2 layers, h64, 4 heads, ffn 128, vocab 128) at
B2 S16 P4 with ``noam_decay(64, 10000, 200)`` and Adam, on the einsum
attention path and on the flash path (the kernels' plain versions
here), with dropout 0:

- both packages build the same program and startup program
  (``to_dict()``), also after ``mp.decorate`` (bf16 AMP);
- each op type the port added for BERT (forward lowering and, where the
  program has one, its grad op) agrees with the JAX lowering within
  1e-5; the grads the JAX op registers but BERT never emits (rsqrt,
  elementwise_min, unsqueeze2, increment) through ``append_backward``
  in both packages; ``gather_grad`` with duplicate indices is the same
  bits run to run; ``truncated_gaussian_random`` stays within two
  standard deviations with the truncated normal's spread;
- the JAX startup's parameters, moments, beta-pows and LR counter are
  carried into the port's scope, then 4 Adam steps: losses rtol 1e-4,
  every state tensor atol 1e-4, ``nsp_acc`` and the learning rate equal
  (bf16 AMP: losses rtol 2e-2 as ``test_torch_amp.py``, the LR and its
  counter equal, state atol 2e-3);
- ``clone(for_test=True)`` drops the scheduler, the backward, the
  optimizer and (``is_test``) dropout, and its loss matches the JAX
  eval loss within 1e-5;
- the flash op's grad reads the forward's saved ``out`` and ``lse2``
  (one forward kernel per layer and step).

The session turns ``FLAGS_verify_passes`` on (tests/conftest.py): every
program here runs verified, its passes validated."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import unique_name as j_unique_name
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import attention_ops

from test_torch_train import _assert_outs_close, _lower_both

B, S, P = 2, 16, 4
JAX_RNG = "@RNG_KEY@"
LR_COUNTER = "@LR_DECAY_COUNTER@"

JAX = (jfluid, jbert, j_unique_name, jmp)
PORT = (tfluid, tbert, tfluid.unique_name, tmp)


def _cfg(bert, mech, dropout=0.0):
    cfg = bert.BertConfig.tiny()
    cfg.attn_mechanism = mech
    cfg.hidden_dropout = cfg.attn_dropout = dropout
    return cfg


def build(pkg, mech=None, amp=False, dropout=0.0):
    """``bert_pretrain`` + ``noam_decay`` + Adam (``amp``: wrapped by
    ``mp.decorate`` at a static loss scale of 1.0, as bench.py trains).
    Returns (cfg, main, startup, {loss, mlm_loss, nsp_acc, lr} names)."""
    fluid, bert, unique_name, mp = pkg
    cfg = _cfg(bert, mech, dropout)
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = bert.bert_pretrain(cfg, B, S, P)
        lr = fluid.layers.noam_decay(cfg.hidden_size, 10000, 200.0)
        opt = fluid.optimizer.AdamOptimizer(lr)
        if amp:
            opt = mp.decorate(opt, init_loss_scaling=1.0,
                              use_dynamic_loss_scaling=False)
        opt.minimize(out["loss"])
    names = {k: out[k].name for k in ("loss", "mlm_loss", "nsp_acc")}
    names["lr"] = lr.name
    return cfg, main, startup, names


def jax_dict(program):
    d = program.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"].values():
            assert v["dist_attr"] is None
    return d


def _carried_scopes(jprog, tprog):
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jfluid.Executor().run(jprog, scope=jscope)
    tfluid.Executor(tfluid.CPUPlace()).run(tprog, scope=tscope)
    scope_from_arrays(tscope, {n: np.asarray(v) for n, v in jscope.items()
                               if n != JAX_RNG})
    return jscope, tscope


def feed_of(cfg):
    return jbert.random_batch(cfg, B, S, P, rng=np.random.default_rng(0))


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("mech", [None, "flash"])
def test_programs_equal_jax(mech, amp):
    _, jmain, jstart, jnames = build(JAX, mech, amp)
    _, tmain, tstart, tnames = build(PORT, mech, amp)
    assert jnames == tnames
    assert tmain.to_dict() == jax_dict(jmain)
    assert tstart.to_dict() == jax_dict(jstart)
    types = {op.type for op in tstart.global_block().ops}
    assert "truncated_gaussian_random" in types


def test_random_batch_equals_jax():
    cfg = _cfg(tbert, None)
    a = jbert.random_batch(cfg, B, S, P, rng=np.random.default_rng(3))
    b = tbert.random_batch(cfg, B, S, P, rng=np.random.default_rng(3))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


# -- the new op types: port lowering and grad vs the JAX lowering ----------

NEW_OPS = ["scale", "mean", "einsum", "softmax", "tanh", "fill_any_like",
           "unsqueeze2", "gather", "top_k", "accuracy", "increment",
           "rsqrt", "elementwise_min"]


@pytest.fixture(scope="module")
def einsum_built():
    return build(JAX), build(PORT)


def _op_inputs(block, op, rng, vocab):
    """Seeded inputs in each op's domain: gather indices within X's rows
    (with duplicates), accuracy's indices and labels in {0, 1}, rsqrt's
    input positive, other ints in [0, vocab), floats normal."""
    vals = {}
    for slot, names in op.inputs.items():
        for n in names:
            v = block.var(n)
            if op.type == "gather" and slot == "Index":
                rows = block.var(op.input("X")[0]).shape[0]
                a = rng.integers(0, rows // 2, v.shape)
            elif op.type == "accuracy" and slot in ("Indices", "Label"):
                a = rng.integers(0, 2, v.shape)
            elif v.dtype.startswith("int"):
                a = rng.integers(0, vocab, v.shape)
            else:
                a = rng.normal(size=v.shape)
                if op.type == "rsqrt":
                    a = np.abs(a) + 0.5
            vals[n] = a.astype(v.dtype)
    return vals


@pytest.mark.parametrize("op_type", NEW_OPS)
def test_new_op_lowering_and_grad_match_jax(einsum_built, op_type):
    (cfg, jmain, _, _), (_, tmain, _, _) = einsum_built
    ops = jmain.global_block().ops
    block = jmain.global_block()
    idxs = [k for k, op in enumerate(ops) if op.type == op_type]
    assert idxs, op_type
    checked_grads = 0
    for i in idxs[:2]:          # both einsum equations; one of the others
        rng = np.random.default_rng(i)
        vals = _op_inputs(block, ops[i], rng, cfg.vocab_size)
        _assert_outs_close(*_lower_both(jmain, tmain, i, vals), op_type)
        gi = [k for k, op in enumerate(ops) if op.type == op_type + "_grad"
              and op.attrs["__fwd_op__"]["outputs"] == ops[i].outputs]
        for k in gi:
            gvals = dict(vals)
            gvals.update({n: rng.normal(size=block.var(n).shape).astype(
                np.float32) for n in ops[k].input_arg_names
                if n not in vals})
            _assert_outs_close(*_lower_both(jmain, tmain, k, gvals),
                               op_type + "_grad")
            checked_grads += 1
    # the grad ops BERT's program has: the rest are checked below
    want = {"scale", "mean", "einsum", "softmax", "tanh", "gather"}
    assert (checked_grads > 0) == (op_type in want), op_type


def _one_op_grad(pkg, op_type, x_val, y_val=None):
    """x@GRAD of reduce_sum(op(x)) (or op(x, y)) through each package's
    append_backward and executor."""
    fluid = pkg[0]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", list(x_val.shape), "float32",
                              stop_gradient=False)
        feed = {"x": x_val}
        if op_type == "rsqrt":
            out = fluid.layers.rsqrt(x)
        elif op_type == "elementwise_min":
            y = fluid.layers.data("y", list(y_val.shape), "float32",
                                  stop_gradient=False)
            feed["y"] = y_val
            out = fluid.layers.elementwise_min(x, y)
        elif op_type == "unsqueeze2":
            out = fluid.layers.unsqueeze(x, [0, 2])
        else:                   # increment into a fresh var
            out = main.global_block().create_var(
                name="inc_out", shape=x.shape, dtype="float32")
            main.global_block().append_op(
                type="increment", inputs={"X": [x]},
                outputs={"Out": [out]}, attrs={"step": 2.0})
        w = fluid.layers.data("w", list(out.shape), "float32")
        feed["w"] = np.linspace(-1, 1, int(np.prod(out.shape))).reshape(
            out.shape).astype(np.float32)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, w))
        fluid.append_backward(loss)
    exe = fluid.Executor(fluid.CPUPlace()) if fluid is tfluid \
        else fluid.Executor()
    names = ["x@GRAD"] + (["y@GRAD"] if y_val is not None else [])
    return [np.asarray(g) for g in exe.run(main, feed=feed,
                                           fetch_list=names,
                                           scope=fluid.Scope())]


@pytest.mark.parametrize("op_type", ["rsqrt", "elementwise_min",
                                     "unsqueeze2", "increment"])
def test_grads_bert_does_not_emit_match_jax(op_type):
    rng = np.random.default_rng(11)
    x = np.abs(rng.normal(size=(3, 5))).astype(np.float32) + 0.5
    y = rng.normal(size=(3, 5)).astype(np.float32) + 1.0 \
        if op_type == "elementwise_min" else None
    got = _one_op_grad(PORT, op_type, x, y)
    want = _one_op_grad(JAX, op_type, x, y)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert np.abs(a).sum() > 0


def test_gather_grad_sums_duplicates_bitwise_run_to_run():
    from paddle_tpu_torch.framework import registry as tregistry
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    idx = torch.tensor([[3], [1], [3], [3], [0], [1]], dtype=torch.int32)
    g = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    attrs = {"__fwd_op__": {"type": "gather", "attrs": {"axis": 0},
                            "inputs": {}, "outputs": {}},
             "__grad_inputs__": {"X": [True]}}
    lower = tregistry.get_op_def("gather_grad").lower
    ins = {"X": [x], "Index": [idx], "Out@GRAD": [g]}
    a = lower(None, ins, attrs)["X@GRAD"][0]
    b = lower(None, ins, attrs)["X@GRAD"][0]
    assert torch.equal(a, b)
    want = np.zeros((6, 8), np.float32)
    np.add.at(want, idx[:, 0].numpy(), g.numpy())
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-6, atol=1e-6)


def test_truncated_gaussian_random_is_truncated_at_two_std():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        w = tfluid.layers.create_global_var([256, 256], 0.0, "float32",
                                            persistable=True, name="tg_w")
        from paddle_tpu_torch.framework.initializer import TruncatedNormal
        TruncatedNormal(loc=1.0, scale=0.5)(w, main.global_block())
    vals = []
    for seed in (0, 1):
        main.random_seed = seed
        out, = tfluid.Executor(tfluid.CPUPlace()).run(
            main, fetch_list=["tg_w"], scope=tfluid.Scope())
        vals.append(out)
    a = vals[0]
    assert np.all(np.abs(a - 1.0) <= 1.0 + 1e-6)
    assert abs(a.mean() - 1.0) < 0.01
    # the standard normal truncated at +-2 has std 0.8796
    assert abs(a.std() - 0.5 * 0.8796) < 0.01
    assert not np.array_equal(vals[0], vals[1])


# -- parameters ------------------------------------------------------------

def test_param_shapes_are_the_startup_params():
    cfg, jmain, jstart, _ = build(JAX)
    params = {p.name: tuple(p.shape) for p in jmain.all_parameters()}
    assert tbert.param_shapes(cfg) == params


def test_params_from_jax_checks_names_and_shapes():
    cfg = _cfg(tbert, None)
    arrays = {n: np.zeros(s, np.float32)
              for n, s in tbert.param_shapes(cfg).items()}
    got = tbert.params_from_jax(cfg, arrays)
    assert set(got) == set(arrays)
    with pytest.raises(ValueError, match="missing"):
        tbert.params_from_jax(cfg, {k: v for k, v in arrays.items()
                                    if k != "word_embedding"})
    with pytest.raises(ValueError, match="unexpected"):
        tbert.params_from_jax(cfg, {**arrays, "nope": np.zeros(1)})
    bad = dict(arrays)
    bad["pooled_fc.w_0"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tbert.params_from_jax(cfg, bad)


def test_init_params_follow_bert_initializers():
    cfg = tbert.BertConfig.tiny()
    p = tbert.init_params(cfg, seed=0)
    assert {n: tuple(t.shape) for n, t in p.items()} == \
        tbert.param_shapes(cfg)
    for n, t in p.items():
        if n.endswith(".b_0") or n.endswith("_bias"):
            assert not t.any(), n
        else:        # layer-norm scales too: truncated normal, not ones
            assert t.abs().max() <= 2 * cfg.initializer_range + 1e-7, n
            assert t.std() > 0.5 * cfg.initializer_range, n
    assert torch.equal(p["word_embedding"],
                       tbert.init_params(cfg, seed=0)["word_embedding"])


# -- training --------------------------------------------------------------

def _noam(step, d_model=64):
    return np.float32(200.0 * d_model ** -0.5 *
                      min(step ** -0.5, step * 10000 ** -1.5))


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("mech", [None, "flash"])
def test_four_noam_adam_steps_match_jax(mech, amp):
    cfg, jmain, jstart, names = build(JAX, mech, amp)
    _, tmain, tstart, _ = build(PORT, mech, amp)
    jscope, tscope = _carried_scopes(jstart, tstart)
    assert tscope.find_var(LR_COUNTER).tolist() == [0.0]
    feed = feed_of(cfg)
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    fetch = [names[k] for k in ("loss", "nsp_acc", "lr")]
    losses = []
    for step in range(4):
        jl, jacc, jlr = jexe.run(jmain, feed=feed, fetch_list=fetch,
                                 scope=jscope)
        tl, tacc, tlr = texe.run(tmain, feed=feed, fetch_list=fetch,
                                 scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=2e-2 if amp else 1e-4,
                                   err_msg=f"step {step}")
        assert np.array_equal(tacc, np.asarray(jacc)), step
        assert np.array_equal(tlr, np.asarray(jlr)), step
        np.testing.assert_allclose(tlr, [_noam(step + 1)], rtol=1e-6)
        losses.append(float(np.ravel(tl)[0]))
    assert abs(losses[0] - np.log(cfg.vocab_size) - np.log(2)) < 1.0
    assert tscope.find_var(LR_COUNTER).tolist() == [4.0]
    names = [n for n in jscope.keys() if n != JAX_RNG]
    assert any("moment1" in n for n in names) and LR_COUNTER in names
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   atol=2e-3 if amp else 1e-4, err_msg=n)


def test_eval_clone_drops_scheduler_and_dropout_and_matches_jax():
    """``clone(for_test=True)`` of the dropout-0.1 training program: the
    LR scheduler's ops (LRSched role), the backward and Adam are gone,
    dropout runs as ``is_test``, and the loss equals the JAX eval loss
    on the same carried parameters."""
    cfg, jmain, jstart, names = build(JAX, dropout=0.1)
    _, tmain, tstart, _ = build(PORT, dropout=0.1)
    jtest, ttest = jmain.clone(for_test=True), tmain.clone(for_test=True)
    assert ttest.to_dict() == jax_dict(jtest)
    types = [op.type for op in ttest.global_block().ops]
    assert "increment" not in types and "adam" not in types
    assert not any(t.endswith("_grad") for t in types)
    drops = [op for op in ttest.global_block().ops if op.type == "dropout"]
    assert drops and all(op.attrs["is_test"] for op in drops)
    jscope, tscope = _carried_scopes(jstart, tstart)
    feed = feed_of(cfg)
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl, = jfluid.Executor().run(jtest, feed=feed,
                                fetch_list=[names["loss"]], scope=jscope)
    runs = [texe.run(ttest, feed=feed, fetch_list=[names["loss"]],
                     scope=tscope)[0] for _ in range(2)]
    np.testing.assert_allclose(runs[0], jl, rtol=1e-5)
    assert np.array_equal(runs[0], runs[1])      # no dropout draw
    assert tscope.find_var(LR_COUNTER).tolist() == [0.0]


def test_flash_grad_reads_the_saved_forward(monkeypatch):
    """A training step on the flash path runs the forward kernel once per
    layer: the grad op takes ``out`` and ``lse2`` from the forward
    (``flash_attention_fwd``, the grad's recompute, is never called)."""
    cfg, tmain, tstart, names = build(PORT, "flash")
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)

    def recompute(*a, **k):
        raise AssertionError("the flash grad recomputed the forward")
    monkeypatch.setattr(attention_ops, "flash_attention_fwd", recompute)
    grads = [op for op in tmain.global_block().ops
             if op.type == "flash_attention_grad"]
    assert len(grads) == cfg.num_layers
    loss, = exe.run(tmain, feed=feed_of(cfg), fetch_list=[names["loss"]],
                    scope=scope)
    assert np.isfinite(loss).all()
