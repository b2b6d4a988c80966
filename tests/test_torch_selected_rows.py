"""SelectedRows sparse embedding grads in the port against the JAX
package, on the CPU (the cases of ``tests/test_selected_rows.py`` and
``tests/test_program_passes.py::test_sparse_grad_stays_unfused``).

- An ``is_sparse`` embedding trained by SGD or Momentum in both packages
  from the JAX startup's values: the port's losses and table equal its
  own dense run (rtol 1e-5, atol 1e-7, the JAX test's tolerance) and the
  JAX sparse run (rtol 1e-5, atol 1e-7).
- The W grad in the env is the ``SelectedRows`` of the batch's ids (B
  rows, not V), its rows and values the JAX grad's (values rtol 1e-6).
- Lazy Adam: untouched rows keep their param and moments bit for bit
  (moments exactly zero), touched rows move; the table equals JAX's lazy
  run (rtol 1e-5, atol 1e-7). With duplicate ids, lazy Adam's touched
  rows equal dense Adam's (rtol 1e-5, atol 1e-7) and JAX's lazy run.
- ``coalesce``, ``merge``, ``to_dense``, the ``sum`` op over
  ``SelectedRows`` and the ``merge_selected_rows`` /
  ``get_tensor_from_selected_rows`` ops against the JAX functions on
  the same seeded inputs (float32, rtol 1e-6, atol 1e-6: the sums of
  duplicates may run in another order).
- ``fuse_optimizer`` leaves the sparse-grad updates per-param and fuses
  the dense ones, as the JAX pass does (the same optimized op types).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jfluid
from paddle_tpu.framework import lowering as jlowering
from paddle_tpu.framework import passes as jpasses
from paddle_tpu.framework import registry as jregistry
from paddle_tpu.framework import selected_rows as jsr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.framework import selected_rows as tsr
from paddle_tpu_torch.framework.executor import scope_from_arrays
from paddle_tpu_torch.framework.lowering import LowerCtx, run_ops
from paddle_tpu_torch.framework.registry import get_op_def

JAX_RNG = "@RNG_KEY@"
V, D, B = 100, 8, 16
TOL = {"rtol": 1e-5, "atol": 1e-7}


def _build(fluid, is_sparse, opt_factory, seed=5, ids_shape=(B, 1),
           size=(V, D), name="sr_emb", head="fc"):
    """tests/test_selected_rows.py's programs, in either package."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = layers.data("ids", list(ids_shape), dtype="int64")
        y = layers.data("y", [ids_shape[0], 1], dtype="float32")
        emb = layers.embedding(ids, size=list(size), is_sparse=is_sparse,
                               param_attr=fluid.ParamAttr(name=name))
        flat = layers.reshape(emb, [-1, size[1]])
        if head == "fc":
            pred = layers.fc(flat, 1,
                             param_attr=fluid.ParamAttr(name="sr_fc.w"),
                             bias_attr=False)
        else:
            pred = layers.reduce_sum(flat, dim=1, keep_dim=True)
        loss = layers.mean(layers.square_error_cost(pred, y))
        opt_factory(fluid).minimize(loss)
    return main, startup, loss


def _train(is_sparse, opt_factory, feed, steps, port_only=False, **kw):
    """``steps`` steps in both packages (the port only with
    ``port_only``) from the JAX startup's values: (port losses, JAX
    losses, port scope, JAX scope, the start values)."""
    jmain, jstart, jloss = _build(jfluid, is_sparse, opt_factory, **kw)
    tmain, tstart, tloss = _build(tfluid, is_sparse, opt_factory, **kw)
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    start = {n: np.array(v) for n, v in jscope.items() if n != JAX_RNG}
    scope_from_arrays(tscope, start)
    tl, jl = [], []
    for _ in range(steps):
        tl.append(float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                                 scope=tscope)[0]))
        if not port_only:
            jl.append(float(jexe.run(jmain, feed=feed, fetch_list=[jloss],
                                     scope=jscope)[0]))
    return tl, jl, tscope, jscope, start


def _table(scope, name):
    v = scope.find_var(name)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _regression_feed():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (B, 1)).astype(np.int64)
    return {"ids": ids, "y": (ids / V - 0.5).astype(np.float32)}


OPTS = {
    "sgd": lambda fluid: fluid.optimizer.SGD(0.5),
    "momentum": lambda fluid: fluid.optimizer.MomentumOptimizer(
        0.2, momentum=0.9),
}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_sparse_update_matches_dense_and_jax(opt):
    feed = _regression_feed()
    dl, _, dscope, _, _ = _train(False, OPTS[opt], feed, 6, port_only=True)
    sl, jl, sscope, jscope, _ = _train(True, OPTS[opt], feed, 6)
    np.testing.assert_allclose(sl, dl, **TOL)
    np.testing.assert_allclose(_table(sscope, "sr_emb"),
                               _table(dscope, "sr_emb"), **TOL)
    np.testing.assert_allclose(sl, jl, **TOL)
    np.testing.assert_allclose(_table(sscope, "sr_emb"),
                               _table(jscope, "sr_emb"), **TOL)
    assert sl[-1] < sl[0]


def test_sparse_grad_is_not_densified():
    """The W grad in the env is (rows, values) with B rows, equal to the
    JAX package's."""
    rng = np.random.default_rng(1)
    feed = {"ids": rng.integers(0, V, (B, 1)).astype(np.int64),
            "y": rng.standard_normal((B, 1)).astype(np.float32)}
    jmain, jstart, _ = _build(jfluid, True, OPTS["sgd"])
    tmain, tstart, _ = _build(tfluid, True, OPTS["sgd"])
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jfluid.Executor().run(jstart, scope=jscope)
    tfluid.Executor(tfluid.CPUPlace()).run(tstart, scope=tscope)
    scope_from_arrays(tscope, {n: np.asarray(v) for n, v in jscope.items()
                               if n != JAX_RNG})
    jenv = {k: v for k, v in jscope.items() if not k.startswith("@")}
    jenv.update({k: np.asarray(v) for k, v in feed.items()})
    jlowering.run_ops(jlowering.LowerCtx(jmain, jmain.global_block(), jenv,
                                         jax.random.PRNGKey(0)))
    tenv = {k: v for k, v in tscope.items() if not k.startswith("@")}
    tenv.update({k: torch.from_numpy(v) for k, v in feed.items()})
    run_ops(LowerCtx(tmain, tmain.global_block(), tenv, "cpu"))
    g, jg = tenv["sr_emb@GRAD"], jenv["sr_emb@GRAD"]
    assert tsr.is_selected_rows(g), type(g)
    assert tuple(g.values.shape) == (B, D)
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_array_equal(g.rows.numpy(), feed["ids"][:, 0])
    np.testing.assert_allclose(g.values.numpy(), np.asarray(jg.values),
                               rtol=1e-6, atol=1e-9)


def test_lazy_adam_touches_only_seen_rows():
    """Lazy Adam: moments of untouched rows stay exactly zero and their
    params unchanged; the table equals JAX's lazy run."""
    rng = np.random.default_rng(3)
    feed = {"ids": rng.integers(0, 10, (B, 1)).astype(np.int64),
            "y": rng.standard_normal((B, 1)).astype(np.float32)}
    lazy = lambda fluid: fluid.optimizer.AdamOptimizer(  # noqa: E731
        0.1, lazy_mode=True)
    tl, jl, tscope, jscope, start = _train(True, lazy, feed, 3, seed=2,
                                           name="la_emb", head="sum")
    emb0, emb1 = start["la_emb"], _table(tscope, "la_emb")
    m1 = next(_table(tscope, n) for n in tscope.keys()
              if n.startswith("la_emb_moment1"))
    np.testing.assert_array_equal(emb1[10:], emb0[10:])
    assert np.all(m1[10:] == 0.0)
    assert np.any(m1[:10] != 0.0)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(emb1, _table(jscope, "la_emb"), **TOL)


def test_lazy_adam_duplicate_ids_match_dense_adam():
    """Duplicate ids in one batch: lazy Adam's touched rows equal dense
    Adam's (the ids merge before the update) and JAX's lazy run's."""
    feed = {"ids": np.array([[3], [3], [3], [5], [5], [7], [7], [7]],
                            np.int64),
            "y": np.linspace(-1, 1, 8, dtype=np.float32).reshape(8, 1)}
    kw = dict(seed=9, ids_shape=(8, 1), size=(20, 4), name="dup_emb",
              head="sum")
    dense = _train(False, lambda fluid: fluid.optimizer.AdamOptimizer(0.1),
                   feed, 4, port_only=True, **kw)[2]
    _, _, lazy, jlazy, _ = _train(
        True, lambda fluid: fluid.optimizer.AdamOptimizer(
            0.1, lazy_mode=True), feed, 4, **kw)
    touched = [3, 5, 7]
    np.testing.assert_allclose(_table(lazy, "dup_emb")[touched],
                               _table(dense, "dup_emb")[touched], **TOL)
    np.testing.assert_allclose(_table(lazy, "dup_emb"),
                               _table(jlazy, "dup_emb"), **TOL)


def _pair(rng, n, vocab, d):
    rows = rng.integers(0, vocab, n).astype(np.int64)
    return rows, rng.standard_normal((n, d)).astype(np.float32)


def _live(rows, values, vocab):
    """{row: value} of the slots a coalesced SelectedRows applies."""
    return {int(r): values[i] for i, r in enumerate(rows) if r < vocab}


def test_coalesce_merges_duplicates_like_jax():
    rng = np.random.default_rng(7)
    rows, vals = _pair(rng, 64, 12, 5)            # many duplicates
    jc = jsr.coalesce(jsr.SelectedRows(jnp.asarray(rows, jnp.int32),
                                       jnp.asarray(vals)))
    tc = tsr.coalesce(tsr.SelectedRows(torch.from_numpy(rows),
                                       torch.from_numpy(vals)))
    assert tuple(tc.values.shape) == vals.shape     # N stays fixed
    trows, tvals = tc.rows.numpy(), tc.values.numpy()
    assert (np.diff(trows) >= 0).all() and trows.max() < 12
    first = tsr.run_heads(tc.rows).numpy()
    head = first == np.arange(64)
    assert np.array_equal(trows[head], np.unique(rows))
    assert not tvals[~head].any()                   # duplicates add 0
    assert (trows[first] == trows).all()            # a run's first slot
    jlive = _live(np.asarray(jc.rows), np.asarray(jc.values), 12)
    tlive = {int(r): tvals[i] for i, r in enumerate(trows) if head[i]}
    assert sorted(jlive) == sorted(tlive)
    for r in jlive:
        np.testing.assert_allclose(tlive[r], jlive[r], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tsr.to_dense(tc, (12, 5)).numpy(),
        np.asarray(jsr.to_dense(jsr.SelectedRows(
            jnp.asarray(rows, jnp.int32), jnp.asarray(vals)), (12, 5))),
        rtol=1e-6, atol=1e-6)


def test_merge_and_to_dense_like_jax():
    rng = np.random.default_rng(8)
    parts = [_pair(rng, n, 30, 4) for n in (5, 9, 3)]
    jm = jsr.merge([jsr.SelectedRows(jnp.asarray(r, jnp.int32),
                                     jnp.asarray(v)) for r, v in parts])
    tm = tsr.merge([tsr.SelectedRows(torch.from_numpy(r),
                                     torch.from_numpy(v)) for r, v in parts])
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_array_equal(tm.values.numpy(), np.asarray(jm.values))
    assert tm.shape == tm.values.shape and tm.dtype == torch.float32
    np.testing.assert_allclose(tsr.to_dense(tm, (30, 4)).numpy(),
                               np.asarray(jsr.to_dense(jm, (30, 4))),
                               rtol=1e-6, atol=1e-6)


def _lower(pkg, op_type, ins, attrs=None):
    if pkg == "jax":
        ctx = jlowering.LowerCtx(None, None, {}, jax.random.PRNGKey(0))
        return jregistry.get_op_def(op_type).lower(ctx, ins, attrs or {})
    return get_op_def(op_type).lower(LowerCtx(None, None, {}, "cpu"), ins,
                                     attrs or {})


def _both(rows, vals):
    return (jsr.SelectedRows(jnp.asarray(rows, jnp.int32), jnp.asarray(vals)),
            tsr.SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals)))


@pytest.mark.parametrize("mixed", [False, True])
def test_sum_over_selected_rows_like_jax(mixed):
    """sparse + sparse stays sparse (the merge); with a dense input each
    sparse one is densified into its shape."""
    rng = np.random.default_rng(9)
    (j1, t1), (j2, t2) = (_both(*_pair(rng, n, 20, 3)) for n in (6, 4))
    jx, tx = [j1, j2], [t1, t2]
    if mixed:
        d = rng.standard_normal((20, 3)).astype(np.float32)
        jx.insert(1, jnp.asarray(d))
        tx.insert(1, torch.from_numpy(d))
    jo = _lower("jax", "sum", {"X": jx})["Out"]
    to = _lower("torch", "sum", {"X": tx})["Out"]
    assert tsr.is_selected_rows(to) is not mixed
    if mixed:
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(to.rows.numpy(), np.asarray(jo.rows))
        np.testing.assert_array_equal(to.values.numpy(),
                                      np.asarray(jo.values))


def test_selected_rows_ops_like_jax():
    rng = np.random.default_rng(10)
    rows, vals = _pair(rng, 16, 6, 3)
    jx, tx = _both(rows, vals)
    jo = _lower("jax", "merge_selected_rows", {"X": [jx]})["Out"]
    to = _lower("torch", "merge_selected_rows", {"X": [tx]})["Out"]
    np.testing.assert_allclose(tsr.to_dense(to, (6, 3)).numpy(),
                               np.asarray(jsr.to_dense(jo, (6, 3))),
                               rtol=1e-6, atol=1e-6)
    jv = _lower("jax", "get_tensor_from_selected_rows", {"X": [jx]})["Out"]
    tv = _lower("torch", "get_tensor_from_selected_rows", {"X": [tx]})["Out"]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    dense = torch.ones(2, 3)
    for op in ("merge_selected_rows", "get_tensor_from_selected_rows"):
        assert _lower("torch", op, {"X": [dense]})["Out"] is dense


def test_sparse_grad_stays_unfused():
    """The sparse-grad param keeps its per-param update; the dense one
    fuses; the optimized programs have the JAX pass's op types."""
    def build(fluid):
        layers = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            ids = layers.data("ids", [-1, 1], dtype="int64")
            y = layers.data("y", [-1, 1], dtype="float32")
            emb = layers.embedding(ids, size=[50, 8], is_sparse=True)
            emb = layers.reshape(emb, [-1, 8])
            h = layers.fc(emb, 4)
            loss = layers.mean(layers.square_error_cost(layers.fc(h, 1), y))
            fluid.optimizer.SGD(0.1).minimize(loss)
        return main, loss

    jmain, jloss = build(jfluid)
    tmain, tloss = build(tfluid)
    jopt = jpasses.optimize_program(jmain, fetch_names=[jloss.name])
    topt = tpasses.optimize_program(tmain, fetch_names=[tloss.name])
    fused = [op for op in topt.global_block().ops if op.type == "fused_sgd"]
    assert fused and not [p for op in fused for p in op.inputs["Param"]
                          if "emb" in p.lower()]
    assert [op.type for op in topt.global_block().ops] == \
        [op.type for op in jopt.global_block().ops]
    sgd = [op for op in topt.global_block().ops if op.type == "sgd"]
    assert [op.inputs["Param"] for op in sgd] == [["embedding_0.w_0"]]
