"""The port's ``layers.Pipeline``, ``pipeline`` op and
``PipelineOptimizer`` in one process (no launch) against the JAX
package, on the CPU:

- JAX ``tests/test_pipeline.py``'s program (B16 D8, 2 stages of fc-tanh,
  4 microbatches, SGD 0.1, 5 steps) on the port's sequential path
  against the JAX package's sequential run and its ``MeshConfig(pp=2)``
  GPipe run, within JAX's own rtol 2e-5 / atol 1e-6;
- the X, P and R grads of a stage that reads an outer var (``R``)
  against the JAX package's;
- the stacked parameters' shapes and ``dist_attr``, the "uniform"
  ``ValueError``, the ``num_microbatches`` mismatch ``ValueError`` and
  the ``cut_list`` and no-pipeline warnings;
- dropout in a stage: the same mask in every stage and microbatch of a
  step, and the same in the forward and the grad's recompute;
- the program through ``verify_program`` and ``dce``/``cse`` (the op is
  a side effect), and pass ``pp_shard`` at pp 2 in a world of 1.

The launch across processes is ``test_torch_pipeline_parallel.py``.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.parallel.mesh import MeshConfig, make_mesh

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework.executor import scope_from_arrays

B, D = 16, 8
S, M = 2, 4
JAX_RNG = "@RNG_KEY@"


def _build(fluid, seed=7, opt=None, reads_outer=False, stages=S):
    """JAX ``test_pipeline.py``'s ``_build`` (with ``reads_outer``, the
    stage also adds an outer var ``r`` to its fc output)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    layers = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data("x", [B, D], dtype="float32")
        y = layers.data("y", [B, 1], dtype="float32")
        x.stop_gradient = False
        r = None
        if reads_outer:
            r = layers.data("r", [D], dtype="float32")
            r.stop_gradient = False
        pipe = layers.Pipeline(num_stages=stages, num_microbatches=M)
        with pipe.stage():
            h = pipe.stage_input(x)
            o = layers.fc(h, D)
            if r is not None:
                o = layers.elementwise_add(o, r)
            pipe.stage_output(layers.tanh(o))
        feat = pipe()
        pred = layers.fc(feat, 1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        optimizer = fluid.optimizer.PipelineOptimizer(
            opt(fluid) if opt else fluid.optimizer.SGD(0.1),
            num_microbatches=M)
        optimizer.minimize(loss)
    return main, startup, loss


def _data():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((B, D)).astype(np.float32),
            "y": rng.standard_normal((B, 1)).astype(np.float32),
            "r": rng.standard_normal((D,)).astype(np.float32)}


def _jax_run(mesh=None, steps=5, fetch=(), reads_outer=False):
    """(losses, fetched per step, startup state) of the JAX program."""
    main, startup, loss = _build(jfluid, reads_outer=reads_outer)
    exe, scope = jfluid.Executor(), jfluid.Scope()
    exe.run(startup, scope=scope)
    start = {n: np.array(v) for n, v in scope.items() if n != JAX_RNG}
    prog = main if mesh is None else jfluid.CompiledProgram(
        main).with_data_parallel(loss_name=loss.name, mesh=mesh)
    feed = _data() if reads_outer else {k: v for k, v in _data().items()
                                        if k != "r"}
    losses, got = [], []
    for _ in range(steps):
        vals = exe.run(prog, feed=feed, fetch_list=[loss] + list(fetch),
                       scope=scope)
        losses.append(float(np.ravel(vals[0])[0]))
        got.append([np.asarray(v) for v in vals[1:]])
    return losses, got, start


def _port_run(start, steps=5, fetch=(), reads_outer=False):
    main, startup, loss = _build(tfluid, reads_outer=reads_outer)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    scope_from_arrays(scope, start)
    feed = _data() if reads_outer else {k: v for k, v in _data().items()
                                        if k != "r"}
    losses, got = [], []
    for _ in range(steps):
        vals = exe.run(main, feed=feed, fetch_list=[loss] + list(fetch),
                       scope=scope)
        losses.append(float(np.ravel(vals[0])[0]))
        got.append([np.asarray(v) for v in vals[1:]])
    return losses, got, main


def test_sequential_matches_jax_sequential_and_pp2():
    seq, _, start = _jax_run()
    pp, _, _ = _jax_run(make_mesh(MeshConfig(pp=S)))
    port, _, _ = _port_run(start)
    np.testing.assert_allclose(port, seq, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(port, pp, rtol=2e-5, atol=1e-6)
    assert port[-1] < port[0], port


def test_stage_grads_of_x_p_and_outer_read_match_jax():
    names = ["x@GRAD", "r@GRAD", "fc_0.w_0@GRAD", "fc_0.b_0@GRAD"]
    _, want, start = _jax_run(steps=2, fetch=names, reads_outer=True)
    _, got, main = _port_run(start, steps=2, fetch=names, reads_outer=True)
    op = next(o for o in main.global_block().ops if o.type == "pipeline")
    assert op.input("R") == ["r"]
    assert op.input("P") == ["fc_0.w_0", "fc_0.b_0"]
    for step in range(2):
        for n, g, w in zip(names, got[step], want[step]):
            assert g.shape == w.shape, (n, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6,
                                       err_msg=n)


def test_stacked_params_shapes_and_dist_attr():
    main, startup, _ = _build(tfluid)
    gb = main.global_block()
    stage = [v for v in gb.vars.values() if getattr(v, "is_parameter", False)
             and v.dist_attr == ("pp",)]
    assert sorted(v.name for v in stage) == ["fc_0.b_0", "fc_0.w_0"]
    assert {v.name: v.shape for v in stage} == {"fc_0.w_0": (S, D, D),
                                               "fc_0.b_0": (S, D)}
    # the startup's init ops make the stacked shape, per-stage bounds
    sgb = startup.global_block()
    for v in stage:
        assert sgb.var(v.name).shape == v.shape
        init = next(o for o in sgb.ops if v.name in o.output_arg_names)
        assert list(init.attrs["shape"]) == list(v.shape)
    jmain, _, _ = _build(jfluid)
    for v in stage:
        jv = jmain.global_block().var(v.name)
        assert tuple(jv.shape) == v.shape and jv.dist_attr == v.dist_attr


def test_rejects_nonuniform_stage():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [B, D], dtype="float32")
        pipe = tfluid.layers.Pipeline(num_stages=2, num_microbatches=4)
        with pytest.raises(ValueError, match="uniform"):
            with pipe.stage():
                h = pipe.stage_input(x)
                pipe.stage_output(tfluid.layers.fc(h, D + 1))


def test_optimizer_microbatch_mismatch_and_warnings():
    with pytest.raises(ValueError, match="num_microbatches"):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", [B, D], dtype="float32")
            pipe = tfluid.layers.Pipeline(num_stages=2, num_microbatches=4)
            with pipe.stage():
                h = pipe.stage_input(x)
                pipe.stage_output(tfluid.layers.fc(h, D))
            loss = tfluid.layers.mean(pipe())
            tfluid.optimizer.PipelineOptimizer(
                tfluid.optimizer.SGD(0.1), num_microbatches=2).minimize(loss)
    with pytest.warns(UserWarning, match="cut_list"):
        opt = tfluid.optimizer.PipelineOptimizer(
            tfluid.optimizer.SGD(0.1), cut_list=[["x"]])
    assert opt._learning_rate == 0.1       # the inner optimizer's
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [B, D], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 1))
        with pytest.warns(UserWarning, match="no layers.Pipeline"):
            tfluid.optimizer.PipelineOptimizer(
                tfluid.optimizer.SGD(0.1)).minimize(loss)


def test_dropout_in_a_stage_draws_one_mask_a_step():
    """Stage ``h + dropout(h)`` twice over ones: with one mask ``m`` in
    both stages the output is ``(1 + m)^2``, 1 or 9 (``upscale``: m is 0
    or 2); two masks would give 3s. Every microbatch draws the same
    mask, the grad's recompute too (``x@GRAD`` = the output over ones),
    and the next step another."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    layers = tfluid.layers
    with tfluid.program_guard(main, startup):
        x = layers.data("x", [B, D], dtype="float32")
        x.stop_gradient = False
        pipe = layers.Pipeline(num_stages=2, num_microbatches=M)
        with pipe.stage():
            h = pipe.stage_input(x)
            pipe.stage_output(layers.elementwise_add(h, layers.dropout(
                h, 0.5, dropout_implementation="upscale_in_train")))
        out = pipe()
        gx, = tfluid.gradients(layers.reduce_sum(out), [x])
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    ones = np.ones((B, D), np.float32)
    outs = []
    for _ in range(2):
        o, g = exe.run(main, feed={"x": ones}, fetch_list=[out, gx],
                       scope=scope)
        assert set(np.unique(o)) <= {1.0, 9.0}, np.unique(o)
        assert 0 < (o == 9.0).sum() < o.size
        mbs = o.reshape(M, B // M, D)
        assert all(np.array_equal(mbs[0], m) for m in mbs[1:])
        np.testing.assert_array_equal(g, o)
        outs.append(o)
    assert not np.array_equal(outs[0], outs[1])


def test_pipeline_op_survives_verify_and_passes():
    from paddle_tpu_torch.framework.analysis import (is_side_effect_type,
                                                     verify_program)
    from paddle_tpu_torch.framework.passes import apply_passes
    main, _, loss = _build(tfluid)
    assert is_side_effect_type("pipeline")
    assert is_side_effect_type("pipeline_grad")
    verify_program(main, fetch_names=[loss.name])
    prog = apply_passes(main.clone(), ["dce", "cse"])
    types = [o.type for o in prog.global_block().ops]
    assert types.count("pipeline") == 1
    assert types.count("pipeline_grad") == 1


def test_pp_shard_cuts_the_stage_state_to_one_slice():
    """Pass ``pp_shard`` over a pp 2 mesh in a world of 1 (a look at the
    rewrite): each stacked parameter, its Adam moments and its grad take
    the ``[1, ...]`` slice, the rest stays whole; a 3-stage pipeline on
    the pp 2 mesh keeps its state whole (the sequential path); beside
    tp or sp the cut is the same, beside ep the pass raises."""
    from paddle_tpu_torch.framework.passes import apply_passes, get_pass
    from paddle_tpu_torch.parallel.mesh import Mesh
    main, _, _ = _build(tfluid, opt=lambda fl: fl.optimizer.Adam(0.01))
    prog = apply_passes(main.clone(), [get_pass("pp_shard",
                                                mesh=Mesh(1, pp=2))])
    gb = prog.global_block()
    lay = prog._pp_layouts
    assert "fc_0.w_0" in lay and lay["fc_0.w_0"].axis == "pp"
    assert lay["fc_0.w_0"].full_shape == (S, D, D)
    assert gb.var("fc_0.w_0").shape == (1, D, D)
    assert gb.var("fc_0.w_0@GRAD").shape == (1, D, D)
    moments = [n for n in lay if n.startswith("fc_0.w_0_moment")]
    assert len(moments) == 2
    assert all(gb.var(n).shape == (1, D, D) for n in moments)
    assert gb.var("fc_1.w_0").shape == (D, 1)
    # the user's program is left whole
    assert main.global_block().var("fc_0.w_0").shape == (S, D, D)
    three, _, _ = _build(tfluid, stages=3)
    prog = apply_passes(three.clone(), [get_pass("pp_shard",
                                                 mesh=Mesh(1, pp=2))])
    assert not prog._pp_layouts
    assert prog.global_block().var("fc_0.w_0").shape == (3, D, D)
    # beside tp (and sp) the slices are cut per pp coordinate only: the
    # same [1, ...] slice, the stage whole on every tp rank
    for mesh in (Mesh(1, tp=2, pp=2), Mesh(1, sp=2, pp=2),
                 Mesh(2, tp=2, pp=2)):
        prog = apply_passes(main.clone(), [get_pass("pp_shard",
                                                    mesh=mesh)])
        assert prog._pp_layouts["fc_0.w_0"].full_shape == (S, D, D)
        assert prog.global_block().var("fc_0.w_0").shape == (1, D, D)
        assert prog.global_block().var("fc_1.w_0").shape == (D, 1)
    # beside ep too (a switch_moe outside the pipeline is the ep
    # split's): the same [1, ...] slice
    prog = apply_passes(main.clone(), [get_pass("pp_shard",
                                                mesh=Mesh(1, pp=2, ep=2))])
    assert prog._pp_layouts["fc_0.w_0"].full_shape == (S, D, D)
    assert prog.global_block().var("fc_0.w_0").shape == (1, D, D)


def test_pp_shard_refuses_batch_statistics_in_a_stage():
    """A stage's ops run only at its pp rank's ticks: batch statistics
    (which the JAX package takes over each device's share of a
    microbatch) raise under pp, and run on the sequential path."""
    from paddle_tpu_torch.framework.passes import apply_passes, get_pass
    from paddle_tpu_torch.parallel.mesh import Mesh
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [B, D], dtype="float32")
        pipe = tfluid.layers.Pipeline(num_stages=2, num_microbatches=M)
        with pipe.stage():
            h = pipe.stage_input(x)
            pipe.stage_output(tfluid.layers.batch_norm(
                tfluid.layers.fc(h, D)))
        loss = tfluid.layers.mean(pipe())
        tfluid.optimizer.SGD(0.1).minimize(loss)
    with pytest.raises(NotImplementedError, match="'batch_norm' in a "
                                                  "pipeline stage"):
        apply_passes(main.clone(), [get_pass("pp_shard",
                                             mesh=Mesh(1, pp=2))])
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    got, = exe.run(main, feed={"x": np.ones((B, D), np.float32)},
                   fetch_list=[loss], scope=scope)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_pipeline_is_a_replicated_region_to_tp_and_sp(axis):
    """Beside tp or sp every rank of a stage runs it whole: an input of
    the ``pipeline`` op split on tp (the output of a column-split fc) or
    on the sequence (after an ``sp`` constraint) is gathered whole
    before it (``c_concat``, ``sp_gather``), its grad cut back to the
    rank's part by the conjugate grad op, the stage sub-block is left as
    built, and the rewritten program verifies (a world of 1, a look at
    the rewrite)."""
    from paddle_tpu_torch.framework.analysis import verify_program
    from paddle_tpu_torch.framework.passes import apply_passes, get_pass
    from paddle_tpu_torch.parallel.mesh import Mesh, set_param_dist_attr
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = L.data("x", [B, 4, D], dtype="float32")
        h = L.fc(x, D, num_flatten_dims=2)
        if axis == "sp":
            h = L.collective.shard(h, "dp", "sp", None)
        pipe = L.Pipeline(num_stages=S, num_microbatches=M)
        with pipe.stage():
            pipe.stage_output(L.tanh(L.fc(pipe.stage_input(h), D,
                                          num_flatten_dims=2)))
        loss = L.mean(pipe())
        if axis == "tp":
            set_param_dist_attr(main, "fc_0.w_0", (None, "tp"))
            set_param_dist_attr(main, "fc_0.b_0", ("tp",))
        tfluid.optimizer.PipelineOptimizer(
            tfluid.optimizer.SGD(0.1), num_microbatches=M).minimize(loss)
    stage_ops = [o.type for o in main.blocks[1].ops]
    mesh = Mesh(1, pp=2, **{axis: 2})
    prog = apply_passes(main.clone(), [get_pass(f"{axis}_shard", mesh=mesh),
                                       get_pass("pp_shard", mesh=mesh)])
    gb = prog.global_block()
    ops = gb.ops
    pipe_op = next(o for o in ops if o.type == "pipeline")
    gather = "c_concat" if axis == "tp" else "sp_gather"
    made = next(o for o in ops if pipe_op.input("X")[0] in
                o.output_arg_names)
    assert made.type == gather
    assert tuple(gb.var(pipe_op.input("X")[0]).shape) == (B, 4, D)
    assert tuple(gb.var(made.input("X")[0]).shape) == \
        ((B, 4, D // 2) if axis == "tp" else (B, 2, D))
    pipe_grad = next(o for o in ops if o.type == "pipeline_grad")
    whole_grad = pipe_grad.output("X@GRAD")[0]
    back = next(o for o in ops if whole_grad in o.input_arg_names
                and o.type == gather + "_grad")
    assert tuple(gb.var(back.output("X@GRAD")[0]).shape) == \
        tuple(gb.var(made.input("X")[0]).shape)
    assert [o.type for o in prog.blocks[1].ops] == stage_ops
    assert prog._pp_layouts
    verify_program(prog, fetch_names=[loss.name])
