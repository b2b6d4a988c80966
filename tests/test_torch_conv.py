"""The image ops of the port against the JAX package's, on the CPU.

``conv2d``, ``pool2d``, ``batch_norm``, ``relu``, ``flatten2`` and
``cross_entropy`` each run as one op of a program in both packages, on
the same seeded numpy inputs, and their outputs and input grads
(``fluid.gradients`` of ``sum(out * cot)`` for a seeded cotangent) are
held to the JAX lowering's: float32 within 1e-5 of the output's max
|ref| (grads too), bf16 (inputs cast in the program, the state float32)
within 2e-2 of it. The port's ``conv2d`` and ``batch_norm`` grads are
bespoke (``aten.convolution_backward``, ``aten.native_batch_norm_backward``
on the forward's saved statistics); ``pool2d`` and the others take the
generic vjp. ``batch_norm``'s first-step ``MeanOut``/``VarianceOut``
are also held to the population-variance update written out in numpy.

The test run turns ``FLAGS_verify_passes`` on (tests/conftest.py), so
each program here runs verified."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.framework import lowering
from paddle_tpu_torch.framework.lowering import LowerCtx
from paddle_tpu_torch.framework.registry import OPS, get_op_def

PKGS = {"jax": (jfluid, None), "port": (tfluid, tfluid.CPUPlace())}


def run_op(pkg, op_type, inputs, attrs, outputs, grad_slots=(),
           amp=False, seed=0):
    """One ``op_type`` op over data vars fed ``inputs`` ({slot: array});
    with ``amp`` the slots in ``amp`` are cast to bf16 in the program.
    Returns ({output slot: array}, {grad slot: array})."""
    fluid, place = PKGS[pkg]
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    feed = {}
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        block = main.global_block()
        ins, leaves = {}, {}
        for slot, a in inputs.items():
            v = L.data(f"in_{slot.lower()}", list(a.shape), str(a.dtype),
                       stop_gradient=slot not in grad_slots)
            feed[v.name] = a
            leaves[slot] = v
            ins[slot] = L.cast(v, "bfloat16") if amp and slot in amp else v
        outs = {s: block.create_var(name=f"out_{s.lower()}")
                for s in outputs}
        for s, names in (("MeanOut", "Mean"), ("VarianceOut", "Variance")):
            if s in outs:           # running stats rebind their input
                outs[s] = ins[names]
        block.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
        y = outs[outputs[0]]
        grads = []
        if grad_slots:
            cot = np.random.default_rng(seed + 99).standard_normal(
                y.shape).astype(np.float32)
            c = L.data("cot", list(cot.shape), "float32")
            feed["cot"] = cot
            y32 = L.cast(y, "float32") if y.dtype != "float32" else y
            loss = L.reduce_sum(L.elementwise_mul(y32, c))
            grads = fluid.gradients([loss], [leaves[s] for s in grad_slots])
    exe = fluid.Executor(place)
    vals = exe.run(main, feed=feed, fetch_list=[outs[s] for s in outputs]
                   + list(grads))
    vals = [np.asarray(v, dtype=np.float32) if np.asarray(v).dtype.kind
            in "fV" or str(np.asarray(v).dtype) == "bfloat16"
            else np.asarray(v) for v in vals]
    return (dict(zip(outputs, vals[:len(outputs)])),
            dict(zip(grad_slots, vals[len(outputs):])))


def assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max |port - jax| / max |jax| = {err:.3g}"


def both(op_type, inputs, attrs, outputs, grad_slots=(), amp=False,
         tol=None):
    tol = tol or (2e-2 if amp else 1e-5)
    jo, jg = run_op("jax", op_type, inputs, attrs, outputs, grad_slots, amp)
    to, tg = run_op("port", op_type, inputs, attrs, outputs, grad_slots,
                    amp)
    for s in outputs:
        assert_close(to[s], jo[s], tol, f"{op_type} {s}")
    for s in grad_slots:
        assert_close(tg[s], jg[s], tol, f"{op_type} {s}@GRAD")
    return to, tg


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- conv2d

CONV_CASES = {
    "3x3_s1_p1": dict(k=3, strides=[1, 1], paddings=[1, 1]),
    "3x3_s2_p1": dict(k=3, strides=[2, 2], paddings=[1, 1]),
    "7x7_s2_p3": dict(k=7, strides=[2, 2], paddings=[3, 3]),
    "1x1_s2": dict(k=1, strides=[2, 2], paddings=[0, 0]),
    "asym_pads": dict(k=3, strides=[1, 1], paddings=[1, 0, 2, 1]),
    "same_s2": dict(k=3, strides=[2, 2], algo="SAME"),
    "same_dil2": dict(k=3, strides=[1, 2], dilations=[2, 1], algo="SAME"),
    "valid_s2": dict(k=3, strides=[2, 2], algo="VALID"),
    "dil2_p2": dict(k=3, strides=[1, 1], paddings=[2, 2],
                    dilations=[2, 2]),
    "groups4": dict(k=3, strides=[1, 1], paddings=[1, 1], groups=4),
    "depthwise": dict(k=3, strides=[2, 2], paddings=[1, 1], groups=8),
}


def _conv_case(name, seed=0):
    c = CONV_CASES[name]
    rng = np.random.default_rng(seed)
    groups = c.get("groups", 1)
    x = _f32(rng, 2, 8, 11, 10)
    w = _f32(rng, 8, 8 // groups, c["k"], c["k"]) * 0.3
    attrs = {"strides": c["strides"], "paddings": c.get("paddings", [0, 0]),
             "dilations": c.get("dilations", [1, 1]), "groups": groups,
             "padding_algorithm": c.get("algo", "EXPLICIT"),
             "data_format": "NCHW"}
    return {"Input": x, "Filter": w}, attrs


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_forward_and_grads_match_jax(case):
    ins, attrs = _conv_case(case)
    both("conv2d", ins, attrs, ["Output"], ["Input", "Filter"])


@pytest.mark.parametrize("case", ["3x3_s2_p1", "asym_pads"])
def test_conv2d_bf16_matches_jax(case):
    ins, attrs = _conv_case(case, seed=1)
    both("conv2d", ins, attrs, ["Output"], ["Input", "Filter"],
         amp={"Input", "Filter"})


def test_conv2d_grad_is_bespoke_and_takes_only_what_is_asked():
    """The grad op runs ``aten.convolution_backward`` (no forward
    recompute) and returns only the grads the program asks for."""
    ins, attrs = _conv_case("asym_pads")
    t = {k: torch.from_numpy(v) for k, v in ins.items()}
    op = get_op_def("conv2d_grad")
    assert op.lower.__name__ == "conv2d_grad"
    ctx = LowerCtx(None, None, {}, "cpu")
    y = get_op_def("conv2d").lower(ctx, {"Input": [t["Input"]],
                                         "Filter": [t["Filter"]]}, attrs)
    g = torch.from_numpy(_f32(np.random.default_rng(3),
                              *y["Output"].shape))
    fwd = {"type": "conv2d", "inputs": {"Input": ["x"], "Filter": ["w"]},
           "outputs": {"Output": ["y"]}, "attrs": attrs}
    for req in ({"Input": [True]}, {"Filter": [True]}):
        out = op.lower(ctx, {"Input": [t["Input"]], "Filter": [t["Filter"]],
                             "Output@GRAD": [g]},
                       {"__fwd_op__": fwd, "__grad_inputs__": req})
        assert set(out) == {s + "@GRAD" for s in req}
        ref = torch.func.vjp(
            lambda x, w: get_op_def("conv2d").lower(
                ctx, {"Input": [x], "Filter": [w]}, attrs)["Output"],
            t["Input"], t["Filter"])[1](g)
        i = 0 if "Input" in req else 1
        got = out[next(iter(out))][0]
        assert got.shape == ref[i].shape
        assert torch.allclose(got, ref[i], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op_type", ["conv2d_transpose", "depthwise_conv2d",
                                     "conv3d", "pool3d"])
def test_ops_left_out_raise(op_type):
    with pytest.raises(NotImplementedError):
        get_op_def(op_type)


# ---------------------------------------------------------------- pool2d

POOL_CASES = {
    "max_3x3_s2_p1": {"pooling_type": "max", "ksize": [3, 3],
                      "strides": [2, 2], "paddings": [1, 1]},
    "max_2x2_s2": {"pooling_type": "max", "ksize": [2, 2],
                   "strides": [2, 2], "paddings": [0, 0]},
    "max_pad_beyond_half": {"pooling_type": "max", "ksize": [3, 3],
                            "strides": [1, 1], "paddings": [2, 2]},
    "max_same": {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                 "paddings": [0, 0], "padding_algorithm": "SAME"},
    "avg_exclusive": {"pooling_type": "avg", "ksize": [3, 3],
                      "strides": [2, 2], "paddings": [1, 1],
                      "exclusive": True},
    "avg_inclusive": {"pooling_type": "avg", "ksize": [3, 3],
                      "strides": [2, 2], "paddings": [1, 1],
                      "exclusive": False},
    "avg_exclusive_asym": {"pooling_type": "avg", "ksize": [3, 3],
                           "strides": [1, 1], "paddings": [2, 1],
                           "exclusive": True},
    "avg_same": {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
                 "paddings": [0, 0], "padding_algorithm": "SAME"},
    "avg_global": {"pooling_type": "avg", "global_pooling": True},
    "max_global": {"pooling_type": "max", "global_pooling": True},
    "avg_adaptive": {"pooling_type": "avg", "ksize": [2, 5],
                     "adaptive": True},
    "max_adaptive": {"pooling_type": "max", "ksize": [4, 2],
                     "adaptive": True},
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_forward_and_grad_match_jax(case):
    x = _f32(np.random.default_rng(4), 2, 3, 8, 10)
    both("pool2d", {"X": x}, POOL_CASES[case], ["Out"], ["X"])


def test_pool2d_bf16_matches_jax():
    x = _f32(np.random.default_rng(5), 2, 3, 9, 9)
    both("pool2d", {"X": x}, POOL_CASES["max_3x3_s2_p1"], ["Out"], ["X"],
         amp={"X"})


def test_pool2d_ceil_mode_raises():
    x = torch.zeros(1, 1, 5, 5)
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        get_op_def("pool2d").lower(
            LowerCtx(None, None, {}, "cpu"), {"X": [x]},
            {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
             "ceil_mode": True})


# ------------------------------------------------------------ batch_norm

BN_OUTS = ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]


def _bn_inputs(seed, shape=(4, 6, 5, 7)):
    rng = np.random.default_rng(seed)
    c = shape[1]
    return {"X": _f32(rng, *shape) * 2.0 + 0.5,
            "Scale": _f32(rng, c), "Bias": _f32(rng, c),
            "Mean": _f32(rng, c) * 0.1,
            "Variance": rng.uniform(0.5, 1.5, c).astype(np.float32)}


@pytest.mark.parametrize("mode", ["train", "is_test", "use_global_stats"])
def test_batch_norm_matches_jax(mode):
    ins = _bn_inputs(6)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": "NCHW",
             "is_test": mode == "is_test",
             "use_global_stats": mode == "use_global_stats"}
    out, _ = both("batch_norm", ins, attrs, BN_OUTS,
                  ["X", "Scale", "Bias"])
    if mode == "train":
        # the first step's running statistics: Paddle's momentum over the
        # batch's mean and POPULATION variance (torch would take the
        # unbiased one)
        x = ins["X"].astype(np.float64)
        m, v = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
        np.testing.assert_allclose(out["MeanOut"],
                                   ins["Mean"] * 0.9 + m * 0.1, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["VarianceOut"],
                                   ins["Variance"] * 0.9 + v * 0.1,
                                   rtol=1e-5)
        np.testing.assert_allclose(out["SavedVariance"],
                                   1 / np.sqrt(v + 1e-5), rtol=1e-5)
    else:
        np.testing.assert_array_equal(out["MeanOut"], ins["Mean"])


def _bn_float64(ins, cot, train):
    """Y and the X, Scale, Bias grads in float64 from the bf16-rounded X
    (the exact values a bf16 batch_norm approximates)."""
    x = torch.from_numpy(ins["X"]).bfloat16().double().requires_grad_()
    sc = torch.from_numpy(ins["Scale"]).double().requires_grad_()
    b = torch.from_numpy(ins["Bias"]).double().requires_grad_()
    if train:
        v, m = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    else:
        m = torch.from_numpy(ins["Mean"]).double()
        v = torch.from_numpy(ins["Variance"]).double()
    c = (1, -1, 1, 1)
    y = (x - m.reshape(c)) / torch.sqrt(v.reshape(c) + 1e-5) * \
        sc.reshape(c) + b.reshape(c)
    (y * torch.from_numpy(cot).double()).sum().backward()
    return {"Y": y.detach().numpy(), "X": x.grad.numpy(),
            "Scale": sc.grad.numpy(), "Bias": b.grad.numpy()}


@pytest.mark.parametrize("mode", ["train", "is_test"])
def test_batch_norm_bf16_keeps_float32_state(mode):
    """bf16 X (as AMP with batch_norm white-listed). Y, the X grad and
    the statistics are held to the JAX lowering within 2e-2. The Scale
    and Bias grads are sums over N*H*W products, which the JAX lowering
    takes in bf16 (its Scale grad is 2-4% off the exact value here) and
    the port's ``native_batch_norm_backward`` in float32: each of the
    port's outputs and grads is held within 2e-2 of the float64 result
    of the same bf16 inputs, and no farther from it than JAX's. The
    statistics and the state stay float32."""
    ins = _bn_inputs(7)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": mode == "is_test"}
    grads = ["X", "Scale", "Bias"]
    jo, jg = run_op("jax", "batch_norm", ins, attrs, BN_OUTS, grads, {"X"})
    to, tg = run_op("port", "batch_norm", ins, attrs, BN_OUTS, grads, {"X"})
    for s in BN_OUTS:
        assert_close(to[s], jo[s], 2e-2, f"batch_norm {s}")
    assert_close(tg["X"], jg["X"], 2e-2, "batch_norm X@GRAD")
    cot = np.random.default_rng(99).standard_normal(
        ins["X"].shape).astype(np.float32)
    exact = _bn_float64(ins, cot, mode == "train")
    for s, port, jax_ in [("Y", to["Y"], jo["Y"])] + \
            [(g, tg[g], jg[g]) for g in grads]:
        scale = np.abs(exact[s]).max()
        port_err = np.abs(port - exact[s]).max() / scale
        jax_err = np.abs(jax_ - exact[s]).max() / scale
        assert port_err <= 2e-2, (s, port_err)
        assert port_err <= jax_err * 1.01 + 1e-6, (s, port_err, jax_err)
    ctx = LowerCtx(None, None, {}, "cpu")
    t = {k: [torch.from_numpy(v)] for k, v in ins.items()}
    t["X"] = [t["X"][0].to(torch.bfloat16)]
    raw = get_op_def("batch_norm").lower(ctx, t, attrs)
    assert raw["Y"].dtype == torch.bfloat16
    assert all(raw[s].dtype == torch.float32 for s in BN_OUTS[1:])


def test_batch_norm_nhwc_matches_jax():
    ins = _bn_inputs(8)
    ins["X"] = np.ascontiguousarray(ins["X"].transpose(0, 2, 3, 1))
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": "NHWC"}
    both("batch_norm", ins, attrs, BN_OUTS, ["X", "Scale", "Bias"])


def test_batch_norm_grad_reads_the_saved_statistics():
    """Through the executor the forward keeps its float32 mean and
    rsqrt(var + eps) for the bespoke grad op, which pops them (nothing is
    left in the run's saved store after it), and its X grad equals the
    generic vjp's over the same lowering within 1e-5."""
    fluid, L = tfluid, tfluid.layers
    x_val = _bn_inputs(9)["X"]
    feed = {"x": x_val, "c": _f32(np.random.default_rng(13), *x_val.shape)}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", list(x_val.shape), "float32", stop_gradient=False)
        c = L.data("c", list(x_val.shape), "float32")
        loss = L.reduce_sum(L.elementwise_mul(L.batch_norm(x), c))
        gx, = fluid.gradients([loss], [x])
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    left = []
    plain = lowering.run_op

    def spy(ctx, op):
        plain(ctx, op)
        if op.type == "batch_norm_grad":
            left.append(dict(ctx.saved))
    lowering.run_op = spy
    try:
        g_bespoke, = exe.run(main, feed=feed, fetch_list=[gx])
    finally:
        lowering.run_op = plain
    assert left == [{}]
    bespoke = OPS["batch_norm"].custom_grad_lower
    OPS["batch_norm"].custom_grad_lower = None
    try:
        g_generic, = exe.run(main.clone(), feed=feed, fetch_list=[gx])
    finally:
        OPS["batch_norm"].custom_grad_lower = bespoke
    assert_close(g_bespoke, g_generic, 1e-5, "batch_norm_grad vs vjp")


# ------------------------------------------- relu, flatten2, cross_entropy

def test_relu_matches_jax():
    x = _f32(np.random.default_rng(10), 3, 4, 5)
    both("relu", {"X": x}, {}, ["Out"], ["X"])


@pytest.mark.parametrize("axis", [1, 2])
def test_flatten2_matches_jax(axis):
    x = _f32(np.random.default_rng(11), 2, 3, 4, 5)
    out, _ = both("flatten2", {"X": x}, {"axis": axis}, ["Out"], ["X"])
    lead = int(np.prod(x.shape[:axis]))
    assert out["Out"].shape == (lead, x.size // lead)


@pytest.mark.parametrize("label_case", ["plain", "ignored", "soft"])
def test_cross_entropy_matches_jax(label_case):
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((6, 5))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    p[0, :] = [1.0, 0, 0, 0, 0]          # a zero probability: the 1e-20 floor
    p = p.astype(np.float32)
    if label_case == "soft":
        lab = rng.uniform(size=(6, 5)).astype(np.float32)
        attrs = {"soft_label": True}
    else:
        lab = rng.integers(0, 5, (6, 1)).astype(np.int64)
        lab[0, 0] = 3                     # picks the zero probability
        attrs = {"soft_label": False, "ignore_index": -100}
        if label_case == "ignored":
            lab[2, 0] = 4
            attrs["ignore_index"] = 4
    out, _ = both("cross_entropy", {"X": p, "Label": lab}, attrs, ["Y"],
                  ["X"])
    if label_case == "plain":
        assert out["Y"][0, 0] == pytest.approx(-np.log(1e-20), rel=1e-6)
    if label_case == "ignored":
        assert out["Y"][2, 0] == 0.0
