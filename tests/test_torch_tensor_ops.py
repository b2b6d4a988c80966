"""The port's tensor ops (``ops/tensor_ops.py``: the v1 names, the shape,
fill, indexing, sorting and layout ops) against the JAX package's, op by
op on the CPU: one case per op over ``torch_pair.op_pair``, forward
within 1e-5 and grads within 1e-4 of max |ref|, integer outputs exactly
(by value: ``argsort``, ``arg_min``, ``range`` and ``randint`` are int64
in the port where the JAX package, with x64 off, gives int32). The
random ops are checked by their range and moments, ``unique`` and an
``expand_as`` to a non-multiple raise in both packages, and
``feed``/``fetch`` run inside a program."""
import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid

from torch_pair import op_pair, run_op

RNG = np.random.default_rng(0)


def f32(*shape, lo=None, hi=None):
    if lo is not None:
        return RNG.uniform(lo, hi, shape).astype(np.float32)
    return RNG.standard_normal(shape).astype(np.float32)


def i64(*vals):
    return np.asarray(vals, np.int64)


X234 = f32(2, 3, 4)
TIES = np.array([[3, 1, 2, 1, 3], [0, 0, 5, 2, 2], [4, 4, 4, 1, 0]],
                np.float32)

# (id, op, inputs, attrs, outputs, grad slots)
CASES = [
    ("reshape", "reshape", {"X": X234}, {"shape": [0, -1]},
     {"Out": ((2, 12), "float32")}, ["X"]),
    ("transpose", "transpose", {"X": X234}, {"axis": [2, 0, 1]},
     {"Out": ((4, 2, 3), "float32")}, ["X"]),
    ("squeeze", "squeeze", {"X": f32(2, 1, 3)}, {"axes": [1]},
     {"Out": ((2, 3), "float32")}, ["X"]),
    ("unsqueeze", "unsqueeze", {"X": f32(2, 3)}, {"axes": [0, 2]},
     {"Out": ((1, 2, 1, 3), "float32")}, ["X"]),
    ("flatten", "flatten", {"X": X234}, {"axis": 2},
     {"Out": ((6, 4), "float32")}, ["X"]),
    ("flatten_contiguous_range", "flatten_contiguous_range",
     {"X": f32(2, 3, 4, 5)}, {"start_axis": 1, "stop_axis": 2},
     {"Out": ((2, 12, 5), "float32")}, ["X"]),
    ("split_num", "split", {"X": f32(4, 6)}, {"axis": 1, "num": 3},
     {"Out": [((4, 2), "float32")] * 3}, ["X"]),
    ("split_sections", "split", {"X": f32(5, 3)},
     {"axis": 0, "sections": [2, 3]},
     {"Out": [((2, 3), "float32"), ((3, 3), "float32")]}, ["X"]),
    ("shape", "shape", {"Input": f32(2, 3, 5)}, {},
     {"Out": ((3,), "int32")}, []),
    ("fill_constant_batch_size_like", "fill_constant_batch_size_like",
     {"Input": f32(3, 4)},
     {"shape": [-1, 5], "value": 2.5, "dtype": "float32",
      "input_dim_idx": 0, "output_dim_idx": 0},
     {"Out": ((3, 5), "float32")}, []),
    ("fill_zeros_like", "fill_zeros_like", {"X": f32(3, 2)}, {},
     {"Out": ((3, 2), "float32")}, []),
    ("range", "range", {}, {"start": 1, "end": 10, "step": 2,
                            "dtype": "int64"},
     {"Out": ((5,), "int64")}, []),
    ("range_float", "range", {}, {"start": 0.5, "end": 2.0, "step": 0.5,
                                  "dtype": "float32"},
     {"Out": ((3,), "float32")}, []),
    ("one_hot", "one_hot", {"X": i64([1], [0], [4], [7])}, {"depth": 5},
     {"Out": ((4, 5), "float32")}, []),
    ("one_hot_v2", "one_hot_v2", {"X": i64([1], [3])}, {"depth": 4},
     {"Out": ((2, 1, 4), "float32")}, []),
    ("meshgrid", "meshgrid",
     {"X": [("mx", f32(3)), ("my", f32(2))]}, {},
     {"Out": [((3, 2), "float32"), ((3, 2), "float32")]}, ["X"]),
    ("diag_v2_vec", "diag_v2", {"X": f32(4)}, {"offset": 1},
     {"Out": ((5, 5), "float32")}, []),
    ("diag_v2_mat", "diag_v2", {"X": f32(4, 4)}, {"offset": -1},
     {"Out": ((3,), "float32")}, []),
    ("tril", "tril_triu", {"X": f32(4, 5)}, {"diagonal": 1, "lower": True},
     {"Out": ((4, 5), "float32")}, ["X"]),
    ("triu", "tril_triu", {"X": f32(4, 5)},
     {"diagonal": -1, "lower": False},
     {"Out": ((4, 5), "float32")}, ["X"]),
    ("gather_nd", "gather_nd",
     {"X": X234, "Index": i64([1, 2], [0, 0], [1, 2])}, {},
     {"Out": ((3, 4), "float32")}, ["X"]),
    ("scatter_overwrite", "scatter",
     {"X": f32(5, 3), "Ids": i64(4, 0, 2), "Updates": f32(3, 3)},
     {"overwrite": True}, {"Out": ((5, 3), "float32")}, ["X", "Updates"]),
    ("scatter_add", "scatter",
     {"X": f32(5, 3), "Ids": i64(1, 1, 3), "Updates": f32(3, 3)},
     {"overwrite": False}, {"Out": ((5, 3), "float32")},
     ["X", "Updates"]),
    ("index_select", "index_select",
     {"X": f32(4, 3), "Index": i64(3, 0, 3, 1, 2)}, {"dim": 0},
     {"Out": ((5, 3), "float32")}, ["X"]),
    ("argsort", "argsort", {"X": TIES}, {"axis": -1},
     {"Out": ((3, 5), "float32"), "Indices": ((3, 5), "int64")}, []),
    ("argsort_desc", "argsort", {"X": TIES}, {"axis": 0,
                                              "descending": True},
     {"Out": ((3, 5), "float32"), "Indices": ((3, 5), "int64")}, []),
    ("arg_min", "arg_min", {"X": f32(3, 5)}, {"axis": 1},
     {"Out": ((3,), "int64")}, []),
    ("arg_min_keepdims", "arg_min", {"X": f32(3, 5)},
     {"axis": 0, "keepdims": True}, {"Out": ((1, 5), "int64")}, []),
    ("top_k_v2", "top_k_v2", {"X": f32(3, 6)}, {"k": 2, "axis": -1},
     {"Out": ((3, 2), "float32"), "Indices": ((3, 2), "int64")}, []),
    ("top_k_v2_smallest", "top_k_v2", {"X": f32(4, 3)},
     {"k": 2, "axis": 0, "largest": False},
     {"Out": ((2, 3), "float32"), "Indices": ((2, 3), "int64")}, []),
    ("cumsum", "cumsum", {"X": f32(3, 4)}, {"axis": 1},
     {"Out": ((3, 4), "float32")}, ["X"]),
    ("cumsum_rev_excl", "cumsum", {"X": f32(3, 4)},
     {"axis": 0, "reverse": True, "exclusive": True},
     {"Out": ((3, 4), "float32")}, ["X"]),
    ("cumsum_int_flat", "cumsum",
     {"X": np.arange(12, dtype=np.int32).reshape(3, 4)},
     {"flatten": True}, {"Out": ((12,), "int32")}, []),
    ("unstack", "unstack", {"X": f32(3, 2, 4)}, {"axis": 1},
     {"Y": [((3, 4), "float32")] * 2}, ["X"]),
    ("flip", "flip", {"X": X234}, {"axis": [0, 2]},
     {"Out": ((2, 3, 4), "float32")}, ["X"]),
    ("reverse", "reverse", {"X": X234}, {"axis": [1]},
     {"Out": ((2, 3, 4), "float32")}, ["X"]),
    ("roll", "roll", {"X": f32(3, 4)}, {"shifts": [1, -2], "axis": [0, 1]},
     {"Out": ((3, 4), "float32")}, ["X"]),
    ("roll_flat", "roll", {"X": f32(3, 4)}, {"shifts": 5},
     {"Out": ((3, 4), "float32")}, ["X"]),
    ("tile", "tile", {"X": f32(2, 3)}, {"repeat_times": [2, 1, 3]},
     {"Out": ((2, 2, 9), "float32")}, ["X"]),
    ("expand_v2", "expand_v2", {"X": f32(3, 1)}, {"shape": [2, -1, 4]},
     {"Out": ((2, 3, 4), "float32")}, ["X"]),
    ("expand_as", "expand_as",
     {"X": f32(2, 3), "target_tensor": f32(4, 6)}, {},
     {"Out": ((4, 6), "float32")}, ["X"]),
    ("expand_as_v2", "expand_as_v2", {"X": f32(1, 3), "Y": f32(2, 3)},
     {}, {"Out": ((2, 3), "float32")}, ["X"]),
    ("pad", "pad", {"X": f32(2, 3)},
     {"paddings": [1, 0, 2, 1], "pad_value": 0.5},
     {"Out": ((3, 6), "float32")}, ["X"]),
    ("pad2d_constant", "pad2d", {"X": f32(1, 2, 4, 5)},
     {"paddings": [1, 2, 0, 1], "pad_value": -1.0},
     {"Out": ((1, 2, 7, 6), "float32")}, ["X"]),
    ("pad2d_reflect", "pad2d", {"X": f32(1, 2, 4, 5)},
     {"paddings": [1, 2, 2, 1], "mode": "reflect"},
     {"Out": ((1, 2, 7, 8), "float32")}, ["X"]),
    ("pad2d_edge", "pad2d", {"X": f32(1, 2, 4, 5)},
     {"paddings": [0, 1, 3, 1], "mode": "edge"},
     {"Out": ((1, 2, 5, 9), "float32")}, ["X"]),
    ("strided_slice", "strided_slice", {"Input": f32(6, 7)},
     {"axes": [0, 1], "starts": [1, -1], "ends": [5, 0],
      "strides": [2, -2]},
     {"Out": ((2, 3), "float32")}, ["Input"]),
    ("strided_slice_to_start", "strided_slice", {"Input": f32(5, 3)},
     {"axes": [0], "starts": [3], "ends": [-6], "strides": [-1]},
     {"Out": ((4, 3), "float32")}, ["Input"]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tensor_op_matches_jax(case):
    _, op, ins, attrs, outs, grads = case
    op_pair(op, ins, attrs, outs, grad_slots=grads)


def test_refusals_raise_in_both_packages():
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="integer multiples"):
            run_op(pkg, "expand_as_v2", {"X": f32(2, 3), "Y": f32(3, 3)},
                   {}, {"Out": ((3, 3), "float32")})
        with pytest.raises(NotImplementedError, match="unique"):
            run_op(pkg, "unique", {"X": i64(1, 2, 2)}, {},
                   {"Out": ((3,), "int64")})
        fluid = jfluid if pkg == "jax" else tfluid
        with pytest.raises(NotImplementedError, match="unique"):
            fluid.layers.unique(None)


@pytest.mark.parametrize("op,attrs,check", [
    ("randint", {"low": -3, "high": 5, "dtype": "int64"},
     lambda v: v.min() >= -3 and v.max() < 5 and len(np.unique(v)) == 8),
    ("uniform_random_batch_size_like", {"min": 2.0, "max": 3.0},
     lambda v: v.min() >= 2.0 and v.max() < 3.0
     and abs(v.mean() - 2.5) < 0.05),
    ("gaussian_random_batch_size_like", {"mean": 1.0, "std": 2.0},
     lambda v: abs(v.mean() - 1.0) < 0.15 and abs(v.std() - 2.0) < 0.15),
])
def test_random_ops_shape_and_moments(op, attrs, check):
    """The random ops draw from the op's seeded generator (threefry
    cannot be matched): both packages give the declared shape, values in
    range with the right moments, and the port the same draw for the
    same seed."""
    ins = {} if op == "randint" else {"Input": f32(40, 3)}
    attrs = dict(attrs, shape=[40, 50] if op == "randint" else [-1, 50],
                 seed=11)
    outs = {"Out": ((40, 50), "int64" if op == "randint" else "float32")}
    first = None
    for pkg in ("jax", "port", "port"):
        v = run_op(pkg, op, ins, attrs, outs)[0]["Out"]
        assert v.shape == (40, 50) and check(v), pkg
        if pkg == "port":
            if first is not None:
                np.testing.assert_array_equal(v, first)
            first = v


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_feed_and_fetch_ops_in_a_program(pkg):
    """A loaded program's ``feed`` op binds nothing (the executor binds
    the feed) and its ``fetch`` op passes its input on."""
    fluid = jfluid if pkg == "jax" else tfluid
    main, startup = fluid.Program(), fluid.Program()
    x = f32(2, 3)
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data("x", [2, 3], "float32")
        block = main.global_block()
        feed_holder = block.create_var(name="feed", shape=None,
                                       dtype="float32")
        block.append_op(type="feed", inputs={"X": [feed_holder]},
                        outputs={"Out": [xv]}, attrs={"col": 0},
                        infer_shape=False)
        y = fluid.layers.scale(xv, 2.0)
        out = block.create_var(name="fetched", shape=(2, 3),
                               dtype="float32")
        block.append_op(type="fetch", inputs={"X": [y]},
                        outputs={"Out": [out]}, attrs={"col": 0},
                        infer_shape=False)
    exe = fluid.Executor() if pkg == "jax" else fluid.Executor(
        fluid.CPUPlace())
    got, = exe.run(main, feed={"x": x, "feed": np.zeros(1, np.float32)},
                   fetch_list=[out])
    np.testing.assert_allclose(np.asarray(got), 2 * x, rtol=1e-6)
