"""The port's math ops (``ops/math_ops.py``: the reductions, the integer
elementwise ops, the logical and float tests, the products and the
linear algebra) against the JAX package's, op by op on the CPU over
``torch_pair.op_pair``: forward within 1e-5 and grads within 1e-4 of max
|ref|, bool and integer outputs exactly. ``reduce_prod`` takes a row
with a zero, ``norm`` a zero row, and ``cholesky`` and ``inverse`` a
well-conditioned SPD matrix."""
import numpy as np
import pytest

from torch_pair import op_pair

RNG = np.random.default_rng(2)


def f32(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def spd(n):
    a = RNG.standard_normal((n, n)).astype(np.float32)
    return (a @ a.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


WITH_ZERO = f32(3, 4)
WITH_ZERO[1, 2] = 0.0
ZERO_ROW = f32(3, 4)
ZERO_ROW[2] = 0.0
BOOLS = RNG.random((3, 4)) < 0.5
BOOLS2 = RNG.random((3, 4)) < 0.5
SPECIAL = np.array([[1.0, np.inf, -np.inf], [np.nan, 0.0, -2.0]],
                   np.float32)
INTS = RNG.integers(-9, 10, (3, 4)).astype(np.int32)
DIVS = np.where(RNG.random((3, 4)) < 0.5, 3, -4).astype(np.int32)

CASES = [
    ("reduce_prod_axis", "reduce_prod", {"X": WITH_ZERO}, {"dim": [1]},
     {"Out": ((3,), "float32")}, ["X"]),
    ("reduce_prod_all_keep", "reduce_prod", {"X": f32(2, 3)},
     {"reduce_all": True, "keep_dim": True},
     {"Out": ((1, 1), "float32")}, ["X"]),
    ("reduce_prod_two_axes", "reduce_prod", {"X": f32(2, 3, 2)},
     {"dim": [0, 2]}, {"Out": ((3,), "float32")}, ["X"]),
    ("reduce_all", "reduce_all", {"X": BOOLS}, {"dim": [1]},
     {"Out": ((3,), "bool")}, []),
    ("reduce_any_all", "reduce_any", {"X": BOOLS},
     {"reduce_all": True}, {"Out": ((), "bool")}, []),
    ("logsumexp", "logsumexp", {"X": f32(3, 4)},
     {"dim": [1], "keep_dim": True}, {"Out": ((3, 1), "float32")}, ["X"]),
    ("logsumexp_axis", "logsumexp", {"X": f32(3, 4)}, {"axis": [0]},
     {"Out": ((4,), "float32")}, ["X"]),
    ("elementwise_floordiv", "elementwise_floordiv",
     {"X": INTS, "Y": DIVS}, {}, {"Out": ((3, 4), "int32")}, []),
    ("elementwise_mod_int", "elementwise_mod", {"X": INTS, "Y": DIVS}, {},
     {"Out": ((3, 4), "int32")}, []),
    ("elementwise_mod_float", "elementwise_mod",
     {"X": f32(3, 4) * 5, "Y": np.float32([1.5, -2.0, 2.5, -0.7])}, {},
     {"Out": ((3, 4), "float32")}, []),
    ("logical_xor", "logical_xor", {"X": BOOLS, "Y": BOOLS2}, {},
     {"Out": ((3, 4), "bool")}, []),
    ("maximum", "maximum", {"X": f32(3, 4), "Y": f32(3, 4)}, {},
     {"Out": ((3, 4), "float32")}, ["X", "Y"]),
    ("minimum", "minimum", {"X": f32(3, 4), "Y": f32(3, 4)}, {},
     {"Out": ((3, 4), "float32")}, ["X", "Y"]),
    ("isfinite_v2", "isfinite_v2", {"X": SPECIAL}, {},
     {"Out": ((2, 3), "bool")}, []),
    ("isinf_v2", "isinf_v2", {"X": SPECIAL}, {},
     {"Out": ((2, 3), "bool")}, []),
    ("isnan_v2", "isnan_v2", {"X": SPECIAL}, {},
     {"Out": ((2, 3), "bool")}, []),
    ("matmul_v2", "matmul_v2", {"X": f32(2, 4, 3), "Y": f32(2, 5, 4)},
     {"trans_x": True, "trans_y": True},
     {"Out": ((2, 3, 5), "float32")}, ["X", "Y"]),
    ("bmm", "bmm", {"X": f32(2, 3, 4), "Y": f32(2, 4, 5)}, {},
     {"Out": ((2, 3, 5), "float32")}, ["X", "Y"]),
    ("dot", "dot", {"X": f32(3, 4), "Y": f32(3, 4)}, {},
     {"Out": ((3,), "float32")}, ["X", "Y"]),
    ("dot_vec", "dot", {"X": f32(4), "Y": f32(4)}, {},
     {"Out": ((1,), "float32")}, ["X", "Y"]),
    ("addmm", "addmm", {"Input": f32(3, 5), "X": f32(3, 4),
                        "Y": f32(4, 5)}, {"Alpha": 0.5, "Beta": 2.0},
     {"Out": ((3, 5), "float32")}, ["Input", "X", "Y"]),
    ("kron", "kron", {"X": f32(2, 3), "Y": f32(3, 2)}, {},
     {"Out": ((6, 6), "float32")}, ["X", "Y"]),
    ("trace", "trace", {"Input": f32(4, 5)}, {"offset": 1},
     {"Out": ((), "float32")}, ["Input"]),
    ("trace_axes", "trace", {"Input": f32(2, 3, 3)},
     {"axis1": 1, "axis2": 2}, {"Out": ((2,), "float32")}, ["Input"]),
    ("norm", "norm", {"X": ZERO_ROW}, {"axis": 1, "epsilon": 1e-6},
     {"Out": ((3, 4), "float32"), "Norm": ((3, 1), "float32")}, ["X"]),
    ("p_norm", "p_norm", {"X": f32(3, 4)},
     {"porder": 3.0, "axis": 1, "keepdim": True},
     {"Out": ((3, 1), "float32")}, ["X"]),
    ("inverse", "inverse", {"Input": spd(4)}, {},
     {"Output": ((4, 4), "float32")}, ["Input"]),
    ("cholesky", "cholesky", {"X": spd(4)}, {},
     {"Out": ((4, 4), "float32")}, ["X"]),
    ("cholesky_upper", "cholesky", {"X": spd(3)}, {"upper": True},
     {"Out": ((3, 3), "float32")}, ["X"]),
    ("matrix_power", "matrix_power", {"X": f32(3, 3) * 0.5}, {"n": 3},
     {"Out": ((3, 3), "float32")}, ["X"]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_math_op_matches_jax(case):
    _, op, ins, attrs, outs, grads = case
    op_pair(op, ins, attrs, outs, grad_slots=grads)
