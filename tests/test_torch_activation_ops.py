"""The port's activation ops (``ops/activation_ops.py``) against the JAX
package's, op by op on the CPU over ``torch_pair.op_pair``: forward
within 1e-5 and grads within 1e-4 of max |ref|, once at the JAX op's
default attributes and once at a non-default value of each attribute
(they are not ``torch.nn.functional``'s defaults: ``leaky_relu``'s alpha
0.02, ``brelu``'s [0, 24], ...). ``selu`` takes no attribute in either
package, so a non-default scale changes nothing in both."""
import numpy as np
import pytest

from torch_pair import op_pair

RNG = np.random.default_rng(1)
WIDE = (RNG.standard_normal((4, 5)) * 3).astype(np.float32)
POS = RNG.uniform(0.5, 2.0, (4, 5)).astype(np.float32)
UNIT = RNG.uniform(-0.9, 0.9, (4, 5)).astype(np.float32)
# round's inputs stay off the .5 boundaries
ROUNDABLE = (np.round(WIDE) + RNG.uniform(-0.4, 0.4, (4, 5))).astype(
    np.float32)

# (op, input, attrs, has grad)
CASES = [
    ("log2", POS, {}, True), ("log10", POS, {}, True),
    ("log1p", POS, {}, True), ("expm1", UNIT, {}, True),
    ("reciprocal", POS, {}, True), ("round", ROUNDABLE, {}, False),
    ("sin", WIDE, {}, True), ("tan", UNIT, {}, True),
    ("asin", UNIT, {}, True), ("acos", UNIT, {}, True),
    ("atan", WIDE, {}, True), ("sinh", UNIT, {}, True),
    ("cosh", UNIT, {}, True), ("erf", WIDE, {}, True),
    ("softplus", WIDE, {}, True), ("softsign", WIDE, {}, True),
    ("logsigmoid", WIDE, {}, True), ("tanh_shrink", WIDE, {}, True),
    ("silu", WIDE, {}, True), ("mish", WIDE, {}, True),
    ("softshrink", WIDE, {}, True),
    ("softshrink", WIDE, {"lambda": 0.3}, True),
    ("hard_shrink", WIDE, {}, True),
    ("hard_shrink", WIDE, {"threshold": 1.2}, True),
    ("relu6", WIDE, {}, True), ("relu6", WIDE, {"threshold": 4.0}, True),
    ("leaky_relu", WIDE, {}, True),
    ("leaky_relu", WIDE, {"alpha": 0.1}, True),
    ("elu", WIDE, {}, True), ("elu", WIDE, {"alpha": 0.5}, True),
    ("selu", WIDE, {}, True),
    ("selu", WIDE, {"scale": 2.0, "alpha": 1.0}, True),
    ("swish", WIDE, {}, True), ("swish", WIDE, {"beta": 1.7}, True),
    ("hard_sigmoid", WIDE, {}, True),
    ("hard_sigmoid", WIDE, {"slope": 0.3, "offset": 0.4}, True),
    ("hard_swish", WIDE, {}, True),
    ("hard_swish", WIDE, {"threshold": 5.0, "scale": 5.0,
                          "offset": 2.0}, True),
    ("brelu", WIDE * 10, {}, True),
    ("brelu", WIDE, {"t_min": -1.0, "t_max": 1.0}, True),
    ("stanh", WIDE, {}, True),
    ("stanh", WIDE, {"scale_a": 0.5, "scale_b": 2.0}, True),
    ("thresholded_relu", WIDE, {}, True),
    ("thresholded_relu", WIDE, {"threshold": 0.4}, True),
    ("gelu", WIDE, {}, True), ("gelu", WIDE, {"approximate": True}, True),
]


def _id(c):
    return c[0] + "".join(f"-{k}" for k in c[2])


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_activation_matches_jax(case):
    op, x, attrs, grad = case
    op_pair(op, {"X": x}, attrs, {"Out": (x.shape, "float32")},
            grad_slots=["X"] if grad else [])


@pytest.mark.parametrize("axis,shape,out", [
    (1, (2, 6, 3, 3), (2, 3, 3, 3)), (-1, (2, 3, 3, 4), (2, 3, 3, 2))])
def test_maxout_matches_jax(axis, shape, out):
    x = RNG.standard_normal(shape).astype(np.float32)
    op_pair("maxout", {"X": x}, {"groups": 2, "axis": axis},
            {"Out": (out, "float32")}, grad_slots=["X"])
