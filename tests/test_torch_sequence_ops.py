"""The port's masked-dense sequence ops against the JAX package's, on the
CPU: the cases of ``tests/test_ops_sequence.py`` at its shapes (B4 T6
D3, lengths [6, 3, 1, 4]). Each op runs alone in a program of both
packages on the same seeded inputs (``tests/torch_pair.py``): outputs
within 1e-5 of max |ref| (integer outputs exactly), the input grads of
sum(out * cot) for a seeded cotangent within 1e-4; each case also holds
the port to the JAX test's numpy reference."""
import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid

from torch_pair import assert_pair, op_pair, run_pair

RNG = np.random.default_rng(7)
B, T, D = 4, 6, 3
LENGTHS = np.array([6, 3, 1, 4], np.int32)


def _mask():
    return np.arange(T)[None, :] < LENGTHS[:, None]


def _x(shape=(B, T, D)):
    return RNG.standard_normal(shape).astype(np.float32)


def _pool_ref(x, pooltype):
    out = np.zeros((B,) + x.shape[2:], np.float32)
    for b in range(B):
        seg = x[b, :LENGTHS[b]]
        out[b] = {"SUM": lambda: seg.sum(0), "MEAN": lambda: seg.mean(0),
                  "SQRT": lambda: seg.sum(0) / np.sqrt(len(seg)),
                  "MAX": lambda: seg.max(0), "MIN": lambda: seg.min(0),
                  "FIRST": lambda: seg[0], "LAST": lambda: seg[-1]}[
                      pooltype]()
    return out


def _check(got, ref, atol=1e-5):
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


X_POOL = _x()


@pytest.mark.parametrize("pooltype", ["SUM", "MEAN", "SQRT", "MAX", "MIN",
                                      "FIRST", "LAST"])
def test_sequence_pool_all_types(pooltype):
    ref = _pool_ref(X_POOL, pooltype)
    to, _ = op_pair("sequence_pool", {"X": X_POOL, "Length": LENGTHS},
                    {"pooltype": pooltype}, {"Out": (ref.shape, "float32")})
    _check(to["Out"], ref)


@pytest.mark.parametrize("pooltype", ["SUM", "MEAN", "SQRT", "MAX", "LAST"])
def test_sequence_pool_grads(pooltype):
    ref = _pool_ref(X_POOL, pooltype)
    to, tg = op_pair("sequence_pool", {"X": X_POOL, "Length": LENGTHS},
                     {"pooltype": pooltype}, {"Out": (ref.shape, "float32")},
                     grad_slots=("X",))
    assert np.all(tg["X"][~_mask()] == 0.0)


def test_sequence_softmax():
    x = _x((B, T))
    z = np.where(_mask(), x, -1e30)
    e = np.exp(z - z.max(1, keepdims=True))
    ref = np.where(_mask(), e / e.sum(1, keepdims=True), 0)
    to, _ = op_pair("sequence_softmax", {"X": x, "Length": LENGTHS}, {},
                    {"Out": ((B, T), "float32")}, grad_slots=("X",))
    _check(to["Out"], ref)


def test_sequence_reverse():
    x = _x()
    ref = x.copy()
    for b in range(B):
        ref[b, :LENGTHS[b]] = x[b, :LENGTHS[b]][::-1]
    to, _ = op_pair("sequence_reverse", {"X": x, "Length": LENGTHS}, {},
                    {"Out": ((B, T, D), "float32")}, grad_slots=("X",))
    _check(to["Out"], ref)


def test_sequence_expand_as():
    x = _x((B, D))
    ref = np.zeros((B, T, D), np.float32)
    for b in range(B):
        ref[b, :LENGTHS[b]] = x[b]
    to, _ = op_pair("sequence_expand_as", {"X": x, "Length": LENGTHS},
                    {"maxlen": T}, {"Out": ((B, T, D), "float32")},
                    grad_slots=("X",))
    _check(to["Out"], ref)


def test_sequence_mask():
    to, _ = op_pair("sequence_mask", {"X": LENGTHS},
                    {"maxlen": T, "out_dtype": "int64"},
                    {"Out": ((B, T), "int64")})
    np.testing.assert_array_equal(to["Out"], _mask().astype(np.int64))


def test_sequence_pad_unpad_roundtrip():
    total = int(LENGTHS.sum())
    packed = RNG.standard_normal((total, D)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(LENGTHS)[:-1]])
    padded = np.zeros((B, T, D), np.float32)
    for b in range(B):
        padded[b, :LENGTHS[b]] = packed[offsets[b]:offsets[b] + LENGTHS[b]]
    to, _ = op_pair("sequence_pad", {"X": packed, "Length": LENGTHS},
                    {"padded_length": T, "pad_value": 0.0},
                    {"Out": ((B, T, D), "float32")}, grad_slots=("X",))
    _check(to["Out"], padded)
    unpacked = np.zeros((B * T, D), np.float32)
    unpacked[:total] = packed
    to, _ = op_pair("sequence_unpad", {"X": padded, "Length": LENGTHS}, {},
                    {"Out": ((B * T, D), "float32")}, grad_slots=("X",))
    _check(to["Out"], unpacked)


def test_sequence_concat():
    l1, l2, T2 = LENGTHS, np.array([2, 4, 3, 1], np.int32), 5
    x1 = np.where(_mask()[..., None], _x(), 0).astype(np.float32)
    m2 = np.arange(T2)[None, :] < l2[:, None]
    x2 = np.where(m2[..., None], _x((B, T2, D)), 0).astype(np.float32)
    ref = np.zeros((B, T + T2, D), np.float32)
    for b in range(B):
        ref[b, :l1[b]] = x1[b, :l1[b]]
        ref[b, l1[b]:l1[b] + l2[b]] = x2[b, :l2[b]]
    to, _ = op_pair("sequence_concat",
                    {"X": [("x1", x1), ("x2", x2)],
                     "Length": [("len1", l1), ("len2", l2)]}, {},
                    {"Out": ((B, T + T2, D), "float32"),
                     "OutLength": ((B,), "int32")}, grad_slots=("X",))
    _check(to["Out"], ref)
    np.testing.assert_array_equal(to["OutLength"], l1 + l2)


def test_sequence_slice():
    x = _x()
    offset = np.array([1, 0, 0, 2], np.int32)
    length = np.array([3, 2, 1, 2], np.int32)
    ref = np.zeros_like(x)
    for b in range(B):
        ref[b, :length[b]] = x[b, offset[b]:offset[b] + length[b]]
    to, _ = op_pair("sequence_slice",
                    {"X": x, "Offset": offset, "SliceLength": length,
                     "Length": LENGTHS}, {},
                    {"Out": ((B, T, D), "float32"),
                     "OutLength": ((B,), "int32")}, grad_slots=("X",))
    _check(to["Out"], ref)
    np.testing.assert_array_equal(to["OutLength"], length)


def test_sequence_erase():
    x = np.array([[2, 1, 2, 3, 0, 0], [5, 2, 2, 0, 0, 0]], np.int64)
    to, _ = op_pair("sequence_erase",
                    {"X": x, "Length": np.array([4, 3], np.int32)},
                    {"tokens": [2]},
                    {"Out": ((2, 6), "int64"), "OutLength": ((2,), "int32")})
    np.testing.assert_array_equal(to["Out"], [[1, 3, 0, 0, 0, 0],
                                              [5, 0, 0, 0, 0, 0]])
    np.testing.assert_array_equal(to["OutLength"], [2, 1])


def test_sequence_enumerate():
    x = np.array([[1, 2, 3, 4, 0, 0]], np.int64)
    to, _ = op_pair("sequence_enumerate",
                    {"X": x, "Length": np.array([4], np.int32)},
                    {"win_size": 2, "pad_value": 0},
                    {"Out": ((1, 6, 2), "int64")})
    np.testing.assert_array_equal(
        to["Out"], [[[1, 2], [2, 3], [3, 4], [4, 0], [0, 0], [0, 0]]])


def test_sequence_reshape():
    lengths = np.array([4, 2], np.int32)
    x = np.where((np.arange(4)[None, :] < lengths[:, None])[..., None],
                 _x((2, 4, 6)), 0).astype(np.float32)
    to, _ = op_pair("sequence_reshape", {"X": x, "Length": lengths},
                    {"new_dim": 3},
                    {"Out": ((2, 8, 3), "float32"),
                     "OutLength": ((2,), "int32")}, grad_slots=("X",))
    _check(to["Out"], x.reshape(2, 8, 3))
    np.testing.assert_array_equal(to["OutLength"], lengths * 2)


def test_sequence_conv():
    x = np.where(_mask()[..., None], _x(), 0).astype(np.float32)
    ctx_len, M, start = 3, 5, -1
    filt = RNG.standard_normal((ctx_len * D, M)).astype(np.float32) * 0.3
    unfolded = np.zeros((B, T, ctx_len * D), np.float32)
    for k in range(ctx_len):
        for t_ in range(T):
            src = t_ + start + k
            if 0 <= src < T:
                unfolded[:, t_, k * D:(k + 1) * D] = x[:, src]
    ref = (unfolded @ filt) * _mask()[..., None]
    to, _ = op_pair("sequence_conv",
                    {"X": x, "Filter": filt, "Length": LENGTHS},
                    {"contextStart": start, "contextLength": ctx_len},
                    {"Out": ((B, T, M), "float32")},
                    grad_slots=("X", "Filter"))
    _check(to["Out"], ref, atol=1e-4)


def test_sequence_layers_api():
    """The layer wrappers build and run end to end in both packages, on
    the JAX startup's filter."""
    xv = _x()

    def build(fluid):
        L = fluid.layers
        x = L.data("x", [B, T, D], dtype="float32")
        ln = L.data("len", [B], dtype="int32")
        return [L.sequence_pool(x, "mean", length=ln),
                L.sequence_reverse(x, length=ln),
                L.sequence_softmax(L.reduce_sum(x, dim=-1), length=ln),
                L.sequence_conv(x, 8, filter_size=3, length=ln)]

    out, _, _ = run_pair(build, {"x": xv, "len": LENGTHS})
    assert_pair(out)
    p, r, s, c = out["port"][0]
    assert p.shape == (B, D) and r.shape == (B, T, D)
    assert s.shape == (B, T) and c.shape == (B, T, 8)
    np.testing.assert_allclose(s.sum(1), np.ones(B), rtol=1e-5)


def test_sequence_topk_avg_pooling():
    """The text-matching pooling (no case in the JAX tests): top-k column
    averages at k 1 and 3 over seeded match matrices with ragged row and
    column counts, positions exact."""
    x = _x((2, 2, 3, 5))
    to, _ = op_pair("sequence_topk_avg_pooling",
                    {"X": x, "ROW": np.array([3, 2], np.int32),
                     "COLUMN": np.array([5, 2], np.int32)},
                    {"topks": [1, 3]},
                    {"Out": ((2, 3, 4), "float32"),
                     "pos": ((2, 3, 2, 3), "int32")})
    assert np.all(to["pos"][1, :, :, 2] == -1)


def test_lod_containers_match_jax():
    data = np.arange(12, dtype=np.int64).reshape(6, 2)
    for fluid in (jfluid, tfluid):
        t = fluid.create_lod_tensor(data, [[2, 4]], None)
        assert t.recursive_sequence_lengths() == [[2, 4]]
        assert np.array_equal(np.asarray(t), data)
        with pytest.raises(ValueError):
            fluid.create_lod_tensor(data, [[2, 3]], None)
        nested = fluid.create_lod_tensor([[1, 2], [3]], [[2, 1]], None)
        assert np.asarray(nested).shape == (3, 1)
        with pytest.raises(ValueError):
            fluid.create_lod_tensor([[1, 2], [3]], [[1, 2]], None)
        r = fluid.create_random_int_lodtensor([[3, 1]], [2], None, 0, 5)
        assert np.asarray(r).shape == (4, 2)
