"""The port's loss ops and the other nn ops the core layers reach
(``ops/nn_ops.py``: the eight losses, ``label_smooth``,
``pixel_shuffle``, the nearest and bilinear resizes, ``embedding``,
``unfold``, ``space_to_depth``) and the metric ops ``auc`` and
``precision_recall`` (``ops/metric_ops.py``) against the JAX package's,
op by op on the CPU over ``torch_pair.op_pair``: forward within 1e-5 and
grads within 1e-4 of max |ref|."""
import numpy as np
import pytest

from torch_pair import FWD_TOL, assert_close, op_pair, run_op

RNG = np.random.default_rng(3)


def f32(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def prob(*shape):
    return RNG.uniform(0.05, 0.95, shape).astype(np.float32)


LOGP = np.log(prob(4, 5) / prob(4, 5).sum(-1, keepdims=True)).astype(
    np.float32)
LABEL = np.array([0, 3, 4, 1], np.int64)
IMG = f32(2, 8, 4, 6)

CASES = [
    ("mse_loss", "mse_loss", {"Input": f32(4, 3), "Label": f32(4, 3)}, {},
     {"Out": ((4, 3), "float32")}, ["Input"]),
    ("huber_loss", "huber_loss", {"X": f32(4, 3) * 2, "Y": f32(4, 3)},
     {"delta": 0.5},
     {"Out": ((4, 3), "float32"), "Residual": ((4, 3), "float32")}, ["X"]),
    ("smooth_l1_loss", "smooth_l1_loss", {"X": f32(4, 3), "Y": f32(4, 3)},
     {"sigma": 2.0},
     {"Out": ((4, 1), "float32"), "Diff": ((4, 3), "float32")}, ["X"]),
    ("log_loss", "log_loss",
     {"Predicted": prob(4, 1), "Labels": (RNG.random((4, 1)) < 0.5)
      .astype(np.float32)}, {"epsilon": 1e-3},
     {"Loss": ((4, 1), "float32")}, ["Predicted"]),
    ("bce_loss", "bce_loss",
     {"X": prob(4, 3), "Label": (RNG.random((4, 3)) < 0.5)
      .astype(np.float32)}, {}, {"Out": ((4, 3), "float32")}, ["X"]),
    ("kldiv_loss_mean", "kldiv_loss", {"X": LOGP, "Target": prob(4, 5)},
     {}, {"Loss": ((), "float32")}, ["X"]),
    ("kldiv_loss_batchmean", "kldiv_loss",
     {"X": LOGP, "Target": prob(4, 5)}, {"reduction": "batchmean"},
     {"Loss": ((), "float32")}, ["X"]),
    ("kldiv_loss_none", "kldiv_loss", {"X": LOGP, "Target": prob(4, 5)},
     {"reduction": "none"}, {"Loss": ((4, 5), "float32")}, ["X"]),
    ("nll_loss_mean", "nll_loss", {"X": LOGP, "Label": LABEL}, {},
     {"Out": ((), "float32")}, ["X"]),
    ("nll_loss_none", "nll_loss", {"X": LOGP, "Label": LABEL},
     {"reduction": "none"}, {"Out": ((4,), "float32")}, ["X"]),
    ("margin_rank_loss", "margin_rank_loss",
     {"X1": f32(4, 1), "X2": f32(4, 1),
      "Label": np.float32([[1], [-1], [1], [-1]])}, {"margin": 0.1},
     {"Out": ((4, 1), "float32"), "Activated": ((4, 1), "float32")},
     ["X1", "X2"]),
    ("label_smooth", "label_smooth", {"X": prob(4, 5)}, {"epsilon": 0.2},
     {"Out": ((4, 5), "float32")}, ["X"]),
    ("label_smooth_prior", "label_smooth",
     {"X": prob(4, 5), "PriorDist": prob(1, 5)}, {},
     {"Out": ((4, 5), "float32")}, ["X"]),
    ("pixel_shuffle", "pixel_shuffle", {"X": IMG},
     {"upscale_factor": 2}, {"Out": ((2, 2, 8, 12), "float32")}, ["X"]),
    ("nearest_interp_up", "nearest_interp", {"X": IMG},
     {"out_h": 7, "out_w": 9}, {"Out": ((2, 8, 7, 9), "float32")}, ["X"]),
    ("interp_nearest_down", "interp_nearest", {"X": IMG},
     {"out_h": 3, "out_w": 4}, {"Out": ((2, 8, 3, 4), "float32")}, ["X"]),
    ("bilinear_interp_up", "bilinear_interp", {"X": IMG},
     {"out_h": 9, "out_w": 11}, {"Out": ((2, 8, 9, 11), "float32")},
     ["X"]),
    ("bilinear_interp_down", "bilinear_interp", {"X": IMG},
     {"out_h": 3, "out_w": 4}, {"Out": ((2, 8, 3, 4), "float32")}, ["X"]),
    ("embedding", "embedding",
     {"W": f32(10, 4), "Ids": np.array([[1, 3], [3, 9]], np.int64)},
     {"padding_idx": 9}, {"Out": ((2, 2, 4), "float32")}, ["W"]),
    ("unfold", "unfold", {"X": f32(2, 3, 5, 6)},
     {"kernel_sizes": [2, 3], "strides": [1, 2], "paddings": [1, 1],
      "dilations": [1, 1]}, {"Y": ((2, 18, 18), "float32")}, ["X"]),
    ("unfold_asym_pad", "unfold", {"X": f32(1, 2, 4, 4)},
     {"kernel_sizes": [2, 2], "strides": [2, 2],
      "paddings": [0, 1, 2, 1], "dilations": [1, 1]},
     {"Y": ((1, 8, 9), "float32")}, ["X"]),
    ("space_to_depth", "space_to_depth", {"X": f32(2, 3, 4, 6)},
     {"blocksize": 2}, {"Out": ((2, 12, 2, 3), "float32")}, ["X"]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_nn_op_matches_jax(case):
    _, op, ins, attrs, outs, grads = case
    op_pair(op, ins, attrs, outs, grad_slots=grads)


def test_auc_matches_jax():
    """Two streaming updates of the histogram state: the AUC and the
    state agree (the JAX op's int64 state is int32 with x64 off)."""
    n = 15
    pred = prob(32, 2)
    label = (RNG.random((32, 1)) < 0.4).astype(np.int64)
    pos = RNG.integers(0, 4, n + 1).astype(np.int64)
    neg = RNG.integers(0, 4, n + 1).astype(np.int64)
    outs = {"AUC": ((1,), "float32"), "StatPosOut": ((n + 1,), "int64"),
            "StatNegOut": ((n + 1,), "int64")}
    ins = {"Predict": pred, "Label": label, "StatPos": pos,
           "StatNeg": neg}
    op_pair("auc", ins, {"num_thresholds": n}, outs)


@pytest.mark.parametrize("weights,states", [(False, False), (True, True)])
def test_precision_recall_matches_jax(weights, states):
    C = 4
    ins = {"Indices": RNG.integers(0, C, (20, 1)).astype(np.int32),
           "Labels": RNG.integers(0, C, (20, 1)).astype(np.int32)}
    if weights:
        ins["Weights"] = prob(20, 1)
    if states:
        ins["StatesInfo"] = RNG.integers(0, 5, (C, 4)).astype(np.float32)
    outs = {"BatchMetrics": ((6,), "float32"),
            "AccumMetrics": ((6,), "float32"),
            "AccumStatesInfo": ((C, 4), "float32")}
    op_pair("precision_recall", ins, {"class_number": C}, outs)


def test_kldiv_sum_and_nll_sum_match_jax():
    for op, ins, attrs, slot in (
            ("kldiv_loss", {"X": LOGP, "Target": prob(4, 5)},
             {"reduction": "sum"}, "Loss"),
            ("nll_loss", {"X": LOGP, "Label": LABEL}, {"reduction": "sum"},
             "Out")):
        j, _ = run_op("jax", op, ins, attrs, {slot: ((), "float32")})
        t, _ = run_op("port", op, ins, attrs, {slot: ((), "float32")})
        assert_close(t[slot], j[slot], FWD_TOL, op)
