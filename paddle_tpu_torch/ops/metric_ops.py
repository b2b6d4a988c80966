"""Metric ops in torch (counterpart of ``paddle_tpu/ops/metric_ops.py``:
``accuracy :10``, ``precision_recall :26`` and ``auc :64``). ``auc``
threads its histogram state through its outputs, as the JAX op does;
its value is float32 (the JAX op's, whose int64 state is int32 with x64
off)."""
import torch

from ..framework.registry import register_op
from .common import x_of


@register_op("accuracy", grad=False)
def accuracy(ctx, ins, attrs):
    """Share of rows whose label is among their top-k ``Indices``;
    ``Correct`` and ``Total`` int32, each output of shape [1]."""
    indices, label = x_of(ins, "Indices"), x_of(ins, "Label")
    if label.dim() == 2 and label.shape[1] == 1:
        label = label[:, 0]
    hit = (indices == label[:, None]).any(dim=1)
    correct = hit.sum(dtype=torch.int32)
    total = torch.full((), label.shape[0], dtype=torch.int32,
                       device=label.device)
    acc = correct.float() / total.float()
    return {"Accuracy": acc.reshape(1), "Correct": correct.reshape(1),
            "Total": total.reshape(1)}


@register_op("precision_recall", grad=False)
def precision_recall(ctx, ins, attrs):
    """Per-class TP/FP/TN/FN of the batch (``[C, 4]``, weighted),
    accumulated onto ``StatesInfo``, and the macro/micro precision,
    recall and F1 of both (6 values each)."""
    idx = x_of(ins, "Indices").reshape(-1).long()
    label = x_of(ins, "Labels").reshape(-1).long()
    weights, states = x_of(ins, "Weights"), x_of(ins, "StatesInfo")
    C = int(attrs["class_number"])
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device) \
        if weights is None else weights.reshape(-1).float()
    classes = torch.arange(C, device=idx.device)
    oh_p = (idx[:, None] == classes).float()
    oh_l = (label[:, None] == classes).float()
    w = w[:, None]
    batch = torch.stack([(w * oh_p * oh_l).sum(0),
                         (w * oh_p * (1 - oh_l)).sum(0),
                         (w * (1 - oh_p) * (1 - oh_l)).sum(0),
                         (w * (1 - oh_p) * oh_l).sum(0)], dim=1)
    accum = batch if states is None else batch + states

    def ratio(a, b):
        return torch.where(b > 0, a / b.clamp_min(1e-12),
                           torch.zeros_like(a))

    def metrics(st):
        tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]
        p, r = ratio(tp, tp + fp), ratio(tp, tp + fn)
        f1 = ratio(2 * p * r, p + r)
        stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
        mp, mr = ratio(stp, stp + sfp), ratio(stp, stp + sfn)
        mf = ratio(2 * mp * mr, mp + mr)
        return torch.stack([p.mean(), r.mean(), f1.mean(), mp, mr, mf])

    return {"BatchMetrics": metrics(batch), "AccumMetrics": metrics(accum),
            "AccumStatesInfo": accum}


@register_op("auc", grad=False)
def auc(ctx, ins, attrs):
    """Streaming ROC AUC: the batch's positive and negative counts per
    threshold bucket added to ``StatPos``/``StatNeg``, and the
    trapezoid area under the accumulated curve."""
    predict, label = x_of(ins, "Predict"), x_of(ins, "Label")
    stat_pos, stat_neg = x_of(ins, "StatPos"), x_of(ins, "StatNeg")
    n = attrs.get("num_thresholds", 4095)
    if label.dim() == 2:
        label = label[:, 0]
    pos_prob = predict[:, -1] if predict.dim() == 2 else predict
    bins = (pos_prob * n).to(torch.int32).clamp(0, n).long()
    is_pos = (label > 0).to(stat_pos.dtype)
    new_pos = stat_pos + torch.zeros_like(stat_pos).index_put(
        (bins,), is_pos, accumulate=True)
    new_neg = stat_neg + torch.zeros_like(stat_neg).index_put(
        (bins,), 1 - is_pos, accumulate=True)
    tp = new_pos.flip(0).cumsum(0).double()
    fp = new_neg.flip(0).cumsum(0).double()
    tp0 = torch.cat([tp.new_zeros(1), tp[:-1]])
    fp0 = torch.cat([fp.new_zeros(1), fp[:-1]])
    area = torch.sum((fp - fp0) * (tp + tp0) / 2.0)
    denom = (tp[-1] * fp[-1]).clamp_min(1.0)
    return {"AUC": (area / denom).float().reshape(1),
            "StatPosOut": new_pos, "StatNegOut": new_neg}
