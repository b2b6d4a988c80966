"""Metric ops in torch (counterpart of ``paddle_tpu/ops/metric_ops.py``:
``accuracy :10``)."""
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
