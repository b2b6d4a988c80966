"""fluid.metrics: host-side running metric state, a copy of
``paddle_tpu/metrics.py`` (``MetricBase``, ``CompositeMetric``,
``Precision``, ``Recall``, ``Accuracy``, ``ChunkEvaluator``,
``EditDistance``, ``Auc``).

They accumulate numpy results between steps; the in-graph counterparts
(the ``accuracy``, ``auc`` and ``precision_recall`` ops) run on the
device. ``DetectionMAP`` needs ``layers.detection`` and raises until
Queue 1 item 10 ports it.
"""
import numpy as np


def _np(x, name):
    if not isinstance(x, np.ndarray):
        raise ValueError(f"The {name!r} must be a numpy ndarray.")
    return x


class MetricBase:
    """Base: state = instance attrs; reset() zeroes them; eval() reports."""

    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, type(v)(0))
            elif isinstance(v, np.ndarray):
                setattr(self, k, np.zeros_like(v))

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def update(self, preds, labels):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    """Fan one update() out to several metrics."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("add_metric expects a MetricBase instance")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary precision: tp / (tp + fp), preds are sigmoid scores."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_np(preds, "preds")).astype(np.int64).reshape(-1)
        labels = _np(labels, "labels").astype(np.int64).reshape(-1)
        pos = preds == 1
        self.tp += int(np.sum(pos & (labels == 1)))
        self.fp += int(np.sum(pos & (labels != 1)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0


class Recall(MetricBase):
    """Binary recall: tp / (tp + fn)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_np(preds, "preds")).astype(np.int64).reshape(-1)
        labels = _np(labels, "labels").astype(np.int64).reshape(-1)
        rel = labels == 1
        self.tp += int(np.sum(rel & (preds == 1)))
        self.fn += int(np.sum(rel & (preds != 1)))

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0


class Accuracy(MetricBase):
    """Weighted running mean of per-batch accuracies."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        if not np.isscalar(value) and not isinstance(value, np.ndarray):
            raise ValueError("The 'value' must be a number(int, float) "
                             "or a numpy ndarray.")
        if weight < 0:
            raise ValueError("The 'weight' can not be negative")
        self.value += float(np.sum(value)) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError(
                "There is no data in Accuracy Metrics; call update first")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """Chunking F1 from (num_infer, num_label, num_correct) counts per
    batch (the reference pairs this with chunk_eval's outputs)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.sum(num_infer_chunks))
        self.num_label_chunks += int(np.sum(num_label_chunks))
        self.num_correct_chunks += int(np.sum(num_correct_chunks))

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    """Mean edit distance + instance error rate."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = _np(np.asarray(distances), "distances")
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError(
                "There is no data in EditDistance Metric; call update first")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    """Histogram-accumulated ROC AUC (reference metrics.py:699; same
    threshold-bucket scheme as the in-graph auc op)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(num_thresholds + 1, np.int64)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = _np(preds, "preds")
        labels = _np(labels, "labels").reshape(-1)
        pos_prob = preds[:, -1] if preds.ndim == 2 else preds.reshape(-1)
        bins = np.clip((pos_prob * self._num_thresholds).astype(np.int64),
                       0, self._num_thresholds)
        pos = labels > 0
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1]).astype(np.float64)
        fp = np.cumsum(self._stat_neg[::-1]).astype(np.float64)
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos * tot_neg == 0:
            return 0.0
        tp0 = np.concatenate([[0.0], tp[:-1]])
        fp0 = np.concatenate([[0.0], fp[:-1]])
        area = np.sum(self.trapezoid_area(fp0, fp, tp0, tp))
        return float(area / (tot_pos * tot_neg))


class DetectionMAP(MetricBase):
    """Detection mAP: not ported (it builds ``layers.detection_map``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "metrics.DetectionMAP needs layers.detection, which Queue 1 "
            "item 10 ports")
