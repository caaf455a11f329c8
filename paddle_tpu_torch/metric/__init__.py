"""paddle.metric of the port (port of ``paddle_tpu/metric/__init__.py``):
Metric, Accuracy, Precision, Recall and Auc, computed on the host in
numpy from the predictions a step hands back (an eager Tensor converts
through ``__array__``)."""
from __future__ import annotations

import numpy as np


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred = np.asarray(pred)
        label = np.asarray(label)
        idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        if label.ndim == pred.ndim:
            label = label.squeeze(-1)
        correct = idx == label[..., None]
        return correct

    def update(self, correct, *args):
        correct = np.asarray(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = correct[..., :k].any(-1).sum()
            tot = correct[..., 0].size
            self.total[i] += num
            self.count[i] += tot
            accs.append(num / max(tot, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).round().astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).round().astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        prob = preds[:, -1] if preds.ndim > 1 else preds
        idx = np.clip((prob * self.num_thresholds).astype(int), 0, self.num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if not tot_pos or not tot_neg:
            return 0.0
        tp0 = np.concatenate([[0], tp[:-1]])
        fp0 = np.concatenate([[0], fp[:-1]])
        area = np.sum((fp - fp0) * (tp + tp0) / 2.0)
        return float(area / (tot_pos * tot_neg))

    def name(self):
        return self._name
