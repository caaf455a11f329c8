"""Metric op lowerings: ``accuracy``, ``mean_iou``, ``auc``,
``precision_recall``, ``positive_negative_pair`` and ``chunk_eval``.

Port of ``paddle_tpu/ops/metric_ops.py``. The first four are device
rules with no host read, so a replayed step computes them inside its
graph (the counts go through ``index_add_``, which a capture takes;
``bincount`` would size its output from a host read).
``positive_negative_pair`` and ``chunk_eval`` walk their inputs in
Python, as in the JAX package: they are host ops (``host=True``), and a
block holding one runs op by op (``framework/executor.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.registry import register_op
from .common import maybe


def _counts(idx: torch.Tensor, n: int, weight: torch.Tensor, dtype):
    """``zeros(n).at[idx].add(weight)``."""
    out = torch.zeros(n, dtype=dtype, device=idx.device)
    return out.index_add_(0, idx.reshape(-1).long(),
                          weight.reshape(-1).to(dtype))


@register_op("accuracy", stop_gradient=True)
def _accuracy(ctx, ins, attrs):
    indices = ins["Indices"][0]  # (N, k) top-k predicted classes
    label = ins["Label"][0]  # (N, 1)
    if label.dim() == 1:
        label = label[:, None]
    correct = (indices == label).any(dim=1)
    num_correct = correct.sum().to(torch.int32)
    total = indices.shape[0]
    return {"Accuracy": (num_correct.float() / total).reshape(()),
            "Correct": num_correct.reshape(1),
            "Total": torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)}


@register_op("mean_iou", stop_gradient=True)
def _mean_iou(ctx, ins, attrs):
    pred, label = ins["Predictions"][0], ins["Labels"][0]
    nc = attrs.get("num_classes", 2)
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    cm = _counts(label * nc + pred, nc * nc, torch.ones_like(pred),
                 torch.int32).reshape(nc, nc)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1),
                      torch.zeros((), device=cm.device))
    mean_iou = iou.sum() / torch.clamp(valid.sum(), min=1)
    return {"OutMeanIou": mean_iou.float(),
            "OutWrong": (cm.sum(1) - inter).to(torch.int32),
            "OutCorrect": inter.to(torch.int32)}


@register_op("auc", stop_gradient=True)
def _auc(ctx, ins, attrs):
    """Streaming AUC over histogram stat buffers; Predict is (N, 2)
    probabilities, Label (N, 1)."""
    predict, label = ins["Predict"][0], ins["Label"][0]
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresh = stat_pos.shape[-1] - 1
    lbl = label.reshape(-1).bool()
    idx = torch.clamp((predict[:, -1] * num_thresh).to(torch.int32), 0,
                      num_thresh)
    n = stat_pos.numel()
    new_pos = stat_pos + _counts(idx, n, lbl, stat_pos.dtype).reshape(
        stat_pos.shape)
    new_neg = stat_neg + _counts(idx, n, ~lbl, stat_neg.dtype).reshape(
        stat_neg.shape)
    # the trapezoid over descending thresholds
    tp = torch.cumsum(new_pos.reshape(-1).flip(0), 0)
    fp = torch.cumsum(new_neg.reshape(-1).flip(0), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    tp0 = torch.cat([torch.zeros(1, dtype=tp.dtype, device=tp.device),
                     tp[:-1]])
    fp0 = torch.cat([torch.zeros(1, dtype=fp.dtype, device=fp.device),
                     fp[:-1]])
    area = ((fp - fp0) * (tp + tp0) / 2.0).sum()
    auc = torch.where((tot_pos > 0) & (tot_neg > 0),
                      area / torch.clamp(tot_pos * tot_neg, min=1),
                      torch.zeros((), device=area.device))
    return {"AUC": auc.to(torch.float64 if auc.dtype == torch.float64
                          else torch.float32),
            "StatPosOut": new_pos, "StatNegOut": new_neg}


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                       torch.zeros((), device=num.device))


def _pr_metrics(st):
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]
    p = _safe_div(tp, tp + fp)
    r = _safe_div(tp, tp + fn)
    f1 = _safe_div(2 * p * r, p + r)
    mp = _safe_div(tp.sum(), (tp + fp).sum())
    mr = _safe_div(tp.sum(), (tp + fn).sum())
    mf = _safe_div(2 * mp * mr, mp + mr)
    return torch.stack([p.mean(), r.mean(), f1.mean(), mp, mr, mf])


@register_op("precision_recall", stop_gradient=True)
def _precision_recall(ctx, ins, attrs):
    """Per-class TP/FP/TN/FN accumulated into ``StatesInfo``; each metrics
    row is [macro P, R, F1, micro P, R, F1]."""
    cls_num = attrs["class_number"]
    idx = ins["Indices"][0].reshape(-1).long()
    labels = ins["Labels"][0].reshape(-1).long()
    weights = maybe(ins, "Weights")
    w = (weights.reshape(-1).float() if weights is not None
         else torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    classes = torch.arange(cls_num, device=idx.device)
    oh_pred = (idx[:, None] == classes).float()
    oh_lab = (labels[:, None] == classes).float()
    wc = w[:, None]
    tp = (oh_pred * oh_lab * wc).sum(0)
    fp = (oh_pred * (1 - oh_lab) * wc).sum(0)
    fn = ((1 - oh_pred) * oh_lab * wc).sum(0)
    tn = ((1 - oh_pred) * (1 - oh_lab) * wc).sum(0)
    batch = torch.stack([tp, fp, tn, fn], dim=1)  # (C, 4)
    states = maybe(ins, "StatesInfo")
    accum = batch + states if states is not None else batch
    return {"BatchMetrics": _pr_metrics(batch),
            "AccumMetrics": _pr_metrics(accum), "AccumStatesInfo": accum}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _scalar(t) -> float:
    return float(_host(t).reshape(())) if t is not None else 0.0


@register_op("positive_negative_pair", stop_gradient=True, skip_infer=True,
             host=True)
def _positive_negative_pair(ctx, ins, attrs):
    """Within each query, count the score-ordered pairs that agree,
    disagree or tie with the labels."""
    score = _host(ins["Score"][0]).reshape(-1)
    label = _host(ins["Label"][0]).reshape(-1)
    qid = _host(ins["QueryID"][0]).reshape(-1)
    pos = neg = neu = 0.0
    for q in np.unique(qid):
        sel = qid == q
        s, lab = score[sel], label[sel]
        for i in range(len(s)):
            for j in range(i + 1, len(s)):
                if lab[i] == lab[j]:
                    continue
                prod = (s[i] - s[j]) * (lab[i] - lab[j])
                if prod > 0:
                    pos += 1
                elif prod < 0:
                    neg += 1
                else:
                    neu += 1
    pos += _scalar(maybe(ins, "AccumulatePositivePair"))
    neg += _scalar(maybe(ins, "AccumulateNegativePair"))
    neu += _scalar(maybe(ins, "AccumulateNeutralPair"))

    def out(v):
        return torch.tensor([v], dtype=torch.float32, device=ctx.device)

    return {"PositivePair": out(pos), "NegativePair": out(neg),
            "NeutralPair": out(neu)}


_TAGS_PER_CHUNK = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _chunks(seq, scheme: str, num_types: int) -> set:
    """The (start, end, type) chunks of one tag sequence. Tag roles: IOB
    0=B 1=I; IOE 0=I 1=E; IOBES 0=B 1=I 2=E 3=S; plain: each id its own
    type."""
    per = _TAGS_PER_CHUNK[scheme]
    chunks = []
    start, typ = None, None

    def close(end):
        nonlocal start, typ
        if start is not None:
            chunks.append((start, end, typ))
            start, typ = None, None

    for pos, tid in enumerate(seq):
        tid = int(tid)
        if tid < 0 or tid >= num_types * per:
            close(pos - 1)
            continue
        t, tag = (tid, 0) if scheme == "plain" else divmod(tid, per)
        if scheme == "plain":
            if start is None or t != typ:
                close(pos - 1)
                start, typ = pos, t
        elif scheme == "IOB":
            if tag == 0 or start is None or t != typ:
                close(pos - 1)
                start, typ = pos, t
        elif scheme == "IOE":
            if start is None or t != typ:
                close(pos - 1)
                start, typ = pos, t
            if tag == 1:  # E closes the chunk at this token
                close(pos)
        elif scheme == "IOBES":
            if tag == 0:
                close(pos - 1)
                start, typ = pos, t
            elif tag == 3:  # S: a one-token chunk
                close(pos - 1)
                chunks.append((pos, pos, t))
            elif start is None or t != typ:
                close(pos - 1)
                start, typ = pos, t
            if tag == 2:
                close(pos)
    close(len(seq) - 1)
    return set(chunks)


@register_op("chunk_eval", stop_gradient=True, skip_infer=True, host=True)
def _chunk_eval(ctx, ins, attrs):
    """Chunking precision, recall and F1 over padded (B, T) tag ids and
    ``SeqLength``."""
    inference = _host(ins["Inference"][0])
    label = _host(ins["Label"][0])
    seq_len = maybe(ins, "SeqLength")
    scheme = attrs.get("chunk_scheme", "IOB")
    num_types = attrs["num_chunk_types"]
    if inference.ndim == 1:
        inference, label = inference[None], label[None]
    b, t = inference.shape
    lens = (_host(seq_len).reshape(-1) if seq_len is not None
            else np.full(b, t))
    n_inf = n_lab = n_cor = 0
    for i in range(b):
        ci = _chunks(inference[i, :lens[i]], scheme, num_types)
        cl = _chunks(label[i, :lens[i]], scheme, num_types)
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0

    def out(v, dtype):
        return torch.tensor([v], dtype=dtype, device=ctx.device)

    return {"Precision": out(p, torch.float32),
            "Recall": out(r, torch.float32),
            "F1-Score": out(f1, torch.float32),
            "NumInferChunks": out(n_inf, torch.int64),
            "NumLabelChunks": out(n_lab, torch.int64),
            "NumCorrectChunks": out(n_cor, torch.int64)}
