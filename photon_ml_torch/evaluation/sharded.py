"""Device evaluators: the metrics computed on the device, scalars to the host.

Counterpart of ``photon_ml_tpu/evaluation/sharded.py``; reference photon-lib
evaluation/Evaluator.scala:39-49 and photon-api
evaluation/MultiEvaluator.scala:40-88 (metrics evaluated on the executors).
The host evaluators (``evaluation/evaluators.py``) read a host copy of the
whole score vector; these read it on the device. Over a mesh each rank's
score block is all-gathered onto every rank's device first (one
``all_gather`` for all the evaluators of a pass), every rank computes the
same metric, and only the scalar reaches the host.

- RMSE, MAE and the four losses: weighted sums.
- AUC and AUPR: one sort by score, then tie-run arithmetic: the exact,
  tie-aware formulas of the host metrics (average-rank Mann-Whitney AUC;
  trapezoidal PR area at distinct scores from the (0, p_first) point).
- Per-query RMSE: sums per query code.
- Per-query AUC and PRECISION@k: one sort by (query, score), stable, then
  run and segment arithmetic (average-rank ties, original-order tie-break).

Padding contract: rows appended to reach a mesh multiple carry weight 0 and
query code Q (a segment of their own that no metric reads), so they move no
metric; AUPR also masks them out of its thresholds (``valid``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from photon_ml_torch.evaluation.evaluators import (
    EvaluationData,
    Evaluator,
    MultiEvaluator,
    _GlobalEvaluator,
)


def _nan_unless(cond: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, value, torch.full_like(value, float("nan")))


def _wsum_metric(fn):
    def compute(scores, c):
        w = c["weights"]
        wsum = torch.sum(w)
        return _nan_unless(wsum > 0, torch.sum(w * fn(scores, c["labels"])) / wsum)

    return compute


def _rmse(scores, c):
    w = c["weights"]
    wsum = torch.sum(w)
    return _nan_unless(wsum > 0, torch.sqrt(torch.sum(w * (scores - c["labels"]) ** 2) / wsum))


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    return torch.zeros((num,), dtype=values.dtype, device=values.device).index_add_(
        0, ids, values)


def _runs(new_run: torch.Tensor):
    """(run id of each element, first position of each element's run)."""
    run_id = torch.cumsum(new_run.long(), 0) - 1
    starts = torch.nonzero(new_run).reshape(-1)
    return run_id, starts[run_id]


def _auc_exact(scores, c):
    """AUC = [Σ_{i∈pos} w_i (W⁻_{<s_i} + ½ W⁻_{=s_i})] / (W⁺ W⁻), ties by
    average rank (``local_metrics.area_under_roc_curve``)."""
    w, y = c["weights"], c["labels"]
    pos = y > 0.5
    wp_all = torch.where(pos, w, torch.zeros_like(w))
    wn_all = torch.where(~pos, w, torch.zeros_like(w))
    wp, wn = torch.sum(wp_all), torch.sum(wn_all)
    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    wpos, wneg = wp_all[order], wn_all[order]
    n = scores.shape[0]
    new_run = torch.ones((n,), dtype=torch.bool, device=scores.device)
    new_run[1:] = s_sorted[1:] != s_sorted[:-1]
    run_id, run_start = _runs(new_run)
    cneg = torch.cat([torch.zeros((1,), dtype=w.dtype, device=w.device), torch.cumsum(wneg, 0)])
    run_neg = _segment_sum(wneg, run_id, n)[run_id]
    contrib = torch.sum(wpos * (cneg[run_start] + 0.5 * run_neg))
    return _nan_unless((wp > 0) & (wn > 0), contrib / (wp * wn))


def _aupr_exact(scores, c):
    """Trapezoidal area under the PR curve at distinct-score thresholds from
    the (0, p_first) point (``local_metrics.area_under_precision_recall_
    curve``). Mesh pads are no threshold; real weight-0 rows are."""
    w, y = c["weights"], c["labels"]
    sort_key = torch.where(c["valid"] > 0, scores, torch.full_like(scores, -float("inf")))
    order = torch.argsort(-sort_key, stable=True)
    s_desc = sort_key[order]
    w_sorted = w[order]
    tp_w = torch.where(y[order] > 0.5, w_sorted, torch.zeros_like(w_sorted))
    total_pos = torch.sum(tp_w)
    n = scores.shape[0]
    new_run = torch.ones((n,), dtype=torch.bool, device=scores.device)
    new_run[1:] = s_desc[1:] != s_desc[:-1]
    run_id, _ = _runs(new_run)
    num_runs = int(run_id[-1]) + 1 if n else 0
    run_tp = torch.cumsum(_segment_sum(tp_w, run_id, num_runs), 0)
    run_all = torch.cumsum(_segment_sum(w_sorted, run_id, num_runs), 0)
    precision = torch.where(run_all > 0, run_tp / torch.clamp(run_all, min=1e-30),
                            torch.zeros_like(run_all))
    recall = run_tp / torch.clamp(total_pos, min=1e-30)
    r_prev = torch.cat([torch.zeros_like(recall[:1]), recall[:-1]])
    p_prev = torch.cat([precision[:1], precision[:-1]])
    area = torch.sum((recall - r_prev) * 0.5 * (precision + p_prev))
    return _nan_unless(total_pos > 0, area)


def _smoothed_hinge(s, y):
    t = (2.0 * y - 1.0) * s
    return torch.where(t >= 1.0, torch.zeros_like(t),
                       torch.where(t <= 0.0, 0.5 - t, 0.5 * (1.0 - t) ** 2))


_GLOBAL_DEVICE: dict[str, Callable] = {
    "RMSE": _rmse,
    "MAE": _wsum_metric(lambda s, y: torch.abs(s - y)),
    "LOGISTIC_LOSS": _wsum_metric(lambda s, y: torch.logaddexp(torch.zeros_like(s), s) - y * s),
    "SQUARED_LOSS": _wsum_metric(lambda s, y: 0.5 * (s - y) ** 2),
    "POISSON_LOSS": _wsum_metric(lambda s, y: torch.exp(s) - y * s),
    "SMOOTHED_HINGE_LOSS": _wsum_metric(_smoothed_hinge),
    "AUC": _auc_exact,
    "AUPR": _aupr_exact,
}


def _mean_over_valid(per: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    cnt = torch.sum(valid)
    return _nan_unless(cnt > 0, torch.sum(torch.where(valid, per, torch.zeros_like(per)))
                       / torch.clamp(cnt, min=1))


def _per_query_rmse(scores, c):
    q, w, y, nq = c["qid"], c["weights"], c["labels"], c["num_queries"]
    se = _segment_sum(w * (scores - y) ** 2, q, nq + 1)
    ws = _segment_sum(w, q, nq + 1)
    per = torch.sqrt(se[:nq] / torch.clamp(ws[:nq], min=1e-30))
    return _mean_over_valid(per, ws[:nq] > 0)


def _sorted_query_layout(c, key: torch.Tensor):
    """Rows sorted by (query, key), stable (equal keys keep their order);
    returns (order, sorted query codes, positions, first position of each
    row's query)."""
    q = c["qid"]
    by_key = torch.argsort(key, stable=True)
    order = by_key[torch.argsort(q[by_key], stable=True)]
    qs = q[order]
    n = q.shape[0]
    idx = torch.arange(n, device=q.device)
    new_q = torch.ones((n,), dtype=torch.bool, device=q.device)
    new_q[1:] = qs[1:] != qs[:-1]
    _, q_start = _runs(new_q)
    return order, qs, idx, q_start


def _per_query_auc(scores, c):
    """Per-query Mann-Whitney AUC (average-rank ties); queries without both
    classes are skipped (MultiEvaluator requires_both_classes)."""
    w, y, nq = c["weights"], c["labels"], c["num_queries"]
    order, qs, idx, q_start = _sorted_query_layout(c, scores)
    s_sorted = scores[order]
    w_sorted = w[order]
    pos_sorted = y[order] > 0.5
    wpos = torch.where(pos_sorted, w_sorted, torch.zeros_like(w_sorted))
    wneg = torch.where(~pos_sorted, w_sorted, torch.zeros_like(w_sorted))
    n = scores.shape[0]
    new_run = torch.ones((n,), dtype=torch.bool, device=scores.device)
    new_run[1:] = (qs[1:] != qs[:-1]) | (s_sorted[1:] != s_sorted[:-1])
    run_id, run_start = _runs(new_run)
    cneg = torch.cat([torch.zeros((1,), dtype=w.dtype, device=w.device), torch.cumsum(wneg, 0)])
    neg_before_run = cneg[run_start] - cneg[q_start]
    run_neg = _segment_sum(wneg, run_id, n)[run_id]
    auc_num = _segment_sum(wpos * (neg_before_run + 0.5 * run_neg), qs, nq + 1)
    wp_q = _segment_sum(wpos, qs, nq + 1)[:nq]
    wn_q = _segment_sum(wneg, qs, nq + 1)[:nq]
    per = auc_num[:nq] / torch.clamp(wp_q * wn_q, min=1e-30)
    return _mean_over_valid(per, (wp_q > 0) & (wn_q > 0))


def _per_query_precision_at_k(k: int):
    def compute(scores, c):
        y, nq = c["labels"], c["num_queries"]
        # query ascending, score descending; ties keep their original order
        order, qs, idx, q_start = _sorted_query_layout(c, -scores)
        in_top = (idx - q_start) < k
        hit = (in_top & (y[order] > 0.5)).to(scores.dtype)
        hits = _segment_sum(hit, qs, nq + 1)[:nq]
        size = _segment_sum(torch.ones_like(scores), qs, nq + 1)[:nq]
        per = hits / torch.clamp(torch.clamp(size, max=float(k)), min=1.0)
        return _mean_over_valid(per, size > 0)

    return compute


@dataclasses.dataclass
class DeviceEvaluator:
    """A host Evaluator bound to one dataset: ``compute(scores, consts)``
    runs on the device that holds ``consts``. The direction stays the host
    evaluator's (callers keep its ``better_than``)."""

    name: str
    larger_is_better: bool
    compute: Callable[[torch.Tensor, dict], torch.Tensor]
    consts: dict


def mesh_data_placer(device):
    """Placement of evaluator constants: the whole (padded) vector on the
    rank's ``device``, where the gathered scores land."""
    def place(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=device)

    return place


def device_evaluator(evaluator: Evaluator, data: EvaluationData, n_pad: int | None = None,
                     place: Callable | None = None, *, device=None) -> DeviceEvaluator | None:
    """The device twin of a host evaluator over one dataset, or None when
    it has none (a custom evaluator: callers take the host path). n_pad:
    the padded score length (appended rows get weight 0 and query code Q).
    place: how a host array reaches the device (default: onto ``device``).
    The constants keep the labels' float type (f32 for other labels), and
    the scores are cast to it."""
    n = len(data.labels)
    n_pad = n if n_pad is None else int(n_pad)
    place = place or mesh_data_placer(device if device is not None else "cpu")
    fdtype = np.asarray(data.labels).dtype
    if fdtype.kind != "f":
        fdtype = np.dtype(np.float32)

    def padded(a, fill=0.0):
        a = np.asarray(a, fdtype)
        if n_pad > n:
            a = np.concatenate([a, np.full(n_pad - n, fill, a.dtype)])
        return place(a)

    consts = {"labels": padded(data.labels), "weights": padded(data.weights),
              "valid": padded(np.ones(n))}
    if isinstance(evaluator, _GlobalEvaluator):
        fn = _GLOBAL_DEVICE.get(evaluator.name)
        if fn is None:
            return None
        return DeviceEvaluator(evaluator.name, evaluator.larger_is_better, fn, consts)
    if isinstance(evaluator, MultiEvaluator):
        ids = data.ids.get(evaluator.id_column)
        if ids is None:
            raise KeyError(f"id column '{evaluator.id_column}' not present in evaluation data")
        _, codes = np.unique(np.asarray(ids), return_inverse=True)
        nq = int(codes.max()) + 1 if len(codes) else 0
        codes = codes.astype(np.int64)
        if n_pad > n:
            codes = np.concatenate([codes, np.full(n_pad - n, nq, np.int64)])
        consts["qid"] = place(codes)
        consts["num_queries"] = nq
        metric = evaluator.name.split(":", 1)[0]
        if metric == "RMSE":
            fn = _per_query_rmse
        elif metric == "AUC":
            fn = _per_query_auc
        elif metric.startswith("PRECISION@"):
            fn = _per_query_precision_at_k(int(metric.split("@", 1)[1]))
        else:
            return None
        return DeviceEvaluator(evaluator.name, evaluator.larger_is_better, fn, consts)
    return None


def prepare_device_evaluators(evaluators: Sequence[Evaluator], data: EvaluationData,
                              n_pad: int | None = None, place: Callable | None = None, *,
                              device=None) -> list:
    """Per-evaluator device twins (None where only the host form exists)."""
    return [device_evaluator(ev, data, n_pad, place, device=device) for ev in evaluators]


def evaluate_prepared(evaluators: Sequence[Evaluator], device_evals: Sequence, scores,
                      eval_data: EvaluationData, host_scores_fn: Callable[[], np.ndarray],
                      *, layout=None) -> list[float]:
    """Metric values in evaluator order. The device twins read the score
    vector on the device (over a mesh, ``layout``: every rank's block
    gathered once); evaluators without one share one host copy from
    ``host_scores_fn``. Every rank of a mesh calls this in the same order."""
    out: list[float] = []
    host_scores = None
    whole = None
    for ev, dev in zip(evaluators, device_evals):
        if dev is not None:
            if whole is None:
                whole = scores if layout is None else layout.gather(scores)
            s = whole.to(dev.consts["labels"].dtype)
            out.append(float(dev.compute(s, dev.consts)))
        else:
            if host_scores is None:
                host_scores = host_scores_fn()
            out.append(float(ev.evaluate(host_scores, eval_data)))
    return out
