"""Detailed post-training evaluation metrics (port of
``tf2_gnn_tpu/harness/evaluation.py``; predictions come from the port's
``harness/training.py::predict``).

Reference: tf2_gnn/models/graph_regression_task.py:184-203 and
graph_binary_classification_task.py:70-101 (sklearn-based). sklearn is used
when available and the metrics fall back to numpy implementations otherwise.
"""
from typing import Dict

import numpy as np

try:  # pragma: no cover - environment-dependent
    from sklearn import metrics as _sk
except Exception:  # pragma: no cover
    _sk = None


def regression_metrics(predictions: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
    predictions = np.asarray(predictions, dtype=np.float64).ravel()
    targets = np.asarray(targets, dtype=np.float64).ravel()
    if _sk is not None:
        return {
            "mae": float(_sk.mean_absolute_error(targets, predictions)),
            "mse": float(_sk.mean_squared_error(targets, predictions)),
            "max_err": float(_sk.max_error(targets, predictions)),
            "expl_var": float(_sk.explained_variance_score(targets, predictions)),
            "r2_score": float(_sk.r2_score(targets, predictions)),
        }
    err = predictions - targets
    var_t = float(np.var(targets))
    return {
        "mae": float(np.abs(err).mean()),
        "mse": float((err ** 2).mean()),
        "max_err": float(np.abs(err).max()),
        "expl_var": 1.0 - float(np.var(err)) / max(var_t, 1e-12),
        "r2_score": 1.0 - float((err ** 2).sum())
        / max(float(((targets - targets.mean()) ** 2).sum()), 1e-12),
    }


def _roc_auc(targets: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (equivalent to sklearn.roc_auc_score)."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    pos = targets > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _average_precision(targets: np.ndarray, scores: np.ndarray) -> float:
    order = np.argsort(-scores, kind="mergesort")
    t = targets[order] > 0.5
    tp = np.cumsum(t)
    precision = tp / np.arange(1, len(t) + 1)
    n_pos = int(t.sum())
    if n_pos == 0:
        return float("nan")
    return float((precision * t).sum() / n_pos)


def binary_classification_metrics(
    probabilities: np.ndarray, targets: np.ndarray
) -> Dict[str, float]:
    probabilities = np.asarray(probabilities, dtype=np.float64).ravel()
    targets = np.asarray(targets, dtype=np.float64).ravel()
    predictions = (probabilities >= 0.5).astype(np.float64)
    if _sk is not None:
        return {
            "acc": float(_sk.accuracy_score(targets, predictions)),
            "balanced_acc": float(_sk.balanced_accuracy_score(targets, predictions)),
            "precision": float(_sk.precision_score(targets, predictions, zero_division=0)),
            "recall": float(_sk.recall_score(targets, predictions, zero_division=0)),
            "f1_score": float(_sk.f1_score(targets, predictions, zero_division=0)),
            "roc_auc": float(_sk.roc_auc_score(targets, probabilities)),
            "average_precision": float(
                _sk.average_precision_score(targets, probabilities)
            ),
        }
    tp = float(((predictions == 1) & (targets == 1)).sum())
    fp = float(((predictions == 1) & (targets == 0)).sum())
    fn = float(((predictions == 0) & (targets == 1)).sum())
    tn = float(((predictions == 0) & (targets == 0)).sum())
    precision = tp / max(tp + fp, 1e-12)
    recall = tp / max(tp + fn, 1e-12)
    specificity = tn / max(tn + fp, 1e-12)
    return {
        "acc": (tp + tn) / max(len(targets), 1),
        "balanced_acc": (recall + specificity) / 2.0,
        "precision": precision,
        "recall": recall,
        "f1_score": 2 * precision * recall / max(precision + recall, 1e-12),
        "roc_auc": _roc_auc(targets, probabilities),
        "average_precision": _average_precision(targets, probabilities),
    }


def collect_graph_predictions(model, batches, device) -> Dict[str, np.ndarray]:
    """Run prediction over a fold; returns per-real-graph preds and
    targets."""
    from .training import predict

    batches = list(batches)
    return {
        "predictions": np.asarray(predict(model, batches, device)),
        "targets": np.concatenate(
            [np.asarray(labels["target_value"])[:batch.num_graphs]
             for batch, labels in batches]),
    }


def evaluate_model(model, batches, device, log=print) -> Dict[str, float]:
    """Task-appropriate detailed metrics (reference evaluate_model hooks)."""
    kind = getattr(model, "EVAL_KIND", None)
    if kind is None:
        raise NotImplementedError(
            f"Model {type(model).__name__} has no detailed evaluation."
        )
    data = collect_graph_predictions(model, batches, device)
    if kind == "regression":
        results = regression_metrics(data["predictions"], data["targets"])
    elif kind == "binary_classification":
        results = binary_classification_metrics(data["predictions"],
                                                data["targets"])
    else:
        raise ValueError(f"Unknown EVAL_KIND {kind}.")
    log(f"Metrics: {', '.join(f'{k}: {v:.3f}' for k, v in results.items())}")
    return results
