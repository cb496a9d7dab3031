"""Training core: TrainState, the train/eval/predict steps and the epoch
and patience loop (port of ``tf2_gnn_tpu/harness/training.py``).

PyTorch runs eagerly, so the steps are plain functions; the state is
updated in place and also returned, mirroring the reference's functional
signature. Dropout draws from an explicit ``torch.Generator`` on the
model's device, seeded with ``seed + 1`` (the reference splits its dropout
keys from ``PRNGKey(seed + 1)``; the bits differ between the frameworks).

The epoch loops take host batches, as ``GraphDataset.batch_iterator``
yields them, and move each to the model's device one batch ahead
(``device_prefetch``); the per-step metrics stay on the device until the
epoch ends.
"""
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..data.graph_batch import GraphBatch
from ..data.graph_dataset import DataFold, GraphDataset
from ..models.graph_task_model import GraphTaskModel
from .optimizers import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: GraphTaskModel
    optimizer: Optimizer
    generator: torch.Generator  # dropout masks


def create_train_state(model: GraphTaskModel, optimizer: Optimizer,
                       seed: int = 0) -> TrainState:
    """State for a model already built on its device (``from_params``)."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=generator)


def make_train_step(model: GraphTaskModel, optimizer: Optimizer
                    ) -> Callable[..., Tuple[TrainState, Dict[str, Any]]]:
    """(state, batch, labels) -> (state, metrics) with dropout; metrics are
    detached tensors on the device (read them when the host needs them)."""

    def train_step(state: TrainState, batch: GraphBatch,
                   labels: Dict[str, torch.Tensor]):
        model.train()
        optimizer.zero_grad()
        task_output = model(batch, True, state.generator)
        metrics = model.compute_task_metrics(batch, task_output, labels)
        metrics["loss"].backward()
        optimizer.step(state.step)
        state.step += 1
        return state, {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}

    return train_step


def make_eval_step(model: GraphTaskModel
                   ) -> Callable[..., Dict[str, Any]]:
    """(batch, labels) -> metrics, no dropout and no gradients."""

    def eval_step(batch: GraphBatch, labels: Dict[str, torch.Tensor]):
        model.eval()
        with torch.no_grad():
            task_output = model(batch, False)
            return model.compute_task_metrics(batch, task_output, labels)

    return eval_step


def make_predict_step(model: GraphTaskModel) -> Callable[[GraphBatch], Any]:
    """batch -> task output, no dropout and no gradients."""

    def predict_step(batch: GraphBatch):
        model.eval()
        with torch.no_grad():
            return model(batch, False)

    return predict_step


def _model_device(model: GraphTaskModel) -> torch.device:
    return next(model.parameters()).device


def to_device(batch: GraphBatch, labels: Dict[str, Any], device
              ) -> Tuple[GraphBatch, Dict[str, torch.Tensor]]:
    """A host (batch, labels) pair as tensors on ``device``."""
    return batch.to(device), {k: torch.as_tensor(np.asarray(v),
                                                 device=device)
                              for k, v in labels.items()}


def device_prefetch(batches: Iterable, device) -> Iterable:
    """Yield host (batch, labels) pairs moved to ``device``, one batch
    ahead of the consumer.

    The next batch is moved before the current one is handed out. Its
    arrays are pageable numpy memory, so ``.to(device)`` is a blocking
    copy: it runs in stream order after the steps already queued, and the
    host waits for it, so a copy overlaps no kernel (a ``non_blocking``
    copy overlaps only from pinned memory). What overlaps the device's
    work is the host's packing and planning of later batches in the
    dataset's worker thread.
    """
    staged = None
    for batch, labels in batches:
        moved = to_device(batch, labels, device)
        if staged is not None:
            yield staged
        staged = moved
    if staged is not None:
        yield staged


def _to_host(metrics: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v)
            for k, v in metrics.items()}


def _trim(x, batch: GraphBatch) -> np.ndarray:
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    if x.shape[0] == batch.num_graphs_padded:
        return x[:batch.num_graphs]
    if x.shape[0] == batch.num_nodes_padded:
        return x[:batch.num_nodes]
    return x


def predict(model: GraphTaskModel, batches, device=None) -> Any:
    """Run prediction over host (batch, labels) pairs and concatenate the
    REAL rows of each output: per-graph outputs keep rows
    ``[:num_graphs]``, per-node outputs ``[:num_nodes]``; tuple outputs
    elementwise."""
    device = _model_device(model) if device is None else device
    predict_step = make_predict_step(model)
    pieces: List[Any] = []
    for batch, _ in device_prefetch(batches, device):
        out = predict_step(batch)
        pieces.append(tuple(_trim(x, batch) for x in out)
                      if isinstance(out, tuple) else _trim(out, batch))
    if isinstance(pieces[0], tuple):
        return tuple(np.concatenate(xs, axis=0) for xs in zip(*pieces))
    return np.concatenate(pieces, axis=0)


def _num_graphs(metrics: Dict[str, Any], batch: GraphBatch) -> int:
    return int(float(metrics.get("num_graphs", batch.num_graphs)))


def run_train_epoch(
    train_step,
    state: TrainState,
    batches: Iterable[Tuple[GraphBatch, Dict[str, np.ndarray]]],
    device=None,
    quiet: bool = True,
    log_fun: Callable[[str], None] = print,
) -> Tuple[TrainState, float, float, List[Dict[str, np.ndarray]]]:
    """One training epoch over host batches; returns (state, per-graph
    average loss, graphs/s, per-batch host metrics).

    The per-step metrics stay on the device until the epoch ends, so a
    quiet epoch reads nothing back inside the loop; non-quiet logging
    reads each step's loss (a synchronisation a step)."""
    device = _model_device(state.model) if device is None else device
    start = time.time()
    device_metrics: List[Dict[str, Any]] = []
    graph_counts: List[int] = []
    running_loss, running_graphs = 0.0, 0
    for step, (batch, labels) in enumerate(device_prefetch(batches, device)):
        state, metrics = train_step(state, batch, labels)
        device_metrics.append(metrics)
        graph_counts.append(_num_graphs(metrics, batch))
        if not quiet:
            loss = float(metrics["loss"])
            running_loss += loss * graph_counts[-1]
            running_graphs += graph_counts[-1]
            log_fun(f"   Step {step:4d} | batch loss {loss:.5f} "
                    f"| epoch avg {running_loss / max(running_graphs, 1):.5f}")
    results = [_to_host(m) for m in device_metrics]
    elapsed = max(time.time() - start, 1e-9)
    total_loss = sum(float(m["loss"]) * g
                     for m, g in zip(results, graph_counts))
    total_graphs = sum(graph_counts)
    return (state, total_loss / max(total_graphs, 1), total_graphs / elapsed,
            results)


def run_eval_epoch(
    eval_step,
    batches: Iterable[Tuple[GraphBatch, Dict[str, np.ndarray]]],
    device,
) -> Tuple[float, float, List[Dict[str, np.ndarray]]]:
    """One evaluation epoch over host batches; returns (per-graph average
    loss, graphs/s, per-batch host metrics)."""
    start = time.time()
    device_metrics: List[Dict[str, Any]] = []
    graph_counts: List[int] = []
    for batch, labels in device_prefetch(batches, device):
        metrics = eval_step(batch, labels)
        device_metrics.append(metrics)
        graph_counts.append(_num_graphs(metrics, batch))
    results = [_to_host(m) for m in device_metrics]
    elapsed = max(time.time() - start, 1e-9)
    total_loss = sum(float(m["loss"]) * g
                     for m, g in zip(results, graph_counts))
    total_graphs = sum(graph_counts)
    return total_loss / max(total_graphs, 1), total_graphs / elapsed, results


def train_loop(
    model: GraphTaskModel,
    state: TrainState,
    train_step,
    eval_step,
    dataset: GraphDataset,
    max_epochs: int,
    patience: int,
    log_fun: Callable[[str], None] = print,
    save_model_fun: Optional[Callable[[TrainState], None]] = None,
    epoch_metrics_fn: Optional[Callable] = None,
    quiet: bool = True,
    metrics_logger=None,
) -> Tuple[TrainState, float]:
    """Best-validation-metric training loop with early stopping (reference
    cli_utils/training_utils.py:40-100): an initial validation
    evaluation, a save at the start and on every improvement, a stop
    after ``patience`` epochs without one. Returns the final state and the
    best validation metric (lower is better)."""
    if epoch_metrics_fn is None:
        epoch_metrics_fn = model.compute_epoch_metrics
    device = _model_device(model)

    _, _, initial_results = run_eval_epoch(
        eval_step, dataset.batch_iterator(DataFold.VALIDATION), device)
    best_metric, best_str = epoch_metrics_fn(initial_results)
    log_fun(f"Initial valid metric: {best_str}.")
    if save_model_fun is not None:
        save_model_fun(state)
    best_epoch = 0
    train_start = time.time()

    for epoch in range(1, max_epochs + 1):
        log_fun(f"== Epoch {epoch}")
        state, train_loss, train_speed, train_results = run_train_epoch(
            train_step, state, dataset.batch_iterator(DataFold.TRAIN),
            device, quiet=quiet, log_fun=log_fun)
        train_metric, train_metric_str = epoch_metrics_fn(train_results)
        log_fun(f" Train:  {train_loss:.4f} loss | {train_metric_str} | "
                f"{train_speed:.2f} graphs/s")
        if metrics_logger is not None:
            metrics_logger.log_epoch(epoch, "train", train_loss, train_metric,
                                     train_metric_str, train_speed)
        valid_loss, valid_speed, valid_results = run_eval_epoch(
            eval_step, dataset.batch_iterator(DataFold.VALIDATION), device)
        valid_metric, valid_metric_str = epoch_metrics_fn(valid_results)
        log_fun(f" Valid:  {valid_loss:.4f} loss | {valid_metric_str} | "
                f"{valid_speed:.2f} graphs/s")
        if metrics_logger is not None:
            metrics_logger.log_epoch(epoch, "valid", valid_loss, valid_metric,
                                     valid_metric_str, valid_speed)

        if valid_metric < best_metric:
            log_fun(f"  (Best epoch so far, target metric decreased to "
                    f"{valid_metric:.5f} from {best_metric:.5f}.)")
            if save_model_fun is not None:
                save_model_fun(state)
            best_metric = valid_metric
            best_epoch = epoch
        elif epoch - best_epoch >= patience:
            total = time.time() - train_start
            log_fun(f"Stopping training after {patience} epochs without "
                    f"improvement on validation metric.")
            log_fun(f"Training took {total:.0f}s. Best validation metric: "
                    f"{best_metric}")
            break

    return state, best_metric


def build_training(model: GraphTaskModel, params: Dict[str, Any],
                   seed: int = 0):
    """Optimizer, state and steps for a model already built on its device
    (``from_params`` / ``from_dataset``): (state, train_step,
    eval_step)."""
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer, seed=seed)
    return state, make_train_step(model, optimizer), make_eval_step(model)
