"""Training core: TrainState and the train/eval steps (port of
``tf2_gnn_tpu/harness/training.py``'s ``create_train_state``,
``make_train_step`` and ``make_eval_step``).

PyTorch runs eagerly, so the steps are plain functions; the state is
updated in place and also returned, mirroring the reference's functional
signature. Dropout draws from an explicit ``torch.Generator`` on the
model's device, seeded with ``seed + 1`` (the reference splits its dropout
keys from ``PRNGKey(seed + 1)``; the bits differ between the frameworks).
"""
import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..data.graph_batch import GraphBatch
from ..models.graph_task_model import GraphTaskModel
from .optimizers import Optimizer


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
