"""Data parallelism over whole graphs (port of
``tf2_gnn_tpu/parallel/data_parallel.py``).

The host packs one padded batch per rank and stacks them on a leading
axis (``stack_batches``, ``shard_batches``: numpy, array-identical to the
JAX package's); each rank takes its own (``multiprocess.distribute_batch``)
and runs the step in its own process. The gradients are weighted by the
ranks' real graph counts, ``psum(g * graphs) / max(psum(graphs), 1)``, so
every graph counts alike, as one device on the concatenated batches would
weigh them; this is not DDP's uniform mean, so the model is not wrapped in
``DistributedDataParallel``. Parameters and optimizer state stay
replicated: every rank applies the same update to the same values.

Dropout draws from a generator per rank (seeded from the state's and the
rank's index); its masks cannot match JAX's ``fold_in`` draws.
"""
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional
from typing import Sequence, Tuple

import numpy as np
import torch

from ..data.graph_batch import GraphBatch
from . import collectives

# Metric keys that are additive counts -> psum; the others are per-batch
# means, weighted by the shard's real graph count.
_ADDITIVE_PREFIXES = ("num_", "batch_")


def make_mesh(devices: Optional[Sequence[int]] = None,
              axis_name: str = "data"):
    """1-D mesh over every rank (``devices``: their global ranks, all of
    them, in order), its one dimension named ``axis_name``; it becomes the
    current mesh of the collectives."""
    import torch.distributed as dist

    return collectives.build_mesh((dist.get_world_size(),), (axis_name,),
                                  devices)


def stack_batches(
    batches: Sequence[GraphBatch], labels: Sequence[Dict[str, np.ndarray]]
) -> Tuple[GraphBatch, Dict[str, np.ndarray]]:
    """Stack per-rank host (batch, labels) pairs along a new leading axis.

    All batches must share the same PaddingConfig-derived static shapes (the
    batcher guarantees this per fold).
    """
    if not batches:
        raise ValueError("Need at least one batch to stack.")
    stacked_labels = {k: np.stack([np.asarray(l[k]) for l in labels])
                      for k in labels[0]}
    return GraphBatch.stack(batches), stacked_labels


def shard_batches(
    batch_iter: Iterable[Tuple[GraphBatch, Dict[str, np.ndarray]]],
    num_shards: int,
) -> Iterator[Tuple[GraphBatch, Dict[str, np.ndarray]]]:
    """Group a single-device batch stream into stacked num_shards-wide steps.

    A trailing partial group is dropped (its graphs reappear next epoch in
    shuffled order), mirroring standard DP semantics.
    """
    group: List[Tuple[GraphBatch, Dict[str, np.ndarray]]] = []
    for item in batch_iter:
        group.append(item)
        if len(group) == num_shards:
            yield stack_batches([b for b, _ in group], [l for _, l in group])
            group = []


def _metric_tensor(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=torch.float32)
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def _combine_metrics(metrics: Dict[str, Any], axis_name: str,
                     local_graphs: float) -> Dict[str, torch.Tensor]:
    """Reduce per-rank metric dicts into global ones, in one psum.

    Count-like keys are summed; mean-like keys (loss, accuracy, f1, ...) are
    combined as a graph-count-weighted mean so the result equals what a
    single device would have computed on the concatenated batch.
    """
    device = collectives.process_device()
    keys = list(metrics)
    graphs = torch.tensor(local_graphs, dtype=torch.float32, device=device)
    values = []
    for key in keys:
        value = _metric_tensor(metrics[key], device)
        values.append(value if key.startswith(_ADDITIVE_PREFIXES)
                      else value * graphs)
    summed = collectives.psum_flat(values + [graphs], axis_name)
    total = torch.clamp(summed[-1], min=1.0)
    return {key: (value if key.startswith(_ADDITIVE_PREFIXES)
                  else value / total)
            for key, value in zip(keys, summed[:-1])}


def rank_generator(state, index: int) -> torch.Generator:
    """A dropout generator for shard ``index`` of the state's step, seeded
    from the state's generator and the index (the JAX package folds the
    index into its key)."""
    seed = state.generator.initial_seed() + 10007 * (index + 1)
    return torch.Generator(device=state.generator.device).manual_seed(seed)


def _params(model) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def _gradients(model) -> List[torch.Tensor]:
    """Every parameter's gradient in f32 (zeros where none flowed)."""
    return [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
            else p.grad.float() for p in _params(model)]


def _set_gradients(model, grads: Sequence[torch.Tensor]) -> None:
    for p, g in zip(_params(model), grads):
        p.grad = g.to(p.dtype)


def weight_gradients(model, axis_name: str, local_graphs: float) -> None:
    """Replace each gradient ``g`` by ``psum(g * graphs) /
    max(psum(graphs), 1)`` over ``axis_name``, in one psum."""
    device = collectives.process_device()
    graphs = torch.tensor(local_graphs, dtype=torch.float32, device=device)
    summed = collectives.psum_flat(
        [g * graphs for g in _gradients(model)] + [graphs], axis_name)
    total = torch.clamp(summed[-1], min=1.0)
    _set_gradients(model, [g / total for g in summed[:-1]])


def mean_gradients(model, axis_name: str) -> None:
    """Replace each gradient by its mean over ``axis_name`` (``pmean``), in
    one psum."""
    size = collectives.axis_size(axis_name)
    summed = collectives.psum_flat(_gradients(model), axis_name)
    _set_gradients(model, [g / size for g in summed])


def _detached(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def local_grads(model, optimizer, batch: GraphBatch,
                labels: Dict[str, torch.Tensor],
                generator: torch.Generator) -> Dict[str, Any]:
    """One forward and backward of this rank's batch: the gradients stay in
    the parameters' ``.grad``; returns the metrics."""
    model.train()
    optimizer.zero_grad()
    task_output = model(batch, True, generator)
    metrics = model.compute_task_metrics(batch, task_output, labels)
    metrics["loss"].backward()
    return metrics


def make_dp_train_step(model, optimizer, mesh, axis_name: str = "data"
                       ) -> Callable:
    """A data-parallel train step over ``mesh``: (TrainState, this rank's
    batch, labels) -> (TrainState, metrics). Each rank runs it in its own
    process on its own batch (``distribute_batch`` of a stacked one); the
    gradients and the metrics are combined weighted by graph count, then
    every rank applies the same update."""
    generators: Dict[int, torch.Generator] = {}

    def train_step(state, batch: GraphBatch, labels):
        collectives.use_mesh(mesh)
        index = collectives.axis_index(axis_name)
        gen = generators.setdefault(id(state), rank_generator(state, index))
        metrics = local_grads(model, optimizer, batch, labels, gen)
        local_graphs = float(batch.num_graphs)
        weight_gradients(model, axis_name, local_graphs)
        optimizer.step(state.step)
        state.step += 1
        return state, _combine_metrics(_detached(metrics), axis_name,
                                       local_graphs)

    return train_step


def make_dp_eval_step(model, mesh, axis_name: str = "data") -> Callable:
    """Data-parallel eval step: (this rank's batch, labels) -> the
    combined metrics, no dropout and no gradients."""

    def eval_step(batch: GraphBatch, labels):
        collectives.use_mesh(mesh)
        model.eval()
        with torch.no_grad():
            task_output = model(batch, False)
            metrics = model.compute_task_metrics(batch, task_output, labels)
            return _combine_metrics(metrics, axis_name,
                                    float(batch.num_graphs))

    return eval_step
