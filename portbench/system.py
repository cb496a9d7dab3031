"""The system under test: the port's data layer, model, optimizer and
training step, built from a configuration file and the generator's draws.

Only this module and the per-layer metric readers touch
``tf2_gnn_tpu_torch``. The data layer sees the draws as a dataset of
graphs (``DrawnGraphs``, a ``GraphDataset`` in the benchmark's own file):
it derives its padding and chunk budgets from every loaded graph, packs
the graphs in order with the C++ engine and plans each batch, as the
command line does for a TRAIN fold. The weights are the benchmark's,
drawn on the device from the seed in one call; the reference receives the
same tensors.
"""
import math
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from tf2_gnn_tpu_torch import models as program_models
from tf2_gnn_tpu_torch.data import DataFold, GraphDataset, GraphSample
from tf2_gnn_tpu_torch.data.graph_batch import (
    pad_graph_label_array,
    pad_node_label_array,
)
from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    TrainState,
    make_train_step,
    to_device,
)

from .generator import Draw, split_graphs


class DrawnGraphs(GraphDataset):
    """The draws' graphs as one TRAIN fold, iterated in draw order."""

    def __init__(self, params: Dict[str, Any], draws: Sequence[Draw]):
        super().__init__(params)
        self._num_types = len(draws[0].edges)
        self._feature_dim = int(draws[0].node_features.shape[1])
        self._node_task = draws[0].node_labels is not None
        self._graphs: List[GraphSample] = []
        for draw in draws:
            degrees = np.stack([
                np.bincount(adj[:, 1], minlength=draw.num_nodes)
                for adj in draw.edges]).astype(np.int32)
            per_graph = np.split(degrees, np.cumsum(draw.graph_nodes)[:-1],
                                 axis=1)
            for (features, adjacency, label), in_degrees in zip(
                    split_graphs(draw), per_graph):
                sample = GraphSample(adjacency,
                                     np.ascontiguousarray(in_degrees),
                                     features)
                sample.label = label
                self._graphs.append(sample)

    @property
    def num_edge_types(self) -> int:
        return self._num_types

    @property
    def node_feature_shape(self) -> Tuple:
        return (self._feature_dim,)

    def load_data(self, path, folds_to_load=None) -> None:
        raise NotImplementedError("the draws are loaded at construction")

    def _graph_iterator(self, data_fold: DataFold):
        return iter(self._graphs)

    def _loaded_folds(self):
        return [DataFold.TRAIN]

    def _graphs_in_fold(self, fold: DataFold):
        return self._graphs

    def _batch_label_arrays(self, batch_graphs, config):
        if self._node_task:
            labels = np.concatenate([g.label for g in batch_graphs])
            return {"node_labels": pad_node_label_array(labels,
                                                        config.num_nodes)}
        targets = np.asarray([g.label for g in batch_graphs], np.float32)
        return {"target_value": pad_graph_label_array(targets,
                                                      config.num_graphs)}


def dataset_params(config: Dict[str, Any]) -> Dict[str, Any]:
    params = GraphDataset.get_default_hyperparameters()
    params.update(config["task_params"])
    return params


def model_params(config: Dict[str, Any]) -> Dict[str, Any]:
    """The task's defaults for the flavour, then the file's ``assumed``
    values, then its ``model_params``: the hyperparameters as run."""
    task = getattr(program_models, config["task"])
    params = task.get_default_hyperparameters(config["flavour"])
    params.update(config["assumed"]["model"])
    params.update(config["model_params"])
    return params


def prepare_batches(config, draws, device) -> Tuple[list, List[float]]:
    """The draws packed, padded, planned and moved by the port's data layer:
    ``[(batch, labels)]`` on ``device`` in draw order, and the host ms each
    batch took (pack, pad and plan, then the move, synchronised)."""
    dataset = DrawnGraphs(dataset_params(config), draws)
    batches, prep_ms = [], []
    iterator = dataset.batch_iterator(DataFold.TRAIN)
    while True:
        start = time.perf_counter()
        try:
            host_batch, host_labels = next(iterator)
        except StopIteration:
            break
        moved = to_device(host_batch, host_labels, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prep_ms.append((time.perf_counter() - start) * 1e3)
        batches.append(moved)
    for (batch, _), draw in zip(batches, draws):
        if (batch.num_nodes, batch.num_graphs) != (draw.num_nodes,
                                                   draw.num_graphs):
            raise RuntimeError(
                f"the data layer packed {batch.num_graphs} graphs of "
                f"{batch.num_nodes} nodes where the traffic sized a draw of "
                f"{draw.num_graphs} graphs of {draw.num_nodes} nodes to one "
                "batch; resize the traffic to the configuration's budget")
    if len(batches) != len(draws):
        raise RuntimeError(f"{len(draws)} draws packed into {len(batches)} "
                           "batches")
    return batches, prep_ms


def glorot_limit(shape: Sequence[int]) -> float:
    """sqrt(6 / (fan_in + fan_out)) over the last two axes (a stacked
    [L, in, out] kernel takes its per-type fans)."""
    return math.sqrt(6.0 / (shape[-2] + shape[-1]))


def initial_weights(shapes: Dict[str, Sequence[int]], seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """Weights by parameter name, drawn on ``device`` in one call from a
    generator seeded with ``seed``: glorot-uniform matrices, zero biases,
    unit scales (1-D parameters named ``weight``, LayerNorm's)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    uniform = torch.rand(total, generator=generator, device=device)
    weights, start = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        if len(shape) >= 2:
            limit = glorot_limit(shape)
            value = uniform[start:start + size].reshape(shape) * (
                2.0 * limit) - limit
        elif name.endswith("weight"):
            value = torch.ones(shape, device=device)
        else:
            value = torch.zeros(shape, device=device)
        weights[name] = value
        start += size
    return weights


def build_model(config: Dict[str, Any], draws: Sequence[Draw]):
    """The task model, its parameters on the meta device (no storage, no
    initialisation): ``to_empty`` places it."""
    task = getattr(program_models, config["task"])
    kwargs = {}
    if draws[0].node_labels is not None:
        kwargs["num_labels"] = int(draws[0].node_labels.shape[1])
    with torch.device("meta"):
        return task(model_params(config),
                    int(draws[0].node_features.shape[1]),
                    len(draws[0].edges), **kwargs)


def parameter_shapes(config, draws) -> Dict[str, Tuple[int, ...]]:
    model = build_model(config, draws)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def build_training(config, draws, weights: Dict[str, torch.Tensor],
                   dropout_seed: int, device):
    """(state, train_step): the model loaded with ``weights``, its
    optimizer, a ``TrainState`` whose dropout generator is seeded with
    ``dropout_seed``, and ``make_train_step``'s step."""
    model = build_model(config, draws).to_empty(device=device)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(weights[name])
    optimizer = make_optimizer(model_params(config), model.parameters())
    generator = torch.Generator(device=device).manual_seed(dropout_seed)
    state = TrainState(step=0, model=model, optimizer=optimizer,
                       generator=generator)
    return state, make_train_step(model, optimizer)


def first_gradients(state) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient as the optimizer received it, worked out
    from its state after one update: Adam's first moment over
    (1 - beta1); RMSProp's momentum trace, which holds the first update
    ``-lr * g / sqrt(nu + eps)``, times ``-sqrt(nu + eps) / lr``. A leaf
    without state reads 0."""
    torch_optimizer = state.optimizer.torch_optimizer
    group_of = {id(p): g for g in torch_optimizer.param_groups
                for p in g["params"]}
    grads = {}
    for name, param in state.model.named_parameters():
        slots = torch_optimizer.state.get(param, {})
        group = group_of[id(param)]
        if "exp_avg" in slots:
            grads[name] = slots["exp_avg"] / (1.0 - group["betas"][0])
        elif "nu" in slots and "trace" in slots:
            grads[name] = -slots["trace"] * torch.sqrt(
                slots["nu"] + group["eps"]) / group["lr"]
        elif slots:
            raise RuntimeError(f"unknown optimizer state {sorted(slots)}")
        else:
            grads[name] = torch.zeros_like(param)
        grads[name] = grads[name].detach().clone()
    return grads


def changes(state, initial: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Each leaf's change from ``initial``."""
    return {name: param.detach() - initial[name]
            for name, param in state.model.named_parameters()}
