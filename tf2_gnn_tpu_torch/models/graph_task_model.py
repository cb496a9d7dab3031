"""Abstract task model: GNN encoder + task head + metric functions (port of
``tf2_gnn_tpu/models/graph_task_model.py``).

GNN hypers ride the flat task dict with a ``gnn_`` prefix, stripped when
the encoder is built (reference graph_task_model.py:94-97). The encoder is
the submodule ``gnn``, so parameter names follow the flax tree
(``gnn.mp_layer_0.edge_mlp_layer_0.kernel`` for
``gnn/mp_layer_0/edge_mlp_layer_0/kernel``). With
``use_intermediate_gnn_results`` the head receives ``(final, all
representations)``, the second the initial projection's output and every
message-passing layer's (reference graph_task_model.py:95-111).
"""
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..data.graph_batch import GraphBatch
from ..layers.gnn import GNN
from ..utils import tracing
from ..utils.device import resolve_device


class GraphTaskModel(nn.Module):
    """Encode with a GNN, then compute a task output."""

    def __init__(self, params: Dict[str, Any], input_dim: int,
                 num_edge_types: int):
        super().__init__()
        gnn_params = {key[len("gnn_"):]: value for key, value in params.items()
                      if key.startswith("gnn_")}
        self.gnn = GNN.from_params(gnn_params, input_dim, num_edge_types)
        self.use_intermediate_gnn_results = bool(
            params.get("use_intermediate_gnn_results", False))

    @classmethod
    def get_default_hyperparameters(
            cls, mp_style: Optional[str] = None) -> Dict[str, Any]:
        params = {
            f"gnn_{name}": value
            for name, value in GNN.get_default_hyperparameters(mp_style).items()
        }
        params.update(
            {
                "optimizer": "Adam",  # One of "SGD", "RMSProp", "Adam"
                "learning_rate": 0.001,
                "learning_rate_warmup_steps": None,
                "learning_rate_decay_steps": None,
                "momentum": 0.85,
                "rmsprop_rho": 0.98,
                "gradient_clip_value": None,
                "gradient_clip_norm": None,
                "gradient_clip_global_norm": None,
                "use_intermediate_gnn_results": False,
            }
        )
        return params

    @classmethod
    def from_params(cls, params: Dict[str, Any], input_dim: int,
                    num_edge_types: int, device="cuda", seed: int = 0,
                    **task_kwargs) -> "GraphTaskModel":
        """Build from the flat task hyperparameter dict, initialise the
        weights from ``seed`` and move the model to ``device``."""
        dev = resolve_device(device)
        model = cls(params, input_dim, num_edge_types, **task_kwargs)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(dev)

    @classmethod
    def from_dataset(cls, params: Dict[str, Any], dataset, device="cuda",
                     seed: int = 0) -> "GraphTaskModel":
        """``from_params`` with the dimensions the dataset holds: the node
        feature width, the edge type count and the task's own
        (``_dataset_kwargs``), as the reference's ``from_params(params,
        dataset)`` reads them."""
        return cls.from_params(
            params, input_dim=int(dataset.node_feature_shape[-1]),
            num_edge_types=dataset.num_edge_types, device=device, seed=seed,
            **cls._dataset_kwargs(params, dataset))

    @classmethod
    def _dataset_kwargs(cls, params: Dict[str, Any],
                        dataset) -> Dict[str, Any]:
        return {}

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.gnn.reset_parameters(generator)

    def compute_task_output(self, batch: GraphBatch, node_representations,
                            training: bool,
                            generator: Optional[torch.Generator] = None):
        """The task output from the final [V, H] node states, or from the
        pair (final, all representations) when
        ``use_intermediate_gnn_results`` is set; ``generator`` draws the
        head's dropout masks in training."""
        raise NotImplementedError()

    def compute_initial_node_features(
            self, batch: GraphBatch, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The GNN's input node features; subclasses override it to build
        their own (JAX graph_task_model.py:85-88, 102-104)."""
        return batch.node_features

    def forward(self, batch: GraphBatch, training: bool = False,
                generator: Optional[torch.Generator] = None):
        initial = self.compute_initial_node_features(batch, training,
                                                     generator)
        if initial is not batch.node_features:
            batch = batch.replace(node_features=initial)
        final, all_reprs = self.gnn(batch, training, generator)
        representations = ((final, all_reprs)
                           if self.use_intermediate_gnn_results else final)
        with tracing.span("gnn.readout"):
            return self.compute_task_output(batch, representations,
                                            training, generator)

    @staticmethod
    def compute_task_metrics(batch: GraphBatch, task_output,
                             labels: Dict[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
        """Per-batch loss/metrics; must contain key "loss"."""
        raise NotImplementedError()

    @staticmethod
    def compute_epoch_metrics(task_results: List[Dict[str, Any]]
                              ) -> Tuple[float, str]:
        """Host-side epoch reduction of the per-batch metrics -> (metric
        where lower is better, text)."""
        raise NotImplementedError()
