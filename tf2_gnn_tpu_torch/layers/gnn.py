"""GNN encoder stack (port of ``tf2_gnn_tpu/layers/gnn.py``).

Stacks ``num_layers`` message-passing layers over a padded GraphBatch in the
reference order (gnn.py:116-180):

1. initial projection [V, D] -> [V, H] + activation,
2. per layer: input dropout (training), mean residual every k layers
   (``(cur + last) / 2``; at layer 0 it only records ``last``), the MP
   layer, a graph-global exchange every k layers but never at layer 0,
   optional LayerNorm (Keras epsilon 1e-3), dense layer every k layers
   (*including* layer 0),
3. returns the final [V, H] plus all MP outputs (captured raw, before the
   exchange).

With ``use_remat`` each message-passing layer runs under
``torch.utils.checkpoint`` (the reference's ``nn.remat`` around the layer):
its activations are dropped after the forward and recomputed in the
backward, so the layer's forward kernels launch twice a train step. The
checkpointed region draws no random numbers (the layers take no
generator; the input dropout before them draws from the caller's
generator outside the region), so the recompute is exact.
"""
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.graph_batch import GraphBatch
from ..ops.activations import get_activation_function
from .dropout import dropout
from .global_exchange import get_global_exchange_class
from ..utils.init import init_dense_
from .message_passing import get_message_passing_class

_GNN_HYPERS = (
    "message_calculation_class", "hidden_dim", "num_layers",
    "dense_every_num_layers", "residual_every_num_layers",
    "use_inter_layer_layernorm", "initial_node_representation_activation",
    "dense_intermediate_layer_activation", "layer_input_dropout_rate",
    "use_remat", "global_exchange_mode", "global_exchange_every_num_layers",
    "global_exchange_weighting_fun", "global_exchange_num_heads",
    "global_exchange_dropout_rate",
)


class GNN(nn.Module):
    def __init__(self, input_dim: int, num_edge_types: int,
                 message_calculation_class: str = "rgcn",
                 hidden_dim: int = 16,
                 num_layers: int = 4,
                 dense_every_num_layers: int = 2,
                 residual_every_num_layers: int = 2,
                 use_inter_layer_layernorm: bool = False,
                 initial_node_representation_activation: str = "tanh",
                 dense_intermediate_layer_activation: str = "tanh",
                 layer_input_dropout_rate: float = 0.0,
                 use_remat: bool = False,
                 global_exchange_mode: str = "gru",
                 global_exchange_every_num_layers: int = 2,
                 global_exchange_weighting_fun: str = "softmax",
                 global_exchange_num_heads: int = 4,
                 global_exchange_dropout_rate: float = 0.2,
                 mp_hypers: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.use_remat = use_remat
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.dense_every_num_layers = dense_every_num_layers
        self.residual_every_num_layers = residual_every_num_layers
        self.use_inter_layer_layernorm = use_inter_layer_layernorm
        self.layer_input_dropout_rate = layer_input_dropout_rate
        self.initial_act = get_activation_function(
            initial_node_representation_activation)
        self.dense_act = get_activation_function(
            dense_intermediate_layer_activation)

        self.initial_node_projection = nn.Linear(input_dim, hidden_dim,
                                                 bias=False)
        mp_class = get_message_passing_class(message_calculation_class)
        mp_params = dict(mp_hypers or {})
        mp_params["hidden_dim"] = hidden_dim
        # Global exchange every k layers, never at layer 0 (reference
        # gnn.py:307-315).
        self.exchange_layers = tuple(
            i for i in range(num_layers)
            if i and i % global_exchange_every_num_layers == 0)
        for i in range(num_layers):
            self.add_module(f"mp_layer_{i}", mp_class.from_params(
                mp_params, num_edge_types=num_edge_types,
                input_dim=hidden_dim))
            if i in self.exchange_layers:
                exchange_class = get_global_exchange_class(
                    global_exchange_mode)
                self.add_module(f"global_exchange_{i}", exchange_class(
                    hidden_dim, weighting_fun=global_exchange_weighting_fun,
                    num_heads=global_exchange_num_heads,
                    dropout_rate=global_exchange_dropout_rate))
            if use_inter_layer_layernorm:
                # Keras LayerNormalization defaults to epsilon=1e-3.
                self.add_module(f"layernorm_{i}",
                                nn.LayerNorm(hidden_dim, eps=1e-3))
            if i % dense_every_num_layers == 0:
                self.add_module(f"dense_{i}",
                                nn.Linear(hidden_dim, hidden_dim, bias=False))

    @classmethod
    def get_default_hyperparameters(
            cls, mp_style: Optional[str] = None) -> Dict[str, Any]:
        """Flat default hyperparameter dict; merges the chosen MP flavour's
        defaults under the same namespace (reference gnn.py:53-79)."""
        these_hypers: Dict[str, Any] = {
            "message_calculation_class": mp_style or "rgcn",
            "initial_node_representation_activation": "tanh",
            "dense_intermediate_layer_activation": "tanh",
            "num_layers": 4,
            "dense_every_num_layers": 2,
            "residual_every_num_layers": 2,
            "use_inter_layer_layernorm": False,
            "hidden_dim": 16,
            "layer_input_dropout_rate": 0.0,
            "use_remat": False,
            "global_exchange_mode": "gru",
            "global_exchange_every_num_layers": 2,
            "global_exchange_weighting_fun": "softmax",
            "global_exchange_num_heads": 4,
            "global_exchange_dropout_rate": 0.2,
        }
        mp_class = get_message_passing_class(
            these_hypers["message_calculation_class"])
        params = mp_class.get_default_hyperparameters()
        params.update(these_hypers)
        return params

    @classmethod
    def from_params(cls, params: Dict[str, Any], input_dim: int,
                    num_edge_types: int) -> "GNN":
        """Build from a flat hyperparameter dict (GNN + MP hypers mixed)."""
        gnn_kwargs = {k: v for k, v in params.items() if k in _GNN_HYPERS}
        mp_hypers = {k: v for k, v in params.items() if k not in _GNN_HYPERS}
        return cls(input_dim, num_edge_types, mp_hypers=mp_hypers,
                   **gnn_kwargs)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_dense_(self.initial_node_projection, generator)
        for i in range(self.num_layers):
            getattr(self, f"mp_layer_{i}").reset_parameters(generator)
            if i in self.exchange_layers:
                getattr(self, f"global_exchange_{i}").reset_parameters(
                    generator)
            if self.use_inter_layer_layernorm:
                getattr(self, f"layernorm_{i}").reset_parameters()
            if i % self.dense_every_num_layers == 0:
                init_dense_(getattr(self, f"dense_{i}"), generator)

    def forward(self, batch: GraphBatch, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        use_dropout = training and self.layer_input_dropout_rate > 0.0
        if use_dropout and generator is None:
            raise ValueError("training with input dropout needs an explicit "
                             "torch.Generator")
        cur = self.initial_act(
            self.initial_node_projection(batch.node_features))
        last = cur
        all_reprs = [cur]
        for layer_idx in range(self.num_layers):
            if use_dropout:
                cur = dropout(cur, self.layer_input_dropout_rate, generator)

            # Mean residual every k layers (reference gnn.py:291-296).
            if layer_idx % self.residual_every_num_layers == 0:
                tmp = cur
                if layer_idx > 0:
                    cur = (cur + last) / 2.0
                last = tmp

            layer = getattr(self, f"mp_layer_{layer_idx}")
            if self.use_remat and torch.is_grad_enabled():
                cur = checkpoint(layer, cur, batch, training,
                                 use_reentrant=False)
            else:
                cur = layer(cur, batch, training)
            # Intermediate representations are captured before
            # exchange/layernorm/dense (reference gnn.py:305).
            all_reprs.append(cur)

            if layer_idx in self.exchange_layers:
                cur = getattr(self, f"global_exchange_{layer_idx}")(
                    cur, batch.node_to_graph, batch.num_graphs_padded,
                    training, generator, batch.spmd_axis)

            if self.use_inter_layer_layernorm:
                cur = getattr(self, f"layernorm_{layer_idx}")(cur)

            # Dense layer every k layers, *including* layer 0
            # (reference gnn.py:324-327).
            if layer_idx % self.dense_every_num_layers == 0:
                cur = self.dense_act(getattr(self, f"dense_{layer_idx}")(cur))

        return cur, tuple(all_reprs)
