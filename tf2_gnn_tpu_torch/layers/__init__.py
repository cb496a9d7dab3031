"""GNN layers (port of ``tf2_gnn_tpu/layers``; reference: tf2_gnn/layers)."""
from .gnn import GNN
from .gnn_input import GNNInput, batch_from_gnn_input
from .global_exchange import (
    GraphGlobalExchange,
    GraphGlobalGRUExchange,
    GraphGlobalMeanExchange,
    GraphGlobalMLPExchange,
    get_global_exchange_class,
)
from .mlp import MLP
from .readout import WASGraphRepresentation, WeightedSumGraphRepresentation
from .message_passing import (
    MESSAGE_PASSING_IMPLEMENTATIONS,
    GGNN,
    GNN_Edge_MLP,
    GNN_FiLM,
    MessagePassing,
    RGAT,
    RGCN,
    RGIN,
    TypedLinear,
    calculate_type_to_num_incoming_edges,
    get_known_message_passing_classes,
    get_message_passing_class,
    register_message_passing_implementation,
)

__all__ = [
    "GNNInput",
    "batch_from_gnn_input",
    "GNN",
    "MLP",
    "GraphGlobalExchange",
    "GraphGlobalGRUExchange",
    "GraphGlobalMeanExchange",
    "GraphGlobalMLPExchange",
    "get_global_exchange_class",
    "WASGraphRepresentation",
    "WeightedSumGraphRepresentation",
    "MESSAGE_PASSING_IMPLEMENTATIONS",
    "GGNN",
    "GNN_Edge_MLP",
    "GNN_FiLM",
    "MessagePassing",
    "RGAT",
    "RGCN",
    "RGIN",
    "TypedLinear",
    "calculate_type_to_num_incoming_edges",
    "get_known_message_passing_classes",
    "get_message_passing_class",
    "register_message_passing_implementation",
]
