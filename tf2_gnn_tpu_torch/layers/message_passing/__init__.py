"""Message-passing flavours + registry (port of
``tf2_gnn_tpu/layers/message_passing``): RGCN, GGNN, RGIN, RGAT,
GNN_Edge_MLP (the source-only form and the target-state forms with 0 and
with one hidden layer) and GNN-FiLM."""
from .base import (
    MESSAGE_PASSING_IMPLEMENTATIONS,
    MessagePassing,
    calculate_type_to_num_incoming_edges,
    get_known_message_passing_classes,
    get_message_passing_class,
    register_message_passing_implementation,
)
from .typed_linear import TypedLinear
from .gnn_edge_mlp import GNN_Edge_MLP
from .rgcn import RGCN
from .ggnn import GGNN
from .rgin import RGIN
from .gnn_film import GNN_FiLM
from .rgat import RGAT

__all__ = [
    "MESSAGE_PASSING_IMPLEMENTATIONS",
    "MessagePassing",
    "TypedLinear",
    "calculate_type_to_num_incoming_edges",
    "get_known_message_passing_classes",
    "get_message_passing_class",
    "register_message_passing_implementation",
    "GGNN",
    "GNN_Edge_MLP",
    "GNN_FiLM",
    "RGAT",
    "RGCN",
    "RGIN",
]
