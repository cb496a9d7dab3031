"""Message-passing flavours + registry (port of
``tf2_gnn_tpu/layers/message_passing``; RGCN, GNN_Edge_MLP (the
source-only form and the target-state form with one hidden layer) and RGAT
so far)."""
from .base import (
    MESSAGE_PASSING_IMPLEMENTATIONS,
    MessagePassing,
    get_message_passing_class,
    register_message_passing_implementation,
)
from .typed_linear import TypedLinear
from .gnn_edge_mlp import GNN_Edge_MLP
from .rgcn import RGCN
from .rgat import RGAT

__all__ = [
    "MESSAGE_PASSING_IMPLEMENTATIONS",
    "MessagePassing",
    "TypedLinear",
    "get_message_passing_class",
    "register_message_passing_implementation",
    "GNN_Edge_MLP",
    "RGAT",
    "RGCN",
]
