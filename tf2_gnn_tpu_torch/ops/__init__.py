"""Ops: activations, GRU, segment reductions, and the plan-driven SpMMs
with their hand-written CUDA kernels (``pair_spmm``, ``pair_attention``,
``pair_edge_mlp``, ``sorted_spmm``, ``probes``; import those modules
directly)."""
from .activations import (
    gelu,
    get_activation_function,
    get_known_activation_names,
)
from .gru import GRUCell
from .segment import (
    gather_rows,
    get_aggregation_function,
    get_known_aggregation_names,
    segment_count,
    segment_log_softmax,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sqrt_n,
    segment_sum,
)

__all__ = [
    "gelu",
    "get_activation_function",
    "get_known_activation_names",
    "GRUCell",
    "gather_rows",
    "get_aggregation_function",
    "get_known_aggregation_names",
    "segment_count",
    "segment_log_softmax",
    "segment_max",
    "segment_mean",
    "segment_softmax",
    "segment_sqrt_n",
    "segment_sum",
]
