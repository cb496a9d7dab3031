"""Data engine: preprocessing, padded batching and the dataset loaders
(port of ``tf2_gnn_tpu/data``)."""
from .graph_batch import (
    GraphBatch,
    PaddingConfig,
    pad_batch_arrays,
    pad_graph_label_array,
    pad_node_label_array,
)
from .graph_dataset import DataFold, GraphDataset, GraphSample
from .jsonl_dataset import JsonLGraphDataset
from .jsonl_property_dataset import (
    GraphWithPropertySample,
    JsonLGraphPropertyDataset,
)
from .ppi_dataset import PPIDataset, PPIGraphSample
from .preprocess import (
    compute_number_of_edge_types,
    get_tied_edge_types,
    process_adjacency_lists,
)
from .qm9_dataset import QM9Dataset, QM9GraphSample

__all__ = [
    "GraphBatch",
    "PaddingConfig",
    "pad_batch_arrays",
    "pad_graph_label_array",
    "pad_node_label_array",
    "DataFold",
    "GraphDataset",
    "GraphSample",
    "JsonLGraphDataset",
    "JsonLGraphPropertyDataset",
    "GraphWithPropertySample",
    "PPIDataset",
    "PPIGraphSample",
    "QM9Dataset",
    "QM9GraphSample",
    "compute_number_of_edge_types",
    "get_tied_edge_types",
    "process_adjacency_lists",
]
