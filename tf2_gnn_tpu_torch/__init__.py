"""PyTorch + CUDA port of ``tf2_gnn_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths
(``data/graph_batch.py``, ``ops/pair_spmm.py``, ``layers/gnn.py``, ...) and
its public names, so each counterpart is easy to find. It imports torch
and numpy only.

Entry points default to ``device="cuda"`` and raise when no card is present;
the CPU runs only when the caller asks for it (``device="cpu"``), as the
tests do. On CPU tensors the hand-written kernels' plain PyTorch versions
run; on CUDA tensors the kernels launch or raise.
"""

__version__ = "0.1.0"

from .data import DataFold, GraphBatch, GraphDataset, GraphSample, PaddingConfig
from .layers import (
    GNN,
    GGNN,
    GNN_Edge_MLP,
    GNN_FiLM,
    MessagePassing,
    RGAT,
    RGCN,
    RGIN,
    WASGraphRepresentation,
    WeightedSumGraphRepresentation,
    get_known_message_passing_classes,
    get_message_passing_class,
    register_message_passing_implementation,
)

from .harness import (
    get_known_tasks,
    register_task,
    run_train_from_args,
    save_model,
    test_model,
    train_loop,
)
from .models import (
    GraphBinaryClassificationTask,
    GraphRegressionTask,
    GraphTaskModel,
    NodeMulticlassTask,
    QM9RegressionTask,
)

__all__ = [
    "GraphBinaryClassificationTask",
    "GraphRegressionTask",
    "GraphTaskModel",
    "NodeMulticlassTask",
    "QM9RegressionTask",
    "get_known_tasks",
    "register_task",
    "run_train_from_args",
    "save_model",
    "test_model",
    "train_loop",
    "DataFold",
    "GraphBatch",
    "GraphDataset",
    "GraphSample",
    "PaddingConfig",
    "GNN",
    "GGNN",
    "GNN_Edge_MLP",
    "GNN_FiLM",
    "MessagePassing",
    "RGAT",
    "RGCN",
    "RGIN",
    "WASGraphRepresentation",
    "WeightedSumGraphRepresentation",
    "get_known_message_passing_classes",
    "get_message_passing_class",
    "register_message_passing_implementation",
]
