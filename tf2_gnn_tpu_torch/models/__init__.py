"""Task models (port of ``tf2_gnn_tpu/models``: node multiclass, graph
regression and binary classification, QM9 regression)."""
from .graph_binary_classification_task import GraphBinaryClassificationTask
from .graph_regression_task import GraphRegressionTask
from .graph_task_model import GraphTaskModel
from .node_multiclass_task import NodeMulticlassTask
from .qm9_regression_task import QM9RegressionTask

__all__ = ["GraphBinaryClassificationTask", "GraphRegressionTask",
           "GraphTaskModel", "NodeMulticlassTask", "QM9RegressionTask"]
