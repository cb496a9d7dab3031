"""Task models (port of ``tf2_gnn_tpu/models``; node multiclass so far)."""
from .graph_task_model import GraphTaskModel
from .node_multiclass_task import NodeMulticlassTask

__all__ = ["GraphTaskModel", "NodeMulticlassTask"]
