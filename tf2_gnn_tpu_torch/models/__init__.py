"""Task models (port of ``tf2_gnn_tpu/models``: node multiclass, graph
regression and binary classification, QM9 regression) and the name ->
class registry."""
from typing import Dict, Type

from .graph_binary_classification_task import GraphBinaryClassificationTask
from .graph_regression_task import GraphRegressionTask
from .graph_task_model import GraphTaskModel
from .node_multiclass_task import NodeMulticlassTask, masked_micro_f1
from .qm9_regression_task import (
    CHEMICAL_ACC_NORMALISING_FACTORS,
    QM9RegressionTask,
)

# Name -> class registry (the JAX package's; the port's checkpoints pickle
# the classes themselves).
MODEL_CLASSES: Dict[str, Type[GraphTaskModel]] = {
    cls.__name__: cls
    for cls in (
        NodeMulticlassTask,
        GraphRegressionTask,
        GraphBinaryClassificationTask,
        QM9RegressionTask,
    )
}


def get_model_class(name: str) -> Type[GraphTaskModel]:
    cls = MODEL_CLASSES.get(name)
    if cls is None:
        raise ValueError(f"Unknown model class '{name}'. Known: "
                         f"{sorted(MODEL_CLASSES)}")
    return cls


def register_model_class(cls) -> None:
    MODEL_CLASSES[cls.__name__] = cls


__all__ = [
    "GraphTaskModel",
    "NodeMulticlassTask",
    "GraphRegressionTask",
    "GraphBinaryClassificationTask",
    "QM9RegressionTask",
    "CHEMICAL_ACC_NORMALISING_FACTORS",
    "MODEL_CLASSES",
    "get_model_class",
    "register_model_class",
    "masked_micro_f1",
]
