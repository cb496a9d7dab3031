"""Task registry: name -> (dataset class/params, model class/params) (port
of ``tf2_gnn_tpu/harness/tasks.py`` over the port's classes).

Reference: tf2_gnn/cli_utils/task_utils.py:23-98. The four built-in tasks are
registered at import; users add their own with ``register_task``.
"""
from typing import Any, Dict, List, NamedTuple, Optional, Type

from ..data.graph_dataset import GraphDataset
from ..data.jsonl_property_dataset import JsonLGraphPropertyDataset
from ..data.ppi_dataset import PPIDataset
from ..data.qm9_dataset import QM9Dataset
from ..models.graph_binary_classification_task import GraphBinaryClassificationTask
from ..models.graph_regression_task import GraphRegressionTask
from ..models.graph_task_model import GraphTaskModel
from ..models.node_multiclass_task import NodeMulticlassTask
from ..models.qm9_regression_task import QM9RegressionTask


class TaskInfo(NamedTuple):
    name: str
    dataset_class: Type[GraphDataset]
    dataset_default_hypers: Dict[str, Any]
    model_class: Type[GraphTaskModel]
    model_default_hypers: Dict[str, Any]


TASK_NAME_TO_DATASET_AND_MODEL_INFO: Dict[str, TaskInfo] = {}


def register_task(
    task_name: str,
    dataset_class: Type[GraphDataset],
    model_class: Type[GraphTaskModel],
    dataset_default_hypers: Optional[Dict[str, Any]] = None,
    model_default_hypers: Optional[Dict[str, Any]] = None,
) -> None:
    TASK_NAME_TO_DATASET_AND_MODEL_INFO[task_name.lower()] = TaskInfo(
        name=task_name,
        dataset_class=dataset_class,
        dataset_default_hypers=dataset_default_hypers or {},
        model_class=model_class,
        model_default_hypers=model_default_hypers or {},
    )


def get_known_tasks() -> List[str]:
    return [t.name for t in TASK_NAME_TO_DATASET_AND_MODEL_INFO.values()]


def task_name_to_dataset_class(name: str):
    info = _get(name)
    return info.dataset_class, info.dataset_default_hypers


def task_name_to_model_class(name: str):
    info = _get(name)
    return info.model_class, info.model_default_hypers


def _get(name: str) -> TaskInfo:
    info = TASK_NAME_TO_DATASET_AND_MODEL_INFO.get(name.lower())
    if info is None:
        raise ValueError(
            f"Unknown task '{name}'. Known tasks: {get_known_tasks()}"
        )
    return info


# Built-in tasks (reference task_utils.py:67-98).
register_task("PPI", PPIDataset, NodeMulticlassTask)
register_task("QM9", QM9Dataset, QM9RegressionTask)
register_task("GraphRegression", JsonLGraphPropertyDataset, GraphRegressionTask)
register_task(
    "GraphBinaryClassification",
    JsonLGraphPropertyDataset,
    GraphBinaryClassificationTask,
    dataset_default_hypers={"threshold_for_classification": 23.0},
)
