"""JSONLines dataset with a scalar per-graph "Property" target (port of
``tf2_gnn_tpu/data/jsonl_property_dataset.py``).

Reference: tf2_gnn/data/jsonl_graph_property_dataset.py:24-117. Supports
optional binarisation against ``threshold_for_classification``.
"""
from typing import Any, Dict, List

import numpy as np

from .graph_batch import PaddingConfig, pad_graph_label_array
from .graph_dataset import GraphSample
from .jsonl_dataset import JsonLGraphDataset
from .preprocess import process_adjacency_lists


class GraphWithPropertySample(GraphSample):
    def __init__(self, adjacency_lists, type_to_node_to_num_inedges, node_features,
                 target_value: float):
        super().__init__(adjacency_lists, type_to_node_to_num_inedges, node_features)
        self._target_value = target_value

    @property
    def target_value(self) -> float:
        return self._target_value


class JsonLGraphPropertyDataset(JsonLGraphDataset):
    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update({"threshold_for_classification": None})
        return params

    def __init__(self, params, metadata=None, **kwargs):
        super().__init__(params, metadata=metadata, **kwargs)
        self._threshold_for_classification = params["threshold_for_classification"]

    def _process_raw_datapoint(self, datapoint: Dict[str, Any]) -> GraphWithPropertySample:
        node_features = np.asarray(datapoint["graph"]["node_features"], dtype=np.float32)
        raw_lists = list(datapoint["graph"]["adjacency_lists"])
        raw_lists += [np.zeros((0, 2), dtype=np.int32)] * (
            self._num_fwd_edge_types - len(raw_lists)
        )
        adjacency_lists, type_to_num_incoming = process_adjacency_lists(
            adjacency_lists=raw_lists,
            num_nodes=len(node_features),
            add_self_loop_edges=self.params["add_self_loop_edges"],
            tied_fwd_bkwd_edge_types=self._tied_fwd_bkwd_edge_types,
        )
        target_value = float(datapoint["Property"])
        if self._threshold_for_classification is not None:
            target_value = float(target_value > self._threshold_for_classification)
        return GraphWithPropertySample(
            adjacency_lists=adjacency_lists,
            type_to_node_to_num_inedges=type_to_num_incoming,
            node_features=node_features,
            target_value=target_value,
        )

    def _batch_label_arrays(
        self, batch_graphs: List[GraphWithPropertySample], config: PaddingConfig
    ) -> Dict[str, np.ndarray]:
        targets = np.asarray([g.target_value for g in batch_graphs], dtype=np.float32)
        return {"target_value": pad_graph_label_array(targets, config.num_graphs)}
