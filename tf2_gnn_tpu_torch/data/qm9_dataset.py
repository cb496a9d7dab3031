"""QM9 molecular dataset loader (port of ``tf2_gnn_tpu/data/qm9_dataset.py``;
TRAIN shuffles draw from the dataset's ``rng``).

Reference: tf2_gnn/data/qm9_dataset.py:15-197. JSONLines molecules with
``graph`` = list of (src, edge_type, dst) triples (edge types 1-indexed in the
raw data), ``node_features``, and per-task ``targets``; 4 forward edge types,
fwd/bkwd tied + self loops by default.
"""
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from .graph_batch import PaddingConfig, pad_graph_label_array
from .graph_dataset import DataFold, GraphDataset, GraphSample
from .io import read_by_file_suffix
from .jsonl_dataset import FOLD_FILE_NAMES
from .preprocess import (
    compute_number_of_edge_types,
    get_tied_edge_types,
    process_adjacency_lists,
)


class QM9GraphSample(GraphSample):
    def __init__(self, adjacency_lists, type_to_node_to_num_inedges, node_features,
                 target_value: float):
        super().__init__(adjacency_lists, type_to_node_to_num_inedges, node_features)
        self._target_value = target_value

    @property
    def target_value(self) -> float:
        return self._target_value


class QM9Dataset(GraphDataset):
    NUM_FWD_EDGE_TYPES = 4

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update(
            {
                "max_nodes_per_batch": 10000,
                "add_self_loop_edges": True,
                "tie_fwd_bkwd_edges": True,
                "task_id": 0,
            }
        )
        return params

    def __init__(self, params, metadata=None, **kwargs):
        super().__init__(params, metadata=metadata, **kwargs)
        self._tied_fwd_bkwd_edge_types = get_tied_edge_types(
            tie_fwd_bkwd_edges=params["tie_fwd_bkwd_edges"],
            num_fwd_edge_types=self.NUM_FWD_EDGE_TYPES,
        )
        self._num_edge_types = compute_number_of_edge_types(
            tied_fwd_bkwd_edge_types=self._tied_fwd_bkwd_edge_types,
            num_fwd_edge_types=self.NUM_FWD_EDGE_TYPES,
            add_self_loop_edges=params["add_self_loop_edges"],
        )
        self._node_feature_shape: Optional[Tuple] = None
        self._loaded_data: Dict[DataFold, List[QM9GraphSample]] = {}

    @property
    def num_edge_types(self) -> int:
        return self._num_edge_types

    @property
    def node_feature_shape(self) -> Tuple:
        if self._node_feature_shape is None:
            some_fold = next(iter(self._loaded_data.values()))
            self._node_feature_shape = (some_fold[0].node_features.shape[-1],)
        return self._node_feature_shape

    # ---- loading ----------------------------------------------------------------
    def load_data(self, path, folds_to_load: Optional[Set[DataFold]] = None) -> None:
        path = Path(path)
        if folds_to_load is None:
            folds_to_load = {DataFold.TRAIN, DataFold.VALIDATION, DataFold.TEST}
        for fold in folds_to_load:
            raw = read_by_file_suffix(path / FOLD_FILE_NAMES[fold])
            self._loaded_data[fold] = [self._process_raw_graph(d) for d in raw]
            self._invalidate_batches(fold)

    def _process_raw_graph(self, datapoint: Dict[str, Any]) -> QM9GraphSample:
        node_features = np.asarray(datapoint["node_features"], dtype=np.float32)
        raw_adjacency = [[] for _ in range(self.NUM_FWD_EDGE_TYPES)]
        for src, edge_type, dst in datapoint["graph"]:
            # Raw QM9 edge types are 1-indexed (reference qm9_dataset.py:912).
            raw_adjacency[int(edge_type) - 1].append((int(src), int(dst)))
        adjacency_lists, type_to_num_incoming = process_adjacency_lists(
            adjacency_lists=raw_adjacency,
            num_nodes=len(node_features),
            add_self_loop_edges=self.params["add_self_loop_edges"],
            tied_fwd_bkwd_edge_types=self._tied_fwd_bkwd_edge_types,
        )
        target = datapoint["targets"][self.params["task_id"]]
        target_value = float(target[0] if isinstance(target, (list, tuple)) else target)
        return QM9GraphSample(
            adjacency_lists=adjacency_lists,
            type_to_node_to_num_inedges=type_to_num_incoming,
            node_features=node_features,
            target_value=target_value,
        )

    # ---- iteration ----------------------------------------------------------------
    def _loaded_folds(self) -> Sequence[DataFold]:
        return list(self._loaded_data.keys())

    def _graphs_in_fold(self, fold: DataFold) -> Sequence[QM9GraphSample]:
        return self._loaded_data[fold]

    def _graph_iterator(self, data_fold: DataFold) -> Iterator[QM9GraphSample]:
        data = self._loaded_data[data_fold]
        if data_fold == DataFold.TRAIN:
            data = self._shuffled(data)
        return iter(data)

    # ---- labels --------------------------------------------------------------------
    def _batch_label_arrays(
        self, batch_graphs: List[QM9GraphSample], config: PaddingConfig
    ) -> Dict[str, np.ndarray]:
        targets = np.asarray([g.target_value for g in batch_graphs], dtype=np.float32)
        return {"target_value": pad_graph_label_array(targets, config.num_graphs)}
