"""Generic JSONLines graph dataset, train/valid/test.jsonl.gz (port of
``tf2_gnn_tpu/data/jsonl_dataset.py``; TRAIN shuffles draw from the
dataset's ``rng``).

Reference: tf2_gnn/data/jsonl_graph_dataset.py:18-145. Each line is a JSON
dict with a "graph" key -> {"node_features": [...], "adjacency_lists": [...]};
backward edges / self loops are added per the dataset hypers.
"""
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from .graph_dataset import DataFold, GraphDataset, GraphSample
from .io import read_by_file_suffix
from .preprocess import (
    compute_number_of_edge_types,
    get_tied_edge_types,
    process_adjacency_lists,
)

FOLD_FILE_NAMES = {
    DataFold.TRAIN: "train.jsonl.gz",
    DataFold.VALIDATION: "valid.jsonl.gz",
    DataFold.TEST: "test.jsonl.gz",
}


class JsonLGraphDataset(GraphDataset):
    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update(
            {
                "num_fwd_edge_types": 3,
                "add_self_loop_edges": True,
                "tie_fwd_bkwd_edges": True,
            }
        )
        return params

    def __init__(self, params, metadata=None, **kwargs):
        super().__init__(params, metadata=metadata, **kwargs)
        self._num_fwd_edge_types = params["num_fwd_edge_types"]
        self._tied_fwd_bkwd_edge_types = get_tied_edge_types(
            tie_fwd_bkwd_edges=params["tie_fwd_bkwd_edges"],
            num_fwd_edge_types=self._num_fwd_edge_types,
        )
        self._num_edge_types = compute_number_of_edge_types(
            tied_fwd_bkwd_edge_types=self._tied_fwd_bkwd_edge_types,
            num_fwd_edge_types=self._num_fwd_edge_types,
            add_self_loop_edges=params["add_self_loop_edges"],
        )
        self._loaded_data: Dict[DataFold, List[GraphSample]] = {}

    @property
    def num_edge_types(self) -> int:
        return self._num_edge_types

    @property
    def node_feature_shape(self) -> Tuple:
        shape = self.metadata.get("_node_feature_shape")
        if shape is None:
            some_fold = next(iter(self._loaded_data.values()))
            shape = (some_fold[0].node_features.shape[-1],)
            self.metadata["_node_feature_shape"] = shape
        return tuple(shape)

    # ---- loading -------------------------------------------------------------
    def load_metadata(self, path) -> None:
        if not self._metadata:
            metadata_path = Path(path) / "metadata.pkl.gz"
            if metadata_path.exists():
                self._metadata = read_by_file_suffix(metadata_path)

    def load_data(self, path, folds_to_load: Optional[Set[DataFold]] = None) -> None:
        path = Path(path)
        self.load_metadata(path)
        if folds_to_load is None:
            folds_to_load = {DataFold.TRAIN, DataFold.VALIDATION, DataFold.TEST}
        for fold in folds_to_load:
            self._loaded_data[fold] = [
                self._process_raw_datapoint(dp)
                for dp in read_by_file_suffix(path / FOLD_FILE_NAMES[fold])
            ]
            self._invalidate_batches(fold)

    def load_data_from_list(
        self, datapoints: List[Dict[str, Any]], target_fold: DataFold = DataFold.TEST
    ):
        self._loaded_data.setdefault(target_fold, []).extend(
            self._process_raw_datapoint(dp) for dp in datapoints
        )
        self._invalidate_batches(target_fold)

    def _process_raw_datapoint(self, datapoint: Dict[str, Any]) -> GraphSample:
        node_features = np.asarray(datapoint["graph"]["node_features"], dtype=np.float32)
        raw_lists = list(datapoint["graph"]["adjacency_lists"])
        # Datapoints may carry MORE lists than num_fwd_edge_types (reference
        # processes them all and silently drops the surplus types at batch
        # time, graph_dataset.py:218-222 — e.g. its own checked-in fixture has
        # 4 raw lists with num_fwd_edge_types=3) or FEWER (omitted trailing
        # empty types; pad so the type count stays consistent).
        raw_lists += [np.zeros((0, 2), dtype=np.int32)] * (
            self._num_fwd_edge_types - len(raw_lists)
        )
        adjacency_lists, type_to_num_incoming = process_adjacency_lists(
            adjacency_lists=raw_lists,
            num_nodes=len(node_features),
            add_self_loop_edges=self.params["add_self_loop_edges"],
            tied_fwd_bkwd_edge_types=self._tied_fwd_bkwd_edge_types,
        )
        return GraphSample(
            adjacency_lists=adjacency_lists,
            type_to_node_to_num_inedges=type_to_num_incoming,
            node_features=node_features,
        )

    # ---- iteration ------------------------------------------------------------
    def _loaded_folds(self) -> Sequence[DataFold]:
        return list(self._loaded_data.keys())

    def _graphs_in_fold(self, fold: DataFold) -> Sequence[GraphSample]:
        return self._loaded_data[fold]

    def _graph_iterator(self, data_fold: DataFold) -> Iterator[GraphSample]:
        data = self._loaded_data[data_fold]
        if data_fold == DataFold.TRAIN:
            data = self._shuffled(data)
        return iter(data)
