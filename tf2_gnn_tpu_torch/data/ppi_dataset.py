"""PPI (protein-protein interaction) dataset loader (port of
``tf2_gnn_tpu/data/ppi_dataset.py``; TRAIN shuffles draw from the
dataset's ``rng``).

Reference: tf2_gnn/data/ppi_dataset.py:22-193. Reads the DGL-format PPI dump
({fold}_graph.json with "links", plus {fold}_feats/labels/graph_id.npy with
concatenated per-node arrays), splits into per-graph samples with 0-based node
ids, and attaches [V, 121] multi-hot node labels.
"""
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from .graph_batch import PaddingConfig, pad_node_label_array
from .graph_dataset import DataFold, GraphDataset, GraphSample
from .io import read_by_file_suffix
from .preprocess import (
    compute_number_of_edge_types,
    get_tied_edge_types,
    process_adjacency_lists,
)

_FOLD_NAMES = {DataFold.TRAIN: "train", DataFold.VALIDATION: "valid", DataFold.TEST: "test"}


class PPIGraphSample(GraphSample):
    def __init__(self, adjacency_lists, type_to_node_to_num_inedges, node_features,
                 node_labels: np.ndarray):
        super().__init__(adjacency_lists, type_to_node_to_num_inedges, node_features)
        self._node_labels = node_labels

    @property
    def node_labels(self) -> np.ndarray:
        return self._node_labels


class PPIDataset(GraphDataset):
    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        params = super().get_default_hyperparameters()
        params.update(
            {
                "max_nodes_per_batch": 10000,
                "add_self_loop_edges": True,
                "tie_fwd_bkwd_edges": False,
            }
        )
        return params

    @staticmethod
    def default_data_path() -> str:
        return "data/ppi"

    def __init__(self, params, metadata=None, **kwargs):
        super().__init__(params, metadata=metadata, **kwargs)
        self._tied_fwd_bkwd_edge_types = get_tied_edge_types(
            tie_fwd_bkwd_edges=params["tie_fwd_bkwd_edges"], num_fwd_edge_types=1
        )
        self._num_edge_types = compute_number_of_edge_types(
            tied_fwd_bkwd_edge_types=self._tied_fwd_bkwd_edge_types,
            num_fwd_edge_types=1,
            add_self_loop_edges=params["add_self_loop_edges"],
        )
        self._loaded_data: Dict[DataFold, List[PPIGraphSample]] = {}

    @property
    def num_edge_types(self) -> int:
        return self._num_edge_types

    @property
    def node_feature_shape(self) -> Tuple:
        some_fold = next(iter(self._loaded_data.values()))
        return (some_fold[0].node_features.shape[-1],)

    @property
    def num_node_target_labels(self) -> int:
        return 121

    # ---- loading ---------------------------------------------------------------
    def load_data(self, path, folds_to_load: Optional[Set[DataFold]] = None) -> None:
        path = Path(path)
        if folds_to_load is None:
            folds_to_load = {DataFold.TRAIN, DataFold.VALIDATION, DataFold.TEST}
        for fold in folds_to_load:
            self._loaded_data[fold] = self._load_fold(path, fold)
            self._invalidate_batches(fold)

    def _load_fold(self, data_dir: Path, fold: DataFold) -> List[PPIGraphSample]:
        name = _FOLD_NAMES[fold]
        graph_json = read_by_file_suffix(data_dir / f"{name}_graph.json")
        features = np.asarray(read_by_file_suffix(data_dir / f"{name}_feats.npy"))
        labels = np.asarray(read_by_file_suffix(data_dir / f"{name}_labels.npy"))
        node_to_graph_id = np.asarray(
            read_by_file_suffix(data_dir / f"{name}_graph_id.npy")
        ).astype(np.int64)

        # Split the concatenated node arrays into per-graph chunks; node ids in
        # the edge list are shifted so each graph starts at node 0.
        graph_ids = np.unique(node_to_graph_id)
        graph_id_to_offset = {
            int(g): int(np.argmax(node_to_graph_id == g)) for g in graph_ids
        }
        graph_id_to_edges: Dict[int, List[Tuple[int, int]]] = {int(g): [] for g in graph_ids}
        for edge in graph_json["links"]:
            src, tgt = int(edge["source"]), int(edge["target"])
            graph_id = int(node_to_graph_id[src])
            offset = graph_id_to_offset[graph_id]
            graph_id_to_edges[graph_id].append((src - offset, tgt - offset))

        samples = []
        for g in graph_ids:
            g = int(g)
            mask = node_to_graph_id == g
            num_nodes = int(mask.sum())
            adjacency_lists, type_to_num_incoming = process_adjacency_lists(
                adjacency_lists=[graph_id_to_edges[g]],
                num_nodes=num_nodes,
                add_self_loop_edges=self.params["add_self_loop_edges"],
                tied_fwd_bkwd_edge_types=self._tied_fwd_bkwd_edge_types,
            )
            samples.append(
                PPIGraphSample(
                    adjacency_lists=adjacency_lists,
                    type_to_node_to_num_inedges=type_to_num_incoming,
                    node_features=features[mask].astype(np.float32),
                    node_labels=labels[mask].astype(np.float32),
                )
            )
        return samples

    # ---- iteration -----------------------------------------------------------
    def _loaded_folds(self) -> Sequence[DataFold]:
        return list(self._loaded_data.keys())

    def _graphs_in_fold(self, fold: DataFold) -> Sequence[PPIGraphSample]:
        return self._loaded_data[fold]

    def _graph_iterator(self, data_fold: DataFold) -> Iterator[PPIGraphSample]:
        data = self._loaded_data[data_fold]
        if data_fold == DataFold.TRAIN:
            data = self._shuffled(data)
        return iter(data)

    # ---- labels ---------------------------------------------------------------
    def _batch_label_arrays(
        self, batch_graphs: List[PPIGraphSample], config: PaddingConfig
    ) -> Dict[str, np.ndarray]:
        node_labels = np.concatenate([g.node_labels for g in batch_graphs], axis=0)
        return {"node_labels": pad_node_label_array(node_labels, config.num_nodes)}
