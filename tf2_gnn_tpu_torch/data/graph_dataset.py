"""Abstract graph dataset: greedy node-budget packing + static padding (port
of ``tf2_gnn_tpu/data/graph_dataset.py``).

The packing policy is the JAX package's: a greedy node-budget fill that also
enforces per-type edge budgets and a graph-count budget (a batch is emitted
early rather than overflowing any static shape), and finished batches are
padded to a fold-independent ``PaddingConfig`` whose budgets are derived
once from the loaded data (``_derive_padding_config``: a packing pass by
node budget only records per-type edge, graph-count and pair-chunk maxima,
then adds slack and rounds up).

Batches leave the dataset as host ``GraphBatch``es (numpy arrays and host
plans) with numpy labels; the caller moves them to its device
(``GraphBatch.to``), where the plans' device forms are built. TRAIN folds
are shuffled with the dataset's own ``np.random.RandomState`` (``rng``;
the JAX loaders draw from the global ``np.random``, so a port dataset whose
``rng`` is ``RandomState(s)`` draws the same permutations as the JAX one
after ``np.random.seed(s)``).
"""
from abc import ABC, abstractmethod
from enum import Enum
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..native import pack_edges, pack_nodes
from ..ops.pair_spmm import (
    BWD_GROUP,
    GROUP,
    build_pair_plans,
    choose_pair_groups,
    measure_pair_chunks,
)
from ..ops.sorted_spmm import BLOCK_NODES, build_merged_plans
from ..utils.shapes import round_up as _round_up
from .graph_batch import GraphBatch, PaddingConfig, host_in_degrees


class DataFold(Enum):
    TRAIN = 0
    VALIDATION = 1
    TEST = 2


class GraphSample:
    """A single graph: per-type [E,2] adjacency + [L,V] in-degrees + node
    features."""

    def __init__(
        self,
        adjacency_lists: List[np.ndarray],
        type_to_node_to_num_inedges: np.ndarray,
        node_features: np.ndarray,
    ):
        self._adjacency_lists = adjacency_lists
        self._type_to_node_to_num_inedges = type_to_node_to_num_inedges
        self._node_features = np.asarray(node_features, dtype=np.float32)

    @property
    def adjacency_lists(self) -> List[np.ndarray]:
        return self._adjacency_lists

    @property
    def type_to_node_to_num_inedges(self) -> np.ndarray:
        return self._type_to_node_to_num_inedges

    @property
    def node_features(self) -> np.ndarray:
        return self._node_features

    @property
    def num_nodes(self) -> int:
        return self._node_features.shape[0]


class GraphDataset(ABC):
    """Turns per-graph samples into statically-shaped padded minibatches."""

    @classmethod
    def get_default_hyperparameters(cls) -> Dict[str, Any]:
        return {
            "max_nodes_per_batch": 10000,
            # Slack multiplier applied to observed per-batch edge/graph
            # maxima when deriving static budgets (shuffling changes the
            # batch mix).
            "padding_slack": 1.25,
            # Alignment of the padded edge budgets.
            "padding_alignment": 64,
            # Build the merged scatter plan per batch (ops/sorted_spmm.py).
            "use_pallas_spmm": False,
            # Build block-pair plans (ops/pair_spmm.py). Edges that do not
            # fit the chunk budget spill into an overflow term of
            # 'pair_overflow_budget' static slots: shuffled epochs repack
            # batches, and chunk demand depends on block-pair structure,
            # which the packer does not bound.
            "use_pair_spmm": False,
            "pair_overflow_budget": 64,
            # One single-type pair plan per edge type over the [V] row
            # space instead of one merged [L*V] plan.
            "pair_per_type": False,
            # Merged pair plan with MERGED TARGETS (l * V + t): per-type
            # aggregates [L*V, H] instead of the joint [V, H] sum.
            "pair_merge_targets": False,
        }

    def __init__(
        self,
        params: Dict[str, Any],
        metadata: Optional[Dict[str, Any]] = None,
        use_worker_threads: bool = False,
        rng: Optional[np.random.RandomState] = None,
    ):
        self._params = dict(params)
        self._params.setdefault("padding_slack", 1.25)
        self._params.setdefault("padding_alignment", 64)
        # Non-TRAIN folds iterate in a fixed order, so their packed batches
        # (plans included) are identical every epoch: cache them after the
        # first full pass. TRAIN reshuffles each epoch and is never cached,
        # unless ``cache_train_batches`` freezes the first epoch's order
        # (a deliberate deviation from a per-epoch reshuffle).
        self._params.setdefault("cache_eval_batches", True)
        self._params.setdefault("cache_train_batches", False)
        self._metadata = metadata if metadata is not None else {}
        self._use_worker_threads = use_worker_threads
        self._rng = rng if rng is not None else np.random.RandomState(0)
        self._padding_config: Optional[PaddingConfig] = None
        self._batch_cache: Dict[DataFold, list] = {}

    # ---- basic properties ---------------------------------------------------
    @property
    def name(self) -> str:
        return self.__class__.__name__

    @property
    def params(self) -> Dict[str, Any]:
        return self._params

    @property
    def metadata(self) -> Dict[str, Any]:
        return self._metadata

    @property
    @abstractmethod
    def num_edge_types(self) -> int:
        ...

    @property
    @abstractmethod
    def node_feature_shape(self) -> Tuple:
        ...

    @abstractmethod
    def load_data(self, path,
                  folds_to_load: Optional[Set[DataFold]] = None) -> None:
        ...

    def load_data_from_list(
        self, datapoints: List[Dict[str, Any]],
        target_fold: DataFold = DataFold.TEST
    ):
        raise NotImplementedError()

    @abstractmethod
    def _graph_iterator(self, data_fold: DataFold) -> Iterator[GraphSample]:
        """Iterate over samples in a fold; shuffles TRAIN on each call."""
        ...

    @abstractmethod
    def _loaded_folds(self) -> Sequence[DataFold]:
        """Folds currently loaded (used for budget derivation)."""
        ...

    def _graphs_in_fold(self, fold: DataFold) -> Sequence[GraphSample]:
        """Deterministic view of a fold's samples for budget derivation."""
        raise NotImplementedError()

    def _shuffled(self, data: Sequence[GraphSample]) -> List[GraphSample]:
        data = list(data)
        self._rng.shuffle(data)
        return data

    # ---- packing core ---------------------------------------------------------
    def _fits(
        self,
        counts: Dict[str, Any],
        graph: GraphSample,
        node_budget: int,
        edge_budgets: Optional[Sequence[int]],
        graph_budget: Optional[int],
    ) -> bool:
        if counts["nodes"] + graph.num_nodes > node_budget - 1:
            return False
        if graph_budget is not None and counts["graphs"] + 1 > graph_budget - 1:
            return False
        if edge_budgets is not None:
            for edge_type, adj in enumerate(
                graph.adjacency_lists[: self.num_edge_types]
            ):
                if counts["edges"][edge_type] + adj.shape[0] > edge_budgets[edge_type]:
                    return False
        return True

    def _pack_graphs(
        self,
        graphs: Iterator[GraphSample],
        node_budget: int,
        edge_budgets: Optional[Sequence[int]] = None,
        graph_budget: Optional[int] = None,
    ) -> Iterator[List[GraphSample]]:
        """Greedily pack graphs into batches under all provided budgets."""
        batch: List[GraphSample] = []
        counts = {"nodes": 0, "graphs": 0, "edges": [0] * self.num_edge_types}
        for graph in graphs:
            if graph.num_nodes > node_budget - 1:
                raise ValueError(
                    f"Graph with {graph.num_nodes} nodes exceeds node budget "
                    f"{node_budget} (need <= {node_budget - 1}); raise "
                    f"'max_nodes_per_batch'."
                )
            if batch and not self._fits(counts, graph, node_budget,
                                        edge_budgets, graph_budget):
                yield batch
                batch = []
                counts = {"nodes": 0, "graphs": 0,
                          "edges": [0] * self.num_edge_types}
            batch.append(graph)
            counts["nodes"] += graph.num_nodes
            counts["graphs"] += 1
            for edge_type, adj in enumerate(
                graph.adjacency_lists[: self.num_edge_types]
            ):
                counts["edges"][edge_type] += adj.shape[0]
        if batch:
            yield batch

    # ---- padding-config derivation ---------------------------------------------
    @property
    def padding_config(self) -> PaddingConfig:
        if self._padding_config is None:
            self._padding_config = self._derive_padding_config()
        return self._padding_config

    def set_padding_config(self, config: PaddingConfig) -> None:
        """Pin an externally chosen config (e.g. restored from a
        checkpoint); cached batches embed the old one, so they are
        dropped."""
        self._padding_config = config
        self._invalidate_batches()

    def _invalidate_batches(self, fold: Optional[DataFold] = None) -> None:
        """Drop cached batches, of one fold or of all. Every load path and
        ``set_padding_config`` call this; so must any subclass code that
        changes a fold's samples."""
        if fold is None:
            self._batch_cache.clear()
        else:
            self._batch_cache.pop(fold, None)

    def _derive_padding_config(self) -> PaddingConfig:
        node_budget = int(self._params["max_nodes_per_batch"])
        slack = float(self._params["padding_slack"])
        align = int(self._params["padding_alignment"])
        use_pairs = bool(self._params.get("use_pair_spmm"))
        if self._params.get("use_pallas_spmm") or use_pairs:
            # The plans tile nodes in BLOCK_NODES rows.
            node_budget = _round_up(node_budget, BLOCK_NODES)

        max_edges_per_batch = [0] * self.num_edge_types
        max_edges_per_graph = [0] * self.num_edge_types
        max_graphs_per_batch = 0
        max_pair_fwd, max_pair_bwd = 0, 0
        pair_groups = None  # (group_fwd, group_bwd), chosen on the 1st batch
        pair_per_type = bool(self._params.get("pair_per_type"))
        merge = bool(self._params.get("pair_merge_targets"))
        max_pair_typed = [[0, 0] for _ in range(self.num_edge_types)]

        for fold in self._loaded_folds():
            graphs = self._graphs_in_fold(fold)
            for g in graphs:
                # Samples may carry more lists than num_edge_types; batches
                # drop the extras, so the budgets do too.
                for edge_type, adj in enumerate(
                    g.adjacency_lists[: self.num_edge_types]
                ):
                    max_edges_per_graph[edge_type] = max(
                        max_edges_per_graph[edge_type], adj.shape[0]
                    )
            for batch in self._pack_graphs(iter(graphs), node_budget):
                max_graphs_per_batch = max(max_graphs_per_batch, len(batch))
                for edge_type in range(self.num_edge_types):
                    total = sum(b.adjacency_lists[edge_type].shape[0]
                                for b in batch)
                    max_edges_per_batch[edge_type] = max(
                        max_edges_per_batch[edge_type], total
                    )
                if not use_pairs:
                    continue
                offsets = np.cumsum([0] + [b.num_nodes for b in batch])[:-1]
                srcs, tgts, counts = [], [], []
                for t in range(self.num_edge_types):
                    adj = [
                        b.adjacency_lists[t] + off
                        for b, off in zip(batch, offsets)
                        if b.adjacency_lists[t].shape[0]
                    ]
                    merged = (np.concatenate(adj) if adj
                              else np.zeros((0, 2), np.int64))
                    srcs.append(merged[:, 0])
                    tgts.append(merged[:, 1])
                    counts.append(merged.shape[0])
                if pair_per_type:
                    if pair_groups is None:
                        pair_groups = choose_pair_groups(
                            [srcs[0]], [tgts[0]], [counts[0]], node_budget)
                    for t in range(self.num_edge_types):
                        f, b_ = measure_pair_chunks(
                            [srcs[t]], [tgts[t]], [counts[t]], node_budget,
                            group_fwd=pair_groups[0],
                            group_bwd=pair_groups[1])
                        max_pair_typed[t][0] = max(max_pair_typed[t][0], f)
                        max_pair_typed[t][1] = max(max_pair_typed[t][1], b_)
                else:
                    if pair_groups is None:
                        pair_groups = choose_pair_groups(
                            srcs, tgts, counts, node_budget,
                            merge_targets=merge)
                    f, b_ = measure_pair_chunks(
                        srcs, tgts, counts, node_budget, merge_targets=merge,
                        group_fwd=pair_groups[0], group_bwd=pair_groups[1])
                    max_pair_fwd = max(max_pair_fwd, f)
                    max_pair_bwd = max(max_pair_bwd, b_)

        if max_graphs_per_batch == 0:
            raise ValueError("Cannot derive padding config: no data loaded.")

        edge_budgets = tuple(
            _round_up(
                max(int(max_edges_per_batch[t] * slack),
                    max_edges_per_graph[t]), align
            )
            for t in range(self.num_edge_types)
        )
        graph_budget = int(max_graphs_per_batch * slack) + 2
        pair_kwargs = {}
        if use_pairs:
            gf, gb = pair_groups if pair_groups is not None else (GROUP,
                                                                  BWD_GROUP)
            pair_kwargs = {
                "pair_overflow": int(self._params.get("pair_overflow_budget",
                                                      64)),
                "pair_group_fwd": gf,
                "pair_group_bwd": gb,
            }
            if pair_per_type:
                pair_kwargs["pair_chunks_typed"] = tuple(
                    (_round_up(int(f * slack), gf),
                     _round_up(int(b * slack), gb))
                    for f, b in max_pair_typed
                )
            else:
                pair_kwargs["pair_chunks_fwd"] = _round_up(
                    int(max_pair_fwd * slack), gf)
                pair_kwargs["pair_chunks_bwd"] = _round_up(
                    int(max_pair_bwd * slack), gb)
        return PaddingConfig(
            num_nodes=node_budget,
            num_graphs=graph_budget,
            edge_budgets=edge_budgets,
            **pair_kwargs,
        )

    # ---- batch assembly hooks ----------------------------------------------------
    def _batch_label_arrays(
        self, batch_graphs: List[GraphSample], config: PaddingConfig
    ) -> Dict[str, np.ndarray]:
        """Subclasses return padded label arrays for one packed batch."""
        return {}

    def _finalise_batch(
        self, batch_graphs: List[GraphSample], config: PaddingConfig
    ) -> Tuple[GraphBatch, Dict[str, np.ndarray]]:
        """Assemble one padded mega-batch with the plans the dataset's
        parameters ask for: nodes and edges packed by the C++ engine
        (``native.pack_nodes`` / ``pack_edges``, as the JAX package's
        graph_dataset.py:411-415), the plans by its planners."""
        num_real_nodes = sum(g.num_nodes for g in batch_graphs)
        v_pad = config.num_nodes
        if num_real_nodes > v_pad - 1:
            raise ValueError(
                f"Batch has {num_real_nodes} nodes but padded budget {v_pad} "
                f"requires at most {v_pad - 1}."
            )
        node_features, node_to_graph = pack_nodes(
            [g.node_features for g in batch_graphs],
            v_pad=v_pad,
            pad_graph_id=config.num_graphs - 1,
        )
        graph_num_nodes = [g.num_nodes for g in batch_graphs]
        pad_node = v_pad - 1
        sources, targets, real_counts = [], [], []
        for edge_type in range(self.num_edge_types):
            src, tgt, count = pack_edges(
                [g.adjacency_lists[edge_type] for g in batch_graphs],
                graph_num_nodes,
                budget=config.edge_budgets[edge_type],
                pad_node=pad_node,
            )
            sources.append(src)
            targets.append(tgt)
            real_counts.append(count)

        scatter_plans = None
        if self._params.get("use_pallas_spmm"):
            scatter_plans = build_merged_plans(
                sources, targets, real_counts, v_pad).astuple()

        pair_plans = None
        pair_plans_typed = None
        pair_targets_merged = bool(self._params.get("pair_merge_targets"))
        if self._params.get("use_pair_spmm"):
            overflow = config.pair_overflow or 0
            if config.pair_chunks_typed is not None:
                pair_plans_typed = tuple(
                    build_pair_plans(
                        [sources[t]], [targets[t]], [real_counts[t]], v_pad,
                        chunk_budget_fwd=config.pair_chunks_typed[t][0],
                        chunk_budget_bwd=config.pair_chunks_typed[t][1],
                        overflow_budget=overflow,
                        overflow_size=overflow,
                        group_fwd=config.pair_group_fwd,
                        group_bwd=config.pair_group_bwd,
                    ).astuple()
                    for t in range(self.num_edge_types)
                )
            else:
                pair_plans = build_pair_plans(
                    sources, targets, real_counts, v_pad,
                    chunk_budget_fwd=config.pair_chunks_fwd,
                    chunk_budget_bwd=config.pair_chunks_bwd,
                    overflow_budget=overflow,
                    overflow_size=overflow,
                    merge_targets=pair_targets_merged,
                    group_fwd=config.pair_group_fwd,
                    group_bwd=config.pair_group_bwd,
                ).astuple()

        graph_batch = GraphBatch(
            node_features=node_features,
            edge_sources=tuple(sources),
            edge_targets=tuple(targets),
            node_to_graph=node_to_graph,
            num_nodes=int(num_real_nodes),
            num_edges=np.asarray(real_counts, dtype=np.int32),
            num_graphs=len(batch_graphs),
            num_graphs_padded=config.num_graphs,
            scatter_plans=scatter_plans,
            pair_plans=pair_plans,
            pair_plans_typed=pair_plans_typed,
            pair_targets_merged=pair_targets_merged and pair_plans is not None,
            in_degrees=host_in_degrees(targets, v_pad),
        )
        return graph_batch, self._batch_label_arrays(batch_graphs, config)

    # ---- public iteration --------------------------------------------------------
    def batch_iterator(
        self, data_fold: DataFold
    ) -> Iterator[Tuple[GraphBatch, Dict[str, np.ndarray]]]:
        """Yield padded host (GraphBatch, labels) pairs for one epoch of a
        fold.

        With ``use_worker_threads`` batch assembly runs in a background
        thread (data/prefetch.py), overlapping host packing with device
        compute. Non-TRAIN folds replay their first epoch's batches from
        an in-memory cache (``cache_eval_batches``, default on); the cache
        commits only when an epoch's generator is fully drained.
        """
        config = self.padding_config
        if data_fold == DataFold.TRAIN:
            cacheable = bool(self._params.get("cache_train_batches"))
        else:
            cacheable = bool(self._params.get("cache_eval_batches"))
        if cacheable and data_fold in self._batch_cache:
            return iter(self._batch_cache[data_fold])

        def generate():
            collected = [] if cacheable else None
            for batch_graphs in self._pack_graphs(
                self._graph_iterator(data_fold),
                config.num_nodes,
                edge_budgets=config.edge_budgets,
                graph_budget=config.num_graphs,
            ):
                finalised = self._finalise_batch(batch_graphs, config)
                if collected is not None:
                    collected.append(finalised)
                yield finalised
            if collected is not None:
                self._batch_cache[data_fold] = collected

        if self._use_worker_threads:
            from .prefetch import prefetch

            return prefetch(generate())
        return generate()
