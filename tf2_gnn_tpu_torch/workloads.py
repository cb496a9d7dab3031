"""The PPI-shaped workload of the main path, made from a seed.

A numpy copy of the JAX repo's ``bench.py::build_raw_arrays`` and of the
two pair-plan branches of ``bench.py::build_batch``: 3 graphs of 2400
nodes padded to V = 8064 (63 node blocks), three edge types (self loops,
34k random forward edges per graph and their reverses, ~211k edges in
all), 50 input features and 121 labels with a 10% positive rate. Plans
are per-type pair plans whose groups are chosen from type 0 (the RGCN
form, ``pair_per_type``), or one merged plan over all three types with
groups chosen from all of them and an overflow budget of 256 (the RGAT
form, and with merged targets the target-state edge-MLP form), as the
dataset path chooses them; or, on the scatter-plan route, one merged
sorted-scatter plan over all three types (``bench.py --no-pairs``).

``edge_mlp_default_params`` is the configuration of the JAX repo's
``benchmarks/edge_mlp_probe.py``: the reference-default GNN_Edge_MLP.
``rgcn_sorted_params`` is the PPI_RGCN configuration that ``bench.py``
times on the scatter-plan route (its ``"sorted"`` path).
"""
from typing import Any, Dict, Tuple

import numpy as np

from .data.graph_batch import (
    GraphBatch,
    PaddingConfig,
    pad_batch_arrays,
    pad_node_label_array,
)
from .ops.pair_spmm import build_pair_plans, choose_pair_groups
from .ops.sorted_spmm import build_merged_plans
from .utils.device import resolve_device
from .utils.shapes import round_up

NODES_PER_GRAPH = 2400
FWD_EDGES_PER_GRAPH = 34000
GRAPHS_PER_BATCH = 3
NUM_LABELS = 121
FEATURE_DIM = 50
NODE_BUDGET = 8064  # 63 * 128 node blocks


def edge_mlp_default_params() -> Dict[str, Any]:
    """The reference-default GNN_Edge_MLP node-classification model
    (target-state input, one hidden edge-MLP layer, GRU global exchange
    after layer 2) at hidden 320 and 4 layers, bf16 edge stream, Adam at
    lr 1e-3: ``NodeMulticlassTask.get_default_hyperparameters(
    "gnn_edge_mlp")`` with the updates of ``edge_mlp_probe.py``."""
    from .models.node_multiclass_task import NodeMulticlassTask

    params = NodeMulticlassTask.get_default_hyperparameters("gnn_edge_mlp")
    params.update({"gnn_hidden_dim": 320, "gnn_num_layers": 4,
                   "learning_rate": 0.001,
                   "gnn_num_edge_MLP_hidden_layers": 1,
                   "gnn_edge_dtype": "bfloat16"})
    return params


def rgcn_sorted_params() -> Dict[str, Any]:
    """PPI_RGCN as ``bench.py::measure(use_pairs=False, use_pallas=True)``
    builds it: ``NodeMulticlassTask.get_default_hyperparameters("rgcn")``
    at hidden 320 and 4 layers, 1/deg normalisation, input dropout 0.1,
    dense, residual and global exchange every 10000 layers (never), Adam at
    lr 1e-3, and the default f32 edge stream (the bench sets bf16 only with
    pair plans)."""
    from .models.node_multiclass_task import NodeMulticlassTask

    params = NodeMulticlassTask.get_default_hyperparameters("rgcn")
    params.update({"gnn_hidden_dim": 320, "gnn_num_layers": 4,
                   "gnn_normalize_by_num_incoming": True,
                   "gnn_layer_input_dropout_rate": 0.1,
                   "gnn_dense_every_num_layers": 10000,
                   "gnn_residual_every_num_layers": 10000,
                   "gnn_global_exchange_every_num_layers": 10000,
                   "learning_rate": 0.001})
    return params


def build_raw_arrays(seed: int):
    """(node_features, [loops, fwd, bkwd] adjacency, node_to_graph)."""
    rng = np.random.RandomState(seed)
    v = GRAPHS_PER_BATCH * NODES_PER_GRAPH
    fwd_chunks, bkwd_chunks, loop_chunks = [], [], []
    for g in range(GRAPHS_PER_BATCH):
        base = g * NODES_PER_GRAPH
        src = rng.randint(0, NODES_PER_GRAPH, FWD_EDGES_PER_GRAPH) + base
        tgt = rng.randint(0, NODES_PER_GRAPH, FWD_EDGES_PER_GRAPH) + base
        fwd_chunks.append(np.stack([src, tgt], axis=1))
        bkwd_chunks.append(np.stack([tgt, src], axis=1))
        nodes = np.arange(base, base + NODES_PER_GRAPH)
        loop_chunks.append(np.stack([nodes, nodes], axis=1))
    adjacency = [
        np.concatenate(loop_chunks).astype(np.int32),
        np.concatenate(fwd_chunks).astype(np.int32),
        np.concatenate(bkwd_chunks).astype(np.int32),
    ]
    node_features = rng.randn(v, FEATURE_DIM).astype(np.float32)
    node_to_graph = np.repeat(
        np.arange(GRAPHS_PER_BATCH, dtype=np.int32), NODES_PER_GRAPH
    )
    return node_features, adjacency, node_to_graph


def build_ppi_batch_host(seed: int, merged: bool = False,
                         merge_targets: bool = False, scatter: bool = False
                         ) -> Tuple[GraphBatch, Dict[str, np.ndarray], int]:
    """(host batch, labels, real edge count). The batch carries per-type
    pair plans, or with ``merged`` one merged plan over all three types
    (the RGAT form; ``bench.py::build_batch`` with ``use_pairs=True``);
    ``merge_targets`` puts that plan's targets in the merged ``l * V + t``
    row space (the target-state edge-MLP form, ``pair_merge_targets=True``).
    With ``scatter`` it carries the merged scatter plan instead, and no
    pair plans (``build_batch(use_pallas=True, use_pairs=False)``)."""
    if merge_targets and not merged:
        raise ValueError("merge_targets needs merged=True")
    if scatter and merged:
        raise ValueError("scatter=True builds scatter plans only, without "
                         "pair plans")
    rng = np.random.RandomState(seed)
    v = GRAPHS_PER_BATCH * NODES_PER_GRAPH
    node_features, (loops, fwd, bkwd), node_to_graph = build_raw_arrays(seed)
    config = PaddingConfig(
        num_nodes=NODE_BUDGET,
        num_graphs=GRAPHS_PER_BATCH + 1,
        edge_budgets=tuple(round_up(a.shape[0], 512)
                           for a in (loops, fwd, bkwd)),
    )
    batch = pad_batch_arrays(
        node_features=node_features,
        adjacency_lists=[loops, fwd, bkwd],
        node_to_graph=node_to_graph,
        num_graphs=GRAPHS_PER_BATCH,
        config=config,
    )
    srcs = list(batch.edge_sources)
    tgts = list(batch.edge_targets)
    cnts = [int(c) for c in batch.num_edges]
    if scatter:
        batch = batch.replace(scatter_plans=build_merged_plans(
            srcs, tgts, cnts, NODE_BUDGET).astuple())
    elif merged:
        # Groups chosen over all three types, as the dataset path does.
        gf, gb = choose_pair_groups(srcs, tgts, cnts, NODE_BUDGET,
                                    merge_targets=merge_targets)
        pairs = build_pair_plans(srcs, tgts, cnts, NODE_BUDGET,
                                 overflow_budget=256,
                                 merge_targets=merge_targets, group_fwd=gf,
                                 group_bwd=gb)
        batch = batch.replace(pair_plans=pairs.astuple(),
                              pair_targets_merged=merge_targets)
    else:
        gf, gb = choose_pair_groups([srcs[0]], [tgts[0]], [cnts[0]],
                                    NODE_BUDGET)
        typed = tuple(
            build_pair_plans([srcs[t]], [tgts[t]], [cnts[t]], NODE_BUDGET,
                             group_fwd=gf, group_bwd=gb).astuple()
            for t in range(len(srcs))
        )
        batch = batch.replace(pair_plans_typed=typed)
    labels = {
        "node_labels": pad_node_label_array(
            (rng.rand(v, NUM_LABELS) > 0.9).astype(np.float32), NODE_BUDGET
        )
    }
    real_edges = loops.shape[0] + fwd.shape[0] + bkwd.shape[0]
    return batch, labels, real_edges


def build_ppi_batch(seed: int, device="cuda", merged: bool = False,
                    merge_targets: bool = False, scatter: bool = False):
    """The PPI-shaped batch (per-type plans, or with ``merged`` the merged
    plan, with merged targets under ``merge_targets``, or with ``scatter``
    the scatter plan) and labels as tensors on ``device``, and the real
    edge count."""
    import torch

    dev = resolve_device(device)
    batch, labels, real_edges = build_ppi_batch_host(seed, merged,
                                                     merge_targets, scatter)
    batch = batch.to(dev)
    labels = {k: torch.as_tensor(v, device=dev) for k, v in labels.items()}
    return batch, labels, real_edges
