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
``shipped_params`` reads a shipped configuration file;
``rgat_eight_heads_params`` is the shipped PPI_RGAT at the head layout of
GAT's transductive models (8 heads of 8 features), a layout whose
attention sums take the hk-major aggregation kernel.

The QM9-shaped workload is a numpy copy of ``bench.py::build_qm9_batch``:
909 molecules of 18 nodes, 5 edge types of 11 random edges a molecule,
V padded to 16384, 910 graph slots, 32 input features, per-type pair
plans grouped from type 0 and one regression target a molecule.
``qm9_shipped_params`` is the shipped QM9_RGCN configuration that
``bench.py::measure_qm9`` times; ``graph_regression_edge_mlp_params`` the
shipped GraphRegression_GNN_Edge_MLP, which reads the same batch.
"""
import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from .data.graph_batch import (
    GraphBatch,
    PaddingConfig,
    pad_batch_arrays,
    pad_graph_label_array,
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

QM9_MOLECULES = 909
QM9_NODES_PER_MOLECULE = 18
QM9_EDGE_TYPES = 5
QM9_EDGES_PER_MOLECULE = 11  # per edge type
QM9_NODE_BUDGET = 16384  # 128 * 128 node blocks
QM9_FEATURE_DIM = 32


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


def _shipped_model_params(hypers_file: str) -> Dict[str, Any]:
    """The model params of ``harness/default_hypers/<hypers_file>``."""
    return json.loads((Path(__file__).resolve().parent / "harness"
                       / "default_hypers" / hypers_file).read_text()
                      )["model_params"]


def shipped_params(hypers_file: str, style: str) -> Dict[str, Any]:
    """The shipped configuration ``harness/default_hypers/<hypers_file>``
    over ``NodeMulticlassTask.get_default_hyperparameters(style)``, with
    Adam at lr 1e-3."""
    from .models.node_multiclass_task import NodeMulticlassTask

    params = NodeMulticlassTask.get_default_hyperparameters(style)
    params.update(_shipped_model_params(hypers_file))
    params["learning_rate"] = 0.001
    return params


def qm9_shipped_params() -> Dict[str, Any]:
    """The shipped QM9_RGCN (``harness/default_hypers/QM9_RGCN.json``'s
    model params over ``QM9RegressionTask.get_default_hyperparameters(
    "rgcn")``): 8 layers, hidden 128, leaky_relu messages, residual every
    2, LayerNorm, dense every 32 (at layer 0 only), a bf16 edge stream,
    RMSProp (lr 0.000572, rho 0.98, momentum 0.85) with clipping by value
    at 1.0, and from the GNN defaults the GRU global exchange at layers 2,
    4 and 6 with dropout 0.2."""
    from .models.qm9_regression_task import QM9RegressionTask

    params = QM9RegressionTask.get_default_hyperparameters("rgcn")
    params.update(_shipped_model_params("QM9_RGCN.json"))
    return params


def graph_regression_edge_mlp_params() -> Dict[str, Any]:
    """The shipped GraphRegression_GNN_Edge_MLP
    (``harness/default_hypers/GraphRegression_GNN_Edge_MLP.json``'s model
    params over ``GraphRegressionTask.get_default_hyperparameters(
    "gnn_edge_mlp")``): 12 layers, hidden 64, target-state input with 0
    hidden edge-MLP layers (the factorised form), gelu messages, residual
    every 2, LayerNorm, dense every 10000 (at layer 0 only), input dropout
    0.1, no global exchange (every 40 layers), an f32 edge stream, a
    [64]-layer readout of 32 features in 4 heads, and Adam at lr 1e-4 with
    clipping by value at 1.0."""
    from .models.graph_regression_task import GraphRegressionTask

    params = GraphRegressionTask.get_default_hyperparameters("gnn_edge_mlp")
    params.update(_shipped_model_params("GraphRegression_GNN_Edge_MLP.json"))
    return params


def rgat_eight_heads_params() -> Dict[str, Any]:
    """The shipped PPI_RGAT (``shipped_params("PPI_RGAT.json", "rgat")``:
    3 layers, tanh, bf16 edge stream, input dropout 0.1, the ``"bound"``
    stabiliser) at hidden 64 in K = 8 heads of F' = 8 features. That is
    the head layout of GAT's transductive models (Veličković et al.,
    "Graph Attention Networks", ICLR 2018, section 3.3: Cora, Citeseer,
    Pubmed) carried over to PPI; GAT's own PPI model takes K = 4 heads of
    F' = 256. With one 128-column tile and K = 8 > 4 heads a tile, the
    reference routes its attention sums to the hk-major aggregation kernel
    (``_agg_kernel_device``, B10) rather than one head-major SpMM a head;
    GAT's PPI layout (head_dim + 1 > 128) would take B10 by its other
    route."""
    params = shipped_params("PPI_RGAT.json", "rgat")
    params.update({"gnn_hidden_dim": 64, "gnn_num_heads": 8})
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


def build_qm9_batch_host(seed: int, molecules: int = QM9_MOLECULES,
                         nodes_per_molecule: int = QM9_NODES_PER_MOLECULE,
                         num_types: int = QM9_EDGE_TYPES,
                         edges_per_molecule: int = QM9_EDGES_PER_MOLECULE,
                         node_budget: int = QM9_NODE_BUDGET,
                         feature_dim: int = QM9_FEATURE_DIM
                         ) -> Tuple[GraphBatch, Dict[str, np.ndarray], int]:
    """(host batch with per-type pair plans, labels, molecule count), the
    arrays of ``bench.py::build_qm9_batch(seed)`` at the default counts.
    Edge budgets round each type's edge count up to 512; the plans' groups
    are chosen from type 0 alone, as the dataset path chooses them."""
    rng = np.random.RandomState(seed)
    v = molecules * nodes_per_molecule
    base = (np.arange(molecules) * nodes_per_molecule)[:, None]
    adjacency = []
    for _ in range(num_types):
        src = rng.randint(0, nodes_per_molecule,
                          (molecules, edges_per_molecule))
        tgt = rng.randint(0, nodes_per_molecule,
                          (molecules, edges_per_molecule))
        adjacency.append(np.stack(
            [(src + base).reshape(-1), (tgt + base).reshape(-1)],
            axis=1).astype(np.int32))
    config = PaddingConfig(
        num_nodes=node_budget,
        num_graphs=molecules + 1,
        edge_budgets=tuple(round_up(a.shape[0], 512) for a in adjacency),
    )
    batch = pad_batch_arrays(
        node_features=rng.randn(v, feature_dim).astype(np.float32),
        adjacency_lists=adjacency,
        node_to_graph=np.repeat(np.arange(molecules, dtype=np.int32),
                                nodes_per_molecule),
        num_graphs=molecules,
        config=config,
    )
    srcs = list(batch.edge_sources)
    tgts = list(batch.edge_targets)
    cnts = [int(c) for c in batch.num_edges]
    gf, gb = choose_pair_groups([srcs[0]], [tgts[0]], [cnts[0]], node_budget)
    typed = tuple(
        build_pair_plans([srcs[t]], [tgts[t]], [cnts[t]], node_budget,
                         group_fwd=gf, group_bwd=gb).astuple()
        for t in range(num_types)
    )
    batch = batch.replace(pair_plans_typed=typed)
    labels = {"target_value": pad_graph_label_array(
        rng.randn(molecules).astype(np.float32), molecules + 1)}
    return batch, labels, molecules


def build_qm9_batch(seed: int, device="cuda", **counts):
    """The QM9-shaped batch (per-type pair plans) and labels as tensors on
    ``device``, and the molecule count; ``counts`` are
    ``build_qm9_batch_host``'s keyword arguments."""
    import torch

    dev = resolve_device(device)
    batch, labels, molecules = build_qm9_batch_host(seed, **counts)
    batch = batch.to(dev)
    labels = {k: torch.as_tensor(v, device=dev) for k, v in labels.items()}
    return batch, labels, molecules
