"""The numpy forms of the C++ engine's packers (port of the numpy halves of
``tf2_gnn_tpu/native/__init__.py``).

They give the same arrays as ``graphpack.cc``'s entry points and are the
plain versions the tests hold the binding to. The planners' numpy forms
live beside their callers: ``ops/pair_spmm.py::_plan_one_direction_numpy``
(also the spill path, the only planner that spills) and
``ops/sorted_spmm.py::plan_sorted_scatter_numpy``.
"""
from typing import Sequence, Tuple

import numpy as np


def pack_nodes(
    features: Sequence[np.ndarray],
    v_pad: int,
    pad_graph_id: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate per-graph node features into a zero-padded [v_pad, D]
    buffer + the node->graph map (pads -> pad_graph_id)."""
    features = [np.ascontiguousarray(f, dtype=np.float32) for f in features]
    feat_dim = features[0].shape[1]
    counts = np.asarray([f.shape[0] for f in features], dtype=np.int32)
    out = np.empty((v_pad, feat_dim), dtype=np.float32)
    n2g = np.empty((v_pad,), dtype=np.int32)
    total = int(counts.sum())
    out[:total] = np.concatenate(features, axis=0)
    out[total:] = 0.0
    n2g[:total] = np.repeat(np.arange(len(features), dtype=np.int32), counts)
    n2g[total:] = pad_graph_id
    return out, n2g


def pack_edges(
    edges: Sequence[np.ndarray],
    graph_num_nodes: Sequence[int],
    budget: int,
    pad_node: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Concatenate one edge type across graphs with node-index offsets into
    padded (src, tgt) arrays. Returns (src, tgt, real_count)."""
    edges = [np.ascontiguousarray(e, dtype=np.int32).reshape(-1, 2)
             for e in edges]
    nodes = np.asarray(graph_num_nodes, dtype=np.int32)
    src = np.empty((budget,), dtype=np.int32)
    tgt = np.empty((budget,), dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(nodes[:-1])])
    pieces = [e + off for e, off in zip(edges, offsets) if e.shape[0]]
    flat = (np.concatenate(pieces, axis=0) if pieces
            else np.zeros((0, 2), dtype=np.int32))
    if flat.shape[0] > budget:
        raise ValueError(f"Edge budget {budget} overflowed while packing.")
    src[: flat.shape[0]] = flat[:, 0]
    tgt[: flat.shape[0]] = flat[:, 1]
    src[flat.shape[0]:] = pad_node
    tgt[flat.shape[0]:] = pad_node
    return src, tgt, flat.shape[0]


def pack_labels(labels: Sequence[np.ndarray], rows_pad: int) -> np.ndarray:
    """Concatenate per-graph float32 label arrays, zero-padded to rows_pad."""
    labels = [np.ascontiguousarray(l, dtype=np.float32) for l in labels]
    labels2d = [l.reshape(l.shape[0], -1) for l in labels]
    cols = labels2d[0].shape[1]
    total = sum(l.shape[0] for l in labels2d)
    out = np.empty((rows_pad, cols), dtype=np.float32)
    out[:total] = np.concatenate(labels2d, axis=0)
    out[total:] = 0.0
    trailing = labels[0].shape[1:] if labels[0].ndim > 1 else ()
    return out.reshape((rows_pad,) + trailing) if trailing else out[:, 0]


def sort_by_target(src: np.ndarray, tgt: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable-sort an edge list by target; returns (src', tgt', permutation)."""
    src = np.ascontiguousarray(src, dtype=np.int32)
    tgt = np.ascontiguousarray(tgt, dtype=np.int32)
    order = np.argsort(tgt, kind="stable").astype(np.int32)
    return src[order], tgt[order], order


def in_degrees(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """float64 [num_nodes] in-degree counts for one edge type."""
    edges = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1, 2)
    if edges.shape[0] == 0:
        return np.zeros((num_nodes,), dtype=np.float64)
    return np.bincount(edges[:, 1], minlength=num_nodes).astype(np.float64)
