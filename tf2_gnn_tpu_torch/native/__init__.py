"""Host-side batch packing (port of the numpy halves of
``tf2_gnn_tpu/native/__init__.py``'s ``pack_nodes`` and ``pack_edges``).

The JAX package binds a C++ data engine (``native/src/graphpack.cc``) and
falls back to these numpy forms when it cannot load it; both give the same
arrays. The port has the numpy forms only: its C++ binding is ROADMAP.md
queue A item 8.
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
