"""Locality-aware node reordering for giant-graph partitioning (port of
``tf2_gnn_tpu/parallel/reorder.py``).

``partition_graph`` cuts contiguous node ranges, so its boundary rows (the
halo bytes of every layer, and whether the ring wire form wins) depend on
how local the node ids are. A reverse Cuthill-McKee pass over the
undirected union of all edge types relabels the nodes so that neighbours
get nearby ids, which shrinks every shard's boundary, concentrates the
active ring distances near +-1 and packs the plans' blocks tighter.

``locality_reorder`` runs in the port's C++ engine
(``native/graphpack.cc::gp_rcm_order``, bound by ``native.rcm_order``); a
failed build raises. ``_rcm_numpy`` is its plain version, which
``native.numpy_forms()`` switches to.

Usage::

    perm = locality_reorder(adjacency_lists, num_nodes)
    nf, adj, n2g, labels = apply_node_permutation(perm, nf, adj, n2g, labels)
    # per-node outputs come back in the new order; out_new[inv[old_ids]]
    # with inv = invert_permutation(perm) restores them.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native


def _rcm_numpy(num_nodes: int, deg: np.ndarray, indptr: np.ndarray,
               indices: np.ndarray) -> np.ndarray:
    perm = np.empty(num_nodes, np.int32)
    seen = np.zeros(num_nodes, bool)
    pos = 0
    for start in np.argsort(deg, kind="stable"):
        if seen[start]:
            continue
        seen[start] = True
        perm[pos] = start
        head = pos
        pos += 1
        while head < pos:
            u = perm[head]
            head += 1
            nb = indices[indptr[u]:indptr[u + 1]]
            nb = np.unique(nb[~seen[nb]])  # dedupe parallel edges, id-sorted
            if nb.size:
                nb = nb[np.argsort(deg[nb], kind="stable")]  # (deg, id) order
                seen[nb] = True
                perm[pos:pos + nb.size] = nb
                pos += nb.size
    return perm[::-1].copy()


def rcm_numpy(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """The RCM permutation of ``edges`` (int32 [E, 2]) in numpy: the
    undirected CSR without self loops, then ``_rcm_numpy``."""
    mask = edges[:, 0] != edges[:, 1]
    und = np.concatenate([edges[mask], edges[mask][:, ::-1]], axis=0)
    deg = np.bincount(und[:, 0], minlength=num_nodes).astype(np.int64)
    order = np.argsort(und[:, 0], kind="stable")
    indices = und[order, 1].astype(np.int32)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return _rcm_numpy(num_nodes, deg, indptr, indices)


def locality_reorder(adjacency_lists: Sequence[np.ndarray],
                     num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation over the union of all edge types.

    Returns ``perm`` (int32 [num_nodes]) listing OLD node ids in the new
    order: new position i holds old node ``perm[i]``.
    """
    parts = [np.asarray(a, np.int32).reshape(-1, 2)
             for a in adjacency_lists if np.asarray(a).size]
    edges = (np.ascontiguousarray(np.concatenate(parts, axis=0))
             if parts else np.zeros((0, 2), np.int32))
    if not native.binding_on():
        native.PLANNED["rcm numpy"] += 1
        return rcm_numpy(edges, num_nodes)
    native.PLANNED["rcm binding"] += 1
    return native.rcm_order(edges, num_nodes)


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """``inv[old_id] = new position`` — index per-node outputs of the
    reordered run with ``out_new[inv]`` to restore the original order."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def apply_node_permutation(
    perm: np.ndarray,
    node_features: np.ndarray,
    adjacency_lists: Sequence[np.ndarray],
    node_to_graph: np.ndarray,
    node_labels: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray,
           Optional[Dict[str, np.ndarray]]]:
    """Relabel a graph's node ids by ``perm`` (rows AND edge endpoints)."""
    inv = invert_permutation(perm)
    adj = [inv[np.asarray(a, np.int32).reshape(-1, 2)]
           for a in adjacency_lists]
    labels = None
    if node_labels is not None:
        labels = {k: v[perm] for k, v in node_labels.items()}
    return node_features[perm], adj, node_to_graph[perm], labels
