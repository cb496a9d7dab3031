"""Host-side adjacency preprocessing, pure numpy (port of
``tf2_gnn_tpu/data/preprocess.py``, the same code).

Behavioural contract matches the reference's ``tf2_gnn/data/utils.py``
(process_adjacency_lists / get_tied_edge_types / compute_number_of_edge_types,
reference lines data/utils.py:9-133), re-implemented with vectorised numpy:

* Backward edges: for each forward edge type, flipped edges are appended to
  the same type if tied, else collected as a fresh type appended after all
  forward types (in forward-type order).
* Self loops: inserted as a whole edge type at a configurable index
  (negative indices count from the end, range [-(L+1), L] where L is the
  type count after backward-edge addition).
* Returns int32 [E, 2] arrays plus a float [L, V] per-type in-degree table.
"""
from typing import List, Sequence, Set, Tuple, Union

import numpy as np

Edges = np.ndarray  # int32 [E, 2], rows are (source, target)


def _as_edge_array(edges) -> np.ndarray:
    arr = np.asarray(edges, dtype=np.int32)
    if arr.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    return arr.reshape(-1, 2)


def get_tied_edge_types(
    tie_fwd_bkwd_edges: Union[bool, List[int]], num_fwd_edge_types: int
) -> Set[int]:
    """Forward edge types whose backward edges reuse the forward type id.

    >>> sorted(get_tied_edge_types(True, 3))
    [0, 1, 2]
    >>> get_tied_edge_types([1], 3)
    {1}
    """
    if isinstance(tie_fwd_bkwd_edges, list):
        return set(tie_fwd_bkwd_edges)
    if tie_fwd_bkwd_edges:
        return set(range(num_fwd_edge_types))
    return set()


def compute_number_of_edge_types(
    tied_fwd_bkwd_edge_types: Set[int], num_fwd_edge_types: int, add_self_loop_edges: bool
) -> int:
    """Total edge-type count after backward edges and optional self loops."""
    return 2 * num_fwd_edge_types - len(tied_fwd_bkwd_edge_types) + int(add_self_loop_edges)


def _add_backward_edges(
    adjacency_lists: List[np.ndarray], tied_fwd_bkwd_edge_types: Set[int]
) -> List[np.ndarray]:
    result = list(adjacency_lists)
    fresh: List[np.ndarray] = []
    for edge_type, edges in enumerate(adjacency_lists):
        flipped = edges[:, ::-1]
        if edge_type in tied_fwd_bkwd_edge_types:
            result[edge_type] = np.concatenate([edges, flipped], axis=0)
        else:
            fresh.append(flipped)
    return result + fresh


def process_adjacency_lists(
    adjacency_lists: Sequence,
    num_nodes: int,
    add_self_loop_edges: bool,
    tied_fwd_bkwd_edge_types: Set[int],
    self_loop_edge_type: int = 0,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Add backward edges and optional self loops; compute per-type in-degrees.

    Returns (list of int32 [E,2] arrays, float [L, num_nodes] in-degree table).

    >>> adj, deg = process_adjacency_lists(
    ...     [[(0, 1), (1, 2)]], 3, add_self_loop_edges=True,
    ...     tied_fwd_bkwd_edge_types={0})
    >>> adj[0].tolist()  # self loops inserted as type 0
    [[0, 0], [1, 1], [2, 2]]
    >>> adj[1].tolist()  # forward + tied backward edges
    [[0, 1], [1, 2], [1, 0], [2, 1]]
    >>> deg[1].tolist()
    [1.0, 2.0, 1.0]
    """
    typed_edges = [_as_edge_array(adj) for adj in adjacency_lists]
    typed_edges = _add_backward_edges(typed_edges, tied_fwd_bkwd_edge_types)

    if add_self_loop_edges:
        num_types = len(typed_edges)
        lo, hi = -(num_types + 1), num_types
        if not (lo <= self_loop_edge_type <= hi):
            raise AssertionError(
                f"Self loop edge type {self_loop_edge_type} should be in range [{lo}, {hi}]."
            )
        if self_loop_edge_type < 0:
            self_loop_edge_type += num_types + 1
        loops = np.stack([np.arange(num_nodes, dtype=np.int32)] * 2, axis=1)
        typed_edges.insert(self_loop_edge_type, loops)

    type_to_num_incoming = np.zeros((len(typed_edges), num_nodes), dtype=np.float64)
    for edge_type, edges in enumerate(typed_edges):
        if edges.shape[0] > 0:
            type_to_num_incoming[edge_type] = np.bincount(
                edges[:, 1], minlength=num_nodes
            ).astype(np.float64)

    return typed_edges, type_to_num_incoming
