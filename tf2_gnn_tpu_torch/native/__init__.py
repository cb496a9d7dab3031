"""ctypes binding of the port's C++ host engine (``graphpack.cc``, the
port's own copy of the JAX package's ``native/src/graphpack.cc``; port of
``tf2_gnn_tpu/native/__init__.py``).

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC
-shared`` into ``build/tf2_gnn_tpu_torch/`` beside the package (the
checkout's git-ignored ``build/``), named by a hash of the source and the
flags, and moved into place atomically, so concurrent first builds (test
workers) agree. No ``-march=native``: a library built on one host loads on
any other of the same architecture. A failed build raises with the
compiler's output; nothing falls back quietly.

The entry points keep the JAX binding's signatures and pointer handling
(C-contiguous int32 / float32 / float64 / int64 buffers allocated here).
The numpy forms (``plain.py`` for the packers, the planners' own numpy
forms in ``ops/``) are the plain versions; ``numpy_forms()`` runs the
packers and planners on them for its duration (process-wide), which is how
the tests and ``chip_smoke.py`` compare the two. ``PLANNED`` counts which
planner planned each direction or stream (``pair binding``, ``pair numpy
spill``, ``pair numpy``, ``scatter binding``, ``scatter numpy``); the
tracing registry reads them as ``planned.<name>``.
"""
import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from . import plain

SOURCE = Path(__file__).resolve().parent / "graphpack.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tf2_gnn_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

PLANNED = collections.Counter()

_lib = None
_lock = threading.Lock()
_use_binding = True

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_ptrs = ctypes.POINTER(ctypes.c_void_p)
_i64 = ctypes.c_int64

# The twelve extern "C" entry points of graphpack.cc: (restype, argtypes).
SIGNATURES = {
    "gp_expand_edges": (_i64, [_i32p, _i64, ctypes.c_int, _i32p]),
    "gp_flip_edges": (None, [_i32p, _i64, _i32p]),
    "gp_self_loops": (None, [_i64, _i32p]),
    "gp_in_degrees": (None, [_i32p, _i64, _i64, _f64p]),
    "gp_pack_nodes": (None, [_ptrs, _i32p, _i64, _i64, _i64, ctypes.c_int32,
                             _f32p, _i32p]),
    "gp_pack_edges": (_i64, [_ptrs, _i64p, _i32p, _i64, _i64, ctypes.c_int32,
                             _i32p, _i32p]),
    "gp_pack_labels": (None, [_ptrs, _i32p, _i64, _i64, _i64, _f32p]),
    "gp_sort_by_target": (None, [_i32p, _i32p, _i64, _i32p, _i32p, _i32p]),
    "gp_scatter_plan": (_i64, [_i32p, _i32p, _i64, _i64, _i64, _i64, _i32p,
                               _i32p, _i32p]),
    "gp_pair_plan": (_i64, [_i32p, _i32p, _i64, _i64, _i64, _i64, _i64,
                            _i32p, _i32p, _i32p, _i32p, _i64p]),
    "gp_pair_plan_count": (_i64, [_i32p, _i32p, _i64, _i64, _i64, _i64]),
    "gp_rcm_order": (None, [_i32p, _i64, _i64, _i32p]),
}


def find_cxx() -> str:
    """``$CXX``, else ``g++`` on PATH. Raises when neither exists."""
    for name in (os.environ.get("CXX"), "g++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError("g++ not found ($CXX or PATH): the port's C++ host "
                       "engine (native/graphpack.cc) cannot be built.")


def library_path() -> Path:
    """The library's path, named by a hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgraphpack_{digest[:16]}.so"


def build() -> Optional[str]:
    """Compile the library if it is missing; returns the compiler's output
    (None when it was built before). Raises with that output on failure."""
    target = library_path()
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([find_cxx(), *CXX_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds agree
    return proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                build()
                lib = ctypes.CDLL(str(library_path()))
                for name, (restype, argtypes) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = lib
    return _lib


def available() -> bool:
    """True once the library is built and loaded (building it now if
    needed; a failed build raises)."""
    return _load() is not None


def binding_on() -> bool:
    """False inside ``numpy_forms()``."""
    return _use_binding


@contextlib.contextmanager
def numpy_forms():
    """Run the packers and planners on their numpy forms for the duration
    (process-wide, worker threads included)."""
    global _use_binding
    previous, _use_binding = _use_binding, False
    try:
        yield
    finally:
        _use_binding = previous


def _ptr_array(arrays: Sequence[np.ndarray]):
    ptrs = (ctypes.c_void_p * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data_as(ctypes.c_void_p).value
    return ptrs


def _check_rows(entry: str, arrays, cols: int, counts, rows_pad: int) -> None:
    """The buffers a packer hands to C++: [n_g, cols] each, their rows
    fitting the padded buffer."""
    if any(a.ndim != 2 or a.shape[1] != cols for a in arrays):
        raise ValueError(f"{entry}: every array must have {cols} columns")
    if int(counts.sum()) > rows_pad:
        raise ValueError(f"{entry}: {int(counts.sum())} rows overflow the "
                         f"padded {rows_pad}")


# ---------------------------------------------------------------------------
# Entry points (the JAX binding's signatures).

def pack_nodes(
    features: Sequence[np.ndarray],
    v_pad: int,
    pad_graph_id: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate per-graph node features into a zero-padded [v_pad, D]
    buffer + the node->graph map (pads -> pad_graph_id)."""
    if not _use_binding:
        return plain.pack_nodes(features, v_pad, pad_graph_id)
    features = [np.ascontiguousarray(f, dtype=np.float32) for f in features]
    feat_dim = features[0].shape[1]
    counts = np.asarray([f.shape[0] for f in features], dtype=np.int32)
    _check_rows("pack_nodes", features, feat_dim, counts, v_pad)
    out = np.empty((v_pad, feat_dim), dtype=np.float32)
    n2g = np.empty((v_pad,), dtype=np.int32)
    _load().gp_pack_nodes(_ptr_array(features), counts, len(features),
                          feat_dim, v_pad, pad_graph_id, out, n2g)
    return out, n2g


def pack_edges(
    edges: Sequence[np.ndarray],
    graph_num_nodes: Sequence[int],
    budget: int,
    pad_node: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Concatenate one edge type across graphs with node-index offsets into
    padded (src, tgt) arrays. Returns (src, tgt, real_count); raises on a
    budget overflow."""
    if not _use_binding:
        return plain.pack_edges(edges, graph_num_nodes, budget, pad_node)
    edges = [np.ascontiguousarray(e, dtype=np.int32).reshape(-1, 2)
             for e in edges]
    counts = np.asarray([e.shape[0] for e in edges], dtype=np.int64)
    nodes = np.ascontiguousarray(graph_num_nodes, dtype=np.int32)
    src = np.empty((budget,), dtype=np.int32)
    tgt = np.empty((budget,), dtype=np.int32)
    written = _load().gp_pack_edges(_ptr_array(edges), counts, nodes,
                                    len(edges), budget, pad_node, src, tgt)
    if written < 0:
        raise ValueError(f"Edge budget {budget} overflowed while packing.")
    return src, tgt, int(written)


def pack_labels(labels: Sequence[np.ndarray], rows_pad: int) -> np.ndarray:
    """Concatenate per-graph float32 label arrays, zero-padded to rows_pad."""
    if not _use_binding:
        return plain.pack_labels(labels, rows_pad)
    labels = [np.ascontiguousarray(l, dtype=np.float32) for l in labels]
    labels2d = [np.ascontiguousarray(l.reshape(l.shape[0], -1))
                for l in labels]
    cols = labels2d[0].shape[1]
    counts = np.asarray([l.shape[0] for l in labels2d], dtype=np.int32)
    _check_rows("pack_labels", labels2d, cols, counts, rows_pad)
    out = np.empty((rows_pad, cols), dtype=np.float32)
    _load().gp_pack_labels(_ptr_array(labels2d), counts, len(labels2d), cols,
                           rows_pad, out)
    trailing = labels[0].shape[1:] if labels[0].ndim > 1 else ()
    return out.reshape((rows_pad,) + trailing) if trailing else out[:, 0]


def sort_by_target(src: np.ndarray, tgt: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable-sort an edge list by target; returns (src', tgt', permutation)."""
    if not _use_binding:
        return plain.sort_by_target(src, tgt)
    src = np.ascontiguousarray(src, dtype=np.int32)
    tgt = np.ascontiguousarray(tgt, dtype=np.int32)
    n = src.shape[0]
    src_out, tgt_out = np.empty_like(src), np.empty_like(tgt)
    perm = np.empty((n,), dtype=np.int32)
    _load().gp_sort_by_target(src, tgt, n, src_out, tgt_out, perm)
    return src_out, tgt_out, perm


def scatter_plan(sorted_vals: np.ndarray, order: np.ndarray, num_chunks: int,
                 chunk_edges: int, block_nodes: int, perm: np.ndarray,
                 rel: np.ndarray, block_ids: np.ndarray) -> int:
    """The chunked scatter planner over value-sorted edges, into the
    caller's ``perm`` / ``rel`` / ``block_ids`` (int32, C-contiguous);
    returns the chunks used, or -1 on overflow."""
    slots = num_chunks * chunk_edges
    if (perm.size < slots or rel.size < slots or block_ids.size < num_chunks
            or order.shape[0] < sorted_vals.shape[0]):
        raise ValueError(f"scatter_plan buffers too small for {num_chunks} "
                         f"chunks of {chunk_edges} slots")
    return int(_load().gp_scatter_plan(
        np.ascontiguousarray(sorted_vals, dtype=np.int32),
        np.ascontiguousarray(order, dtype=np.int32),
        sorted_vals.shape[0], num_chunks, chunk_edges, block_nodes,
        perm, rel, block_ids))


def pair_plan(src: np.ndarray, tgt: np.ndarray, budget: int, group: int,
              blk: int, e_c: int):
    """The block-pair planner for one direction (no spilling). Returns
    (chunks_used, rel_src, rel_tgt, src_blk, tgt_blk, edge_slot) with
    chunks_used == -1 on a budget overflow, where the caller runs the
    numpy planner, the only one that spills."""
    n = int(src.shape[0])
    src = np.ascontiguousarray(src, dtype=np.int32)
    tgt = np.ascontiguousarray(tgt, dtype=np.int32)
    rel_src = np.empty((budget * e_c,), np.int32)
    rel_tgt = np.empty((budget * e_c,), np.int32)
    src_blk = np.empty((budget,), np.int32)
    tgt_blk = np.empty((budget,), np.int32)
    edge_slot = np.empty((n,), np.int64)
    used = int(_load().gp_pair_plan(src, tgt, n, budget, group, blk, e_c,
                                    rel_src, rel_tgt, src_blk, tgt_blk,
                                    edge_slot))
    return used, rel_src, rel_tgt, src_blk, tgt_blk, edge_slot


def pair_plan_count(src: np.ndarray, tgt: np.ndarray, group: int, blk: int,
                    e_c: int) -> int:
    """Run-aligned chunk total one pair-plan direction needs (the
    count-only twin of ``pair_plan``; 0 for no edges)."""
    return int(_load().gp_pair_plan_count(
        np.ascontiguousarray(src, dtype=np.int32),
        np.ascontiguousarray(tgt, dtype=np.int32),
        int(src.shape[0]), group, blk, e_c))


def rcm_order(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node permutation over the undirected union of
    ``edges`` (int32 [E, 2], all types concatenated): perm[new] = old."""
    edges = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1, 2)
    perm = np.empty((num_nodes,), dtype=np.int32)
    _load().gp_rcm_order(edges, edges.shape[0], num_nodes, perm)
    return perm


def in_degrees(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """float64 [num_nodes] in-degree counts for one edge type."""
    if not _use_binding:
        return plain.in_degrees(edges, num_nodes)
    edges = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1, 2)
    out = np.empty((num_nodes,), dtype=np.float64)
    _load().gp_in_degrees(edges, edges.shape[0], num_nodes, out)
    return out
