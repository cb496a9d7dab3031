"""The traffic generator: raw graphs made from a seed and a traffic file.

A traffic file (``portbench/traffic/<name>.json``) names a ``layout`` and
its parameters. A run draws ``draws`` independent draws, each from its own
seed derived from the run's ``--seed`` and the draw's index, and each draw
is sized to fill one batch of the configuration's data layer.

A layout is a file of its own, ``traffic/layouts/<layout>.py``, found by
name: its ``draw(seed, **params)`` makes one draw from the traffic file's
parameters. ``ppi`` and ``qm9`` copy the port's synthetic workloads
(``tf2_gnn_tpu_torch/workloads.py``) draw for draw.

The arrays are plain numpy and leave the generator unpadded, in draw-local
node ids; the benchmark hands the same draws to the program's data layer
and to the plain reference.
"""
import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from portbench import load_module

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Draw:
    """One draw: the raw graphs of one batch, concatenated in graph order.

    ``edges[l]`` is int32 [E_l, 2] (source, target) in draw-local node ids,
    each graph's edges of a type contiguous and in graph order;
    ``graph_nodes[g]`` and ``graph_edges[l][g]`` give each graph's share.
    ``node_labels`` is f32 [N, C] (node tasks) and ``graph_targets`` f32
    [G] (graph tasks); the other is None."""

    node_features: np.ndarray
    edges: List[np.ndarray]
    graph_nodes: List[int]
    graph_edges: List[List[int]]
    node_labels: Optional[np.ndarray] = None
    graph_targets: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return int(self.node_features.shape[0])

    @property
    def num_graphs(self) -> int:
        return len(self.graph_nodes)

    @property
    def node_to_graph(self) -> np.ndarray:
        return np.repeat(np.arange(self.num_graphs, dtype=np.int32),
                         self.graph_nodes)


def derive_seed(seed: int, *keys: int, bits: int = 32) -> int:
    """A seed of ``bits`` bits for the stream ``keys`` of the run ``seed``
    (any whole number, negative or past 64 bits included)."""
    entropy = [abs(int(seed)), int(seed < 0), *map(int, keys)]
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    value = (int(words[0]) << 32) | int(words[1])
    return value & ((1 << bits) - 1)


def layout(name: str) -> Callable[..., Draw]:
    """The ``draw(seed, **params)`` of ``traffic/layouts/<name>.py``."""
    path = BENCH_DIR / "traffic" / "layouts" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no traffic layout {name!r} ({path})")
    return load_module(path, f"portbench_layout_{name}").draw


def generate(traffic: Dict[str, Any], seed: int) -> List[Draw]:
    """The run's draws: ``traffic["draws"]`` of ``traffic["layout"]``, draw
    ``i`` from ``derive_seed(seed, i)``."""
    params = {k: v for k, v in traffic.items()
              if k not in ("layout", "draws", "why")}
    make = layout(traffic["layout"])
    return [make(derive_seed(seed, i), **params)
            for i in range(int(traffic["draws"]))]


def split_graphs(draw: Draw):
    """The draw's graphs one by one: (node features, [per-type [E, 2]
    edges in graph-local ids], node labels or graph target), each a view
    into the draw's arrays or a slice of one array a type."""
    bounds = np.cumsum(draw.graph_nodes)[:-1]
    starts = np.concatenate([[0], bounds])
    features = np.split(draw.node_features, bounds)
    per_type = []
    for adj, counts in zip(draw.edges, draw.graph_edges):
        local = adj - np.repeat(starts, counts).astype(adj.dtype)[:, None]
        per_type.append(np.split(local, np.cumsum(counts)[:-1]))
    if draw.node_labels is not None:
        labels = np.split(draw.node_labels, bounds)
    else:
        labels = draw.graph_targets.tolist()
    for g in range(draw.num_graphs):
        yield features[g], [t[g] for t in per_type], labels[g]
