"""The port's locality reordering (``tf2_gnn_tpu_torch/parallel/reorder.py``)
against the JAX package's, and the invariance of the port's partitioned
run under it over a 2-rank gloo cluster of CPU processes.

Host side: ``locality_reorder`` through the bound C++ engine
(``native.rcm_order``), through the numpy forms (``_rcm_numpy``) and the
JAX package's are the same permutation on random, shuffled ring-local,
multi-type, self-loop, isolated-node and empty graphs;
``invert_permutation`` and ``apply_node_permutation`` are array-identical
to JAX's; RCM restores a shuffled ring-local graph's locality, and the
partitioner then picks the ring with neighbour distances only.

The cluster (one module fixture, a 600 s timeout): on a shuffled
ring-local graph, the forward with ``reorder=True`` (per-type pair plans,
K2 / K1, and no plans) restored by ``restore_node_order`` equals the
forward with ``reorder=False`` and the JAX package's, and one SGD step's
loss and parameters are the same either way. Tolerances
(``tests/torch_parallel_cases.py``, those of ``tests/test_spmd.py``):
forwards rtol 2e-4 / atol 2e-5 (2e-4 on the per-type plans); the step's
loss rtol 1e-4, F1 atol 5e-3, the update within 1e-3 of each
parameter's largest update entry.
"""
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.parallel import reorder as jro
from tf2_gnn_tpu_torch import native
from tf2_gnn_tpu_torch.parallel import partition_graph
from tf2_gnn_tpu_torch.parallel import reorder as tro

from .torch_parallel_cases import (
    FWD_TOLS,
    PLAN_FWD_TOLS,
    assert_close,
    assert_step_matches,
    run_cluster,
    spmd_case,
)

WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shuffled_local(seed: int, v: int = 256, features: int = 12):
    """Ring-local edges (ids within +-3) under a random relabelling, two
    edge types."""
    rng = np.random.RandomState(seed)
    nodes = np.arange(v)
    shuf = rng.permutation(v)
    adj = []
    for _ in range(2):
        src = np.clip(nodes.repeat(2) + rng.randint(-3, 4, v * 2), 0, v - 1)
        tgt = np.clip(nodes.repeat(2) + rng.randint(-3, 4, v * 2), 0, v - 1)
        adj.append(np.stack([shuf[src], shuf[tgt]], 1).astype(np.int32))
    nf = rng.randn(v, features).astype(np.float32)
    n2g = np.sort(rng.randint(0, 3, v)).astype(np.int32)
    return nf, adj, n2g, 3


def _random(seed, v=700):
    rng = np.random.RandomState(seed)
    return [np.stack([rng.randint(0, v, e), rng.randint(0, v, e)],
                     1).astype(np.int32) for e in (2000, 900)], v


GRAPHS = {
    "random": lambda: _random(3),
    "local": lambda: (shuffled_local(4)[1], 256),
    "self_loops_and_parallel": lambda: (
        [np.array([[0, 0], [1, 2], [1, 2], [2, 1], [3, 3], [4, 0]],
                  np.int32)], 6),
    "isolated": lambda: ([np.array([[0, 1], [1, 2]], np.int32)], 5),
    "empty": lambda: ([np.zeros((0, 2), np.int32)], 5),
    "no_types": lambda: ([], 4),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_locality_reorder_matches_jax_and_numpy(graph):
    adj, v = GRAPHS[graph]()
    want = jro.locality_reorder(adj, v)
    native.PLANNED.clear()
    got = tro.locality_reorder(adj, v)
    assert native.PLANNED["rcm binding"] == 1
    with native.numpy_forms():
        plain = tro.locality_reorder(adj, v)
    assert native.PLANNED["rcm numpy"] == 1
    assert got.dtype == plain.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    assert sorted(got.tolist()) == list(range(v))


def test_permutation_helpers_match_jax():
    nf, adj, n2g, _ = shuffled_local(5)
    labels = {"node_labels": np.random.RandomState(6).rand(256, 3)}
    perm = tro.locality_reorder(adj, 256)
    np.testing.assert_array_equal(tro.invert_permutation(perm),
                                  jro.invert_permutation(perm))
    got = tro.apply_node_permutation(perm, nf, adj, n2g, labels)
    want = jro.apply_node_permutation(perm, nf, adj, n2g, labels)
    for a, b in zip((got[0], got[2], got[3]["node_labels"]),
                    (want[0], want[2], want[3]["node_labels"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tro.apply_node_permutation(perm, nf, adj, n2g)[3] is None


def test_rcm_recovers_locality_and_the_ring():
    nf, adj, n2g, g = shuffled_local(7)
    scattered, _ = partition_graph(nf, adj, n2g, g, 8, reorder=False)
    perm = tro.locality_reorder(adj, nf.shape[0])
    nf2, adj2, n2g2, _ = tro.apply_node_permutation(perm, nf, adj, n2g)
    bandwidth = np.abs(adj2[0][:, 0].astype(np.int64) - adj2[0][:, 1]).mean()
    assert bandwidth < 10
    local, _ = partition_graph(nf2, adj2, n2g2, g, 8, reorder=False)
    assert local.halo_ring_send is not None
    assert set(local.halo_ring_dists) <= {1, 7}
    rows = sum(i.shape[1] for i in local.halo_ring_send)
    before = (sum(i.shape[1] for i in scattered.halo_ring_send)
              if scattered.halo_ring_send is not None
              else scattered.halo_send_idx.shape[0]
              * scattered.halo_send_idx.shape[2])
    assert rows < before / 4


# -- the cluster -------------------------------------------------------------

NO_EXCHANGE = {"gnn_global_exchange_every_num_layers": 10000}
# (partition, the first layer's route)
CASES = {
    f"{plans}_{'reordered' if reorder else 'as_given'}": (
        dict(num_graphs_padded=4, reorder=reorder, halo="ring",
             **({"build_pair_plans": True, "pair_per_type": True}
                if plans == "typed" else {})),
        "pair_joint" if plans == "typed" else "unfused")
    for plans in ("typed", "none") for reorder in (True, False)
}


@pytest.fixture(scope="module")
def cluster():
    graph = shuffled_local(8)
    cases, refs = [], []
    for name, (partition, _) in CASES.items():
        case, ref = spmd_case(name, "node", "rgcn", WORLD, partition,
                              graph=graph, train=True, **NO_EXCHANGE)
        cases.append(case)
        refs.append(ref)
    results = run_cluster(cases, WORLD)
    return [c["name"] for c in cases], refs, results


@pytest.mark.parametrize("plans", ["typed", "none"])
def test_output_invariant_under_reorder(cluster, plans):
    names, refs, results = cluster
    i = names.index(f"{plans}_reordered")
    j = names.index(f"{plans}_as_given")
    tols = PLAN_FWD_TOLS if plans == "typed" else FWD_TOLS
    for k in (i, j):
        assert results[0][k]["route"] == CASES[names[k]][1]
        assert_close(results[0][k]["forward"], refs[k]["jax_forward"], tols,
                     f"{names[k]} against JAX's SPMD")
        n = refs[k]["num_nodes"]
        assert_close(results[0][k]["forward"][:n],
                     refs[k]["port_forward"][:n], tols,
                     f"{names[k]} against the single process")
        assert_step_matches(results[0][k]["metrics"],
                            results[0][k]["params"], refs[k]["jax_metrics"],
                            refs[k]["jax_params"], refs[k]["initial"],
                            f"{names[k]}: JAX")
    assert_close(results[0][i]["forward"], results[0][j]["forward"], tols,
                 "reordered against as given")
    assert_step_matches(results[0][i]["metrics"], results[0][i]["params"],
                        results[0][j]["metrics"], results[0][j]["params"],
                        refs[i]["initial"], "reordered against as given")
