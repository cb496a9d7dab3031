"""The port's partitioner and stacking against the JAX package's, on the
host, and its partitioned forward on every plan kind over a 2-rank gloo
cluster of CPU processes against the JAX package's on 2 virtual devices.

Host side (numpy, no processes):

* ``partition_graph`` is array-identical to the JAX package's (every array
  field, its static fields and the stacked labels) for every halo form
  (``"auto"``, ``"dense"``, ``"ring"``, ``False``) and reorder choice, and
  with scatter, merged, merged-target and per-type pair plans, on a random
  and on a shuffled ring-local graph;
* ``restore_node_order``, ``stack_batches``, ``shard_batches`` and
  ``stack_partitioned_batches`` (and its two rejections) match JAX's;
  ``GraphBatch.shard`` takes back what ``stack`` stacked;
* ``ReorderEngaged`` fires exactly where JAX's does;
* ``workloads.scaling_graph`` is array-identical to the graph that the JAX
  package's ``benchmarks/scaling.py::run_at`` builds from the same seed,
  and ``scaling_partition`` to its partition.

The cluster (one module fixture, a 600 s timeout): the forward of the
flavours on scatter plans (halo), on scatter plans and on none with the
all_gather (``halo=False``), on merged, merged-target and per-type pair
plans, and one SGD step on per-type plans, against the JAX package's
partitioned runs and the port's single process; and a partition with no
boundary emits no halo collective. Tolerances
(``tests/torch_parallel_cases.py``, those of ``tests/test_spmd.py``):
forwards rtol 2e-4 / atol 2e-4; the step's loss rtol 1e-4, F1 atol
5e-3, the update within 1e-3 of each parameter's largest update entry;
the host side is array-identical.
"""
import warnings
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from tf2_gnn_tpu import parallel as jparallel
from tf2_gnn_tpu.data import graph_batch as jgb
from tf2_gnn_tpu.parallel import spmd as jspmd
from tf2_gnn_tpu_torch import parallel as tparallel
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.data import graph_batch as tgb
from tf2_gnn_tpu_torch.parallel import spmd as tspmd

from .test_spmd import _giant_graph
from .torch_parallel_cases import (
    PLAN_FWD_TOLS,
    assert_close,
    assert_step_matches,
    dp_batches,
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


def local_graph(seed: int, v: int = 160, shuffle: bool = True):
    """Ring-local connectivity (ids within +-4), its labels shuffled."""
    rng = np.random.RandomState(seed)
    nodes = np.arange(v)
    src = np.clip(nodes.repeat(3) + rng.randint(-4, 5, v * 3), 0, v - 1)
    tgt = np.clip(nodes.repeat(3) + rng.randint(-4, 5, v * 3), 0, v - 1)
    perm = rng.permutation(v) if shuffle else nodes
    adj = [np.stack([perm[src], perm[tgt]], 1).astype(np.int32)]
    nf = rng.randn(v, 6).astype(np.float32)
    return nf, adj, np.zeros((v,), np.int32), 1


def jax_arrays(batch):
    leaves, _ = jax.tree_util.tree_flatten_with_path(batch)
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in leaves]


def assert_batches_identical(tbatch, jbatch):
    """Every array field of the port's batch equals the JAX batch's leaf
    in the same place (shape, dtype and values), and the static fields
    agree."""
    want = jax_arrays(jbatch)
    got = [(p, np.asarray(x)) for p, x in tbatch.array_fields()]
    assert [p for p, _ in got] == [p.lstrip(".") for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    for name in ("num_graphs_padded", "spmd_axis", "spmd_num_shards",
                 "halo_ext_nodes", "halo_ring_dists", "pair_targets_merged"):
        assert getattr(tbatch, name) == getattr(jbatch, name), name


GRAPHS = {"random": lambda: _giant_graph(num_nodes=200, seed=21),
          "local": lambda: local_graph(3)}
PARTITIONS = {
    **{f"halo_{h}_reorder_{r}": dict(halo=h, reorder=r)
       for h in ("auto", "dense", "ring", False)
       for r in ("auto", True, False)},
    "scatter": dict(build_scatter_plans=True),
    "scatter_all_gather": dict(build_scatter_plans=True, halo=False),
    "pairs": dict(build_pair_plans=True, halo="dense"),
    "merged_targets": dict(build_pair_plans=True, pair_merge_targets=True,
                           halo="ring"),
    "typed_dense": dict(build_pair_plans=True, pair_per_type=True,
                        halo="dense", reorder=True),
    "typed_auto": dict(build_pair_plans=True, pair_per_type=True),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", list(PARTITIONS))
def test_partition_graph_array_identical(name, graph):
    nf, adj, n2g, g = GRAPHS[graph]()
    labels = {"node_labels": np.random.RandomState(2).rand(
        nf.shape[0], 3).astype(np.float32)}
    graph_labels = {"target_value": np.arange(g, dtype=np.float32)}
    kwargs = dict(num_graphs_padded=g + 2, node_labels=labels,
                  graph_labels=graph_labels, **PARTITIONS[name])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jb, jl = jparallel.partition_graph(nf, adj, n2g, g, 4, **kwargs)
        tb, tl = tparallel.partition_graph(nf, adj, n2g, g, 4, **kwargs)
    assert_batches_identical(tb, jb)
    assert sorted(tl) == sorted(jl)
    for key in jl:
        np.testing.assert_array_equal(tl[key], jl[key], err_msg=key)
        assert tl[key].dtype == jl[key].dtype


def test_build_pair_plans_needs_a_halo():
    nf, adj, n2g, g = _giant_graph()
    with pytest.raises(ValueError, match="requires a halo form"):
        tparallel.partition_graph(nf, adj, n2g, g, 4, halo=False,
                                  build_pair_plans=True)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_boundary_row_count_matches_jax(graph):
    nf, adj, _, _ = GRAPHS[graph]()
    perm = tparallel.locality_reorder(adj, nf.shape[0])
    inv = tparallel.invert_permutation(perm).astype(np.int64)
    for rows in (8, 40, 64):
        for relabel in (None, inv):
            assert (tspmd._boundary_row_count(adj, rows, relabel)
                    == jspmd._boundary_row_count(adj, rows, relabel))


@pytest.mark.parametrize("reorder", [False, True])
def test_restore_node_order_matches_jax(reorder):
    nf, adj, n2g, g = local_graph(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jb, _ = jparallel.partition_graph(nf, adj, n2g, g, 4,
                                          reorder=reorder)
        tb, _ = tparallel.partition_graph(nf, adj, n2g, g, 4,
                                          reorder=reorder)
    out = np.random.RandomState(6).randn(4, tb.num_nodes_padded, 5).astype(
        np.float32)
    want = jparallel.restore_node_order(out, jb)
    got = tparallel.restore_node_order(out, tb)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tparallel.restore_node_order(torch.as_tensor(out), tb), want)
    np.testing.assert_array_equal(
        tparallel.restore_node_order(out.reshape(-1, 5), tb), want)


def test_stack_and_shard_batches_match_jax():
    jpairs = dp_batches(jgb, 7)
    tpairs = dp_batches(tgb, 7)
    jb, jl = jparallel.stack_batches([b for b, _ in jpairs],
                                     [l for _, l in jpairs])
    tb, tl = tparallel.stack_batches([b for b, _ in tpairs],
                                     [l for _, l in tpairs])
    assert_batches_identical(tb, jb)
    np.testing.assert_array_equal(tl["target_value"], jl["target_value"])
    for i, (b, _) in enumerate(tpairs):
        one = tb.shard(i)
        assert one.num_nodes == b.num_nodes and one.num_graphs == b.num_graphs
        for (path, x), (_, y) in zip(one.array_fields(), b.array_fields()):
            np.testing.assert_array_equal(x, y, err_msg=path)
    jgroups = list(jparallel.shard_batches(iter(jpairs), 3))
    tgroups = list(tparallel.shard_batches(iter(tpairs), 3))
    assert len(tgroups) == len(jgroups) == 1   # the partial group drops
    assert_batches_identical(tgroups[0][0], jgroups[0][0])
    with pytest.raises(ValueError, match="at least one batch"):
        tparallel.stack_batches([], [])


def _replicas(seeds=(0, 1)):
    """Two replicas of one shuffled local graph's edges (so their static
    structure agrees), each with its own features."""
    out = []
    for seed in seeds:
        nf, adj, n2g, g = local_graph(10)
        nf = np.random.RandomState(seed).randn(*nf.shape).astype(np.float32)
        labels = {"node_labels": np.ones((nf.shape[0], 2), np.float32)}
        out.append((nf, adj, n2g, g, labels))
    return out


def _partition_both(replicas, **partition):
    parts = {}
    for name, module in (("jax", jparallel), ("port", tparallel)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            parts[name] = [module.partition_graph(
                nf, adj, n2g, g, 2, num_graphs_padded=2, node_labels=lab,
                **partition) for nf, adj, n2g, g, lab in replicas]
    return parts


def test_stack_partitioned_batches_matches_jax():
    parts = _partition_both(_replicas(), halo="ring", reorder=False,
                            build_pair_plans=True, pair_per_type=True)
    jb, jl = jparallel.stack_partitioned_batches(
        [b for b, _ in parts["jax"]], [l for _, l in parts["jax"]])
    tb, tl = tparallel.stack_partitioned_batches(
        [b for b, _ in parts["port"]], [l for _, l in parts["port"]])
    assert_batches_identical(tb, jb)
    np.testing.assert_array_equal(tl["node_labels"], jl["node_labels"])
    one = tb.shard((1, 0))
    assert one.num_nodes == int(parts["port"][1][0].num_nodes[0])


def test_stack_partitioned_batches_rejects_like_jax():
    """Replicas whose reorder outcome differs (a self-loop replica and a
    shuffled local one under ``reorder="auto"``), and replicas whose leaf
    shapes differ, fail with JAX's messages."""
    v = 64
    nodes = np.arange(v)
    loops = [np.stack([nodes, nodes], 1).astype(np.int32)]
    nf, shuffled, n2g, g = local_graph(3, v=v)
    nf = nf[:, :6]
    for name, module in (("jax", jparallel), ("port", tparallel)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            reps = [module.partition_graph(nf, adj, n2g, 1, 4,
                                           num_graphs_padded=2)
                    for adj in (loops, shuffled)]
        assert reps[0][0].node_restore is None, name
        assert reps[1][0].node_restore is not None, name
        with pytest.raises(ValueError, match="reorder=False"):
            module.stack_partitioned_batches([b for b, _ in reps],
                                             [l for _, l in reps])
        reps = [module.partition_graph(
            np.zeros((v, dim), np.float32), loops, n2g, 1, 4,
            num_graphs_padded=2, reorder=False) for dim in (6, 8)]
        with pytest.raises(ValueError, match="node_features"):
            module.stack_partitioned_batches([b for b, _ in reps],
                                             [l for _, l in reps])


@pytest.mark.parametrize("reorder,graph,warns", [
    ("auto", "local", True), ("auto", "loops", False),
    (True, "local", False), (False, "local", False)])
def test_reorder_engaged_warns_like_jax(reorder, graph, warns):
    if graph == "local":
        nf, adj, n2g, g = local_graph(4)
    else:
        nodes = np.arange(96)
        adj = [np.stack([nodes, nodes], 1).astype(np.int32)]
        nf, n2g, g = np.zeros((96, 3), np.float32), np.zeros(96, np.int32), 1
    for module, category in ((jspmd, jspmd.ReorderEngaged),
                             (tspmd, tspmd.ReorderEngaged)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            module.partition_graph(nf, adj, n2g, g, 4, reorder=reorder)
        engaged = [w for w in caught if issubclass(w.category, category)]
        assert len(engaged) == (1 if warns else 0), module.__name__
        if warns:
            assert "restore_node_order" in str(engaged[0].message)


class _Captured(Exception):
    pass


def test_scaling_workload_matches_run_at():
    """``run_at``'s arrays, captured at its ``partition_graph`` call (the
    mock raises there, before any training), against ``scaling_graph`` and
    ``scaling_partition`` at a cut size; the model's hyperparameters
    against ``scaling_params``."""
    import benchmarks.scaling as scaling

    seen = {}

    def capture(nf, adjacency, node_to_graph, **kwargs):
        seen.update(nf=nf, adjacency=adjacency, node_to_graph=node_to_graph,
                    kwargs=kwargs)
        raise _Captured()

    from tf2_gnn_tpu.models.node_multiclass_task import NodeMulticlassTask

    real_from_params = NodeMulticlassTask.from_params

    def from_params(params, *args, **kwargs):
        seen["params"] = dict(params)
        return real_from_params(params, *args, **kwargs)

    with mock.patch.object(jparallel, "partition_graph", capture), \
            mock.patch.object(NodeMulticlassTask, "from_params",
                              from_params):
        with pytest.raises(_Captured):
            scaling.run_at(2, 256, 2048, hidden=256, layers=4, steps=3)
    nf, adj, n2g, labels = workloads.scaling_graph(2, 256, 2048)
    np.testing.assert_array_equal(nf, seen["nf"])
    assert nf.dtype == seen["nf"].dtype
    for a, b in zip(adj, seen["adjacency"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(n2g, seen["node_to_graph"])
    np.testing.assert_array_equal(labels,
                                  seen["kwargs"]["node_labels"]["node_labels"])
    assert {k: v for k, v in seen["kwargs"].items() if k != "node_labels"} == {
        "num_graphs": 1, "num_shards": 2, "num_graphs_padded": 2,
        "build_pair_plans": True}
    assert workloads.scaling_params() == seen["params"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tb, tl = workloads.scaling_partition(2, nodes_per_shard=256,
                                             edges_per_shard=2048)
        jb, jl = jparallel.partition_graph(
            seen["nf"], seen["adjacency"], seen["node_to_graph"],
            **seen["kwargs"])
    assert_batches_identical(tb, jb)


# -- the cluster -------------------------------------------------------------

NO_REORDER = dict(num_graphs_padded=4, reorder=False)
# (flavour, partition, the first layer's route)
CASES = {
    **{f"{flavour}_scatter": (flavour, dict(NO_REORDER, halo="dense",
                                             build_scatter_plans=True), route)
       for flavour, route in (("rgcn", "scatter_sum"),
                              ("ggnn", "scatter_sum"),
                              ("rgin", "scatter_sum"), ("rgat", "sorted"),
                              ("gnn_edge_mlp", "scatter_one_hidden"),
                              ("gnn_edge_mlp0", "scatter_zero_hidden"),
                              ("gnn_film", "scatter_film"))},
    "rgat_scatter_all_gather": ("rgat", dict(NO_REORDER, halo=False,
                                             build_scatter_plans=True),
                                "sorted"),
    "edge_mlp_scatter_all_gather": ("gnn_edge_mlp", dict(
        NO_REORDER, halo=False, build_scatter_plans=True),
        "scatter_one_hidden"),
    "rgcn_all_gather": ("rgcn", dict(NO_REORDER, halo=False), "unfused"),
    "rgat_all_gather": ("rgat", dict(NO_REORDER, halo=False), "unfused"),
    **{f"{flavour}_pairs": (flavour, dict(NO_REORDER, halo="dense",
                                           build_pair_plans=True), route)
       for flavour, route in (("rgcn", "pair_merged"),
                              ("ggnn", "pair_merged"),
                              ("rgin", "pair_merged"),
                              ("rgat", "pair_attention"))},
    **{f"{flavour}_merged_targets": (flavour, dict(
        NO_REORDER, halo="ring", build_pair_plans=True,
        pair_merge_targets=True), route)
       for flavour, route in (("gnn_edge_mlp0", "factorised"),
                              ("gnn_edge_mlp", "relu_pair"),
                              ("gnn_film", "factorised"))},
    **{f"{flavour}_typed_{halo}": (flavour, dict(
        NO_REORDER, halo=halo, build_pair_plans=True, pair_per_type=True),
        route)
       for flavour, halo, route in (("rgcn", "dense", "pair_joint"),
                                    ("ggnn", "ring", "pair_joint"),
                                    ("rgin", "dense", "pair_joint"),
                                    ("gnn_film", "ring", "factorised"))},
}
TRAIN_CASES = {"rgcn_typed_train": ("rgcn", dict(
    NO_REORDER, halo="dense", build_pair_plans=True, pair_per_type=True),
    "pair_joint")}


def zero_boundary_graph():
    """Self loops only: strictly shard-local for any partition."""
    rng = np.random.RandomState(13)
    nodes = np.arange(96)
    adj = [np.stack([nodes, nodes], 1).astype(np.int32)]
    return (rng.randn(96, 12).astype(np.float32), adj,
            np.zeros((96,), np.int32), 1)


@pytest.fixture(scope="module")
def cluster():
    cases, refs = [], []
    for name, (flavour, partition, _) in CASES.items():
        case, ref = spmd_case(name, "node", flavour, WORLD, partition)
        cases.append(case)
        refs.append(ref)
    for name, (flavour, partition, _) in TRAIN_CASES.items():
        case, ref = spmd_case(name, "node", flavour, WORLD, partition,
                              train=True,
                              gnn_global_exchange_every_num_layers=10000)
        cases.append(case)
        refs.append(ref)
    graph = zero_boundary_graph()
    case, ref = spmd_case("zero_boundary", "node", "rgcn", WORLD,
                          dict(num_graphs_padded=2), graph=graph)
    cases.append(case)
    refs.append(ref)
    results = run_cluster(cases, WORLD)
    return [c["name"] for c in cases], refs, results


@pytest.mark.parametrize("name", list(CASES) + list(TRAIN_CASES))
def test_plan_kind_forward_matches_jax(cluster, name):
    names, refs, results = cluster
    i = names.index(name)
    ref, got = refs[i], results[0][i]
    route = {**CASES, **TRAIN_CASES}[name][2]
    assert all(r[i]["route"] == route for r in results)
    n = ref["num_nodes"]
    assert_close(got["forward"], ref["jax_forward"], PLAN_FWD_TOLS,
                 "against JAX's SPMD")
    assert_close(got["forward"][:n], ref["port_forward"][:n], PLAN_FWD_TOLS,
                 "against the port's single process")
    if name in TRAIN_CASES:
        assert_step_matches(got["metrics"], got["params"],
                            ref["jax_metrics"], ref["jax_params"],
                            ref["initial"], "JAX")
        assert_step_matches(got["metrics"], got["params"],
                            ref["port_metrics"], ref["port_params"],
                            ref["initial"], "single process")


def test_zero_boundary_partition_emits_no_halo_collective(cluster):
    names, refs, results = cluster
    i = names.index("zero_boundary")
    for per_rank in results:
        counts = per_rank[i]["forward_counts"]
        assert counts["all_to_all"]["calls"] == 0
        assert counts["ppermute"]["calls"] == 0
    n = refs[i]["num_nodes"]
    assert_close(results[0][i]["forward"], refs[i]["jax_forward"],
                 PLAN_FWD_TOLS, "against JAX's SPMD")
    assert_close(results[0][i]["forward"][:n], refs[i]["port_forward"][:n],
                 PLAN_FWD_TOLS, "against the port's single process")
