"""The port's host planner (tf2_gnn_tpu_torch/ops/pair_spmm.py) against the
JAX package's: plans, groups and the streamed concatenation must be
byte-identical, on the full PPI bench workload (per-type and merged plans,
and the bench's batch without plans) and on degenerate fuzz cases
(empty edge types, tiny types, one hot target row, self loops, and a chunk
budget small enough to spill pairs into the overflow list)."""
import numpy as np
import pytest
import torch

import bench
from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.ops import pair_spmm as tps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_arrays(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), f"array {i} differs"


@pytest.fixture(scope="module")
def bench_batches():
    ref_batch, ref_labels, ref_edges = bench.build_batch(
        0, use_pallas=False, use_pairs=True, pair_per_type=True)
    batch, labels, edges = workloads.build_ppi_batch_host(0)
    return (ref_batch, ref_labels, ref_edges), (batch, labels, edges)


def test_workload_copy_is_array_identical(bench_batches):
    (ref_batch, ref_labels, ref_edges), (batch, labels, edges) = bench_batches
    ref_raw = bench.build_raw_arrays(0)
    raw = workloads.build_raw_arrays(0)
    assert_same_arrays(raw[1], ref_raw[1])
    assert_same_arrays([raw[0], raw[2]], [ref_raw[0], ref_raw[2]])
    assert edges == ref_edges == 211200
    assert_same_arrays(
        [batch.node_features, batch.node_to_graph, batch.num_edges,
         *batch.edge_sources, *batch.edge_targets, batch.in_degrees,
         labels["node_labels"]],
        [ref_batch.node_features, ref_batch.node_to_graph,
         ref_batch.num_edges, *ref_batch.edge_sources,
         *ref_batch.edge_targets, ref_batch.in_degrees,
         ref_labels["node_labels"]])
    assert batch.num_nodes == int(ref_batch.num_nodes)
    assert batch.num_graphs == int(ref_batch.num_graphs)
    assert batch.num_graphs_padded == ref_batch.num_graphs_padded


def test_bare_workload_is_the_bench_xla_batch(bench_batches):
    """``build_ppi_batch_host(0, plans=False)`` is array-identical to
    ``bench.build_batch(0, use_pallas=False, use_pairs=False)``, the batch
    of the bench's ``"xla"`` path, and neither carries a plan; its arrays
    are those of the per-type-plan batch."""
    ref_batch, ref_labels, ref_edges = bench.build_batch(
        0, use_pallas=False, use_pairs=False)
    batch, labels, edges = workloads.build_ppi_batch_host(0, plans=False)
    (_, _, _), (typed, typed_labels, _) = bench_batches
    assert edges == ref_edges == 211200
    fields = ("node_features", "node_to_graph", "num_edges", "in_degrees")
    for got in (batch, typed):
        assert_same_arrays(
            [getattr(got, f) for f in fields] + [*got.edge_sources,
                                                 *got.edge_targets],
            [getattr(ref_batch, f) for f in fields]
            + [*ref_batch.edge_sources, *ref_batch.edge_targets])
    assert_same_arrays([labels["node_labels"], typed_labels["node_labels"]],
                       [ref_labels["node_labels"]] * 2)
    assert (ref_batch.pair_plans, ref_batch.pair_plans_typed,
            ref_batch.scatter_plans) == (None, None, None)
    assert (batch.pair_plans, batch.pair_plans_typed, batch.scatter_plans,
            batch.pair_targets_merged) == (None, None, None, False)
    with pytest.raises(ValueError, match="plans=False"):
        workloads.build_ppi_batch_host(0, merged=True, plans=False)


def test_bench_typed_plans_are_byte_identical(bench_batches):
    (ref_batch, _, _), (batch, _, _) = bench_batches
    assert len(batch.pair_plans_typed) == len(ref_batch.pair_plans_typed) == 3
    for got, want in zip(batch.pair_plans_typed, ref_batch.pair_plans_typed):
        assert_same_arrays(got, want)
    v = workloads.NODE_BUDGET
    for normalize in (False, True):
        assert_same_arrays(
            tps.concat_typed_plans(batch.pair_plans_typed, v, v, normalize),
            jps.concat_typed_plans(ref_batch.pair_plans_typed, v, v,
                                   normalize))


@pytest.fixture(scope="module")
def bench_merged_batches():
    ref = bench.build_batch(0, use_pallas=False, use_pairs=True)
    return ref, workloads.build_ppi_batch_host(0, merged=True)


def test_bench_merged_plans_are_byte_identical(bench_merged_batches):
    """The RGAT form: one merged plan over all three types, groups chosen
    from all of them, overflow budget 256 (bench.py:125-139)."""
    (ref_batch, ref_labels, ref_edges), (batch, labels, edges) = \
        bench_merged_batches
    assert ref_batch.pair_plans_typed is None
    assert batch.pair_plans_typed is None
    assert batch.pair_targets_merged is ref_batch.pair_targets_merged is False
    assert_same_arrays(batch.pair_plans, ref_batch.pair_plans)
    assert edges == ref_edges == 211200
    assert_same_arrays(
        [batch.node_features, batch.node_to_graph, batch.num_edges,
         *batch.edge_sources, *batch.edge_targets, labels["node_labels"]],
        [ref_batch.node_features, ref_batch.node_to_graph,
         ref_batch.num_edges, *ref_batch.edge_sources,
         *ref_batch.edge_targets, ref_labels["node_labels"]])
    plans = tps.PairPlans.fromtuple(batch.pair_plans)
    # The shapes the RGAT kernels run at: 2800 forward chunks in groups of
    # 16, 3256 backward chunks in groups of 8, no spilled edge.
    assert plans.fwd.rel_src.shape == (2800, tps.E_C)
    assert tps.plan_group(plans.fwd.src_blk, plans.fwd.grp_tgt) == 16
    assert plans.bwd.rel_src.shape == (3256, tps.E_C)
    assert tps.plan_group(plans.bwd.src_blk, plans.bwd.grp_tgt) == 8
    assert plans.ovf_src.shape == (0,)
    assert int(np.sum(plans.fwd.rel_src < tps.BLK)) == 211200
    assert_same_arrays(plans.kernel_arrays,
                       jps.PairPlans.fromtuple(
                           ref_batch.pair_plans).kernel_arrays)


def test_bench_merged_target_plans_are_byte_identical():
    """The target-state edge-MLP form: the merged plan with targets in the
    merged ``l * V + t`` row space (bench.py with pair_merge_targets=True,
    the configuration of benchmarks/edge_mlp_probe.py); on the device its
    forward output rows are L * V."""
    ref_batch, ref_labels, ref_edges = bench.build_batch(
        0, use_pallas=False, use_pairs=True, pair_merge_targets=True)
    batch, labels, edges = workloads.build_ppi_batch_host(
        0, merged=True, merge_targets=True)
    assert batch.pair_targets_merged is ref_batch.pair_targets_merged is True
    assert_same_arrays(batch.pair_plans, ref_batch.pair_plans)
    assert_same_arrays([labels["node_labels"]], [ref_labels["node_labels"]])
    assert edges == ref_edges == 211200
    plans = tps.PairPlans.fromtuple(batch.pair_plans)
    v = workloads.NODE_BUDGET
    # The shapes the relu-pair kernels run at: 3256 forward chunks in
    # groups of 8, every edge in a kernel slot.
    assert plans.fwd.rel_src.shape == (3256, tps.E_C)
    assert tps.plan_group(plans.fwd.src_blk, plans.fwd.grp_tgt) == 8
    assert int(np.sum(plans.fwd.rel_src < tps.BLK)) == 211200
    assert int(plans.fwd.grp_tgt.max()) < 3 * v // tps.BLK
    on_device = batch.to("cpu")
    assert on_device.pair_merged.out_rows == 3 * v
    merged_only = workloads.build_ppi_batch_host(0, merged=True)[0].to("cpu")
    assert merged_only.pair_merged.out_rows == v
    with pytest.raises(ValueError, match="merged=True"):
        workloads.build_ppi_batch_host(0, merge_targets=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_unit_scales_match_jax(seed):
    """Ones on the kernel slots, the overflow slots' validity mask (a
    budget small enough that pairs spill)."""
    rng = np.random.RandomState(40 + seed)
    v = 256
    srcs, tgts, counts = _case(rng, "random", v, 2)
    need_f, need_b = tps.measure_pair_chunks(srcs, tgts, counts, v,
                                             merge_targets=True)
    host = tps.build_pair_plans(
        srcs, tgts, counts, v, merge_targets=True, overflow_budget=4096,
        overflow_size=4096, chunk_budget_fwd=need_f - tps.GROUP,
        chunk_budget_bwd=need_b - tps.BWD_GROUP).astuple()
    assert 0 < int(np.sum(host[9] < 2 * v)) < host[9].size
    plan = tps.MergedPlan(*host, out_rows=2 * v).to("cpu")
    got = tps.pair_unit_scales(plan, 2 * v)
    want = jps.pair_unit_scales(host, 2 * v)
    assert_same_arrays([t.numpy() for t in got], [np.asarray(w) for w in want])


def test_merged_plan_moves_to_the_device_form():
    rng = np.random.RandomState(3)
    v = 256
    srcs, tgts, counts = _case(rng, "random", v, 3)
    host = tps.build_pair_plans(srcs, tgts, counts, v).astuple()
    plan = tps.MergedPlan(*host).to("cpu")
    assert_same_arrays([t.numpy() for t in plan.fwd + plan.bwd], host[:8])
    assert_same_arrays([plan.ovf_src.numpy(), plan.ovf_tgt.numpy(),
                        plan.inv_fwd.numpy()], host[8:11])


def test_bench_groups_match():
    _, (loops, _, _), _ = workloads.build_raw_arrays(0)
    v = workloads.NODE_BUDGET
    args = ([loops[:, 0]], [loops[:, 1]], [loops.shape[0]], v)
    assert tps.choose_pair_groups(*args) == jps.choose_pair_groups(*args)
    assert tps.measure_pair_chunks(*args) == jps.measure_pair_chunks(*args)


def _case(rng, kind, v, num_types):
    """Per-type padded edge lists in the style of test_planner_fuzz.py."""
    srcs, tgts, counts = [], [], []
    for t in range(num_types):
        if kind == "empty" or (kind == "mixed" and t == 0):
            e = 0
        elif kind == "tiny":
            e = rng.randint(1, 4)
        elif kind == "hot_target":
            e = rng.randint(64, 400)
        else:
            e = rng.randint(1, v * 4)
        budget = max(((e + 63) // 64) * 64, 64)
        s = np.full((budget,), v - 1, np.int64)
        g = np.full((budget,), v - 1, np.int64)
        if kind == "selfloop":
            e = min(e, v)
            nodes = rng.choice(v, size=e, replace=False)
            s[:e] = nodes
            g[:e] = nodes
        elif kind == "hot_target":
            s[:e] = rng.randint(0, v, e)
            g[:e] = rng.randint(0, max(v // 64, 1))
        else:
            s[:e] = rng.randint(0, v, e)
            g[:e] = rng.randint(0, v, e)
        srcs.append(s)
        tgts.append(g)
        counts.append(e)
    return srcs, tgts, counts


KINDS = ("random", "empty", "mixed", "tiny", "hot_target", "selfloop")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_plans_are_byte_identical(kind, seed):
    rng = np.random.RandomState(seed * 101 + KINDS.index(kind))
    v = int(rng.choice([128, 256, 384]))
    num_types = int(rng.choice([1, 2, 3]))
    srcs, tgts, counts = _case(rng, kind, v, num_types)
    for kwargs in ({}, {"merge_targets": True},
                   {"group_fwd": 8, "group_bwd": 16}):
        got = tps.build_pair_plans(srcs, tgts, counts, v, overflow_budget=64,
                                   overflow_size=64, **kwargs)
        want = jps.build_pair_plans(srcs, tgts, counts, v, overflow_budget=64,
                                    overflow_size=64, **kwargs)
        assert_same_arrays(got.astuple(), want.astuple())
    typed_got = tuple(
        tps.build_pair_plans([srcs[t]], [tgts[t]], [counts[t]], v,
                             group_fwd=8, group_bwd=8).astuple()
        for t in range(num_types))
    typed_want = tuple(
        jps.build_pair_plans([srcs[t]], [tgts[t]], [counts[t]], v,
                             group_fwd=8, group_bwd=8).astuple()
        for t in range(num_types))
    for normalize in (False, True):
        assert_same_arrays(
            tps.concat_typed_plans(typed_got, v, v, normalize),
            jps.concat_typed_plans(typed_want, v, v, normalize))
    assert tps.choose_pair_groups(srcs, tgts, counts, v) == \
        jps.choose_pair_groups(srcs, tgts, counts, v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spilled_plans_are_byte_identical(seed):
    """A chunk budget below the data's need spills the smallest pairs into
    the overflow list; the overflow ids, sentinels and 1/deg scales and the
    re-planned kernel slots must match, and the concatenation must map
    every per-type sentinel to the global discard row L*Vo."""
    rng = np.random.RandomState(17 + seed)
    v, num_types = 384, 2
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v // 2, v * 6)
        budget = ((e + 63) // 64) * 64
        s = np.full((budget,), v - 1, np.int32)
        t = np.full((budget,), v - 1, np.int32)
        s[:e], t[:e] = rng.randint(0, v, e), rng.randint(0, v, e)
        srcs.append(s)
        tgts.append(t)
        counts.append(e)
    kwargs = dict(chunk_budget_fwd=jps.GROUP, chunk_budget_bwd=jps.GROUP,
                  group_fwd=8, group_bwd=8)
    got, want = [], []
    for t in range(num_types):
        budget = ((counts[t] + 63) // 64) * 64
        got.append(tps.build_pair_plans([srcs[t]], [tgts[t]], [counts[t]], v,
                                        overflow_budget=budget,
                                        **kwargs).astuple())
        want.append(jps.build_pair_plans([srcs[t]], [tgts[t]], [counts[t]],
                                         v, overflow_budget=budget,
                                         **kwargs).astuple())
        assert_same_arrays(got[-1], want[-1])
        assert int(np.sum(got[-1][9] < v)) > 0  # pairs really spilled
    for normalize in (False, True):
        cat = tps.concat_typed_plans(got, v, v, normalize)
        assert_same_arrays(cat, jps.concat_typed_plans(want, v, v, normalize))
    ovf_tgt = cat[14]
    per_type_sentinel = np.concatenate([p[9] >= v for p in got])
    assert np.all(ovf_tgt[per_type_sentinel] == num_types * v)
    assert np.all(ovf_tgt[~per_type_sentinel] < num_types * v)


def test_concat_rejects_mismatched_groups():
    rng = np.random.RandomState(11)
    v = 256
    srcs, tgts, counts = _case(rng, "random", v, 2)
    mixed = (
        tps.build_pair_plans(srcs[:1], tgts[:1], counts[:1], v,
                             group_fwd=8).astuple(),
        tps.build_pair_plans(srcs[1:], tgts[1:], counts[1:], v,
                             group_fwd=16).astuple(),
    )
    with pytest.raises(ValueError, match="shared .group_fwd, group_bwd."):
        tps.concat_typed_plans(mixed, v, v, normalize=False)
