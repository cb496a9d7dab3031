"""The port's scatter-plan planner (tf2_gnn_tpu_torch/ops/sorted_spmm.py)
against the JAX package's (``ops/spmm_pallas.py``): the plans must be
byte-identical, on the PPI bench batch of the ``"sorted"`` path (all twelve
arrays), on an empty edge type and on a fuzz of random graphs, whether the
reference plans through its C++ planner or its per-edge Python loop; an
overflow raises the same ``ValueError``. Also the device form
(``ScatterPlan``) and its derived gather indices."""
import numpy as np
import pytest

import bench
from tf2_gnn_tpu import native as jnative
from tf2_gnn_tpu.ops import spmm_pallas as jsp
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss

from .test_torch_pair_plans import _case, assert_same_arrays


@pytest.fixture(params=["native", "python_loop"])
def reference_planner(request, monkeypatch):
    """The JAX planner through its C++ library, or with the library
    hidden so that its per-edge Python loop runs."""
    if request.param == "python_loop":
        monkeypatch.setattr(jnative, "scatter_plan", lambda *a, **k: None)
    return request.param


def test_bench_scatter_plans_are_byte_identical():
    """``bench.build_batch(0, use_pallas=True, use_pairs=False)``, the batch
    of the bench's sorted path: 480 forward chunks (245,760 slots) over the
    8064 target rows, 608 backward chunks (311,296 slots) over the 24,192
    merged source rows, every real edge in one slot of each."""
    ref_batch, ref_labels, ref_edges = bench.build_batch(
        0, use_pallas=True, use_pairs=False)
    batch, labels, edges = workloads.build_ppi_batch_host(0, scatter=True)
    assert batch.pair_plans is batch.pair_plans_typed is None
    assert ref_batch.pair_plans is ref_batch.pair_plans_typed is None
    assert_same_arrays(batch.scatter_plans, ref_batch.scatter_plans)
    assert edges == ref_edges == 211200
    assert_same_arrays(
        [batch.node_features, batch.num_edges, *batch.edge_sources,
         *batch.edge_targets, labels["node_labels"]],
        [ref_batch.node_features, ref_batch.num_edges,
         *ref_batch.edge_sources, *ref_batch.edge_targets,
         ref_labels["node_labels"]])
    plan = tss.MergedScatterPlan(*batch.scatter_plans)
    assert plan.rel_tgt.shape == (480 * tss.CHUNK_EDGES,)
    assert plan.rel_src.shape == (608 * tss.CHUNK_EDGES,)
    assert int(np.sum(plan.rel_tgt < tss.BLOCK_NODES)) == 211200
    assert int(np.sum(plan.rel_src < tss.BLOCK_NODES)) == 211200
    assert np.all(np.diff(plan.tgt_blocks) >= 0)
    assert np.all(np.diff(plan.src_blocks) >= 0)
    with pytest.raises(ValueError, match="scatter plans only"):
        workloads.build_ppi_batch_host(0, merged=True, scatter=True)


def test_scatter_plan_moves_to_the_device_form():
    rng = np.random.RandomState(7)
    v, num_types = 256, 3
    srcs, tgts, counts = _case(rng, "random", v, num_types)
    host = tss.build_merged_plans(srcs, tgts, counts, v)
    plan = tss.ScatterPlan.from_host(host.astuple(), v, num_types).to("cpu")
    assert_same_arrays(
        [getattr(plan, name).numpy() for name in tss.PLAN_FIELDS], host)
    valid = host.rel_tgt < tss.BLOCK_NODES
    assert np.array_equal(plan.fwd_sentinel.numpy(), ~valid)
    assert np.array_equal(plan.src_idx.numpy(), host.src_merged)
    typed = plan.tgt_typed_idx.numpy()
    assert np.array_equal(typed, host.tgtabs_fwd * num_types + host.type_fwd)
    # The type-minor relative rows lie in one expanded block of 128 * L.
    rel_typed = plan.rel_typed.numpy()
    chunk = np.arange(rel_typed.shape[0]) // tss.CHUNK_EDGES
    rows = host.tgt_blocks[chunk] * tss.BLOCK_NODES * num_types + rel_typed
    assert np.array_equal(rows[valid], typed[valid])
    assert np.all(rel_typed[~valid] == tss.BLOCK_NODES * num_types)
    # bwd_to_fwd_slot carries each edge to its forward slot.
    valid_b = host.rel_src < tss.BLOCK_NODES
    fwd = host.bwd_to_fwd_slot[valid_b]
    assert np.array_equal(host.src_merged[fwd], (
        host.src_blocks[np.nonzero(valid_b)[0] // tss.CHUNK_EDGES]
        * tss.BLOCK_NODES + host.rel_src[valid_b]))
    assert np.array_equal(host.tgtabs_fwd[fwd], host.tgtabs_by_src[valid_b])
    on_batch = workloads.build_ppi_batch_host(0, scatter=True)[0].to("cpu")
    assert on_batch.scatter_merged.num_types == 3
    assert on_batch.scatter_merged.num_nodes == workloads.NODE_BUDGET


KINDS = ("random", "empty", "mixed", "tiny", "hot_target", "selfloop")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_scatter_plans_are_byte_identical(kind, seed,
                                               reference_planner):
    rng = np.random.RandomState(seed * 53 + KINDS.index(kind))
    v = int(rng.choice([128, 256, 640]))
    num_types = int(rng.choice([1, 2, 3]))
    srcs, tgts, counts = _case(rng, kind, v, num_types)
    assert_same_arrays(tss.build_merged_plans(srcs, tgts, counts, v),
                       jsp.build_merged_plans(srcs, tgts, counts,
                                              v).astuple())
    # One stream straight through the planner, with a roomy chunk budget.
    n = int(sum(counts))
    targets = np.concatenate([t[:c] for t, c in zip(tgts, counts)])
    chunks = tss.plan_chunk_budget(n, v) + 8
    assert tss.plan_chunk_budget(n, v) == jsp.plan_chunk_budget(n, v)
    assert_same_arrays(tss.plan_sorted_scatter(targets, n, v, chunks),
                       jsp.plan_sorted_scatter(targets, n, v, chunks))


def test_empty_edge_type_and_empty_batch(reference_planner):
    rng = np.random.RandomState(3)
    v = 256
    srcs, tgts, counts = _case(rng, "mixed", v, 3)
    assert counts[0] == 0
    assert_same_arrays(tss.build_merged_plans(srcs, tgts, counts, v),
                       jsp.build_merged_plans(srcs, tgts, counts,
                                              v).astuple())
    srcs, tgts, counts = _case(rng, "empty", v, 2)
    got = tss.build_merged_plans(srcs, tgts, counts, v)
    assert_same_arrays(got, jsp.build_merged_plans(srcs, tgts, counts,
                                                   v).astuple())
    assert np.all(got.rel_tgt == tss.BLOCK_NODES)
    assert np.all(got.inv_fwd == 0.0)


def test_overflow_raises_the_same_way(reference_planner):
    rng = np.random.RandomState(4)
    v = 512
    targets = rng.randint(0, v, 3000)
    need = int(np.unique(targets // tss.BLOCK_NODES).size)
    for num_chunks in (need, 3):  # too few for 3000 edges in 4 blocks
        with pytest.raises(ValueError) as ours:
            tss.plan_sorted_scatter(targets, 3000, v, num_chunks)
        with pytest.raises(ValueError) as theirs:
            jsp.plan_sorted_scatter(targets, 3000, v, num_chunks)
        assert str(ours.value) == str(theirs.value)
    # Exactly enough chunks: no overflow, and the same plan.
    exact = int(sum(-(-np.sum(targets // tss.BLOCK_NODES == b)
                      // tss.CHUNK_EDGES)
                    for b in range(v // tss.BLOCK_NODES)))
    assert_same_arrays(tss.plan_sorted_scatter(targets, 3000, v, exact),
                       jsp.plan_sorted_scatter(targets, 3000, v, exact))
