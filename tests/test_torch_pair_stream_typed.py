"""The per-type streamed op of the port (``pair_stream_typed``, K1 in
both directions over ``StreamTypedPlan``)
against the JAX package's ``pair_stream_from_typed`` on the CPU (both
through their plain versions): forward output and table gradient,
normalized and unit scales, f32 and bf16 streams, and per-type plans with
genuinely spilled pairs (the overflow term and its transpose); the plan's
two compact forms against the plan's valid slots; and the per-type
in-degrees (``GraphBatch.in_degrees``, ``calculate_type_to_num_incoming_edges``)
against the JAX package's, pad row included.

Tolerances: as ``test_torch_pair_stream.py`` (f32 rtol 1e-5 / atol 1e-5,
the same f32 products summed in another order; bf16 rtol 2**-8, one bf16
ulp, / atol 1e-5: both sides round the same f32 tables and cotangents to
bf16 and accumulate in f32). The in-degrees are counts: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.data import graph_batch as jgb
from tf2_gnn_tpu.layers.message_passing import base as jbase
from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu_torch.data import graph_batch as tgb
from tf2_gnn_tpu_torch.layers.message_passing import (
    calculate_type_to_num_incoming_edges,
)
from tf2_gnn_tpu_torch.ops import pair_spmm as tps

from .test_torch_pair_stream import TOLS, _random_edges, _typed_plans


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_value_and_grad(tables, cot, plans, v, normalize, dtype):
    def f(t):
        out = jps.pair_stream_from_typed(t.astype(dtype), plans, v,
                                         normalize)
        return jnp.vdot(out, cot), out

    (_, out), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(tables))
    return np.asarray(out), np.asarray(grad, np.float32)


def _torch_value_and_grad(tables, cot, plans, v, normalize, dtype):
    t = torch.tensor(tables, requires_grad=True)
    plan = tps.stream_typed_plan(plans, v, v).to("cpu")
    out = tps.pair_stream_typed(t, plan, normalize,
                                stream_dtype=getattr(torch, dtype))
    torch.sum(out * torch.from_numpy(cot)).backward()
    assert out.dtype == torch.float32 and t.grad.dtype == torch.float32
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("spill", [False, True])
def test_typed_stream_matches_jax(spill, normalize, dtype):
    rng = np.random.RandomState(31 + 2 * spill + normalize)
    v, num_types, h = 384, 3, 24
    srcs, tgts, counts = _random_edges(rng, num_types, v, clusters=not spill)
    tables = rng.randn(num_types * v, h).astype(np.float32)
    cot = rng.randn(num_types * v, h).astype(np.float32)
    plans_j = _typed_plans(jps, srcs, tgts, counts, v, spill)
    plans_t = _typed_plans(tps, srcs, tgts, counts, v, spill)
    if spill:
        assert sum(int(np.sum(p[9] < v)) for p in plans_t) > 0

    out_j, grad_j = _jax_value_and_grad(tables, cot, plans_j, v, normalize,
                                        dtype)
    out_t, grad_t = _torch_value_and_grad(tables, cot, plans_t, v, normalize,
                                          dtype)
    assert out_t.shape == (num_types * v, h)
    np.testing.assert_allclose(out_t, out_j, **TOLS[dtype])
    np.testing.assert_allclose(grad_t, grad_j, **TOLS[dtype])


def _expected_entries(src, tgt, valid, table_rows, out_rows):
    """The (target, slot, clipped source) of every valid slot whose target
    lies in the output, in the compact form's order (by target, then
    slot)."""
    keep = valid & (tgt >= 0) & (tgt < out_rows)
    slot = torch.nonzero(keep).reshape(-1)
    order = torch.argsort(tgt[slot] * (slot.numel() + 1)
                          + torch.arange(slot.numel()))
    slot = slot[order]
    return tgt[slot], slot, torch.clamp(src[slot], 0, table_rows - 1)


@pytest.mark.parametrize("spill", [False, True])
def test_compact_forms_are_the_plans_valid_slots(spill):
    """Each direction's compact form holds exactly the plan's valid slots
    with a target in the output, as a CSR by target: the forward's sources
    in the stacked [L * V] tables, targets in the [L * V] outputs; the
    backward's sources in type l's slab of the [L * V] cotangent."""
    rng = np.random.RandomState(7 + spill)
    v, num_types = 384, 3
    srcs, tgts, counts = _random_edges(rng, num_types, v, clusters=not spill)
    plans = _typed_plans(tps, srcs, tgts, counts, v, spill)
    plan = tps.stream_typed_plan(plans, v, v).to("cpu")
    rows = num_types * v
    for compact, arrays, grp_type in (
            (plan.fwd_rows, (plan.rel_src_f, plan.rel_tgt_f, plan.src_blk_f,
                             plan.grp_tgt_f), plan.grp_type_f),
            (plan.bwd_rows, (plan.rel_src_b, plan.rel_tgt_b, plan.src_blk_b,
                             plan.grp_tgt_b), plan.grp_type_b)):
        src, tgt, valid = tps._stream_slot_abs_ids(*arrays, grp_type, v)
        want_tgt, want_slot, want_src = _expected_entries(src, tgt, valid,
                                                          rows, rows)
        assert compact.table_rows == compact.out_rows == rows
        assert compact.num_slots == arrays[0].numel()
        assert torch.equal(compact.slot.long(), want_slot)
        assert torch.equal(compact.src_row.long(), want_src)
        counts_by_row = torch.bincount(want_tgt, minlength=rows)
        assert torch.equal(torch.diff(compact.row_ptr.long()), counts_by_row)
        # Every real edge of the plans is a slot of the form or spilled.
        n_ovf = int((plan.ovf_tgt < rows).sum())
        assert compact.src_row.numel() + n_ovf == sum(counts)
        assert (n_ovf > 0) == spill
    # The backward reads each type's own cotangent slab.
    assert set(plan.grp_type_b.tolist()) == set(range(num_types))
    # Cached at first read.
    assert plan.fwd_rows is plan.fwd_rows and plan.bwd_rows is plan.bwd_rows


def _batches(seed, v_pad=256):
    rng = np.random.RandomState(seed)
    n = 150
    adjacency = [rng.randint(0, n, (e, 2)).astype(np.int32)
                 for e in (0, 300, 41)]
    features = rng.randn(n, 4).astype(np.float32)
    n2g = np.zeros((n,), np.int32)
    config_args = dict(num_nodes=v_pad, num_graphs=2,
                       edge_budgets=(64, 320, 64))
    jbatch = jgb.pad_batch_arrays(features, adjacency, n2g, 1,
                                  jgb.PaddingConfig(**config_args))
    tbatch = tgb.pad_batch_arrays(features, adjacency, n2g, 1,
                                  tgb.PaddingConfig(**config_args))
    return jbatch, tbatch


def test_in_degrees_match_jax():
    """``pad_batch_arrays`` fills the same [L, V] in-degrees as the JAX
    package's (the pad row counts the padded edges), ``.to`` moves them,
    and ``calculate_type_to_num_incoming_edges`` gives the JAX function's
    counts with them and, on a batch without them, from the edge
    targets."""
    jbatch, tbatch = _batches(0)
    v = tbatch.num_nodes_padded
    assert tbatch.in_degrees.dtype == np.float32
    np.testing.assert_array_equal(tbatch.in_degrees,
                                  np.asarray(jbatch.in_degrees))
    assert tbatch.in_degrees[:, v - 1].tolist() == [64, 20, 23]
    want = np.asarray(jbase.calculate_type_to_num_incoming_edges(jbatch))
    want_counted = np.asarray(jbase.calculate_type_to_num_incoming_edges(
        jbatch.replace(in_degrees=None)))
    np.testing.assert_array_equal(want, want_counted)
    moved = tbatch.to("cpu")
    assert isinstance(moved.in_degrees, torch.Tensor)
    for batch in (moved, moved.replace(in_degrees=None)):
        got = calculate_type_to_num_incoming_edges(batch)
        assert got.dtype == torch.float32 and got.shape == (3, v)
        np.testing.assert_array_equal(got.numpy(), want)
