"""The pair-joint route's compact tables on the CPU: a joint plan's read
rows (``StreamJointPlan.read_rows``), the forms over a table of those rows
alone, and ``GNN_Edge_MLP._pair_joint_sum``'s compact products against its
full ones.

The case is QM9-like at a low read share (0.32 of the ``L * v_src``
rows): five types of unequal source counts, one with no edges, one (a self
loop on every row) whose rows are all read, and spilled pairs, so the
overflow term and its transpose run. The remapped forms have no plain
version over plan arrays; ``pair_spmm.slot_rows_plain`` is their plain
twin over the form itself, and it is held here to the plan-array plain
versions on the full forms.

Tolerances: f32 streams rtol 1e-5 / atol 1e-5 (``test_torch_pair_stream``'s:
the same products summed in another order); the products' output and
gradients within 1e-6 of the largest entry (``test_torch_typed_linear``'s:
the same products, f32 sums in other orders); bf16 streams rtol 2**-8 (one
bf16 ulp, where a table entry rounds the other way) / atol 1e-5.
"""
import numpy as np
import pytest
import torch

from tf2_gnn_tpu_torch.data import graph_batch as tgb
from tf2_gnn_tpu_torch.layers.message_passing import gnn_edge_mlp
from tf2_gnn_tpu_torch.layers.message_passing.gnn_edge_mlp import (
    GNN_Edge_MLP,
)
from tf2_gnn_tpu_torch.layers.message_passing.rgcn import RGCN
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.utils import tracing


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


V = 512
NODES = 500
TYPES = 5
STREAM_TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
               torch.bfloat16: dict(rtol=2.0 ** -8, atol=1e-5)}


def _adjacency(seed=0):
    """[E, 2] edges a type: self loops on every row (all rows read), none,
    and three types whose sources are 30, 90 and 200 nodes."""
    rng = np.random.RandomState(seed)
    rows = np.arange(V)
    adjacency = [np.stack([rows, rows], 1), np.zeros((0, 2), np.int64)]
    for sources, edges in ((30, 700), (90, 400), (200, 600)):
        src = rng.choice(NODES, sources, replace=False)
        adjacency.append(np.stack(
            [src[rng.randint(0, sources, edges)],
             rng.randint(0, NODES, edges)], 1))
    return [a.astype(np.int32) for a in adjacency]


def _batch(seed=0, spill=True, features=8):
    """The case as a padded batch with per-type plans; ``spill`` plans each
    type with a chunk budget of one group, so most pairs spill."""
    rng = np.random.RandomState(seed + 1)
    adjacency = _adjacency(seed)
    budgets = tuple(max(64, (len(a) + 63) // 64 * 64) for a in adjacency)
    batch = tgb.pad_batch_arrays(
        rng.randn(NODES, features).astype(np.float32), adjacency,
        np.zeros((NODES,), np.int32), 1,
        tgb.PaddingConfig(num_nodes=V, num_graphs=2, edge_budgets=budgets))
    plans = []
    for t, a in enumerate(adjacency):
        kwargs = dict(group_fwd=8, group_bwd=8)
        if spill and t != 1:
            kwargs.update(chunk_budget_fwd=tps.GROUP,
                          chunk_budget_bwd=tps.GROUP,
                          overflow_budget=budgets[t])
        plans.append(tps.build_pair_plans(
            [np.asarray(batch.edge_sources[t])],
            [np.asarray(batch.edge_targets[t])], [len(a)], V,
            **kwargs).astuple())
    return batch.replace(pair_plans_typed=tuple(plans)).to("cpu")


@pytest.fixture(scope="module")
def case():
    return _batch()


def _has_entries(compact):
    return torch.nonzero(torch.diff(compact.row_ptr)).reshape(-1)


def test_the_case_is_what_it_claims(case):
    plan = case.pair_stream_joint
    read = plan.read_rows
    counts = np.diff(read.type_offsets)
    assert counts[0] == V and counts[1] == 0
    assert len(set(counts[2:].tolist())) == 3
    assert read.num_rows / (TYPES * V) < 0.35
    assert int((plan.ovf_tgt_l < V).sum()) > 100


def test_read_rows_are_the_union_of_what_the_plan_reads(case):
    plan = case.pair_stream_joint
    read = plan.read_rows
    rows = read.rows
    assert bool((rows[1:] > rows[:-1]).all())
    valid_ovf = plan.ovf_src.long()[plan.ovf_tgt_l < V]
    union = torch.unique(torch.cat([plan.fwd_rows.src_row.long(),
                                    _has_entries(plan.bwd_rows),
                                    valid_ovf]))
    assert torch.equal(rows, union)
    # Each edge takes one path both ways: the forward sources are the
    # backward targets.
    assert torch.equal(torch.unique(plan.fwd_rows.src_row.long()),
                       _has_entries(plan.bwd_rows))
    offsets = read.type_offsets
    assert offsets[0] == 0 and offsets[-1] == read.num_rows
    for l in range(TYPES):
        part = rows[offsets[l]:offsets[l + 1]]
        assert bool((part // V == l).all())
    assert torch.equal(read.node, rows % V)
    assert plan.num_read_rows == read.num_rows


def test_remapped_forward_form_is_the_plans_form(case):
    plan = case.pair_stream_joint
    read, fwd = plan.read_rows, plan.fwd_rows
    got = read.fwd_rows
    assert (got.table_rows, got.out_rows, got.num_slots) == (
        read.num_rows, fwd.out_rows, fwd.num_slots)
    assert torch.equal(got.row_ptr, fwd.row_ptr)
    assert torch.equal(got.slot, fwd.slot)
    assert torch.equal(read.rows[got.src_row.long()], fwd.src_row.long())
    valid = plan.ovf_tgt_l < V
    assert torch.equal(read.rows[read.ovf_src.long()][valid],
                       plan.ovf_src.long()[valid])
    assert bool((read.ovf_src >= 0).all())
    assert bool((read.ovf_src < read.num_rows).all())


def test_plain_twin_is_the_plain_version_on_the_plans_forms(case):
    """``slot_rows_plain`` over the full forms gives the plan-array plain
    versions' sums bit for bit (the same entries added in slot order)."""
    plan = case.pair_stream_joint
    gen = torch.Generator().manual_seed(2)
    tables = torch.randn((TYPES * V, 24), generator=gen)
    cot = torch.randn((V, 24), generator=gen)
    fwd = tps.pair_spmm_stream_plain(
        tables, plan.scale_fwd, plan.rel_src_f, plan.rel_tgt_f,
        plan.src_blk_f, plan.grp_tgt_fl, plan.grp_type_f, V, V)
    bwd = tps.pair_spmm_stream_plain(
        cot, plan.scale_bwd, plan.rel_src_b, plan.rel_tgt_b,
        plan.src_blk_b, plan.grp_tgt_b, plan.type_b_zeros, V, TYPES * V)
    assert torch.equal(
        tps.slot_rows_plain(tables, plan.scale_fwd, plan.fwd_rows), fwd)
    assert torch.equal(
        tps.slot_rows_plain(cot, plan.scale_bwd, plan.bwd_rows), bwd)


def test_restricted_backward_form_sums_the_same(case):
    """The backward form restricted to the rows read, scattered back into
    the stacked rows, is the full form's table gradient bit for bit, and
    the full form has nothing at the other rows."""
    plan = case.pair_stream_joint
    read, form = plan.read_rows, plan.read_bwd_rows
    assert (form.table_rows, form.out_rows) == (V, read.num_rows)
    cot = torch.randn((V, 40), generator=torch.Generator().manual_seed(3))
    full = tps.slot_rows_plain(cot, plan.scale_bwd, plan.bwd_rows)
    got = tps.slot_rows_plain(cot, plan.scale_bwd, form)
    back = torch.zeros_like(full)
    back[read.rows] = got
    assert torch.equal(back, full)


def test_node_form_sums_each_nodes_rows_in_type_order(case):
    """``ReadRows.node_rows`` is a CSR of the table's rows by node, each
    node's rows in type order, every row once: its plain sum is the
    per-type scatter of the rows into their nodes."""
    read = case.pair_stream_joint.read_rows
    form = read.node_rows
    assert (form.table_rows, form.out_rows) == (read.num_rows, V)
    entries = form.src_row.long()
    assert torch.equal(torch.sort(entries).values,
                       torch.arange(read.num_rows))
    node_of = read.node[entries]
    assert bool((node_of[1:] >= node_of[:-1]).all())
    same = node_of[1:] == node_of[:-1]
    assert bool((entries[1:][same] > entries[:-1][same]).all())
    rows = torch.randn((read.num_rows, 12),
                       generator=torch.Generator().manual_seed(10))
    want = torch.zeros((V, 12))
    want.index_add_(0, read.node, rows)
    torch.testing.assert_close(tps.slot_rows_plain(rows, None, form), want,
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(tps.pair_spmm_node_rows(rows, read),
                       tps.slot_rows_plain(rows, None, form))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
def test_joint_op_over_the_read_rows(case, normalize, stream_dtype):
    """``pair_stream_joint`` over the read rows' table against the full
    table: the output, and the table gradient at the rows read (0 at the
    others in the full form)."""
    plan = case.pair_stream_joint
    read = plan.read_rows
    gen = torch.Generator().manual_seed(4)
    full = torch.randn((TYPES * V, 40), generator=gen)
    cot = torch.randn((V, 40), generator=gen)

    def run(tables, **kw):
        t = tables.clone().requires_grad_(True)
        out = tps.pair_stream_joint(t, plan, normalize, stream_dtype, **kw)
        (out * cot).sum().backward()
        return out.detach(), t.grad

    out, grad = run(full)
    out_c, grad_c = run(full[read.rows], read=read)
    torch.testing.assert_close(out_c, out, **STREAM_TOLS[stream_dtype])
    torch.testing.assert_close(grad_c, grad[read.rows],
                               **STREAM_TOLS[stream_dtype])
    unread = torch.ones(TYPES * V, dtype=torch.bool)
    unread[read.rows] = False
    assert float(grad[unread].abs().max()) == 0.0


def _layer(kind, d, h, seed=0):
    if kind.startswith("rgcn"):
        layer = RGCN(TYPES, d, hidden_dim=h, dense_dtype=(
            "bfloat16" if kind == "rgcn_bf16_dense" else "float32"))
    else:
        layer = GNN_Edge_MLP(TYPES, d, hidden_dim=h,
                             use_target_state_as_input=False,
                             normalize_by_num_incoming=True,
                             num_edge_MLP_hidden_layers=2)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    return layer


def _sums(layer, batch, x, cot, gate=None):
    """The layer's joint sums over ``batch`` with ``COMPACT_TABLES_BELOW``
    at ``gate`` (None: as shipped): (output, d_x, each kernel's gradient,
    the ``pair_tables`` counters)."""
    x = x.clone().requires_grad_(True)
    layer.zero_grad()
    tracing.reset()
    with pytest.MonkeyPatch.context() as mp:
        if gate is not None:
            mp.setattr(gnn_edge_mlp, "COMPACT_TABLES_BELOW", gate)
        assert layer._route(batch) == "pair_joint"
        out = layer._fused_sum_aggregate(x, batch, False)
    (out * cot).sum().backward()
    grads = [p.grad.clone() for p in layer.parameters()]
    counters = tracing.counters("pair_tables")
    tracing.reset()
    return out.detach(), x.grad, grads, counters


def _close(got, want, rtol=1e-5):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("kind", ["rgcn", "source_only_two_hidden",
                                  "rgcn_bf16_dense"])
def test_compact_route_matches_the_full_route(case, kind):
    """At f32 (a f32 stream), the compact products give the full route's
    output, input gradient and kernel gradients; the counters read the
    rows each computed; two compact calls agree bit for bit. With bf16
    operands (``dense_dtype``) the products' operands are rounded as the
    full route's, and the gradients, rounded to bf16 from f32 sums in
    other orders, lie within one bf16 step (2**-7 relative)."""
    d, h = 8, 24
    layer = _layer(kind, d, h)
    rtol = 2.0 ** -7 if kind == "rgcn_bf16_dense" else 1e-5
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((V, d), generator=gen)
    cot = torch.randn((V, h), generator=gen)
    read = case.pair_stream_joint.read_rows
    full = _sums(layer, case, x, cot, gate=0.0)
    compact = _sums(layer, case, x, cot)
    assert full[3] == {"rows_computed": TYPES * V, "rows_full": TYPES * V}
    assert compact[3] == {"rows_computed": read.num_rows,
                          "rows_full": TYPES * V}
    _close(compact[0], full[0])
    _close(compact[1], full[1], rtol)
    assert len(compact[2]) == len(full[2]) >= 1
    for got, want in zip(compact[2], full[2]):
        _close(got, want, rtol)
    # The type without edges reads no row: its kernel gradient is 0.
    assert float(compact[2][0][1].abs().max()) == 0.0
    again = _sums(layer, case, x, cot)
    for a, b in zip(compact[:2] + tuple(compact[2]),
                    again[:2] + tuple(again[2])):
        assert torch.equal(a, b)


def test_a_bf16_stream_takes_the_compact_route(case):
    """The shipped QM9 stream (bf16 tables): the compact route's output
    within one bf16 ulp of the full route's."""
    layer = RGCN(TYPES, 8, hidden_dim=24, edge_dtype="bfloat16")
    layer.reset_parameters(torch.Generator().manual_seed(6))
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((V, 8), generator=gen)
    cot = torch.randn((V, 24), generator=gen)
    full = _sums(layer, case, x, cot, gate=0.0)
    compact = _sums(layer, case, x, cot)
    assert compact[3]["rows_computed"] < full[3]["rows_computed"]
    for got, want in zip((compact[0], compact[1]) + tuple(compact[2]),
                         (full[0], full[1]) + tuple(full[2])):
        torch.testing.assert_close(got, want, rtol=2.0 ** -8,
                                   atol=1e-5 * float(want.abs().max()))


def _ppi_like_batch(seed=0):
    """Three types over 500 real nodes of V = 512, each node a source of
    every type: 0.977 of the rows read, the PPI cell's share (48,000 real
    nodes of 49,152)."""
    rng = np.random.RandomState(seed)
    n = 500
    rows = np.arange(n)
    adjacency = [np.stack([rows, rows], 1)]
    for _ in range(2):
        adjacency.append(np.stack([np.concatenate([rows, rng.randint(0, n, n)]),
                                   rng.randint(0, n, 2 * n)], 1))
    adjacency = [a.astype(np.int32) for a in adjacency]
    budgets = tuple((len(a) + 63) // 64 * 64 for a in adjacency)
    batch = tgb.pad_batch_arrays(
        rng.randn(n, 8).astype(np.float32), adjacency,
        np.zeros((n,), np.int32), 1,
        tgb.PaddingConfig(num_nodes=V, num_graphs=2, edge_budgets=budgets))
    plans = tuple(tps.build_pair_plans(
        [np.asarray(batch.edge_sources[t])],
        [np.asarray(batch.edge_targets[t])], [len(a)], V, group_fwd=8,
        group_bwd=8).astuple() for t, a in enumerate(adjacency))
    return batch.replace(pair_plans_typed=plans).to("cpu")


def test_a_ppi_like_read_share_keeps_the_full_products():
    """At PPI's read share the gate keeps ``TypedLinear``'s all-types
    form: ``typed_linear.shared_input`` counts, and the rows computed are
    the full rows (``table_rows_share`` 1.0). The gate reads the plan's
    count of its read rows alone: their forms are never built."""
    batch = _ppi_like_batch()
    share = batch.pair_stream_joint.num_read_rows / (3 * V)
    assert 0.97 < share < 0.98
    assert share >= gnn_edge_mlp.COMPACT_TABLES_BELOW
    layer = RGCN(3, 8, hidden_dim=16)
    layer.reset_parameters(torch.Generator().manual_seed(8))
    tracing.reset()
    layer._fused_sum_aggregate(torch.randn((V, 8)), batch, False)
    counters = tracing.counters()
    tracing.reset()
    assert counters["typed_linear.shared_input"] == 1
    assert counters["pair_tables.rows_computed"] == 3 * V
    assert counters["pair_tables.rows_full"] == 3 * V
    assert "compact.build.stream_joint.read" not in counters
    assert "read" not in batch.pair_stream_joint._rows


def test_the_read_form_is_built_once_a_batch():
    """A second call over the same batch builds no form: the read rows at
    the first forward, the restricted backward form at the first
    backward."""
    layer = _layer("rgcn", 8, 16)
    batch = _batch(seed=1)
    x = torch.randn((V, 8), generator=torch.Generator().manual_seed(9))
    tracing.reset()
    for _ in range(2):
        layer._fused_sum_aggregate(x.requires_grad_(True), batch,
                                   False).sum().backward()
    assert tracing.counters("compact.build") == {
        "stream_joint.fwd": 1, "stream_joint.bwd": 1,
        "stream_joint.read": 1, "stream_joint.read_bwd": 1}
    tracing.reset()
