"""The compact form of a plan direction (``ops/pair_spmm.py::slot_rows``),
which the card's K1, K2 and B3 read instead of the plan arrays, on the CPU:

* against the plan's own slot ids (``slot_abs_ids`` /
  ``_stream_slot_abs_ids``) on a small merged plan, a per-type joint plan
  (PPI-like: 3 types) and a QM9-shaped plan in both directions (the
  backward one as K1 reads it: all-zero types, the [V] cotangent into the
  stacked [L * V] rows) and both probe plans (groups 1 and 8), whole and
  with the output and the table cut to half their rows: each row holds the
  same (target, source, slot) triples, in ascending slot order;
  ``row_ptr`` is monotone and ends at ``n``; targets at or past
  ``out_rows`` are dropped and sources clipped into the table;
* ``StreamJointPlan.bwd_rows`` is that backward form, built once and kept;
* an all-sentinel plan gives ``n = 0``;
* an ``index_add_`` over the compact form's slots equals the plain
  versions ``pair_spmm_plain`` / ``pair_spmm_stream_plain`` over the plan
  arrays, in float64 within 1e-12: the tables hold small integers and the
  scales are powers of two, so every f32 sum of the plain versions is
  exact;
* the models build it once per batch: two forwards of RGCN (per-type
  plans) and RGAT (merged and per-type plans) build one form per plan and
  hand the same object to every kernel call; three RGCN train steps build
  the forward (K2) and backward (K1) forms once each. RGCN runs on full
  tables here (``COMPACT_TABLES_BELOW`` at 0): the forms of tables that
  hold only the rows a plan reads are held in
  ``test_torch_compact_tables.py``.
"""
import functools

import numpy as np
import pytest
import torch

from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_train_step,
)
from tf2_gnn_tpu_torch.layers.message_passing import gnn_edge_mlp
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import probes

from .test_torch_rgcn_model import FEATURES, NUM_LABELS, small_workload


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


V = 384


def _edges(seed, num_types=3):
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(V, 6 * V)
        srcs.append(rng.randint(0, V, e))
        tgts.append(rng.randint(0, V, e))
        counts.append(e)
    return srcs, tgts, counts


def _merged():
    srcs, tgts, counts = _edges(0)
    plan = tps.MergedPlan(*tps.build_pair_plans(
        srcs, tgts, counts, V).astuple()).to("cpu")
    return plan.fwd, None, 0, 3 * V, V


@functools.lru_cache(maxsize=None)
def _joint_plan():
    srcs, tgts, counts = _edges(1)
    typed = tuple(tps.build_pair_plans([s], [t], [c], V, group_fwd=8,
                                       group_bwd=8).astuple()
                  for s, t, c in zip(srcs, tgts, counts))
    return tps.stream_joint_plan(typed, V, V).to("cpu")


@functools.lru_cache(maxsize=None)
def _qm9_plan():
    batch, _, _ = workloads.build_qm9_batch(0, device="cpu", molecules=120,
                                            node_budget=2304)
    return batch.pair_stream_joint


def _fwd(plan):
    return (plan.rel_src_f, plan.rel_tgt_f, plan.src_blk_f,
            plan.grp_tgt_fl), plan.grp_type_f, plan.v_src, \
        plan.num_types * plan.v_src, plan.v_out


def _bwd(plan):
    """K1's layout: the [v_out] cotangent's rows (all-zero types) into the
    stacked [L * v_src] table rows."""
    return (plan.rel_src_b, plan.rel_tgt_b, plan.src_blk_b,
            plan.grp_tgt_b), plan.type_b_zeros, plan.v_out, plan.v_out, \
        plan.num_types * plan.v_src


def _probe(build):
    rng = np.random.RandomState(2)
    src = np.concatenate([rng.randint(0, 3 * V, 4000), np.full(300, 9)])
    tgt = np.concatenate([rng.randint(0, V, 4000), np.full(300, 2)])
    plan = build(src, tgt, 3 * V, V).to("cpu")
    return plan.kernel_args[1:], None, 0, 3 * V, V


PLANS = {"merged": _merged, "joint": lambda: _fwd(_joint_plan()),
         "qm9": lambda: _fwd(_qm9_plan()),
         "joint_bwd": lambda: _bwd(_joint_plan()),
         "qm9_bwd": lambda: _bwd(_qm9_plan()),
         "probe_group1": lambda: _probe(probes.chunked_plan),
         "probe_group8": lambda: _probe(probes.unrolled_plan)}


@pytest.fixture(scope="module")
def plans():
    return {name: build() for name, build in PLANS.items()}


def _shape(case, cut):
    """(table_rows, out_rows): the plan's, or half of each."""
    _, _, _, table_rows, out_rows = case
    return (table_rows // 2, out_rows // 2) if cut else (table_rows, out_rows)


def _reference(case, table_rows, out_rows):
    """(target, clipped source, slot) of each kept slot, ordered by target
    and then slot, from the plan's slot ids; and how many were dropped and
    clipped."""
    arrays, grp_type, v, _, _ = case
    if grp_type is None:
        src, tgt, valid = tps.slot_abs_ids(*arrays)
    else:
        src, tgt, valid = tps._stream_slot_abs_ids(*arrays, grp_type, v)
    src, tgt, valid = src.numpy(), tgt.numpy(), valid.numpy()
    slot = np.flatnonzero(valid & (tgt < out_rows))
    order = np.lexsort((slot, tgt[slot]))
    slot = slot[order]
    dropped = int((valid & (tgt >= out_rows)).sum())
    clipped = int((src[slot] >= table_rows).sum())
    return (tgt[slot], np.minimum(src[slot], table_rows - 1), slot, dropped,
            clipped)


def _compact(case, table_rows, out_rows):
    arrays, grp_type, v, _, _ = case
    return tps.slot_rows(*arrays, table_rows, out_rows, grp_type, v)


def _rows_of(compact):
    counts = torch.diff(compact.row_ptr.long())
    return torch.repeat_interleave(
        torch.arange(compact.out_rows), counts).numpy()


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("name", list(PLANS))
def test_slot_rows_matches_the_plans_slot_ids(plans, name, cut):
    case = plans[name]
    table_rows, out_rows = _shape(case, cut)
    compact = _compact(case, table_rows, out_rows)
    tgt, src, slot, dropped, clipped = _reference(case, table_rows,
                                                  out_rows)
    row_ptr = compact.row_ptr.numpy()
    n = compact.src_row.numel()
    for t in (compact.row_ptr, compact.src_row, compact.slot):
        assert t.dtype == torch.int32 and t.is_contiguous()
    assert row_ptr.shape == (out_rows + 1,) and row_ptr[0] == 0
    assert (np.diff(row_ptr) >= 0).all() and row_ptr[-1] == n == slot.size
    assert (compact.table_rows, compact.out_rows) == (table_rows, out_rows)
    assert compact.num_slots == case[0][0].numel()
    rows = _rows_of(compact)
    np.testing.assert_array_equal(rows, tgt)
    np.testing.assert_array_equal(compact.src_row.numpy(), src)
    np.testing.assert_array_equal(compact.slot.numpy(), slot)
    same_row = np.diff(rows) == 0
    assert (np.diff(compact.slot.numpy())[same_row] > 0).all()
    if cut:  # the cut drops targets and clips sources
        assert dropped > 0 and clipped > 0
    else:
        assert dropped == 0 and clipped == 0


@pytest.mark.parametrize("name", ["joint", "qm9"])
def test_stream_plan_bwd_rows_is_the_backward_form(name):
    """``StreamJointPlan.bwd_rows``, which K1 reads: the backward layout's
    (target, source, slot) triples from ``_stream_slot_abs_ids`` with the
    all-zero types, into the stacked [L * v_src] rows from the [v_out]
    cotangent, kept on the plan."""
    plan = {"joint": _joint_plan, "qm9": _qm9_plan}[name]()
    case = _bwd(plan)
    compact = plan.bwd_rows
    assert compact is plan.bwd_rows
    assert int(plan.type_b_zeros.abs().max()) == 0
    assert (compact.table_rows, compact.out_rows) == (
        plan.v_out, plan.num_types * plan.v_src)
    assert compact.num_slots == plan.scale_bwd.numel()
    tgt, src, slot, dropped, clipped = _reference(case, plan.v_out,
                                                  plan.num_types * plan.v_src)
    assert dropped == 0 and clipped == 0 and slot.size > 0
    np.testing.assert_array_equal(_rows_of(compact), tgt)
    np.testing.assert_array_equal(compact.src_row.numpy(), src)
    np.testing.assert_array_equal(compact.slot.numpy(), slot)


def test_all_sentinel_plan_has_no_slots():
    host = tps.build_pair_plans([np.zeros(0, np.int32)],
                                [np.zeros(0, np.int32)], [0], 256)
    plan = tps.MergedPlan(*host.astuple(), out_rows=256).to("cpu")
    assert (plan.rel_src_f == tps.BLK).all()
    compact = plan.fwd_rows(256, 256)
    assert compact.src_row.numel() == compact.slot.numel() == 0
    assert torch.equal(compact.row_ptr, torch.zeros(257, dtype=torch.int32))


def _compact_sum(table, scale, compact):
    """``index_add_`` over the compact form's slots, in float64."""
    out = torch.zeros((compact.out_rows, table.shape[1]), dtype=torch.float64)
    msgs = (table.double()[compact.src_row.long()]
            * scale.double()[compact.slot.long()][:, None])
    rows = torch.from_numpy(_rows_of(compact))
    return out.index_add_(0, rows, msgs)


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("name", list(PLANS))
def test_compact_sum_equals_the_plain_versions(plans, name, cut):
    case = plans[name]
    arrays, grp_type, v, _, _ = case
    table_rows, out_rows = _shape(case, cut)
    rng = np.random.RandomState(3)
    table = torch.from_numpy(
        rng.randint(-8, 9, (table_rows, 7)).astype(np.float32))
    scale = torch.from_numpy(rng.choice(
        [0.25, 0.5, 1.0, 2.0, -1.0], arrays[0].numel()).astype(np.float32))
    if grp_type is None:
        want = tps.pair_spmm_plain(table, scale, *arrays, out_rows)
    else:
        want = tps.pair_spmm_stream_plain(table, scale, *arrays, grp_type, v,
                                          out_rows)
    got = _compact_sum(table, scale, _compact(case, table_rows, out_rows))
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want.double(), rtol=0.0, atol=1e-12)


def _spy(monkeypatch, module, name, seen):
    """Record the ``compact`` argument of each call of ``module.name``
    (other keywords, such as B3's ``by_entry``, pass through)."""
    real = getattr(module, name)

    def spy(*args, compact=None, **kwargs):
        seen.append(compact)
        return real(*args, compact=compact, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("style,form", [("rgcn", "typed"),
                                        ("rgat", "merged"),
                                        ("rgat", "typed")])
def test_compact_form_is_built_once_per_batch(style, form, monkeypatch):
    monkeypatch.setattr(gnn_edge_mlp, "COMPACT_TABLES_BELOW", 0.0)
    _, batch, _ = small_workload(seed=1, merged=form == "merged")
    params = NodeMulticlassTask.get_default_hyperparameters(style)
    params.update({"gnn_hidden_dim": 8, "gnn_num_layers": 2,
                   "gnn_num_heads": 2, "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000})
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    built, seen = [], []
    real_build = tps.slot_rows
    monkeypatch.setattr(tps, "slot_rows",
                        lambda *a: built.append(real_build(*a)) or built[-1])
    if style == "rgcn":
        _spy(monkeypatch, tps, "pair_spmm_stream_joint", seen)
    else:
        _spy(monkeypatch, tpa, "pair_spmm", seen)
    with torch.no_grad():
        first = model(batch, False)
        second = model(batch, False)
    torch.testing.assert_close(first, second, rtol=0.0, atol=0.0)
    plans_per_batch = 3 if (style, form) == ("rgat", "typed") else 1
    heads = 2 if style == "rgat" else 1
    assert len(built) == plans_per_batch
    assert len(seen) == 2 * 2 * heads * plans_per_batch
    assert all(any(c is b for b in built) for c in seen)
    # Each plan hands its one form to both forwards.
    per_forward = len(seen) // 2
    assert all(a is b for a, b in zip(seen[:per_forward], seen[per_forward:]))


def test_rgcn_builds_its_two_forms_once_per_batch(monkeypatch):
    """Three train steps of RGCN on per-type plans: K2's forward form and
    K1's backward form are each built once, and every K2 (K1) call of every
    layer and step gets the one forward (backward) form."""
    monkeypatch.setattr(gnn_edge_mlp, "COMPACT_TABLES_BELOW", 0.0)
    _, batch, labels = small_workload(seed=2)
    params = NodeMulticlassTask.get_default_hyperparameters("rgcn")
    params.update({"gnn_hidden_dim": 8, "gnn_num_layers": 2,
                   "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000})
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, optimizer)
    built, fwd_seen, bwd_seen = [], [], []
    real_build = tps.slot_rows
    monkeypatch.setattr(tps, "slot_rows",
                        lambda *a: built.append(real_build(*a)) or built[-1])
    _spy(monkeypatch, tps, "pair_spmm_stream_joint", fwd_seen)
    _spy(monkeypatch, tps, "pair_spmm_stream", bwd_seen)
    targets = {"node_labels": torch.from_numpy(labels)}
    for _ in range(3):
        state, _ = train_step(state, batch, targets)
    plan = batch.pair_stream_joint
    assert len(built) == 2
    assert len(fwd_seen) == len(bwd_seen) == 2 * 3
    assert all(c is plan.fwd_rows for c in fwd_seen)
    assert all(c is plan.bwd_rows for c in bwd_seen)
    assert {id(plan.fwd_rows), id(plan.bwd_rows)} == {id(b) for b in built}
