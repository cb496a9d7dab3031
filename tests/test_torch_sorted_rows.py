"""The compact form of a sorted (scatter) plan
(``ops/sorted_spmm.py::sorted_rows``, kept by ``ScatterPlan.sum_rows``),
which the card's B12 reads instead of the plan arrays, on the CPU:

* against the plan's own segment ids (``_segment_ids``) on the scatter
  plans of ``test_torch_sorted_spmm.py``, in each of B12's call forms: the
  forward slots by target (R = 128), the backward slots by merged source
  (R = 128), read row by row or through the slot map, and the type-minor
  rows ``rel * L + type`` (R = 128 * L), whole and with the output cut by
  one node block: each row holds the same slots in ascending slot order;
  ``row_ptr`` is monotone and ends at ``n``; rows at or past the output
  are dropped; a plan whose chunks are shuffled keeps slot order too (the
  sort is stable, whatever order the planner leaves inside a chunk);
* the gathered form: every entry reads the forward slot
  ``bwd_to_fwd_idx[slot]``, which is the same edge's (its source is the
  entry's row);
* an all-sentinel plan gives ``n = 0`` in every form;
* a float64 ``index_add_`` over each compact form equals B12's plain
  version and the gathered form's plain version exactly (the streams hold
  small integers, so every f32 sum is exact);
* the sorted RGAT model builds B12's two forms, and B14's forward form,
  once per batch: three train steps hand the same two objects to every
  B12 launch.
"""
import numpy as np
import pytest
import torch

from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_train_step,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss

from .test_torch_rgcn_model import FEATURES, NUM_LABELS
from .test_torch_sorted_models import scatter_workload, sorted_rgat_params
from .test_torch_sorted_spmm import L, V, plans

FORMS = ("fwd", "bwd", "bwd_fused", "fwd_typed")


@pytest.fixture(scope="module")
def plan():
    return plans(30)[2]


def _form(plan, form, cut):
    """(rel, block_ids, R, out_rows) of one call form of B12."""
    rel, blocks = {"fwd": (plan.rel_tgt, plan.tgt_blocks),
                   "fwd_typed": (plan.rel_typed, plan.tgt_blocks)}.get(
                       form, (plan.rel_src, plan.src_blocks))
    r = tss.BLOCK_NODES * (L if form == "fwd_typed" else 1)
    rows = V if form == "fwd" else L * V
    return rel, blocks, r, rows - r if cut else rows


def _reference(rel, blocks, r, out_rows):
    """The kept slots, ordered by output row and then slot, their rows,
    and how many valid slots fell past the output."""
    seg = tss._segment_ids(rel, blocks, out_rows, r).numpy()
    kept = np.flatnonzero(seg < out_rows)
    slot = kept[np.lexsort((kept, seg[kept]))]
    full = tss._segment_ids(rel, blocks, 10 ** 9, r).numpy()
    dropped = int(((full < 10 ** 9) & (full >= out_rows)).sum())
    return seg[slot], slot, dropped


def _rows_of(compact):
    counts = torch.diff(compact.row_ptr.long())
    return torch.repeat_interleave(
        torch.arange(compact.out_rows), counts).numpy()


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("form", FORMS)
def test_sorted_rows_match_the_segment_ids(plan, form, cut):
    rel, blocks, r, out_rows = _form(plan, form, cut)
    compact = plan.sum_rows(form, out_rows)
    assert compact is plan.sum_rows(form, out_rows)  # kept on the plan
    rows, slot, dropped = _reference(rel, blocks, r, out_rows)
    row_ptr = compact.row_ptr.numpy()
    n = compact.src_row.numel()
    for t in (compact.row_ptr, compact.src_row, compact.slot):
        assert t.dtype == torch.int32 and t.is_contiguous()
    assert row_ptr.shape == (out_rows + 1,) and row_ptr[0] == 0
    assert (np.diff(row_ptr) >= 0).all() and row_ptr[-1] == n == slot.size
    assert compact.out_rows == out_rows
    assert compact.num_slots == rel.numel()
    np.testing.assert_array_equal(_rows_of(compact), rows)
    np.testing.assert_array_equal(compact.slot.numpy(), slot)
    same_row = np.diff(rows) == 0
    assert (np.diff(slot)[same_row] > 0).all()
    if form == "bwd_fused":
        assert compact.table_rows == plan.rel_tgt.numel()
        np.testing.assert_array_equal(compact.src_row.numpy(),
                                      plan.bwd_to_fwd_idx.numpy()[slot])
    else:
        assert compact.table_rows == rel.numel()
        np.testing.assert_array_equal(compact.src_row.numpy(), slot)
    assert (dropped > 0) == cut


def test_sorted_rows_keep_slot_order_in_shuffled_chunks(plan):
    """The forward plan's relative rows shuffled inside each chunk: every
    row's entries still come in ascending slot order, and the form equals
    the segment ids' (rows, then slots)."""
    rng = np.random.RandomState(32)
    rel = plan.rel_typed.numpy().reshape(-1, tss.CHUNK_EDGES).copy()
    for chunk in rel:
        rng.shuffle(chunk)
    rel = torch.from_numpy(rel.reshape(-1))
    r = tss.BLOCK_NODES * L
    compact = tss.sorted_rows(rel, plan.tgt_blocks, L * V, r)
    rows, slot, _ = _reference(rel, plan.tgt_blocks, r, L * V)
    assert (np.diff(slot) < 0).any()  # the slots are not in row order
    np.testing.assert_array_equal(_rows_of(compact), rows)
    np.testing.assert_array_equal(compact.slot.numpy(), slot)


def test_gathered_form_reads_the_same_edges_forward_slot(plan):
    """Each entry of the gathered form reads the forward slot of its own
    edge: a valid forward slot whose merged source is the entry's row."""
    compact = plan.sum_rows("bwd_fused", L * V)
    rows = _rows_of(compact)
    fwd_slot = compact.src_row.numpy()
    np.testing.assert_array_equal(
        fwd_slot, plan.bwd_to_fwd_idx.numpy()[compact.slot.numpy()])
    assert not plan.fwd_sentinel.numpy()[fwd_slot].any()
    np.testing.assert_array_equal(plan.src_merged.numpy()[fwd_slot], rows)
    # Every valid forward slot is read exactly once.
    assert np.array_equal(np.sort(fwd_slot),
                          np.flatnonzero(~plan.fwd_sentinel.numpy()))


@pytest.mark.parametrize("form", FORMS)
def test_all_sentinel_plan_has_no_entries(form):
    host = tss.build_merged_plans([np.zeros(0, np.int32)] * L,
                                  [np.zeros(0, np.int32)] * L, [0] * L, V)
    empty = tss.ScatterPlan.from_host(host, V, L).to("cpu")
    assert bool(empty.fwd_sentinel.all()) and bool(empty.bwd_sentinel.all())
    _, _, _, out_rows = _form(empty, form, False)
    compact = empty.sum_rows(form, out_rows)
    assert compact.src_row.numel() == compact.slot.numel() == 0
    assert torch.equal(compact.row_ptr,
                       torch.zeros(out_rows + 1, dtype=torch.int32))


def _compact_sum(stream, compact):
    """``index_add_`` of the compact form's stream rows, in float64."""
    out = torch.zeros((compact.out_rows, stream.shape[1]),
                      dtype=torch.float64)
    rows = torch.from_numpy(_rows_of(compact))
    return out.index_add_(0, rows, stream.double()[compact.src_row.long()])


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("form", FORMS)
def test_compact_sum_equals_the_plain_versions(plan, form, cut):
    rel, blocks, r, out_rows = _form(plan, form, cut)
    rng = np.random.RandomState(31)
    slots = (plan.rel_tgt if form == "bwd_fused" else rel).numel()
    stream = torch.from_numpy(rng.randint(-8, 9, (slots, 5)).astype(
        np.float32))
    if form == "bwd_fused":
        want = tss.sorted_segment_sum_gathered_plain(
            stream, plan.bwd_to_fwd_idx, plan.bwd_sentinel, rel, blocks,
            out_rows)
    else:
        want = tss.sorted_segment_sum_plain(stream, rel, blocks, out_rows,
                                            block_rows=r)
    got = _compact_sum(stream, plan.sum_rows(form, out_rows))
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want.double(), rtol=0.0, atol=0.0)


def test_sorted_rgat_builds_b12_forms_once_per_batch(monkeypatch):
    """Three train steps of the sorted RGAT model (2 layers): B12's
    gathered form (``plan_gather_src``'s gradient) and its type-minor form
    (``plan_gather_tgt_typed``'s), and the forward form that B14 reads,
    are built once each, and every B12 call of every layer and step gets
    one of the first two."""
    _, batch, labels = scatter_workload(seed=6)
    params = sorted_rgat_params("bfloat16")
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, optimizer)
    built, seen = [], {"sorted_segment_sum": [],
                       "sorted_segment_sum_gathered": []}
    real_build = tss.sorted_rows
    monkeypatch.setattr(
        tss, "sorted_rows",
        lambda *a, **k: built.append(real_build(*a, **k)) or built[-1])
    for name, calls in seen.items():
        def spy(*args, _real=getattr(tss, name), _calls=calls,
                compact=None, **kwargs):
            _calls.append(compact)
            return _real(*args, compact=compact, **kwargs)
        monkeypatch.setattr(tss, name, spy)
    targets = {"node_labels": torch.from_numpy(labels)}
    for _ in range(3):
        state, _ = train_step(state, batch, targets)
    plan = batch.scatter_merged
    fused = plan.sum_rows("bwd_fused", L * batch.num_nodes_padded)
    typed = plan.sum_rows("fwd_typed", L * batch.num_nodes_padded)
    fwd = plan.sum_rows("fwd", batch.num_nodes_padded)
    assert len(built) == 3 and {id(b) for b in built} == {id(fused),
                                                          id(typed), id(fwd)}
    assert len(seen["sorted_segment_sum_gathered"]) == 2 * 3
    assert all(c is fused for c in seen["sorted_segment_sum_gathered"])
    # On the CPU the gathered form runs B12's wrapper on the re-ordered
    # stream, without a compact form; the type-minor calls carry theirs.
    with_form = [c for c in seen["sorted_segment_sum"] if c is not None]
    assert len(with_form) == 2 * 3 and all(c is typed for c in with_form)
    assert len(seen["sorted_segment_sum"]) == 2 * 2 * 3
