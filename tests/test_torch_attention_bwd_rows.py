"""B9's two compact forms and its two row-owner passes on the CPU. The
card's B9 (``pair_attention_bwd_fused``) reads, in place of the backward
plan's arrays, ``MergedPlan.bwd_rows(rows, v)`` (``slot_rows`` of the
backward direction: the valid slots as a CSR by source row u, each with
its target t clipped into the v rows of dw) and ``MergedPlan.bwd_ts_rows(
rows, v, vs)`` (``ops/pair_spmm.py::ts_rows``: each entry's target-score
row, and a second CSR of the entries by their d_ts row ``(u // vs) * vs +
t``):

* on a merged plan (3 types, sources in the stacked rows) and a per-type
  plan, whole and cut (fewer source rows, so entries with u past them are
  dropped; fewer dw rows than targets, so a t past v is clipped for the
  gathers and kept unclipped in the d_ts row): both forms hold the plan's
  own slot ids in slot order, with empty rows among them, and are kept on
  the plan; an all-sentinel plan has no entries;
* a float64 emulation of the two passes over the forms (pass 1 per source
  row: e, d_p, d_ss and d_table; pass 2: each entry's d_p summed by d_ts
  row) equals the plain version ``pair_attention_bwd_fused_plain`` over
  the plan arrays, at K = 4 and K = 8, and at H = 576 and 1024 (rows that
  the kernel's tiled form takes), within f32 rounding (rtol 1e-5);
* RGAT on a merged plan, on per-type plans and at 8 heads (the hk-major
  route) builds each plan's forms once over 3 train steps and hands the
  same objects to every B9 call;
* B9 takes any width (a row its registers cannot hold takes the tiled
  form), so the route gate is the reference's: an RGAT layer of 512, 576
  or 1024 columns takes the pair path and reaches B9, even on a batch
  that also carries scatter plans.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import pair_attention as jpa
from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_train_step,
)
from tf2_gnn_tpu_torch.layers.message_passing import rgat as trgat
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss

from .test_torch_rgcn_model import FEATURES, NUM_LABELS, small_workload

V = 384


@functools.lru_cache(maxsize=None)
def _plan(form: str):
    """A merged plan over 3 random edge types or one type's plan; no edge
    leaves a source of 100-199, so those rows have no entries."""
    rng = np.random.RandomState({"merged": 0, "typed": 1}[form])
    srcs, tgts, counts = [], [], []
    for _ in range(3 if form == "merged" else 1):
        e = rng.randint(V, 4 * V)
        srcs.append(rng.choice(np.r_[0:100, 200:V], e))
        tgts.append(rng.randint(0, V, e))
        counts.append(e)
    host = tps.build_pair_plans(srcs, tgts, counts, V)
    return tps.MergedPlan(*host.astuple()).to("cpu")


# (plan, rows, v, vs): the source rows, the dw rows, one type's rows.
CASES = {
    "merged": ("merged", 3 * V, V, V),
    "merged_cut": ("merged", 2 * V, 256, V),
    "typed": ("typed", V, V, V),
    "typed_cut": ("typed", V, 256, V),
}


def _rows_of(compact):
    return torch.repeat_interleave(
        torch.arange(compact.out_rows),
        torch.diff(compact.row_ptr.long())).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_forms_match_the_plans_slot_ids(case):
    form, rows, v, vs = CASES[case]
    plan = _plan(form)
    compact = plan.bwd_rows(rows, v)
    ts = plan.bwd_ts_rows(rows, v, vs)
    assert compact is plan.bwd_rows(rows, v)
    assert ts is plan.bwd_ts_rows(rows, v, vs)
    t, u, valid = (x.numpy() for x in tps.slot_abs_ids(*plan.bwd))
    slot = np.flatnonzero(valid & (u < rows))
    slot = slot[np.lexsort((slot, u[slot]))]
    assert (compact.table_rows, compact.out_rows) == (v, rows)
    assert compact.num_slots == plan.rel_src_b.numel()
    np.testing.assert_array_equal(_rows_of(compact), u[slot])
    np.testing.assert_array_equal(compact.src_row.numpy(),
                                  np.minimum(t[slot], v - 1))
    np.testing.assert_array_equal(compact.slot.numpy(), slot)
    assert (np.diff(compact.row_ptr.numpy()) == 0).any()  # empty rows

    key = (u[slot] // vs) * vs + t[slot]
    np.testing.assert_array_equal(ts.score_row.numpy(),
                                  np.minimum(key, rows - 1))
    entry = np.flatnonzero(key < rows)
    entry = entry[np.lexsort((entry, key[entry]))]
    sums = ts.sums
    for x in (ts.score_row, sums.row_ptr, sums.src_row, sums.slot):
        assert x.dtype == torch.int32 and x.is_contiguous()
    assert (sums.table_rows, sums.out_rows) == (slot.size, rows)
    np.testing.assert_array_equal(_rows_of(sums), key[entry])
    np.testing.assert_array_equal(sums.src_row.numpy(), entry)
    np.testing.assert_array_equal(sums.slot.numpy(), slot[entry])
    cut = case.endswith("cut")
    past_v = t[slot] >= v
    assert past_v.any() == cut
    if cut:  # clipped for the gathers, unclipped in the d_ts row
        assert int((valid & (u >= rows)).sum()) > 0 or rows == V
        assert (compact.src_row.numpy()[past_v] == v - 1).all()
        assert (key[past_v] == (u[slot][past_v] // vs) * vs
                + t[slot][past_v]).all()
        assert np.isin(np.flatnonzero(past_v), entry).any()


def test_all_sentinel_plan_has_no_entries():
    host = tps.build_pair_plans([np.zeros(0, np.int32)],
                                [np.zeros(0, np.int32)], [0], 256)
    plan = tps.MergedPlan(*host.astuple()).to("cpu")
    ts = plan.bwd_ts_rows(256, 256, 256)
    assert plan.bwd_rows(256, 256).src_row.numel() == 0
    assert ts.score_row.numel() == ts.sums.src_row.numel() == 0
    assert torch.equal(ts.sums.row_ptr, torch.zeros(257, dtype=torch.int32))


def _inputs(rows, v, k, head_dim, seed):
    rng = np.random.RandomState(seed)

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (shift + scale * rng.randn(*shape)).astype(np.float32))

    # The stabiliser sits near the logits' top (about 3 here), as the
    # model's does, so e stays near or below 1 and the f32 sums of the
    # plain version carry no large cancelling terms.
    return (f32(rows, head_dim * k), f32(v, head_dim * k), f32(v, k),
            f32(rows, 2 * k, scale=0.5), f32(v, k, scale=0.1, shift=3.0))


def _two_passes(table, dw, d_denom, scores, maxes, compact, ts, k):
    """B9's kernels in float64 over the compact forms: pass 1 per entry of
    source row u (e, d_p, d_ss[u], d_table[u]), pass 2 each entry's d_p
    summed by its d_ts row."""
    table, dw, d_denom, scores, maxes = (
        x.double() for x in (table, dw, d_denom, scores, maxes))
    rows, h = table.shape
    u = torch.from_numpy(_rows_of(compact))
    t = compact.src_row.long()
    p = scores[u, :k] + scores[ts.score_row.long(), k:]
    e = torch.exp(torch.where(p >= 0, p, 0.2 * p) - maxes[t])
    de = (table[u] * dw[t]).reshape(-1, h // k, k).sum(dim=1) + d_denom[t]
    d_p = e * torch.where(p >= 0, 1.0, 0.2) * de
    d_ss = torch.zeros((rows, k), dtype=torch.float64).index_add_(0, u, d_p)
    d_table = torch.zeros((rows, h), dtype=torch.float64).index_add_(
        0, u, dw[t] * e.repeat(1, h // k))
    d_ts = torch.zeros((rows, k), dtype=torch.float64).index_add_(
        0, torch.from_numpy(_rows_of(ts.sums)), d_p[ts.sums.src_row.long()])
    return d_ss, d_ts, d_table


@pytest.mark.parametrize("k,head_dim", [(4, 20), (8, 8), (4, 144),
                                        (4, 256)])
@pytest.mark.parametrize("case", list(CASES))
def test_two_passes_equal_the_plain_version(case, k, head_dim):
    """Each side runs twice and must give the same bits both times, so
    that a run-to-run change (once seen at [typed-8-8]: d_ss 1.4e-4 off,
    not reproduced since; ROADMAP queue C) names the side that moved.
    Both sides run on one torch thread, so that their sums keep one order
    whatever the load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_two_passes(case, k, head_dim)
    finally:
        torch.set_num_threads(threads)


def _check_two_passes(case, k, head_dim):
    form, rows, v, vs = CASES[case]
    plan = _plan(form)
    args = _inputs(rows, v, k, head_dim, seed=k)

    def plain():
        return tpa.pair_attention_bwd_fused_plain(*args, *plan.bwd, v, k,
                                                  src_space=vs)

    def emulation():
        return _two_passes(*args, plan.bwd_rows(rows, v),
                           plan.bwd_ts_rows(rows, v, vs), k)

    want, got = plain(), emulation()
    for side, fn, first in (("plain version", plain, want),
                            ("emulation", emulation, got)):
        for name, x, y in zip(("d_ss", "d_ts", "d_table"), first, fn()):
            assert torch.equal(x, y), (
                f"the {side}'s {name} moved between two runs by "
                f"{float((x - y).abs().max())} "
                f"({torch.get_num_threads()} torch threads)")
    for name, g, w in zip(("d_ss", "d_ts", "d_table"), got, want):
        assert w.abs().max() > 0
        torch.testing.assert_close(g, w.double(), rtol=1e-5, atol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("form,heads", [("merged", 2), ("typed", 2),
                                        ("typed", 8)])
def test_rgat_builds_its_forms_once_per_batch(form, heads, monkeypatch):
    """Three train steps of RGAT under the "exact" stabiliser: each
    plan's two B9 forms are built once (and its forward form once, which
    B11, B8, the head-major route and B10 read), every B9 call of every
    layer and step gets that plan's forms, and every B11 call its forward
    form; every B8 call gets the object its B11 call got, and every B3
    (2 heads) or B10 (8 heads) call after it that object too, reading
    B8's output by entry."""
    _, batch, labels = small_workload(seed=7, merged=form == "merged")
    params = NodeMulticlassTask.get_default_hyperparameters("rgat")
    params.update({"gnn_hidden_dim": 2 * heads, "gnn_num_layers": 2,
                   "gnn_num_heads": heads,
                   "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000,
                   "gnn_attention_stabiliser": "exact"})
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, optimizer)
    built, built_ts, seen, seen_b11 = [], [], [], []
    seen_fwd = {"b8": [], "sums": []}
    real_rows, real_ts = tps.slot_rows, tps.ts_rows
    real_b9, real_b11 = tpa.pair_attention_bwd_fused, tpa.pair_attention_max
    monkeypatch.setattr(tps, "slot_rows",
                        lambda *a: built.append(real_rows(*a)) or built[-1])
    monkeypatch.setattr(tps, "ts_rows",
                        lambda *a: built_ts.append(real_ts(*a))
                        or built_ts[-1])

    def spy(*args, compact=None, ts_rows=None, **kwargs):
        seen.append((compact, ts_rows))
        return real_b9(*args, compact=compact, ts_rows=ts_rows, **kwargs)

    def spy_b11(*args, compact=None, **kwargs):
        seen_b11.append(compact)
        return real_b11(*args, compact=compact, **kwargs)

    def spy_fwd(key, real):
        def call(*args, compact=None, **kwargs):
            seen_fwd[key].append((compact, kwargs.get("by_entry")))
            return real(*args, compact=compact, **kwargs)
        return call

    monkeypatch.setattr(tpa, "pair_attention_bwd_fused", spy)
    monkeypatch.setattr(tpa, "pair_attention_max", spy_b11)
    monkeypatch.setattr(tpa, "pair_attention_expd",
                        spy_fwd("b8", tpa.pair_attention_expd))
    sums = "pair_spmm" if heads == 2 else "pair_attention_agg"
    monkeypatch.setattr(tpa, sums, spy_fwd("sums", getattr(tpa, sums)))
    targets = {"node_labels": torch.from_numpy(labels)}
    for _ in range(3):
        state, _ = train_step(state, batch, targets)
    plans = (batch.pair_merged,) if form == "merged" else batch.pair_typed
    assert len(built) == 2 * len(plans)
    assert len(built_ts) == len(plans)
    assert len(seen) == 2 * 3 * len(plans)
    v = batch.num_nodes_padded
    for i, (compact, ts) in enumerate(seen):
        plan = plans[i % len(plans)]
        rows = compact.out_rows
        assert compact is plan.bwd_rows(rows, v)
        assert ts is plan.bwd_ts_rows(rows, v, v)
        assert any(compact is b for b in built)
        assert any(ts is b for b in built_ts)
    assert len(seen_b11) == 2 * 3 * len(plans)
    for i, compact in enumerate(seen_b11):
        plan = plans[i % len(plans)]
        assert compact is plan.fwd_rows(v, compact.table_rows)
        assert any(compact is b for b in built)
    assert len(seen_fwd["b8"]) == len(seen_b11)
    assert all(b8 is b11 for (b8, _), b11 in zip(seen_fwd["b8"], seen_b11))
    per_b8 = heads if heads == 2 else 1
    assert len(seen_fwd["sums"]) == per_b8 * len(seen_b11)
    for i, (compact, by_entry) in enumerate(seen_fwd["sums"]):
        assert by_entry and compact is seen_b11[i // per_b8]


@pytest.mark.parametrize("hidden", [512, 576, 1024])
def test_rgat_wider_than_b9s_row_takes_the_sorted_route(hidden,
                                                        monkeypatch):
    """Wider than B9's register row the port's gate is the reference's:
    at the PPI shape in bf16 both take the pair path at 4 heads of 128
    and 144 columns and, by the reference's VMEM budgets, not at 256; on
    this batch, which also carries scatter plans, both take it at all
    three widths, and a train step reaches B9 (its register form at 512
    columns, its tiled form at 576 and 1024) and never the sorted-scatter
    route. (The name is kept from the port's narrower gate, which sent
    the wider layers to the sorted route.)"""
    rows, v = 3 * 8064, 8064
    assert (tpa.pair_attention_applicable(rows, v, hidden, 4, torch.bfloat16,
                                          torch.bfloat16, v)
            == jpa.pair_attention_applicable(rows, v, hidden, 4,
                                             jnp.bfloat16, jnp.bfloat16, v)
            == (hidden < 1024))

    _, batch, labels = small_workload(seed=8, merged=True)
    small = (3 * batch.num_nodes_padded, batch.num_nodes_padded)
    assert jpa.pair_attention_applicable(*small, hidden, 4, jnp.float32,
                                         jnp.float32, small[1])
    srcs = [np.asarray(x) for x in batch.edge_sources]
    tgts = [np.asarray(x) for x in batch.edge_targets]
    cnts = [int(c) for c in np.asarray(batch.num_edges)]
    batch = batch.replace(scatter_plans=tss.build_merged_plans(
        srcs, tgts, cnts, batch.num_nodes_padded).astuple()).to("cpu")
    params = NodeMulticlassTask.get_default_hyperparameters("rgat")
    params.update({"gnn_hidden_dim": hidden, "gnn_num_layers": 1,
                   "gnn_num_heads": 4, "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000})
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    calls = []
    for module, name in ((trgat, "pair_attention"),
                         (trgat, "sorted_segment_max"),
                         (tpa, "pair_attention_bwd_fused")):
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer)
    state, metrics = make_train_step(model, optimizer)(
        state, batch, {"node_labels": torch.from_numpy(labels)})
    assert np.isfinite(float(metrics["loss"]))
    assert calls == ["pair_attention", "pair_attention_bwd_fused"]
