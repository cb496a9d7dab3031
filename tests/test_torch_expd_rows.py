"""B8 as a row owner over the forward compact form, on the CPU. On the card
B8 (``pair_attention_expd``) runs ``csrc/pair_stream.cu``'s
``expd_rows_kernel`` over ``MergedPlan.fwd_rows(V, rows)``, the form B11,
B3 and B10 read: for entry e of row t, in the form's order, with u its
``src_row``,

    expd[k, e] = exp(logit(e, k) - m[t, k]),
    logit(e, k) = leaky(ss[u, k] + ts[clip((u // vs) * vs + t, rows), k]),

the logit from the same device function as B11's, in f32, the subtraction
not contracted into an FMA. Its output is f32 ``[K, n]`` by entry.

An emulation of that, entry by entry in the form's order with the same f32
operations, equals ``pair_attention_expd_plain(...)[:, compact.slot]``
exactly: on a merged plan and one type's plan, at K = 1, 4 and 8, with f32
and bf16 scores, and on plans whose last source block is partly padded
(nodes below 300 of 384), where the form's clipped u and the first port's
unclipped u give the same target-score row. On a CPU tensor the wrapper
with ``compact=`` returns that tensor and counts no launch; without it,
the plain version by slot. Through B8's by-entry output, B3's head-major
sums and B10's sums equal their plain versions over the plain version's
by-slot expd bit for bit, so the RGAT op's CPU results do not depend on
the layout. Every B8 call of an RGAT model's train steps gets its plan's
forward form, the one B11, B3 and B10 get.
"""
import functools

import numpy as np
import pytest
import torch

from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_train_step,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_spmm as tps

from .test_torch_max_rows import (
    DTYPES,
    V,
    _edges,
    _entry_logits,
    _pair_plans,
    _rows_of,
    _scores,
)
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


def _b8_row_owner(scores, maxes, compact, k: int, vs: int):
    """``expd_rows_kernel`` over ``compact``: each entry's f32 logits
    (B11's), minus its target row's stabiliser, through exp; [K, n]."""
    logit = _entry_logits(scores, compact, k, vs)
    return torch.exp(logit - maxes[_rows_of(compact)]).t().contiguous()


def _stabiliser(scores, k: int):
    return tpa._stabilise(tpa._bound_stabiliser(scores, V, k), scores.dtype)


@functools.lru_cache(maxsize=None)
def _padded_plans():
    """(plan, score rows) of a merged plan and one type's plan whose last
    source block is partly padded: no source at or past node 300."""
    srcs, tgts, counts = _edges(3, 3, max_node=300)
    merged = tps.MergedPlan(*tps.build_pair_plans(
        srcs, tgts, counts, V).astuple()).to("cpu")
    typed = tps.MergedPlan(*tps.build_pair_plans(
        srcs[:1], tgts[:1], counts[:1], V).astuple()).to("cpu")
    return {"merged": (merged, 3 * V), "typed": (typed, V)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("form", ["merged", "typed", "merged_padded",
                                  "typed_padded"])
def test_b8_row_owner_equals_the_plain_version_at_the_forms_slots(form, k,
                                                                   dtype):
    """B8's emulation over ``fwd_rows`` equals the plain version at the
    form's slots bit for bit, and so does the wrapper on a CPU tensor
    with the form; rows without entries have no column."""
    if form.endswith("_padded"):
        plan, rows = _padded_plans()[form.split("_")[0]]
    else:
        _, plans, rows = _pair_plans(form)
        plan = plans[-1]
    scores = _scores(30 + k, rows, k, dtype)
    maxes = _stabiliser(scores, k)
    compact = plan.fwd_rows(V, rows)
    want = tpa.pair_attention_expd_plain(scores, maxes, *plan.fwd, V, k)
    assert tuple(want.shape) == (k, plan.rel_src_f.numel())
    at_slots = want[:, compact.slot.long()]
    got = _b8_row_owner(scores, maxes, compact, k, V)
    assert tuple(got.shape) == (k, compact.src_row.numel())
    assert float(got.min()) > 0 and torch.equal(got, at_slots)
    before = dict(tpa.LAUNCHES)
    wrapped = tpa.pair_attention_expd(scores, maxes, *plan.fwd, V, k,
                                      compact=compact)
    assert wrapped.is_contiguous() and torch.equal(wrapped, at_slots)
    assert torch.equal(tpa.pair_attention_expd(scores, maxes, *plan.fwd, V,
                                               k), want)
    assert tpa.LAUNCHES == before


@pytest.mark.parametrize("route,k,head_dim", [("b3", 4, 6), ("b3", 1, 5),
                                              ("b10", 8, 2), ("b10", 4, 130)])
@pytest.mark.parametrize("form", ["merged", "typed"])
def test_sums_over_b8s_by_entry_output_equal_the_by_slot_sums(form, route, k,
                                                              head_dim):
    """The forward's sums over B8's by-entry output (the head-major B3
    launches, or B10, each with ``by_entry=True``) equal their plain
    versions over the plain B8's by-slot output bit for bit."""
    _, plans, rows = _pair_plans(form)
    plan = plans[-1]
    rng = np.random.RandomState(40 + k)
    table = torch.from_numpy(rng.randn(rows, head_dim * k).astype(np.float32))
    scores = _scores(41, rows, k, "float32")
    maxes = _stabiliser(scores, k)
    compact = plan.fwd_rows(V, rows)
    by_entry = tpa.pair_attention_expd(scores, maxes, *plan.fwd, V, k,
                                       compact=compact)
    by_slot = tpa.pair_attention_expd_plain(scores, maxes, *plan.fwd, V, k)
    if route == "b3":
        got = tpa._headmajor_sums(table, by_entry, plan, V, k)
        heads = table.reshape(rows, head_dim, k).permute(2, 0, 1)
        want = []
        for kk in range(k):
            t_head = torch.cat([heads[kk], torch.ones((rows, 1))], dim=1)
            want.append(tps.pair_spmm_plain(t_head, by_slot[kk], *plan.fwd,
                                            V))
        want = (torch.stack([w[:, head_dim] for w in want], dim=-1),
                torch.stack([w[:, :head_dim] for w in want],
                            dim=-1).reshape(V, head_dim * k))
    else:
        got = tpa.pair_attention_agg(table, by_entry, *plan.fwd, V, k,
                                     compact=compact, by_entry=True)
        want = tpa.pair_attention_agg_plain(table, by_slot, *plan.fwd, V, k)
    for name, g, w in zip(("denom", "weighted"), got, want):
        assert float(w.abs().max()) > 0
        assert torch.equal(g, w), name


@pytest.mark.parametrize("form", ["merged", "typed"])
def test_rgat_hands_b8_its_plans_forward_form(form, monkeypatch):
    """Two train steps of RGAT under the "exact" stabiliser (4 heads, the
    head-major route): every B8 call gets its plan's cached ``fwd_rows``
    form, the object its B11 call got just before, and B3's launches
    read B8's output by entry over that same form."""
    _, batch, labels = small_workload(seed=9, merged=form == "merged")
    params = NodeMulticlassTask.get_default_hyperparameters("rgat")
    params.update({"gnn_hidden_dim": 8, "gnn_num_layers": 2,
                   "gnn_num_heads": 4, "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000,
                   "gnn_attention_stabiliser": "exact"})
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    seen = {"b11": [], "b8": [], "b3": []}
    real = (tpa.pair_attention_max, tpa.pair_attention_expd, tpa.pair_spmm)

    def spy(key, fn):
        def call(*args, compact=None, **kwargs):
            seen[key].append((compact, kwargs.get("by_entry", False)))
            return fn(*args, compact=compact, **kwargs)
        return call

    for (key, name), fn in zip((("b11", "pair_attention_max"),
                                ("b8", "pair_attention_expd"),
                                ("b3", "pair_spmm")), real):
        monkeypatch.setattr(tpa, name, spy(key, fn))
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    for _ in range(2):
        state, metrics = step(state, batch,
                              {"node_labels": torch.from_numpy(labels)})
        assert np.isfinite(float(metrics["loss"]))
    plans = (batch.pair_merged,) if form == "merged" else batch.pair_typed
    v = batch.num_nodes_padded
    calls = 2 * 2 * len(plans)
    assert len(seen["b11"]) == len(seen["b8"]) == calls
    assert len(seen["b3"]) == 4 * calls
    for i, ((b11_form, _), (b8_form, _)) in enumerate(zip(seen["b11"],
                                                          seen["b8"])):
        plan = plans[i % len(plans)]
        assert b8_form is b11_form
        assert b8_form is plan.fwd_rows(v, b8_form.table_rows)
    for i, (b3_form, by_entry) in enumerate(seen["b3"]):
        assert by_entry and b3_form is seen["b8"][i // 4][0]
