"""B10 and B14 over their plans' compact forms, on the CPU. On the card both
run ``csrc/pair_stream.cu``'s per-head row owner (``head_rows_kernel``)
over the valid slots of a plan direction as a CSR by output row: B10
(``pair_attention_agg``) over ``MergedPlan.fwd_rows(V, rows)``, the form
B3 reads, with B8's ``[K, slots]`` expd; B14 (``attention_scatter_sums``)
over ``ScatterPlan.sum_rows("fwd", V)``, B12's forward form, whose entries
read their own stream row, with the ``[slots, K]`` expd. A float64
emulation of the kernel over the form (per output row, its entries in
order: ``weighted[t, c] += expd(slot, c % K) * table[src_row, c]`` and
``denom[t, k] += expd(slot, k)``) equals:

* for B10, the reference's jnp twin ``_agg_kernel_jnp`` over the plan
  arrays, on a merged plan and one type's plan, at both of RGAT's call
  forms (K = 8 heads of 2 features; K = 4 heads of 128) and 3 heads, and
  the plain version ``pair_attention_agg_plain``;
* for B14, the reference's ``attention_scatter`` (its Pallas kernel in
  interpret mode) over the sorted plan, at K = 4 heads of 80, 2 of 3 and
  3 heads of 5 (a head count that does not divide 32), and the plain
  version ``attention_scatter_sums_plain``;

exactly: the tables hold small integers and expd powers of two, so every
product and sum is exact in f32 and float64. Every B10 and B14 call of
an RGAT model's train steps gets the one compact form its plan keeps, and
on a CPU tensor the wrappers take their plain versions with or without
the form.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import pair_attention as jpa
from tf2_gnn_tpu.ops import spmm_pallas as jsp
from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_train_step,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss

from .test_torch_rgcn_model import FEATURES, NUM_LABELS, small_workload

V = 384


@functools.lru_cache(maxsize=None)
def _pair_plan(form: str):
    """A merged plan over 3 random edge types, or one type's plan; no edge
    reaches a target of 100-199, so those rows have no entries."""
    rng = np.random.RandomState({"merged": 0, "typed": 1}[form])
    srcs, tgts, counts = [], [], []
    for _ in range(3 if form == "merged" else 1):
        e = rng.randint(V, 4 * V)
        srcs.append(rng.randint(0, V, e))
        tgts.append(rng.choice(np.r_[0:100, 200:V], e))
        counts.append(e)
    host = tps.build_pair_plans(srcs, tgts, counts, V)
    return host, tps.MergedPlan(*host.astuple()).to("cpu"), len(srcs) * V


@functools.lru_cache(maxsize=None)
def _sorted_plan():
    """The merged scatter plan of 3 random edge types over V nodes."""
    rng = np.random.RandomState(2)
    srcs, tgts, counts = [], [], []
    for _ in range(3):
        e = rng.randint(V, 4 * V)
        srcs.append(rng.randint(0, V, e).astype(np.int32))
        tgts.append(rng.choice(np.r_[0:100, 200:V], e).astype(np.int32))
        counts.append(e)
    host = tss.build_merged_plans(srcs, tgts, counts, V)
    return host, tss.ScatterPlan.from_host(host.astuple(), V, 3).to("cpu")


def _rows_of(compact):
    return torch.repeat_interleave(
        torch.arange(compact.out_rows),
        torch.diff(compact.row_ptr.long()))


def _head_rows(table, expd_at, k, compact):
    """The per-head row owner in float64: per output row, its entries in
    order; ``expd_at(slots)`` gives their [n, K] head values."""
    t = _rows_of(compact)
    e = expd_at(compact.slot.long()).double()
    x = table.double()[compact.src_row.long()]
    h = table.shape[1]
    heads = torch.arange(h) % k
    weighted = torch.zeros((compact.out_rows, h), dtype=torch.float64)
    denom = torch.zeros((compact.out_rows, k), dtype=torch.float64)
    return (denom.index_add_(0, t, e),
            weighted.index_add_(0, t, x * e[:, heads]))


def _exact_inputs(rng, rows, h, k, slots, valid):
    """Integer table rows and power-of-two expd (0 on pad slots), so every
    sum is exact."""
    table = rng.randint(-6, 7, (rows, h)).astype(np.float32)
    expd = rng.choice([0.25, 0.5, 1.0, 2.0], (slots, k)).astype(np.float32)
    return table, expd * valid[:, None]


@pytest.mark.parametrize("k,head_dim", [(8, 2), (4, 128), (3, 4)])
@pytest.mark.parametrize("form", ["merged", "typed"])
def test_b10_row_owner_sum_equals_the_jax_twin(form, k, head_dim):
    """B10's emulation over ``fwd_rows`` against ``_agg_kernel_jnp`` (on
    the transposed expd stream) and the plain version."""
    host, plan, rows = _pair_plan(form)
    rng = np.random.RandomState(k)
    slots = plan.rel_src_f.numel()
    valid = tps.slot_abs_ids(*plan.fwd)[2].numpy()
    table, expd = _exact_inputs(rng, rows, head_dim * k, k, slots, valid)
    expd_km = torch.from_numpy(np.ascontiguousarray(expd.T))  # B8's layout
    compact = plan.fwd_rows(V, rows)
    got = _head_rows(torch.from_numpy(table), lambda s: expd_km.t()[s], k,
                     compact)
    want = jpa._agg_kernel_jnp(jnp.asarray(table), jnp.asarray(expd),
                               *host.fwd, V, k)
    plain = tpa.pair_attention_agg_plain(torch.from_numpy(table), expd_km,
                                         *plan.fwd, V, k)
    for name, g, w, p in zip(("denom", "weighted"), got, want, plain):
        assert float(np.abs(np.asarray(w)).max()) > 0
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.float64),
                                      err_msg=name)
        torch.testing.assert_close(g, p.double(), rtol=0.0, atol=0.0,
                                   msg=name)
    assert float(got[0][100:200].abs().max()) == 0.0  # rows without entries


@pytest.mark.parametrize("k,head_dim", [(4, 80), (2, 3), (3, 5)])
def test_b14_row_owner_sum_equals_the_pallas_kernel(k, head_dim):
    """B14's emulation over ``sum_rows("fwd")`` (each entry's stream row
    its slot) against the reference's ``attention_scatter`` in interpret
    mode and the plain version, with the layer's strided message view."""
    host, plan = _sorted_plan()
    rng = np.random.RandomState(10 + k)
    slots = plan.rel_tgt.numel()
    valid = ~plan.fwd_sentinel.numpy()
    h = head_dim * k
    bundle, expd = _exact_inputs(rng, slots, h + k, k, slots, valid)
    msgs = torch.from_numpy(bundle)[:, :h]
    compact = plan.sum_rows("fwd", V)
    assert (compact.table_rows, compact.out_rows) == (slots, V)
    assert torch.equal(compact.src_row, compact.slot)
    got = _head_rows(msgs, lambda s: torch.from_numpy(expd)[s], k, compact)
    want = jsp.attention_scatter(
        jnp.asarray(expd), jnp.asarray(bundle[:, :h]),
        jnp.asarray(host.rel_tgt), jnp.asarray(host.tgt_blocks),
        jnp.asarray(host.tgtabs_fwd),
        jnp.asarray(host.rel_tgt >= tss.BLOCK_NODES), V, k, interpret=True)
    plain = tss.attention_scatter_sums_plain(torch.from_numpy(expd), msgs,
                                             plan.rel_tgt, plan.tgt_blocks, V)
    for name, g, w, p in zip(("denom", "weighted"), got, want, plain):
        assert float(np.abs(np.asarray(w)).max()) > 0
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.float64),
                                      err_msg=name)
        torch.testing.assert_close(g, p.double(), rtol=0.0, atol=0.0,
                                   msg=name)


def test_cpu_wrappers_take_the_plain_versions():
    """On a CPU tensor B10 and B14 run their plain versions, with or
    without the compact form, which only the kernel reads, and count no
    launch."""
    host, plan, rows = _pair_plan("typed")
    rng = np.random.RandomState(3)
    valid = tps.slot_abs_ids(*plan.fwd)[2].numpy()
    table, expd = _exact_inputs(rng, rows, 16, 8, plan.rel_src_f.numel(),
                                valid)
    table, expd_km = torch.from_numpy(table), torch.from_numpy(
        np.ascontiguousarray(expd.T))
    before = (dict(tpa.LAUNCHES), dict(tss.LAUNCHES))
    want = tpa.pair_attention_agg_plain(table, expd_km, *plan.fwd, V, 8)
    for compact in (None, plan.fwd_rows(V, rows)):
        got = tpa.pair_attention_agg(table, expd_km, *plan.fwd, V, 8,
                                     compact=compact)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    _, splan = _sorted_plan()
    slots = splan.rel_tgt.numel()
    msgs, sexpd = (torch.from_numpy(x) for x in _exact_inputs(
        rng, slots, 8, 4, slots, ~splan.fwd_sentinel.numpy()))
    want = tss.attention_scatter_sums_plain(sexpd, msgs, splan.rel_tgt,
                                            splan.tgt_blocks, V)
    for compact in (None, splan.sum_rows("fwd", V)):
        got = tss.attention_scatter_sums(sexpd, msgs, splan.rel_tgt,
                                         splan.tgt_blocks, V, compact=compact)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (tpa.LAUNCHES, tss.LAUNCHES) == before


@pytest.mark.parametrize("route", ["b10", "b14"])
def test_rgat_hands_every_call_its_plans_form(route, monkeypatch):
    """Two train steps of RGAT: every B10 call (8 heads on per-type plans)
    gets its type's cached ``fwd_rows`` form, every B14 call (the sorted
    fallback, on a batch with scatter plans and merged targets) the
    plan's cached ``sum_rows("fwd")`` form."""
    _, batch, labels = small_workload(seed=4, merged=route == "b14")
    params = NodeMulticlassTask.get_default_hyperparameters("rgat")
    heads = 8 if route == "b10" else 4
    params.update({"gnn_hidden_dim": 2 * heads, "gnn_num_layers": 2,
                   "gnn_num_heads": heads,
                   "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000})
    if route == "b14":
        srcs = [np.asarray(x) for x in batch.edge_sources]
        tgts = [np.asarray(x) for x in batch.edge_targets]
        cnts = [int(c) for c in np.asarray(batch.num_edges)]
        batch = batch.replace(
            scatter_plans=tss.build_merged_plans(
                srcs, tgts, cnts, batch.num_nodes_padded).astuple(),
            pair_targets_merged=True).to("cpu")
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    module, name = ((tpa, "pair_attention_agg") if route == "b10"
                    else (tss, "attention_scatter_sums"))
    real, seen = getattr(module, name), []

    def spy(*args, compact=None, **kwargs):
        seen.append(compact)
        return real(*args, compact=compact, **kwargs)

    monkeypatch.setattr(module, name, spy)
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    for _ in range(2):
        state, metrics = step(state, batch,
                              {"node_labels": torch.from_numpy(labels)})
        assert np.isfinite(float(metrics["loss"]))
    v = batch.num_nodes_padded
    if route == "b10":
        plans = batch.pair_typed
        assert len(seen) == 2 * 2 * len(plans)
        for i, compact in enumerate(seen):
            assert compact is plans[i % len(plans)].fwd_rows(v, v)
    else:
        assert len(seen) == 2 * 2
        assert all(c is batch.scatter_merged.sum_rows("fwd", v) for c in seen)
