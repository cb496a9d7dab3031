"""The relu-pair row owners' compact forms and sums on the CPU. On the card
B4 (``relu_pair_fwd_m``), B6 (``relu_pair_fwd``) and B7 (``relu_pair_db``)
read the forward plan's compact form, ``MergedPlan.fwd_rows(out_rows, rows of A)``, and B5
(``relu_pair_da``) the backward plan's, ``MergedPlan.bwd_rows(rows of A,
rows of B)`` (both ``ops/pair_spmm.py::slot_rows``), instead of the plan
arrays:

* on a merged-target plan (the GNN_Edge_MLP layout), a merged plan and a
  per-type plan, whole and with A, B and the output cut to fewer rows:
  each forward row holds the (target, clipped source, slot) triples of the
  plan's own slot ids, in slot order; targets at or past the output are
  dropped, sources clipped into A; each backward row u holds its (target t
  clipped into B, slot) pairs in slot order, u at or past A's rows
  dropped; some rows are empty; the forms are kept on the plan;
* an all-sentinel plan has no entries in either form, and the plain
  versions give zeros;
* float64 emulations of the kernels over the compact forms equal the plain
  versions over the plan arrays exactly (the tables and the cotangent hold
  small integers and the scales are powers of two): B4's (a row owner: B
  read once per row at ``clip(t)``, then per entry ``z = A[src] + B``,
  ``R += relu(z) * s``, ``M += (z > 0) * s``, in entry order), B6's (B4's
  without M), B7's (B4's M without R, times g[t] once at the store) and
  B5's (A[u] read once, then per entry ``z = A[u] + B[t]``, ``dA += (z >
  0) * g[t] * s``); B5's also equals the reference's jnp twin
  ``_relu_pair_da_jnp`` on the same plan; B7's f32 emulation, its mask
  sum in slot order, equals its plain version exactly with f32 scales
  too;
* the GNN_Edge_MLP model builds each form once over 3 train steps and an
  eval forward, and hands the one object to every B4, B6 and B5 call.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import pair_edge_mlp as jpem
from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_edge_mlp as tpem
from tf2_gnn_tpu_torch.ops import pair_spmm as tps

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


@functools.lru_cache(maxsize=None)
def _plan(form: str):
    """(plan, rows of A, output rows) of a plan over 3 random edge types
    with empty target rows (no edge reaches a target of 100-199)."""
    rng = np.random.RandomState({"targets": 0, "merged": 1, "typed": 2}[form])
    srcs, tgts, counts = [], [], []
    for _ in range(3 if form != "typed" else 1):
        e = rng.randint(V, 4 * V)
        srcs.append(rng.randint(0, V, e))
        tgts.append(rng.choice(np.r_[0:100, 200:V], e))
        counts.append(e)
    host = tps.build_pair_plans(srcs, tgts, counts, V,
                                merge_targets=form == "targets")
    out_rows = 3 * V if form == "targets" else V
    plan = tps.MergedPlan(*host.astuple(), out_rows=out_rows).to("cpu")
    return plan, len(srcs) * V, out_rows


def _shape(form, cut):
    """(rows of A, rows of B, output rows): the plan's, or cut."""
    _, rows_a, out_rows = _plan(form)
    if cut:
        return rows_a // 2, out_rows // 3, out_rows // 2
    return rows_a, out_rows, out_rows


def _rows_of(compact):
    return torch.repeat_interleave(
        torch.arange(compact.out_rows),
        torch.diff(compact.row_ptr.long())).numpy()


FORMS = ["targets", "merged", "typed"]


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("form", FORMS)
def test_fwd_rows_matches_the_plans_slot_ids(form, cut):
    plan = _plan(form)[0]
    rows_a, _, out_rows = _shape(form, cut)
    compact = plan.fwd_rows(out_rows, rows_a)
    assert compact is plan.fwd_rows(out_rows, rows_a)
    src, tgt, valid = (x.numpy() for x in tps.slot_abs_ids(*plan.fwd))
    slot = np.flatnonzero(valid & (tgt < out_rows))
    slot = slot[np.lexsort((slot, tgt[slot]))]
    for t in (compact.row_ptr, compact.src_row, compact.slot):
        assert t.dtype == torch.int32 and t.is_contiguous()
    assert (compact.table_rows, compact.out_rows) == (rows_a, out_rows)
    assert compact.num_slots == plan.rel_src_f.numel()
    np.testing.assert_array_equal(_rows_of(compact), tgt[slot])
    np.testing.assert_array_equal(compact.src_row.numpy(),
                                  np.minimum(src[slot], rows_a - 1))
    np.testing.assert_array_equal(compact.slot.numpy(), slot)
    assert (np.diff(compact.row_ptr.numpy()) == 0).any()  # empty rows
    dropped = int((valid & (tgt >= out_rows)).sum())
    clipped = int((src[slot] >= rows_a).sum())
    assert (dropped > 0 and clipped > 0) if cut else dropped == clipped == 0


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("form", FORMS)
def test_bwd_rows_matches_the_plans_slot_ids(form, cut):
    """B5's form: the backward plan's valid slots by A's row u (its
    plan-"tgt"), each with its target t (its plan-"src") clipped into B's
    rows, in slot order; u at or past A's rows dropped."""
    plan = _plan(form)[0]
    rows_a, rows_b, _ = _shape(form, cut)
    compact = plan.bwd_rows(rows_a, rows_b)
    assert compact is plan.bwd_rows(rows_a, rows_b)
    t, u, valid = (x.numpy() for x in tps.slot_abs_ids(*plan.bwd))
    slot = np.flatnonzero(valid & (u < rows_a))
    slot = slot[np.lexsort((slot, u[slot]))]
    for x in (compact.row_ptr, compact.src_row, compact.slot):
        assert x.dtype == torch.int32 and x.is_contiguous()
    assert (compact.table_rows, compact.out_rows) == (rows_b, rows_a)
    assert compact.num_slots == plan.rel_src_b.numel()
    np.testing.assert_array_equal(_rows_of(compact), u[slot])
    np.testing.assert_array_equal(compact.src_row.numpy(),
                                  np.minimum(t[slot], rows_b - 1))
    np.testing.assert_array_equal(compact.slot.numpy(), slot)
    assert (np.diff(compact.row_ptr.numpy()) == 0).any()  # empty rows
    dropped = int((valid & (u >= rows_a)).sum())
    clipped = int((t[slot] >= rows_b).sum())
    assert (dropped > 0 and clipped > 0) if cut else dropped == clipped == 0


def test_all_sentinel_plan_has_no_entries():
    host = tps.build_pair_plans([np.zeros(0, np.int32)] * 3,
                                [np.zeros(0, np.int32)] * 3, [0, 0, 0], 256,
                                merge_targets=True)
    plan = tps.MergedPlan(*host.astuple(), out_rows=768).to("cpu")
    for compact in (plan.fwd_rows(768, 768), plan.bwd_rows(768, 768)):
        assert compact.src_row.numel() == 0
        assert torch.equal(compact.row_ptr,
                           torch.zeros(769, dtype=torch.int32))
    a = b = g = torch.ones(768, 5)
    r, m = tpem.relu_pair_fwd_m_plain(a, b, plan.inv_fwd, *plan.fwd, 768)
    r6 = tpem.relu_pair_fwd_plain(a, b, plan.inv_fwd, *plan.fwd, 768)
    da = tpem.relu_pair_da_plain(a, b, g, plan.inv_bwd, *plan.bwd, 768)
    for x in (r, m, r6, da):
        assert float(x.abs().max()) == 0.0


def _row_owner_sum(a, b, scale, compact, dtype=torch.float64):
    """B4's kernel in ``dtype`` (float64 unless given): per output row t,
    B[clip(t)] once, then its entries in order."""
    t = torch.from_numpy(_rows_of(compact))
    z = (a.to(dtype)[compact.src_row.long()]
         + b.to(dtype)[torch.clamp(t, max=b.shape[0] - 1)])
    s = scale.to(dtype)[compact.slot.long()][:, None]
    r = torch.zeros((compact.out_rows, a.shape[1]), dtype=dtype)
    m = torch.zeros_like(r)
    return (r.index_add_(0, t, torch.relu(z) * s),
            m.index_add_(0, t, (z > 0).to(dtype) * s))


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("form", FORMS)
def test_row_owner_sum_equals_the_plain_version(form, cut):
    plan = _plan(form)[0]
    rows_a, rows_b, out_rows = _shape(form, cut)
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(rng.randint(-6, 7, (n, 9)).astype(np.float32))
            for n in (rows_a, rows_b))
    scale = torch.from_numpy(rng.choice(
        [0.25, 0.5, 1.0, 2.0, -1.0], plan.rel_src_f.numel()).astype(
            np.float32))
    want = tpem.relu_pair_fwd_m_plain(a, b, scale, *plan.fwd, out_rows)
    got = _row_owner_sum(a, b, scale, plan.fwd_rows(out_rows, rows_a))
    for name, g, w in zip(("R", "M"), got, want):
        assert w.abs().max() > 0
        torch.testing.assert_close(g, w.double(), rtol=0.0, atol=0.0,
                                   msg=name)


def _inputs(plan, rows_a, rows_b, seed):
    """Integer A, B and g (g with B's rows) and power-of-two forward and
    backward scales, so every sum is exact in f32 and float64."""
    rng = np.random.RandomState(seed)
    a, b, g = (torch.from_numpy(rng.randint(-6, 7, (n, 9)).astype(np.float32))
               for n in (rows_a, rows_b, rows_b))
    sf, sb = (torch.from_numpy(rng.choice(
        [0.25, 0.5, 1.0, 2.0, -1.0], n).astype(np.float32))
              for n in (plan.rel_src_f.numel(), plan.rel_src_b.numel()))
    return a, b, g, sf, sb


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("form", FORMS)
def test_b6_row_owner_sum_equals_the_plain_version(form, cut):
    """B6 is B4's row owner without M: its R equals ``relu_pair_fwd_plain``
    over the plan arrays."""
    plan = _plan(form)[0]
    rows_a, rows_b, out_rows = _shape(form, cut)
    a, b, _, sf, _ = _inputs(plan, rows_a, rows_b, 7)
    want = tpem.relu_pair_fwd_plain(a, b, sf, *plan.fwd, out_rows)
    got, _ = _row_owner_sum(a, b, sf, plan.fwd_rows(out_rows, rows_a))
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want.double(), rtol=0.0, atol=0.0)


def _db_row_owner(a, b, g, scale, compact, dtype=torch.float64):
    """B7's kernel in ``dtype``: B4's M (the mask sum of row t's entries in
    order, from 0), then times g[t] once."""
    _, m = _row_owner_sum(a, b, scale, compact, dtype)
    return m * g.to(dtype)


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("form", FORMS)
def test_b7_row_owner_equals_the_plain_version(form, cut):
    """B7's emulation over B4's form equals ``relu_pair_db_plain`` over the
    plan arrays exactly: in float64 on integer inputs with power-of-two
    scales, and in f32 with random f32 scales (both sum the mask terms in
    slot order and multiply by g once)."""
    plan = _plan(form)[0]
    rows_a, rows_b, out_rows = _shape(form, cut)
    a, b, _, sf, _ = _inputs(plan, rows_a, rows_b, 10)
    g = torch.from_numpy(np.random.RandomState(11).randint(
        -6, 7, (out_rows, 9)).astype(np.float32))
    compact = plan.fwd_rows(out_rows, rows_a)
    want = tpem.relu_pair_db_plain(a, b, g, sf, *plan.fwd, out_rows)
    assert want.abs().max() > 0
    torch.testing.assert_close(_db_row_owner(a, b, g, sf, compact),
                               want.double(), rtol=0.0, atol=0.0)
    rng = np.random.RandomState(12)
    scale = torch.from_numpy(rng.rand(sf.numel()).astype(np.float32))
    g = torch.from_numpy(rng.randn(out_rows, 9).astype(np.float32))
    got = _db_row_owner(a, b, g, scale, compact, torch.float32)
    want = tpem.relu_pair_db_plain(a, b, g, scale, *plan.fwd, out_rows)
    assert torch.equal(got, want)
    assert torch.equal(tpem.relu_pair_db(a, b, g, scale, *plan.fwd,
                                         out_rows, compact=compact), want)


def _da_row_owner_sum(a, b, g, scale, compact):
    """B5's kernel in float64: per A row u, A[u] once, then its entries in
    order, each with B and g at the entry's clipped target."""
    u = torch.from_numpy(_rows_of(compact))
    t = compact.src_row.long()
    z = a.double()[u] + b.double()[t]
    s = scale.double()[compact.slot.long()][:, None]
    out = torch.zeros((compact.out_rows, a.shape[1]), dtype=torch.float64)
    return out.index_add_(0, u, (z > 0).double() * g.double()[t] * s)


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("form", FORMS)
def test_b5_row_owner_sum_equals_the_plain_version(form, cut):
    plan = _plan(form)[0]
    rows_a, rows_b, _ = _shape(form, cut)
    a, b, g, _, sb = _inputs(plan, rows_a, rows_b, 8)
    want = tpem.relu_pair_da_plain(a, b, g, sb, *plan.bwd, rows_a)
    got = _da_row_owner_sum(a, b, g, sb, plan.bwd_rows(rows_a, rows_b))
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want.double(), rtol=0.0, atol=0.0)


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
def test_b5_row_owner_sum_equals_the_jax_twin(cut):
    """The chain to the reference: B5's emulation over the merged-target
    plan's backward form equals ``_relu_pair_da_jnp`` over its arrays."""
    plan = _plan("targets")[0]
    rows_a, rows_b, _ = _shape("targets", cut)
    a, b, g, _, sb = _inputs(plan, rows_a, rows_b, 9)
    want = jpem._relu_pair_da_jnp(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
        jnp.asarray(g.numpy()), jnp.asarray(sb.numpy()),
        *(jnp.asarray(x.numpy()) for x in plan.bwd), rows_a)
    got = _da_row_owner_sum(a, b, g, sb, plan.bwd_rows(rows_a, rows_b))
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.float64))


def test_edge_mlp_builds_its_form_once_per_batch(monkeypatch):
    """Three train steps and an eval forward of GNN_Edge_MLP on a
    merged-target batch: the forward and backward forms are each built
    once; every B4 and B6 call of every layer and step gets the one forward
    form, every B5 call the one backward form."""
    _, batch, labels = small_workload(seed=6, merged=True,
                                      merge_targets=True)
    params = NodeMulticlassTask.get_default_hyperparameters("gnn_edge_mlp")
    params.update({"gnn_hidden_dim": 8, "gnn_num_layers": 2,
                   "gnn_num_edge_MLP_hidden_layers": 1,
                   "gnn_layer_input_dropout_rate": 0.0})
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer)
    train_step = make_train_step(model, optimizer)
    built = []
    seen = {name: [] for name in ("relu_pair_fwd_m", "relu_pair_fwd",
                                  "relu_pair_da")}
    real_build = tps.slot_rows
    monkeypatch.setattr(tps, "slot_rows",
                        lambda *a: built.append(real_build(*a)) or built[-1])

    def spy(name):
        real = getattr(tpem, name)

        def call(*args, compact=None):
            seen[name].append(compact)
            return real(*args, compact=compact)
        return call

    for name in seen:
        monkeypatch.setattr(tpem, name, spy(name))
    targets = {"node_labels": torch.from_numpy(labels)}
    for _ in range(3):
        state, _ = train_step(state, batch, targets)
    make_eval_step(model)(batch, targets)
    plan = batch.pair_merged
    assert len(built) == 2
    fwd, bwd = built
    assert fwd is plan.fwd_rows(plan.out_rows, fwd.table_rows)
    assert bwd is plan.bwd_rows(bwd.out_rows, plan.out_rows)
    assert bwd.out_rows == fwd.table_rows
    assert {name: len(calls) for name, calls in seen.items()} == {
        "relu_pair_fwd_m": 2 * 3, "relu_pair_fwd": 2, "relu_pair_da": 2 * 3}
    assert all(c is fwd
               for c in seen["relu_pair_fwd_m"] + seen["relu_pair_fwd"])
    assert all(c is bwd for c in seen["relu_pair_da"])
