"""B11 and B15 as row owners over the compact forms the forward builds, on
the CPU. On the card both run ``csrc/pair_stream.cu``'s ``max_rows_kernel``
over the valid slots of a plan direction as a CSR by output row: B11
(``pair_attention_max``, RGAT's ``"exact"`` stabiliser) over
``MergedPlan.fwd_rows(V, rows)``, the form B3 and B10 read, each entry's
logit ``leaky(ss[u] + ts[clip((u // vs) * vs + t, rows)])``; B15
(``sorted_segment_max``, the sorted RGAT's stabiliser) over
``ScatterPlan.sum_rows("fwd", V)``, the form B14 reads, each entry's row of
values its slot. G lanes own a row (8, the kernel's ``MAX_LANES``); lane j
folds the row's entries j, j + G, ... in order into running maxes, the
group folds its lanes by xor steps, and the row is stored once: from NEG
and with ``init`` for B11, with a non-finite max stored as 0 for B15. The
kernel's max is that of an order on the bits: NaN above everything, +0.0
above -0.0.

An emulation of that reduction, entry by entry as the kernel groups them,
equals the plain versions exactly (values; NaN where the plain version has
NaN): B11 on merged and per-type pair plans at K = 1, 3, 4 and 8 with f32
and bf16 scores, B15 on the merged scatter plan at K = 1, 3 and 4, with
-0.0 beside +0.0 among the values, targets without an entry (NEG for B11,
0 for B15), and -inf, +inf and NaN values for B15. Where a row's max is a
zero, the emulation holds the kernel's rule (+0.0 where the row has one);
the plain version, ``scatter_reduce_``'s amax, keeps the row's first zero.
B11's ``init`` chains the per-type launches: the chain equals
``reduce(torch.maximum, ...)`` of separate launches, and the plain version
with ``init`` equals ``jnp.maximum(init, ...)`` of the reference's
``pair_attention_max`` in interpret mode. B15's plain version with
non-finite values equals the reference's Pallas kernel in interpret mode.
The sorted RGAT builds its forward form once per batch and hands it to
every B15 and B14 call.
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
LANES = 8   # csrc/pair_stream.cu's MAX_LANES
EXACT = dict(rtol=0.0, atol=0.0, equal_nan=True)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _edges(seed: int, num_types: int, max_node: int = V):
    """Random edges of ``num_types`` types among nodes below ``max_node``;
    no edge reaches a target of 100-199."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(V, 4 * V)
        srcs.append(rng.randint(0, max_node, e).astype(np.int32))
        tgts.append(rng.choice(np.r_[0:100, 200:max_node], e)
                    .astype(np.int32))
        counts.append(e)
    return srcs, tgts, counts


@functools.lru_cache(maxsize=None)
def _pair_plans(form: str):
    """(the host plan arrays of each launch, their ``MergedPlan`` forms, the
    score rows of one launch): one merged plan over 3 edge types, or one
    plan per type over its [V]-row slab."""
    srcs, tgts, counts = _edges({"merged": 0, "typed": 1}[form], 3)
    if form == "merged":
        hosts = [tps.build_pair_plans(srcs, tgts, counts, V)]
        rows = 3 * V
    else:
        hosts = [tps.build_pair_plans([s], [t], [c], V)
                 for s, t, c in zip(srcs, tgts, counts)]
        rows = V
    plans = [tps.MergedPlan(*h.astuple(), out_rows=V).to("cpu")
             for h in hosts]
    return hosts, plans, rows


@functools.lru_cache(maxsize=None)
def _sorted_plan():
    srcs, tgts, counts = _edges(2, 3)
    host = tss.build_merged_plans(srcs, tgts, counts, V)
    return host, tss.ScatterPlan.from_host(host.astuple(), V, 3).to("cpu")


def _key(x):
    """The kernel's order on f32 bits: NaN above everything, then the
    numbers, +0.0 above -0.0."""
    i = x.contiguous().view(torch.int32).long()
    key = torch.where(i >= 0, i, i ^ 0x7fffffff)
    return torch.where(torch.isnan(x), torch.full_like(key, 2 ** 31 - 1),
                       key)


def _max_of(a, b):
    return torch.where(_key(b) > _key(a), b, a)


def _max_rows(values, compact, lanes: int, start: float):
    """``max_rows_kernel``'s reduction over ``compact``: ``values`` [n, K]
    f32, one row per entry of the form. Lane j of row t's G lanes folds the
    row's entries j, j + G, ... in order from ``start``; then each xor step
    (G / 2, ..., 1) takes ``max_of(own, partner)``; lane 0's maxes are the
    row's."""
    ptr = compact.row_ptr.long()
    counts = torch.diff(ptr)
    rows, k = compact.out_rows, values.shape[1]
    rounds = max(1, -(-int(counts.max()) // lanes))
    pos = torch.arange(rounds * lanes).reshape(rounds, lanes)
    present = pos[None] < counts[:, None, None]
    grid = torch.full((rows, rounds, lanes, k), start)
    grid[present] = values[(ptr[:-1, None, None] + pos)[present]]
    m = torch.full((rows, lanes, k), start)
    for r in range(rounds):
        m = _max_of(m, grid[:, r])
    off = lanes // 2
    while off:
        m = _max_of(m, m[:, torch.arange(lanes) ^ off])
        off //= 2
    return m[:, 0]


def _rows_of(compact):
    return torch.repeat_interleave(torch.arange(compact.out_rows),
                                   torch.diff(compact.row_ptr.long()))


def _entry_logits(scores, compact, k: int, vs: int):
    """Each entry's f32 logit, as the kernel computes it from the form:
    the source half of row u, the target half of row clip((u // vs) * vs
    + t), added and leaky in f32."""
    u = compact.src_row.long()
    t = _rows_of(compact)
    r = torch.clamp((u // vs) * vs + t, 0, scores.shape[0] - 1)
    p = scores[u, :k].float() + scores[r, k:].float()
    return torch.where(p >= 0, p, tpa.LEAKY_SLOPE * p)


def _b11_row_owner(scores, compact, k: int, vs: int, init=None,
                   lanes: int = LANES):
    m = _max_rows(_entry_logits(scores, compact, k, vs), compact,
                  lanes, tpa.NEG)
    return m if init is None else _max_of(init, m)


def _b15_row_owner(vals, compact, lanes: int = LANES):
    m = _max_rows(vals[compact.src_row.long()], compact,
                  lanes, -torch.inf)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _scores(seed: int, rows: int, k: int, dtype):
    """[rows, 2K] scores; for K > 1 the last head's logits are all +0.0 or
    -0.0 (source half +-0.0, target half -0.0), so its maxes are zeros."""
    rng = np.random.RandomState(seed)
    scores = (0.5 * rng.randn(rows, 2 * k)).astype(np.float32)
    if k > 1:
        scores[:, k - 1] = np.where(rng.rand(rows) < 0.5, 0.0, -0.0)
        scores[:, 2 * k - 1] = -0.0
    return torch.from_numpy(scores).to(DTYPES[dtype])


def _assert_zero_rule(got, values, compact):
    """Where the max of a row with entries is a zero, it is +0.0 if one
    of the row's values in that column is +0.0, else -0.0."""
    pos = ((values == 0) & ~torch.signbit(values)).long()
    has_pos_zero = torch.zeros(got.shape, dtype=torch.long).index_add_(
        0, _rows_of(compact), pos) > 0
    zero = (got == 0) & (torch.diff(compact.row_ptr) > 0)[:, None]
    assert bool(zero.any()) and bool(has_pos_zero[zero].any())
    assert torch.equal(torch.signbit(got[zero]), ~has_pos_zero[zero])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("form", ["merged", "typed"])
def test_b11_row_owner_equals_the_plain_version(form, k, dtype):
    """B11's reduction over ``fwd_rows`` at every lane count the kernel
    takes equals the plain version over the plan arrays: NEG on rows
    without entries, the zero rule on the last head."""
    _, plans, rows = _pair_plans(form)
    plan = plans[-1]
    scores = _scores(k, rows, k, dtype)
    compact = plan.fwd_rows(V, rows)
    want = tpa.pair_attention_max_plain(scores, *plan.fwd, V, k)
    for lanes in (4, 8, 16, 32):
        got = _b11_row_owner(scores, compact, k, V, lanes=lanes)
        torch.testing.assert_close(got, want, **EXACT)
    has_entries = torch.diff(compact.row_ptr) > 0
    assert not bool(has_entries[100:200].any())
    assert bool((got[~has_entries] == tpa.NEG).all())
    assert bool((got[has_entries] > 0.5 * tpa.NEG).all())
    if k > 1:
        _assert_zero_rule(got[:, k - 1:],
                          _entry_logits(scores, compact, k, V)[:, k - 1:],
                          compact)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_b11_init_chain_equals_separate_maxes(dtype):
    """The per-type forward's chain (each launch starting from the maxes of
    the plans before it) equals ``reduce(torch.maximum, ...)`` of separate
    launches, in the plain version and in the row owner's emulation, and
    the autograd op's "exact" stabiliser is that chain."""
    _, plans, rows = _pair_plans("typed")
    k = 4
    scores = [_scores(10 + i, rows, k, dtype) for i in range(len(plans))]
    separate = functools.reduce(torch.maximum, (
        tpa.pair_attention_max_plain(s, *p.fwd, V, k)
        for s, p in zip(scores, plans)))
    chain = emulated = None
    for s, p in zip(scores, plans):
        chain = tpa.pair_attention_max_plain(s, *p.fwd, V, k, init=chain)
        emulated = _b11_row_owner(s, p.fwd_rows(V, rows), k, V, emulated)
    assert torch.equal(chain, separate)
    assert torch.equal(emulated, separate)
    seen = []
    real = tpa._launch_max

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpa, "_launch_max", spy)
        table = torch.zeros((3 * rows, k), dtype=DTYPES[dtype])
        tpa.pair_attention_typed(table, torch.cat(scores), plans, V, k,
                                 "exact")
    assert len(seen) == len(plans) and torch.equal(seen[-1], separate)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_b11_plain_with_init_matches_jnp(dtype):
    """The plain version with ``init`` against ``jnp.maximum(init, ...)``
    of the reference's B11 in interpret mode, on the merged plan."""
    hosts, plans, rows = _pair_plans("merged")
    k = 4
    scores = _scores(20, rows, k, dtype)
    rng = np.random.RandomState(21)
    init = rng.randn(V, k).astype(np.float32)
    init[rng.rand(V) < 0.3] = tpa.NEG
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jnp.maximum(jnp.asarray(init), jpa.pair_attention_max(
        jnp.asarray(scores.float().numpy(), jdt), *hosts[0].fwd, V, k,
        interpret=True))
    got = tpa.pair_attention_max_plain(scores, *plans[0].fwd, V, k,
                                       init=torch.from_numpy(init))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_b11_form_holds_unclipped_source_rows():
    """The compact form carries u clipped into the scores, and the kernel
    takes the target-score row from that u; the first port's kernel took
    it from the unclipped u. The two agree because every valid slot's u
    lies in the table: here on plans whose last source block is partly
    padded (nodes below 300 of 384), merged and per type."""
    srcs, tgts, counts = _edges(3, 3, max_node=300)
    merged = tps.MergedPlan(*tps.build_pair_plans(
        srcs, tgts, counts, V).astuple()).to("cpu")
    typed = tps.MergedPlan(*tps.build_pair_plans(
        srcs[:1], tgts[:1], counts[:1], V).astuple()).to("cpu")
    for plan, rows in ((merged, 3 * V), (typed, V)):
        u, t, valid = tps.slot_abs_ids(*plan.fwd)
        assert bool((u[valid] % V >= 256).any())   # in the last block
        assert bool((u[valid] < rows).all())
        compact = plan.fwd_rows(V, rows)
        slot = compact.slot.long()
        assert torch.equal(compact.src_row.long(), u[slot])
        assert bool(((u[slot] // V) * V + t[slot] < rows).all())
        scores = _scores(4, rows, 4, "float32")
        torch.testing.assert_close(
            _b11_row_owner(scores, compact, 4, V),
            tpa.pair_attention_max_plain(scores, *plan.fwd, V, 4), **EXACT)


def _nonfinite_vals(seed: int, slots: int, k: int):
    """f32 [slots, K] values: random, with runs of -0.0 and +0.0, and
    -inf, +inf and NaN in some entries."""
    rng = np.random.RandomState(seed)
    vals = rng.randn(slots, k).astype(np.float32)
    vals[rng.rand(slots) < 0.5] *= -1.0
    col = k - 1
    vals[:, col] = -np.abs(vals[:, col])
    vals[rng.rand(slots) < 0.3, col] = -0.0
    vals[rng.rand(slots) < 0.1, col] = 0.0
    special = rng.choice(slots, 60, replace=False)
    vals[special[:20], 0] = -np.inf
    vals[special[20:40], 0] = np.inf
    vals[special[40:], 0] = np.nan
    return torch.from_numpy(vals)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_b15_row_owner_equals_the_plain_version(k):
    """B15's reduction over ``sum_rows("fwd")`` at every lane count the
    kernel takes equals the plain version over the plan arrays: 0 on rows
    without entries and wherever a max is not finite, the zero rule on
    the last column."""
    _, plan = _sorted_plan()
    slots = plan.rel_tgt.numel()
    vals = _nonfinite_vals(k, slots, k)
    compact = plan.sum_rows("fwd", V)
    want = tss.sorted_segment_max_plain(vals, plan.rel_tgt, plan.tgt_blocks,
                                        V)
    for lanes in (4, 8, 16, 32):
        got = _b15_row_owner(vals, compact, lanes)
        torch.testing.assert_close(got, want, **EXACT)
    assert float(got[100:200].abs().max()) == 0.0
    entries = vals[compact.src_row.long()]
    # The special values land in valid slots and zero their rows' maxes.
    hits = torch.zeros(V, dtype=torch.bool)
    hits[_rows_of(compact)[~torch.isfinite(entries[:, 0])
                           & (entries[:, 0] != -torch.inf)]] = True
    assert bool(hits.any()) and bool((got[hits, 0] == 0).all())
    if k > 1:
        _assert_zero_rule(got[:, k - 1:], entries[:, k - 1:], compact)


def test_b15_plain_with_nonfinite_values_matches_pallas():
    """The plain version against the reference's ``sorted_segment_max``
    (its Pallas kernel in interpret mode) with -inf, +inf and NaN among
    the values."""
    host, plan = _sorted_plan()
    vals = _nonfinite_vals(5, plan.rel_tgt.numel(), 4)
    got = tss.sorted_segment_max_plain(vals, plan.rel_tgt, plan.tgt_blocks,
                                       V)
    want = jsp.sorted_segment_max(jnp.asarray(vals.numpy()),
                                  jnp.asarray(host.rel_tgt),
                                  jnp.asarray(host.tgt_blocks), V,
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrappers_take_the_plain_versions():
    """On a CPU tensor B11 and B15 run their plain versions, with or
    without the compact form, which only the kernel reads, and count no
    launch."""
    _, plans, rows = _pair_plans("merged")
    scores = _scores(30, rows, 4, "bfloat16")
    init = torch.randn(V, 4)
    _, splan = _sorted_plan()
    vals = _nonfinite_vals(31, splan.rel_tgt.numel(), 4)
    before = (dict(tpa.LAUNCHES), dict(tss.LAUNCHES))
    for compact in (None, plans[0].fwd_rows(V, rows)):
        assert torch.equal(
            tpa.pair_attention_max(scores, *plans[0].fwd, V, 4,
                                   compact=compact, init=init),
            tpa.pair_attention_max_plain(scores, *plans[0].fwd, V, 4,
                                         init=init))
    for compact in (None, splan.sum_rows("fwd", V)):
        assert torch.equal(
            tss.sorted_segment_max(vals, splan.rel_tgt, splan.tgt_blocks, V,
                                   compact=compact),
            tss.sorted_segment_max_plain(vals, splan.rel_tgt,
                                         splan.tgt_blocks, V))
    assert (tpa.LAUNCHES, tss.LAUNCHES) == before


def test_sorted_rgat_builds_its_forward_form_once(monkeypatch):
    """Two train steps of RGAT on its sorted fallback: the forward form
    ``sum_rows("fwd")`` is built once, at B15's first read, and every B15
    and B14 call gets that object."""
    _, batch, labels = small_workload(seed=5, merged=True)
    srcs = [np.asarray(x) for x in batch.edge_sources]
    tgts = [np.asarray(x) for x in batch.edge_targets]
    cnts = [int(c) for c in np.asarray(batch.num_edges)]
    batch = batch.replace(
        scatter_plans=tss.build_merged_plans(
            srcs, tgts, cnts, batch.num_nodes_padded).astuple(),
        pair_targets_merged=True).to("cpu")
    params = NodeMulticlassTask.get_default_hyperparameters("rgat")
    params.update({"gnn_hidden_dim": 8, "gnn_num_layers": 2,
                   "gnn_num_heads": 4, "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000})
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    v = batch.num_nodes_padded
    plan = batch.scatter_merged
    built, seen = [], []
    real_rows = tss.sorted_rows

    def build(rel, blocks, out_rows, *args, **kwargs):
        built.append(rel is plan.rel_tgt and blocks is plan.tgt_blocks
                     and out_rows == v)
        return real_rows(rel, blocks, out_rows, *args, **kwargs)

    monkeypatch.setattr(tss, "sorted_rows", build)
    for module, name in ((tss, "sorted_segment_max"),
                         (tss, "attention_scatter_sums")):
        real = getattr(module, name)

        def spy(*args, compact=None, _real=real, _name=name, **kwargs):
            seen.append((_name, compact))
            return _real(*args, compact=compact, **kwargs)

        monkeypatch.setattr(module, name, spy)
    from tf2_gnn_tpu_torch.layers.message_passing import rgat as trgat
    monkeypatch.setattr(trgat, "sorted_segment_max", tss.sorted_segment_max)
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer)
    for _ in range(2):
        state, metrics = step(state, batch,
                              {"node_labels": torch.from_numpy(labels)})
        assert np.isfinite(float(metrics["loss"]))
    assert sum(built) == 1
    form = plan.sum_rows("fwd", v)
    assert [name for name, _ in seen] == [
        "sorted_segment_max", "attention_scatter_sums"] * 2 * 2
    assert all(compact is form for _, compact in seen)
