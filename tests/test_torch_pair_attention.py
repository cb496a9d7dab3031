"""The port's pair attention (tf2_gnn_tpu_torch/ops/pair_attention.py) and
merged-plan SpMM (``pair_spmm``) against the JAX package on the CPU, where
each wrapper takes its plain version: B3 against ``_pair_spmm_jnp``, B8
against ``_expd_kernel_jnp`` (rows 0..K-1 of its stream), B9 against
``_bwd_fused_jnp``, B11 against ``pair_attention_max`` in interpret mode
(``_max_kernel_jnp`` with NEG on empty targets), B10 against
``_agg_kernel_jnp`` on the transposed expd stream; ``pair_attention``'s
forward and both gradients against ``jax.grad`` of ``pa.pair_attention``
under both stabilisers, in f32 and bf16, with and without spilled edges,
with 4 heads and with 3 heads padded to 4, and on both routes to B10
(K > 4 heads a 128-column tile; head_dim + 1 > 128);
``pair_attention_typed`` against the reference's per-type op, forward and
gradients, under both stabilisers, with spilled edges, on both the
head-major and the B10 route.

Tolerances. f32: rtol 1e-5 / atol 1e-6 on every output and gradient; both
sides compute the same f32 products and sum them in other orders (observed
below 1e-6 relative), and exp differs in its last bit between XLA and
PyTorch. bf16 inputs: outputs rtol 1e-5 / atol 1e-5, since the products of
bf16 inputs are exact in f32, those with the f32 expd are the same f32
products on both sides, and only the summation order differs; gradients
rtol 1e-2 / atol 1e-4, since both sides return them rounded to bf16, and
two f32 sums that differ in their last bits may round to neighbouring bf16
values (2**-8 relative). Heads of 128 features, f32: atol 1e-5 on top,
since the score gradients sum 128 products a head and reach ~30 (2e-6 a
ulp), and where they cancel to near 0 a few ulps of the summands remain
(observed 3.8e-6). B11 is a max of the same f32 logits on both sides:
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import pair_attention as pa
from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_spmm as tps

F32 = dict(rtol=1e-5, atol=1e-6)
F32_WIDE_HEADS = dict(rtol=1e-5, atol=1e-5)
BF16_OUT = dict(rtol=1e-5, atol=1e-5)
BF16_GRAD = dict(rtol=1e-2, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _edges(rng, num_types, v, avg_deg=4, empty_targets=False):
    """Random edges per type; with ``empty_targets`` no edge goes into a
    node whose id is a multiple of 7."""
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v // 2, v * avg_deg)
        budget = ((e + 63) // 64) * 64
        s = np.full((budget,), v - 1, np.int32)
        t = np.full((budget,), v - 1, np.int32)
        s[:e], t[:e] = rng.randint(0, v, e), rng.randint(0, v, e)
        if empty_targets:
            t[:e][t[:e] % 7 == 0] += 1
        srcs.append(s)
        tgts.append(t)
        counts.append(e)
    return srcs, tgts, counts


def _spill_budgets(counts):
    return dict(chunk_budget_fwd=jps.GROUP, chunk_budget_bwd=jps.GROUP,
                overflow_budget=((sum(counts) + 63) // 64) * 64)


def _plans(seed, v=256, num_types=3, spill=False, empty_targets=False):
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = _edges(rng, num_types, v,
                                empty_targets=empty_targets)
    kwargs = _spill_budgets(counts) if spill else {}
    plans = tps.build_pair_plans(srcs, tgts, counts, v, **kwargs)
    if spill:
        assert int(np.sum(plans.ovf_tgt < v)) > 0
    return rng, plans


def _typed_plans(seed, v=256, num_types=3, spill=False):
    """Per-type plans (each type's sources in its own [V]-row slab), with
    spilled edges in every type under ``spill``."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = _edges(rng, num_types, v)
    typed = []
    for s, t, c in zip(srcs, tgts, counts):
        kwargs = _spill_budgets([c]) if spill else {}
        plans = tps.build_pair_plans([s], [t], [c], v, **kwargs)
        assert (int(np.sum(plans.ovf_tgt < v)) > 0) == spill
        typed.append(plans.astuple())
    return rng, tuple(typed)


def _inputs(rng, rows, k, head_dim, real_heads):
    """Table [rows, head_dim * k] (hk-major) and scores [rows, 2k]; heads
    from ``real_heads`` on are pad heads (zero messages, source half 0,
    target half NEG), as the RGAT layer pads them."""
    table = rng.randn(rows, head_dim, k).astype(np.float32)
    table[:, :, real_heads:] = 0.0
    scores = (0.5 * rng.randn(rows, 2 * k)).astype(np.float32)
    scores[:, real_heads:k] = 0.0
    scores[:, k + real_heads:] = tpa.NEG
    return table.reshape(rows, head_dim * k), scores


def _real_cols(h, k, real_heads):
    return np.arange(h)[np.arange(h) % k < real_heads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_spmm_plain_matches_jnp(dtype):
    rng, plans = _plans(0)
    jdt, tdt = DTYPES[dtype]
    v = 256
    table = rng.randn(3 * v, 81).astype(np.float32)
    scale = rng.rand(plans.fwd.rel_src.size).astype(np.float32)
    want = jps._pair_spmm_jnp(jnp.asarray(table, jdt), jnp.asarray(scale),
                              *plans.fwd, v)
    t_plan = [torch.from_numpy(a) for a in plans.fwd]
    got = tps.pair_spmm(torch.tensor(table).to(tdt), torch.from_numpy(scale),
                        *t_plan, v)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert torch.equal(got, tps.pair_spmm_plain(
        torch.tensor(table).to(tdt), torch.from_numpy(scale), *t_plan, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4, 8])
def test_expd_plain_matches_jnp(dtype, k):
    rng, plans = _plans(1)
    jdt, tdt = DTYPES[dtype]
    v = 256
    scores = (0.5 * rng.randn(3 * v, 2 * k)).astype(np.float32)
    m = tpa._stabilise(tpa._bound_stabiliser(
        torch.tensor(scores).to(tdt), v, k), tdt)
    want, _ = pa._expd_kernel_jnp(
        jnp.asarray(scores, jdt), jnp.asarray(m.numpy()), *plans.fwd, v, k,
        swap=False, with_slope=False)
    got = tpa.pair_attention_expd(
        torch.tensor(scores).to(tdt), m,
        *[torch.from_numpy(a) for a in plans.fwd], v, k)
    assert tuple(got.shape) == (k, plans.fwd.rel_src.size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:k], **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_fused_plain_matches_jnp(dtype):
    rng, plans = _plans(2)
    jdt, tdt = DTYPES[dtype]
    v, k, head_dim = 256, 4, 6
    table, scores = _inputs(rng, 3 * v, k, head_dim, k)
    dw = rng.randn(v, head_dim * k).astype(np.float32)
    d_denom = rng.randn(v, k).astype(np.float32)
    m = tpa._stabilise(tpa._bound_stabiliser(
        torch.tensor(scores).to(tdt), v, k), tdt)
    want = pa._bwd_fused_jnp(
        jnp.asarray(table, jdt), jnp.asarray(dw, jdt), jnp.asarray(d_denom),
        jnp.asarray(scores, jdt), jnp.asarray(m.numpy()), *plans.bwd, v, k)
    got = tpa.pair_attention_bwd_fused(
        torch.tensor(table).to(tdt), torch.tensor(dw).to(tdt),
        torch.from_numpy(d_denom), torch.tensor(scores).to(tdt), m,
        *[torch.from_numpy(a) for a in plans.bwd], v, k)
    for name, g, w in zip(("d_ss", "d_ts", "d_table"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4, 8])
def test_max_plain_matches_jnp(dtype, k):
    rng, plans = _plans(11, empty_targets=True)
    jdt, tdt = DTYPES[dtype]
    v = 256
    _, scores = _inputs(rng, 3 * v, k, 1, k - 1)   # the last head is a pad
    want = pa.pair_attention_max(jnp.asarray(scores, jdt), *plans.fwd, v, k,
                                 interpret=True)
    got = tpa.pair_attention_max(torch.tensor(scores).to(tdt),
                                 *[torch.from_numpy(a) for a in plans.fwd],
                                 v, k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (v, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, tgt, valid = tps.slot_abs_ids(*[torch.from_numpy(a)
                                       for a in plans.fwd])
    has_edges = np.zeros(v, bool)
    has_edges[tgt[valid].numpy()] = True
    assert not has_edges[np.arange(v) % 7 == 0].any()
    assert np.all(got.numpy()[~has_edges] == np.float32(tpa.NEG))
    assert np.all(got.numpy()[has_edges] > 0.5 * tpa.NEG)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,head_dim", [(8, 2), (4, 128)])
def test_agg_plain_matches_jnp(dtype, k, head_dim):
    rng, plans = _plans(12)
    jdt, tdt = DTYPES[dtype]
    v = 256
    table, _ = _inputs(rng, 3 * v, k, head_dim, k)
    slots = plans.fwd.rel_src.size
    valid = (plans.fwd.rel_src.reshape(-1) < jps.BLK)
    expd = (rng.rand(k, slots) * valid).astype(np.float32)  # B8: 0 on pads
    want = pa._agg_kernel_jnp(jnp.asarray(table, jdt), jnp.asarray(expd.T),
                              *plans.fwd, v, k)
    got = tpa.pair_attention_agg(torch.tensor(table).to(tdt),
                                 torch.from_numpy(expd),
                                 *[torch.from_numpy(a) for a in plans.fwd],
                                 v, k)
    tol = F32 if dtype == "float32" else BF16_OUT
    for name, g, w in zip(("denom", "weighted"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **tol)


def _check_attention_grads(jloss, tloss, table, scores, dtype, cols, k,
                           real_heads):
    """Forward outputs and both gradients of the port's op against
    ``jax.value_and_grad`` of the reference's, on the real heads."""
    jdt, tdt = DTYPES[dtype]
    jt, js = jnp.asarray(table, jdt), jnp.asarray(scores, jdt)
    (_, (jdenom, jweighted)), (jd_t, jd_s) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jt, js)
    tt = torch.tensor(table).to(tdt).requires_grad_(True)
    ts = torch.tensor(scores).to(tdt).requires_grad_(True)
    loss, (denom, weighted) = tloss(tt, ts)
    loss.backward()

    f32 = F32 if table.shape[1] // k < 128 else F32_WIDE_HEADS
    out_tol = f32 if dtype == "float32" else BF16_OUT
    grad_tol = f32 if dtype == "float32" else BF16_GRAD
    np.testing.assert_allclose(denom.detach()[:, :real_heads].numpy(),
                               np.asarray(jdenom)[:, :real_heads], **out_tol)
    np.testing.assert_allclose(weighted.detach()[:, cols].numpy(),
                               np.asarray(jweighted)[:, cols], **out_tol)
    assert tt.grad.dtype == tdt and ts.grad.dtype == tdt
    score_cols = np.r_[0:real_heads, k:k + real_heads]
    np.testing.assert_allclose(tt.grad.float()[:, cols].numpy(),
                               np.asarray(jd_t, np.float32)[:, cols],
                               err_msg="d_table", **grad_tol)
    np.testing.assert_allclose(ts.grad.float()[:, score_cols].numpy(),
                               np.asarray(jd_s, np.float32)[:, score_cols],
                               err_msg="d_scores", **grad_tol)


def _check_pair_attention(dtype, spill, real_heads, stabiliser, k=4,
                          head_dim=4, seed=3):
    rng, plans = _plans(seed, num_types=2, spill=spill)
    v = 256
    table, scores = _inputs(rng, 2 * v, k, head_dim, real_heads)
    cols = _real_cols(head_dim * k, k, real_heads)
    cot_d = rng.randn(v, real_heads).astype(np.float32)
    cot_w = rng.randn(v, cols.size).astype(np.float32)

    def jloss(t, s):
        denom, weighted = pa.pair_attention(
            t, s, *plans.kernel_arrays, v, k, stabiliser)
        return (jnp.vdot(denom[:, :real_heads], cot_d)
                + jnp.vdot(weighted[:, cols], cot_w)), (denom, weighted)

    plan = tps.MergedPlan(*plans.astuple()).to("cpu")

    def tloss(t, s):
        denom, weighted = tpa.pair_attention(t, s, plan, v, k, stabiliser)
        return ((denom[:, :real_heads] * torch.from_numpy(cot_d)).sum()
                + (weighted[:, cols] * torch.from_numpy(cot_w)).sum()), (
                    denom, weighted)

    _check_attention_grads(jloss, tloss, table, scores, dtype, cols, k,
                           real_heads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("real_heads", [4, 3])
def test_pair_attention_forward_and_gradients_match_jax(dtype, spill,
                                                        real_heads):
    _check_pair_attention(dtype, spill, real_heads, "bound")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("real_heads", [4, 3])
def test_pair_attention_exact_stabiliser_matches_jax(dtype, spill,
                                                     real_heads):
    """The "exact" stabiliser: B11 over the plan plus the overflow max."""
    _check_pair_attention(dtype, spill, real_heads, "exact", seed=13)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,head_dim", [(8, 2), (4, 128)])
def test_pair_attention_agg_routes_match_jax(dtype, k, head_dim):
    """Both routes to B10: 8 heads in one 128-column tile (K > 4 a tile),
    and heads of 128 features (head_dim + 1 > 128)."""
    _check_pair_attention(dtype, True, k, "exact", k=k, head_dim=head_dim,
                          seed=14)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stabiliser", ["bound", "exact"])
@pytest.mark.parametrize("k,head_dim", [(4, 4), (8, 2)])
def test_pair_attention_typed_matches_jax(dtype, stabiliser, k, head_dim):
    """The per-type form with spilled edges in every type: one stabiliser
    over all types, per-type B8 and B3 (4 heads) or B10 (8 heads), and B9
    per type, against the reference's ``pair_attention_typed``."""
    rng, plans_typed = _typed_plans(15, spill=True)
    v, num_types = 256, len(plans_typed)
    real_heads = k - 1   # one pad head
    table, scores = _inputs(rng, num_types * v, k, head_dim, real_heads)
    cols = _real_cols(head_dim * k, k, real_heads)
    cot_d = rng.randn(v, real_heads).astype(np.float32)
    cot_w = rng.randn(v, cols.size).astype(np.float32)

    def jloss(t, s):
        denom, weighted = pa.pair_attention_typed(t, s, plans_typed, v, k,
                                                  stabiliser)
        return (jnp.vdot(denom[:, :real_heads], cot_d)
                + jnp.vdot(weighted[:, cols], cot_w)), (denom, weighted)

    plans = [tps.MergedPlan(*p, out_rows=v).to("cpu") for p in plans_typed]

    def tloss(t, s):
        denom, weighted = tpa.pair_attention_typed(t, s, plans, v, k,
                                                   stabiliser)
        return ((denom[:, :real_heads] * torch.from_numpy(cot_d)).sum()
                + (weighted[:, cols] * torch.from_numpy(cot_w)).sum()), (
                    denom, weighted)

    _check_attention_grads(jloss, tloss, table, scores, dtype, cols, k,
                           real_heads)


def test_unported_routes_raise():
    """Every route of the op is ported now (B11, B10 on both of its routes,
    the per-type form); what still raises is a call that no route takes:
    an unknown stabiliser, and per-type tables whose rows are not the
    types' slabs."""
    rng, plans = _plans(4)
    v = 256
    plan = tps.MergedPlan(*plans.astuple()).to("cpu")
    table, scores = (torch.tensor(a) for a in _inputs(rng, 3 * v, 4, 4, 4))
    for k, head_dim in ((1, 128), (8, 2)):   # B10 routes, no longer raising
        t, s = (torch.tensor(a) for a in _inputs(rng, 3 * v, k, head_dim, k))
        denom, weighted = tpa.pair_attention(t, s, plan, v, k, "exact")
        assert tuple(weighted.shape) == (v, k * head_dim)
        assert bool(torch.isfinite(denom).all())
    with pytest.raises(ValueError, match="unknown stabiliser"):
        tpa.pair_attention(table, scores, plan, v, 4, "max")
    _, typed = _typed_plans(4)
    typed = [tps.MergedPlan(*p, out_rows=v).to("cpu") for p in typed]
    with pytest.raises(ValueError, match="unknown stabiliser"):
        tpa.pair_attention_typed(table, scores, typed, v, 4, "max")
    with pytest.raises(ValueError, match="per-type plans"):
        tpa.pair_attention_typed(table[:2 * v], scores[:2 * v], typed, v, 4,
                                 "bound")


@pytest.mark.parametrize("case", [
    (24192, 8064, 320, 4, "bfloat16"), (24192, 8064, 320, 16, "bfloat16"),
    (24192, 8064, 512, 4, "bfloat16"), (24192, 8064, 576, 4, "bfloat16"),
    (24192, 8064, 1024, 4, "bfloat16"),
    (768, 256, 16, 4, "float32"), (768, 256, 12, 3, "float32"),
    (1000, 256, 16, 4, "float32"), (3 * 60000, 60000, 256, 4, "float32")])
def test_applicability_gate_matches_jax(case):
    rows, v, h, k, dtype = case
    jdt, tdt = DTYPES[dtype]
    assert (tpa.pair_attention_applicable(rows, v, h, k, tdt, tdt, v)
            == pa.pair_attention_applicable(rows, v, h, k, jdt, jdt, v))
