"""The port's pair attention (tf2_gnn_tpu_torch/ops/pair_attention.py) and
merged-plan SpMM (``pair_spmm``) against the JAX package on the CPU, where
each wrapper takes its plain version: B3 against ``_pair_spmm_jnp``, B8
against ``_expd_kernel_jnp`` (rows 0..K-1 of its stream), B9 against
``_bwd_fused_jnp``, and ``pair_attention``'s forward and both gradients
against ``jax.grad`` of ``pa.pair_attention`` with the ``"bound"``
stabiliser, in f32 and bf16, with and without spilled edges, with 4 heads
and with 3 heads padded to 4. The routes the port does not have raise.

Tolerances. f32: rtol 1e-5 / atol 1e-6 on every output and gradient; both
sides compute the same f32 products and sum them in other orders (observed
below 1e-6 relative), and exp differs in its last bit between XLA and
PyTorch. bf16 inputs: outputs rtol 1e-5 / atol 1e-5, since the products of
bf16 inputs are exact in f32 and only the summation order differs;
gradients rtol 1e-2 / atol 1e-4, since both sides return them rounded to
bf16, and two f32 sums that differ in their last bits may round to
neighbouring bf16 values (2**-8 relative).
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
BF16_OUT = dict(rtol=1e-5, atol=1e-5)
BF16_GRAD = dict(rtol=1e-2, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _edges(rng, num_types, v, avg_deg=4):
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v // 2, v * avg_deg)
        budget = ((e + 63) // 64) * 64
        s = np.full((budget,), v - 1, np.int32)
        t = np.full((budget,), v - 1, np.int32)
        s[:e], t[:e] = rng.randint(0, v, e), rng.randint(0, v, e)
        srcs.append(s)
        tgts.append(t)
        counts.append(e)
    return srcs, tgts, counts


def _plans(seed, v=256, num_types=3, spill=False):
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = _edges(rng, num_types, v)
    kwargs = {}
    if spill:
        kwargs = dict(chunk_budget_fwd=jps.GROUP, chunk_budget_bwd=jps.GROUP,
                      overflow_budget=((sum(counts) + 63) // 64) * 64)
    plans = tps.build_pair_plans(srcs, tgts, counts, v, **kwargs)
    if spill:
        assert int(np.sum(plans.ovf_tgt < v)) > 0
    return rng, plans


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
@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("real_heads", [4, 3])
def test_pair_attention_forward_and_gradients_match_jax(dtype, spill,
                                                        real_heads):
    rng, plans = _plans(3, num_types=2, spill=spill)
    jdt, tdt = DTYPES[dtype]
    v, k, head_dim = 256, 4, 4
    rows = 2 * v
    table, scores = _inputs(rng, rows, k, head_dim, real_heads)
    cols = _real_cols(head_dim * k, k, real_heads)
    cot_d = rng.randn(v, real_heads).astype(np.float32)
    cot_w = rng.randn(v, cols.size).astype(np.float32)

    def jloss(t, s):
        denom, weighted = pa.pair_attention(
            t, s, *plans.kernel_arrays, v, k, "bound")
        return (jnp.vdot(denom[:, :real_heads], cot_d)
                + jnp.vdot(weighted[:, cols], cot_w)), (denom, weighted)

    jt, js = jnp.asarray(table, jdt), jnp.asarray(scores, jdt)
    (_, (jdenom, jweighted)), (jd_t, jd_s) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jt, js)

    plan = tps.MergedPlan(*plans.astuple()).to("cpu")
    tt = torch.tensor(table).to(tdt).requires_grad_(True)
    ts = torch.tensor(scores).to(tdt).requires_grad_(True)
    denom, weighted = tpa.pair_attention(tt, ts, plan, v, k, "bound")
    loss = ((denom[:, :real_heads] * torch.from_numpy(cot_d)).sum()
            + (weighted[:, cols] * torch.from_numpy(cot_w)).sum())
    loss.backward()

    out_tol = F32 if dtype == "float32" else BF16_OUT
    grad_tol = F32 if dtype == "float32" else BF16_GRAD
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


def test_unported_routes_raise():
    rng, plans = _plans(4)
    v = 256
    plan = tps.MergedPlan(*plans.astuple()).to("cpu")
    rows = 3 * v

    def run(k, head_dim, stabiliser="bound"):
        table, scores = _inputs(rng, rows, k, head_dim, k)
        return tpa.pair_attention(torch.tensor(table), torch.tensor(scores),
                                  plan, v, k, stabiliser)

    with pytest.raises(NotImplementedError, match="B11"):
        run(4, 4, "exact")
    with pytest.raises(NotImplementedError, match="B10"):
        run(1, 128)      # head_dim + 1 > TILE
    with pytest.raises(NotImplementedError, match="B10"):
        run(8, 2)        # K > 4 * h_tiles
    with pytest.raises(NotImplementedError, match="pair_attention_typed"):
        tpa.pair_attention_typed(None, None, (), v, 4, "bound")


@pytest.mark.parametrize("case", [
    (24192, 8064, 320, 4, "bfloat16"), (24192, 8064, 320, 16, "bfloat16"),
    (768, 256, 16, 4, "float32"), (768, 256, 12, 3, "float32"),
    (1000, 256, 16, 4, "float32"), (3 * 60000, 60000, 256, 4, "float32")])
def test_applicability_gate_matches_jax(case):
    rows, v, h, k, dtype = case
    jdt, tdt = DTYPES[dtype]
    assert (tpa.pair_attention_applicable(rows, v, h, k, tdt, tdt, v)
            == pa.pair_attention_applicable(rows, v, h, k, jdt, jdt, v))
