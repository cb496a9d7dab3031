"""The port's scatter-plan route (tf2_gnn_tpu_torch/ops/sorted_spmm.py)
against the JAX package's ``ops/spmm_pallas.py`` on the CPU, whose Pallas
kernels run in interpret mode here:

* the four plain versions (B12 ``sorted_segment_sum``, with R = 128 and
  R = 128 * L; B13 ``sorted_segment_sum_scaled``; B15
  ``sorted_segment_max``; B14 ``attention_scatter_sums``) against the
  kernels they replace, on plans with sentinel slots and an empty node
  block;
* every autograd op's forward and gradients against ``jax.grad`` of its
  JAX counterpart, in f32;
* ``plan_gather_src`` under RGAT's cast pattern (a bf16 gather read in
  f32): the table gradient against ``jax.grad`` at f32 rounding.

Tolerance: rtol 1e-5 / atol 1e-5. Both sides sum the same f32 products
(or, in the max, pick the same element), in other orders; inputs are made
with numpy from a seed. B15 matches exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import spmm_pallas as jsp
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-5, atol=1e-5)
V, L = 256, 3


def random_edges(seed, v=V, num_types=L, empty_block=None):
    """Per-type padded edge lists (budgets rounded to 64, pad edges on the
    pad node v - 1); ``empty_block`` keeps every real target out of that
    node block."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = int(rng.randint(100, 300))
        budget = ((e + 63) // 64) * 64
        s = np.full((budget,), v - 1, np.int32)
        t = np.full((budget,), v - 1, np.int32)
        s[:e] = rng.randint(0, v, e)
        t[:e] = rng.randint(0, v, e)
        if empty_block is not None:
            hit = t[:e] // tss.BLOCK_NODES == empty_block
            t[:e][hit] = (t[:e][hit] + tss.BLOCK_NODES) % v
        srcs.append(s)
        tgts.append(t)
        counts.append(e)
    return srcs, tgts, counts


def plans(seed, **kwargs):
    """(port host plan, JAX host plan tuple, device ScatterPlan on the
    CPU) of one random case."""
    srcs, tgts, counts = random_edges(seed, **kwargs)
    host = tss.build_merged_plans(srcs, tgts, counts, V)
    ref = jsp.build_merged_plans(srcs, tgts, counts, V).astuple()
    return host, ref, tss.ScatterPlan.from_host(host, V, L).to("cpu")


def jarr(x):
    return jnp.asarray(np.asarray(x))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def stream(rng, plan_rel, h, garbage=7.7):
    """A [slots, h] f32 stream with finite garbage on sentinel slots."""
    out = rng.randn(plan_rel.shape[0], h).astype(np.float32)
    out[plan_rel >= tss.BLOCK_NODES] = garbage
    return out


@pytest.mark.parametrize("h", [4, 40])
def test_sorted_segment_sums_match_pallas(h):
    host, _, _ = plans(0, empty_block=1)
    rng = np.random.RandomState(1)
    rel, blocks = host.rel_tgt, host.tgt_blocks
    assert np.any(rel >= tss.BLOCK_NODES)
    msgs = stream(rng, rel, h)
    scale = rng.rand(rel.shape[0]).astype(np.float32)
    got = tss.sorted_segment_sum_plain(torch.from_numpy(msgs),
                                       torch.from_numpy(rel),
                                       torch.from_numpy(blocks), V)
    want = jsp.sorted_segment_sum(jarr(msgs), jarr(rel), jarr(blocks), V)
    close(got, want)
    assert float(got[128:256].abs().max()) == 0.0  # the empty block
    got = tss.sorted_segment_sum_scaled_plain(
        torch.from_numpy(msgs), torch.from_numpy(scale),
        torch.from_numpy(rel), torch.from_numpy(blocks), V)
    want = jsp.sorted_segment_sum_scaled(jarr(msgs), jarr(scale), jarr(rel),
                                         jarr(blocks), V)
    close(got, want)


def test_sorted_segment_sum_type_minor_rows_match_pallas():
    """B12 over the forward plan with rel * L + type and R = 128 * L, the
    gradient of plan_gather_tgt_typed."""
    host, _, plan = plans(2)
    rng = np.random.RandomState(3)
    msgs = stream(rng, host.rel_tgt, 4)
    rel_typed = plan.rel_typed.numpy()
    assert rel_typed.max() == tss.BLOCK_NODES * L  # sentinels
    got = tss.sorted_segment_sum_plain(
        torch.from_numpy(msgs), plan.rel_typed, plan.tgt_blocks, V * L,
        block_rows=tss.BLOCK_NODES * L)
    want = jsp.sorted_segment_sum(jarr(msgs), jarr(rel_typed),
                                  jarr(host.tgt_blocks), V * L,
                                  block_rows=tss.BLOCK_NODES * L)
    close(got, want)
    with pytest.raises(ValueError, match="not a multiple"):
        tss.sorted_segment_sum_plain(torch.from_numpy(msgs), plan.rel_typed,
                                     plan.tgt_blocks, V * L + 128,
                                     block_rows=tss.BLOCK_NODES * L)


def test_sorted_segment_max_matches_pallas():
    host, _, _ = plans(4, empty_block=0)
    rng = np.random.RandomState(5)
    vals = stream(rng, host.rel_tgt, 4, garbage=50.0)
    got = tss.sorted_segment_max_plain(torch.from_numpy(vals),
                                       torch.from_numpy(host.rel_tgt),
                                       torch.from_numpy(host.tgt_blocks), V)
    want = np.asarray(jsp.sorted_segment_max(jarr(vals), jarr(host.rel_tgt),
                                             jarr(host.tgt_blocks), V))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want[:128] == 0.0)  # empty rows give 0, not -inf


def test_attention_scatter_sums_match_pallas():
    host, _, plan = plans(6)
    rng = np.random.RandomState(7)
    k, hd = 4, 8
    sentinel = host.rel_tgt >= tss.BLOCK_NODES
    expd = rng.rand(sentinel.shape[0], k).astype(np.float32)
    expd[sentinel] = 0.0
    msgs = stream(rng, host.rel_tgt, k * hd, garbage=9.9)
    denom, weighted = tss.attention_scatter_sums_plain(
        torch.from_numpy(expd), torch.from_numpy(msgs), plan.rel_tgt,
        plan.tgt_blocks, V)
    want_d, want_w = jsp.attention_scatter(
        jarr(expd), jarr(msgs), jarr(host.rel_tgt), jarr(host.tgt_blocks),
        jarr(host.tgtabs_fwd), jarr(sentinel), V, k)
    close(denom, want_d)
    close(weighted, want_w)


# ---------------------------------------------------------------------------
# The autograd ops against jax.grad of the JAX ops.


def _grad_inputs(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
def test_typed_gather_scatter_matches_jax(normalize):
    host, ref, plan = plans(8)
    h = 24
    tables = _grad_inputs(9, (L * V, h))
    cot = _grad_inputs(10, (V, h))
    if normalize:
        sf, sb = host.inv_fwd, host.inv_bwd
    else:
        sf = np.ones(host.src_merged.shape, np.float32)
        sb = np.ones(host.rel_src.shape, np.float32)
    r = [jarr(a) for a in ref]

    def jloss(t):
        out = jsp.typed_gather_scatter(t, jarr(sf), jarr(sb), r[0], r[1],
                                       r[2], r[3], r[4], r[5], r[6], r[7], V)
        return jnp.sum(out * jarr(cot)), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jarr(tables))
    t = torch.from_numpy(tables).requires_grad_(True)
    out = tss.typed_gather_scatter(t, plan, torch.from_numpy(sf),
                                   torch.from_numpy(sb))
    (out * torch.from_numpy(cot)).sum().backward()
    close(out, jout)
    close(t.grad, jgrad)


@pytest.mark.parametrize("stream_dtype", ["float32", "bfloat16"])
def test_plan_gather_src_matches_jax(stream_dtype):
    """The RGAT cast pattern: the f32 table cast to the stream dtype, the
    gather, the result read in f32. The cotangent reaching the gather's
    backward is rounded to the stream dtype (the transpose of the f32
    cast) on both sides; the f32 table gradient is not rounded again."""
    host, ref, plan = plans(11)
    h = 20
    table = _grad_inputs(12, (L * V, h))
    cot = _grad_inputs(13, (host.rel_tgt.shape[0], h))
    r = [jarr(a) for a in ref]
    jdtype = getattr(jnp, stream_dtype)

    def jloss(t):
        g = jsp.plan_gather_src(t.astype(jdtype), r[0], r[6], r[7], r[9],
                                L * V).astype(jnp.float32)
        return jnp.sum(g * jarr(cot)), g

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jarr(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = tss.plan_gather_src(t, plan, getattr(torch, stream_dtype)).float()
    (out * torch.from_numpy(cot)).sum().backward()
    assert t.grad.dtype == torch.float32
    close(out, jout)
    close(t.grad, jgrad)
    if stream_dtype == "bfloat16":
        # Rounding the cotangent to bf16 matters at this tolerance.
        exact = torch.zeros_like(t.grad).index_add_(
            0, plan.src_idx[~plan.fwd_sentinel],
            torch.from_numpy(cot)[~plan.fwd_sentinel])
        assert float((exact - t.grad).abs().max()) > 1e-4


def test_plan_gather_tgt_typed_matches_jax():
    host, ref, plan = plans(14)
    k = 4
    table_tl = _grad_inputs(15, (V * L, k))
    cot = _grad_inputs(16, (host.rel_tgt.shape[0], k))
    r = [jarr(a) for a in ref]

    def jloss(t):
        g = jsp.plan_gather_tgt_typed(t, r[3], r[4], r[1], r[2], L)
        return jnp.sum(g * jarr(cot)), g

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jarr(table_tl))
    t = torch.from_numpy(table_tl).requires_grad_(True)
    out = tss.plan_gather_tgt_typed(t, plan)
    (out * torch.from_numpy(cot)).sum().backward()
    close(out, jout)
    close(t.grad, jgrad)


def test_plan_scatter_matches_jax():
    host, ref, plan = plans(17)
    h = 12
    weighted = _grad_inputs(18, (host.rel_tgt.shape[0], h))
    cot = _grad_inputs(19, (V, h))
    r = [jarr(a) for a in ref]

    def jloss(w):
        out = jsp.plan_scatter(w, r[1], r[2], r[4], V)
        return jnp.sum(out * jarr(cot)), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jarr(weighted))
    w = torch.from_numpy(weighted).requires_grad_(True)
    out = tss.plan_scatter(w, plan)
    (out * torch.from_numpy(cot)).sum().backward()
    close(out, jout)
    close(w.grad, jgrad)


def test_attention_scatter_op_matches_jax():
    host, ref, plan = plans(20)
    k, hd = 4, 6
    sentinel = host.rel_tgt >= tss.BLOCK_NODES
    rng = np.random.RandomState(21)
    expd = rng.rand(sentinel.shape[0], k).astype(np.float32)
    expd[sentinel] = 0.0
    msgs = _grad_inputs(22, (sentinel.shape[0], k * hd))
    cot_d = _grad_inputs(23, (V, k))
    cot_w = _grad_inputs(24, (V, k * hd))
    r = [jarr(a) for a in ref]

    def jloss(e, m):
        d, w = jsp.attention_scatter(e, m, r[1], r[2], r[4], jarr(sentinel),
                                     V, k)
        return jnp.sum(d * jarr(cot_d)) + jnp.sum(w * jarr(cot_w)), (d, w)

    (_, (jd, jw)), (je, jm) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jarr(expd), jarr(msgs))
    e = torch.from_numpy(expd).requires_grad_(True)
    m = torch.from_numpy(msgs).requires_grad_(True)
    d, w = tss.attention_scatter(e, m, plan)
    ((d * torch.from_numpy(cot_d)).sum()
     + (w * torch.from_numpy(cot_w)).sum()).backward()
    close(d, jd)
    close(w, jw)
    close(e.grad, je)
    close(m.grad, jm)
