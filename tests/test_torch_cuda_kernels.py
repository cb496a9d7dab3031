"""The hand-written CUDA kernels (tf2_gnn_tpu_torch/csrc/pair_stream.cu:
K1, K2 and B3; csrc/pair_attention.cu: B8 and B9; csrc/pair_edge_mlp.cu:
B4, B5, B6 and B7; csrc/sorted_scatter.cu: B12, B13, B14 and B15) against
their plain PyTorch versions on the card, at small shapes with a ragged
feature width, f32 and bf16 tables, plans with pad slots and an
all-padding group (sorted plans: sentinel slots, an unused trailing chunk
and an all-sentinel chunk of NaN rows), and through the autograd ops. Marked
``cuda``; each test skips without a card. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the port's
machines need not have.)

Tolerance: rtol 1e-5 / atol 1e-5; both sides sum the same f32 products,
the kernel in a run-dependent order (atomics), and B8/B9 take expf of the
same f32 argument as torch.exp (each within 2 ulp). Gradients of the
attention op in bf16 are rounded to bf16 after those sums: rtol 1e-2 /
atol 1e-4 there (one bf16 ulp). B15, a max, matches exactly.
"""
import numpy as np
import pytest
import torch

from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_edge_mlp as tpem
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _plan(seed, v=384, num_types=3):
    rng = np.random.RandomState(seed)
    plans = []
    for _ in range(num_types):
        e = rng.randint(v, 6 * v)
        src, tgt = rng.randint(0, v, e), rng.randint(0, v, e)
        plans.append(tps.build_pair_plans([src], [tgt], [e], v,
                                          group_fwd=8,
                                          group_bwd=8).astuple())
    return tps.stream_joint_plan(tuple(plans), v, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [64, 100, 320])
def test_kernels_match_plain_versions(device, dtype, h):
    plan = _plan(0).to(device)
    v, num_types = plan.v_out, plan.num_types
    gen = torch.Generator(device=device).manual_seed(1)
    tables = torch.randn((num_types * v, h), generator=gen,
                         device=device).to(dtype)
    cot = torch.randn((v, h), generator=gen, device=device).to(dtype)
    fwd = (plan.scale_fwd, plan.rel_src_f, plan.rel_tgt_f, plan.src_blk_f,
           plan.grp_tgt_fl, plan.grp_type_f, v, v)
    bwd = (plan.scale_bwd, plan.rel_src_b, plan.rel_tgt_b, plan.src_blk_b,
           plan.grp_tgt_b, plan.type_b_zeros, v, num_types * v)
    before = dict(tps.LAUNCHES)
    got = tps.pair_spmm_stream_joint(tables, *fwd)
    got_b = tps.pair_spmm_stream(cot, *bwd)
    torch.cuda.synchronize()
    assert tps.LAUNCHES["pair_stream_joint"] == before["pair_stream_joint"] + 1
    assert tps.LAUNCHES["pair_stream"] == before["pair_stream"] + 1
    torch.testing.assert_close(got, tps.pair_spmm_stream_plain(tables, *fwd),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_b, tps.pair_spmm_stream_plain(cot, *bwd),
                               rtol=1e-5, atol=1e-5)


def test_autograd_op_matches_plain_on_card(device):
    plan = _plan(2).to(device)
    v, num_types = plan.v_out, plan.num_types
    gen = torch.Generator(device=device).manual_seed(3)
    base = torch.randn((num_types * v, 96), generator=gen, device=device)
    cot = torch.randn((v, 96), generator=gen, device=device)

    def run():
        t = base.clone().requires_grad_(True)
        out = tps.pair_stream_joint(t, plan, True, torch.bfloat16)
        (out * cot).sum().backward()
        return out.detach(), t.grad

    out, grad = run()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tps, "pair_spmm_stream_joint", tps.pair_spmm_stream_plain)
        mp.setattr(tps, "pair_spmm_stream", tps.pair_spmm_stream_plain)
        out_p, grad_p = run()
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad, grad_p, rtol=1e-5, atol=1e-5)


def _merged_plan(seed, v=384, num_types=3):
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v, 6 * v)
        srcs.append(rng.randint(0, v, e))
        tgts.append(rng.randint(0, v, e))
        counts.append(e)
    plans = tps.build_pair_plans(srcs, tgts, counts, v, group_fwd=16,
                                 group_bwd=8)
    return tps.MergedPlan(*plans.astuple())


def _attention_inputs(device, dtype, rows, v, k, head_dim, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn((rows, head_dim * k), generator=gen, device=device)
    scores = 0.5 * torch.randn((rows, 2 * k), generator=gen, device=device)
    m = tpa._stabilise(tpa._bound_stabiliser(scores.to(dtype), v, k), dtype)
    return table.to(dtype), scores.to(dtype), m, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [5, 81, 100])
def test_pair_spmm_matches_plain_version(device, dtype, h):
    plan = _merged_plan(4).to(device)
    v = 384
    gen = torch.Generator(device=device).manual_seed(5)
    table = torch.randn((3 * v, h), generator=gen, device=device).to(dtype)
    scale = torch.rand((plan.rel_src_f.numel(),), generator=gen,
                       device=device)
    before = tps.LAUNCHES["pair_spmm"]
    got = tps.pair_spmm(table, scale, *plan.fwd, v)
    got_b = tps.pair_spmm(table[:v].contiguous(), plan.inv_bwd, *plan.bwd,
                          3 * v)
    torch.cuda.synchronize()
    assert tps.LAUNCHES["pair_spmm"] == before + 2
    torch.testing.assert_close(
        got, tps.pair_spmm_plain(table, scale, *plan.fwd, v),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        got_b, tps.pair_spmm_plain(table[:v].contiguous(), plan.inv_bwd,
                                   *plan.bwd, 3 * v), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,head_dim", [(4, 20), (4, 3), (8, 5), (1, 16)])
def test_attention_kernels_match_plain_versions(device, dtype, k, head_dim):
    plan = _merged_plan(6).to(device)
    v = 384
    table, scores, m, gen = _attention_inputs(device, dtype, 3 * v, v, k,
                                              head_dim, 7)
    dw = torch.randn((v, head_dim * k), generator=gen,
                     device=device).to(dtype)
    d_denom = torch.randn((v, k), generator=gen, device=device)
    before = dict(tpa.LAUNCHES)
    expd = tpa.pair_attention_expd(scores, m, *plan.fwd, v, k)
    grads = tpa.pair_attention_bwd_fused(table, dw, d_denom, scores, m,
                                         *plan.bwd, v, k)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["pair_attention_expd"] == \
        before["pair_attention_expd"] + 1
    assert tpa.LAUNCHES["pair_attention_bwd_fused"] == \
        before["pair_attention_bwd_fused"] + 1
    torch.testing.assert_close(
        expd, tpa.pair_attention_expd_plain(scores, m, *plan.fwd, v, k),
        rtol=1e-5, atol=1e-5)
    want = tpa.pair_attention_bwd_fused_plain(table, dw, d_denom, scores, m,
                                              *plan.bwd, v, k)
    for name, g, w in zip(("d_ss", "d_ts", "d_table"), grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_op_matches_plain_on_card(device, dtype):
    plan = _merged_plan(8).to(device)
    v, k, head_dim = 384, 4, 20
    base, scores0, _, gen = _attention_inputs(device, torch.float32, 3 * v,
                                              v, k, head_dim, 9)
    cot_d = torch.randn((v, k), generator=gen, device=device)
    cot_w = torch.randn((v, head_dim * k), generator=gen, device=device)

    def run():
        t = base.to(dtype).requires_grad_(True)
        s = scores0.to(dtype).requires_grad_(True)
        denom, weighted = tpa.pair_attention(t, s, plan, v, k, "bound")
        ((denom * cot_d).sum() + (weighted * cot_w).sum()).backward()
        return denom.detach(), weighted.detach(), t.grad, s.grad

    got = run()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tps, "pair_spmm", tps.pair_spmm_plain)
        mp.setattr(tpa, "pair_spmm", tps.pair_spmm_plain)
        mp.setattr(tpa, "pair_attention_expd", tpa.pair_attention_expd_plain)
        mp.setattr(tpa, "pair_attention_bwd_fused",
                   tpa.pair_attention_bwd_fused_plain)
        want = run()
    grad_tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
                else dict(rtol=1e-2, atol=1e-4))
    for i, name in enumerate(("denom", "weighted")):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-5,
                                   msg=name)
    for i, name in ((2, "d_table"), (3, "d_scores")):
        torch.testing.assert_close(got[i].float(), want[i].float(),
                                   msg=name, **grad_tol)


def _merged_target_plan(seed, v=384, num_types=3):
    """A merged-target plan (pad slots in its partly filled chunks) with
    one all-padding group appended to each direction."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v, 4 * v)
        srcs.append(rng.randint(0, v, e))
        tgts.append(rng.randint(0, v, e))
        counts.append(e)
    host = list(tps.build_pair_plans(srcs, tgts, counts, v,
                                     merge_targets=True).astuple())
    for first, inv in ((0, 10), (4, 11)):  # forward, backward
        rel_src, rel_tgt, src_blk, grp_tgt = host[first:first + 4]
        group = tps.plan_group(src_blk, grp_tgt)
        pad = np.full((group, tps.E_C), tps.BLK, np.int32)
        host[first:first + 4] = (
            np.concatenate([rel_src, pad]), np.concatenate([rel_tgt, pad]),
            np.concatenate([src_blk, np.zeros(group, np.int32)]),
            np.concatenate([grp_tgt, grp_tgt[-1:]]))
        host[inv] = np.concatenate([host[inv],
                                    np.zeros(pad.size, np.float32)])
    return tps.MergedPlan(*host, out_rows=num_types * v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [5, 64, 100, 320])
def test_relu_pair_kernels_match_plain_versions(device, dtype, h):
    plan = _merged_target_plan(10).to(device)
    rows = plan.out_rows
    assert int((plan.rel_src_f >= tps.BLK).sum()) > 0
    gen = torch.Generator(device=device).manual_seed(11)
    a = torch.randn((rows, h), generator=gen, device=device).to(dtype)
    b = torch.randn((rows, h), generator=gen, device=device).to(dtype)
    g = torch.randn((rows, h), generator=gen, device=device)
    sf = torch.rand((plan.rel_src_f.numel(),), generator=gen, device=device)
    sb = torch.rand((plan.rel_src_b.numel(),), generator=gen, device=device)
    before = dict(tpem.LAUNCHES)
    got = {"relu_pair_fwd": (tpem.relu_pair_fwd(a, b, sf, *plan.fwd, rows),),
           "relu_pair_fwd_m": tpem.relu_pair_fwd_m(a, b, sf, *plan.fwd, rows),
           "relu_pair_da": (tpem.relu_pair_da(a, b, g, sb, *plan.bwd, rows),),
           "relu_pair_db": (tpem.relu_pair_db(a, b, g, sf, *plan.fwd, rows),)}
    torch.cuda.synchronize()
    want = {"relu_pair_fwd": (tpem.relu_pair_fwd_plain(a, b, sf, *plan.fwd,
                                                       rows),),
            "relu_pair_fwd_m": tpem.relu_pair_fwd_m_plain(a, b, sf,
                                                          *plan.fwd, rows),
            "relu_pair_da": (tpem.relu_pair_da_plain(a, b, g, sb, *plan.bwd,
                                                     rows),),
            "relu_pair_db": (tpem.relu_pair_db_plain(a, b, g, sf, *plan.fwd,
                                                     rows),)}
    for name in got:
        assert tpem.LAUNCHES[name] == before[name] + 1
        for i, (x, y) in enumerate(zip(got[name], want[name])):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5,
                                       msg=f"{name} output {i}")


@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
def test_relu_pair_op_matches_plain_on_card(device, stream_dtype):
    plan = _merged_target_plan(12).to(device)
    rows = plan.out_rows
    gen = torch.Generator(device=device).manual_seed(13)
    a0 = torch.randn((rows, 96), generator=gen, device=device)
    b0 = torch.randn((rows, 96), generator=gen, device=device)
    cot = torch.randn((rows, 96), generator=gen, device=device)

    def run():
        a = a0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        out = tpem.pair_relu_mlp_aggregate(
            a, b, plan, plan.inv_fwd, plan.inv_bwd, plan.inv_ovf, rows,
            stream_dtype)
        (out * cot).sum().backward()
        with torch.no_grad():
            out_eval = tpem.pair_relu_mlp_aggregate(
                a0, b0, plan, plan.inv_fwd, plan.inv_bwd, plan.inv_ovf, rows,
                stream_dtype)
        return out.detach(), out_eval, a.grad, b.grad

    got = run()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("relu_pair_fwd", "relu_pair_fwd_m", "relu_pair_da"):
            mp.setattr(tpem, name, getattr(tpem, f"{name}_plain"))
        want = run()
    for name, x, y in zip(("out", "out_eval", "d_a", "d_b"), got, want):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5, msg=name)


def _sorted_case(seed, v=384, num_types=3):
    """A host scatter plan over random edges whose targets skip node block
    1, and its forward (rel, block_ids) with one all-sentinel chunk
    inserted after chunk 0 (the plan's trailing chunks are unused ones)."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v, 4 * v)
        t = rng.randint(0, v, e)
        t[t // tss.BLOCK_NODES == 1] += tss.BLOCK_NODES
        srcs.append(rng.randint(0, v, e))
        tgts.append(t)
        counts.append(e)
    host = tss.build_merged_plans(srcs, tgts, counts, v)
    assert np.all(host.rel_tgt[-tss.CHUNK_EDGES:] == tss.BLOCK_NODES)
    e_c = tss.CHUNK_EDGES
    rel = np.concatenate([host.rel_tgt[:e_c],
                          np.full(e_c, tss.BLOCK_NODES, np.int32),
                          host.rel_tgt[e_c:]])
    blocks = np.concatenate([host.tgt_blocks[:1], host.tgt_blocks[:1],
                             host.tgt_blocks[1:]])
    return host, rel, blocks


def _stream(rel, h, gen, device, dtype=torch.float32):
    """A [slots, h] stream with NaN rows on the inserted sentinel chunk."""
    x = torch.randn((rel.shape[0], h), generator=gen, device=device)
    x[tss.CHUNK_EDGES:2 * tss.CHUNK_EDGES] = float("nan")
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [4, 40, 324])
def test_sorted_sums_match_plain_versions(device, dtype, h):
    host, rel_np, blocks_np = _sorted_case(20)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    gen = torch.Generator(device=device).manual_seed(21)
    msgs = _stream(rel_np, h, gen, device, dtype)
    scale = torch.rand((rel.numel(),), generator=gen, device=device)
    before = dict(tss.LAUNCHES)
    got = tss.sorted_segment_sum(msgs, rel, blocks, v)
    got_s = tss.sorted_segment_sum_scaled(msgs, scale, rel, blocks, v)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["sorted_segment_sum"] == \
        before["sorted_segment_sum"] + 1
    assert tss.LAUNCHES["sorted_segment_sum_scaled"] == \
        before["sorted_segment_sum_scaled"] + 1
    want = tss.sorted_segment_sum_plain(msgs, rel, blocks, v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got[128:256].abs().max()) == 0.0  # the empty node block
    torch.testing.assert_close(
        got_s, tss.sorted_segment_sum_scaled_plain(msgs, scale, rel, blocks,
                                                   v), rtol=1e-5, atol=1e-5)
    # A row-strided view of a wider stream reads the same columns.
    wide = torch.cat([msgs, msgs[:, :3]], dim=1)
    torch.testing.assert_close(tss.sorted_segment_sum(wide[:, :h], rel,
                                                      blocks, v), want,
                               rtol=1e-5, atol=1e-5)


def test_sorted_segment_sum_type_minor_rows(device):
    """B12 with rel * L + type and R = 128 * L = 384."""
    host, _, _ = _sorted_case(22)
    v, num_types = 384, 3
    plan = tss.ScatterPlan.from_host(host, v, num_types).to(device)
    gen = torch.Generator(device=device).manual_seed(23)
    g = torch.randn((plan.rel_typed.numel(), 4), generator=gen,
                    device=device)
    args = (g, plan.rel_typed, plan.tgt_blocks, v * num_types)
    got = tss.sorted_segment_sum(*args, block_rows=384)
    torch.testing.assert_close(
        got, tss.sorted_segment_sum_plain(*args, block_rows=384),
        rtol=1e-5, atol=1e-5)


def test_sorted_segment_max_matches_exactly(device):
    host, rel_np, blocks_np = _sorted_case(24)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    gen = torch.Generator(device=device).manual_seed(25)
    vals = _stream(rel_np, 4, gen, device)
    vals[::7] = -vals[::7].abs()  # runs of negatives, and a -0.0
    vals[3, 1] = -0.0
    before = tss.LAUNCHES["sorted_segment_max"]
    got = tss.sorted_segment_max(vals, rel, blocks, v)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["sorted_segment_max"] == before + 1
    want = tss.sorted_segment_max_plain(vals, rel, blocks, v)
    assert torch.equal(got, want)
    assert float(got[128:256].abs().max()) == 0.0


@pytest.mark.parametrize("k,head_dim", [(4, 80), (2, 3), (1, 4)])
def test_attention_scatter_sums_match_plain_version(device, k, head_dim):
    host, rel_np, blocks_np = _sorted_case(26)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    gen = torch.Generator(device=device).manual_seed(27)
    expd = torch.rand((rel.numel(), k), generator=gen, device=device)
    bundle = _stream(rel_np, head_dim * k + k, gen, device)
    msgs = bundle[:, :head_dim * k]  # the layer's strided message view
    before = tss.LAUNCHES["attention_scatter_sums"]
    denom, weighted = tss.attention_scatter_sums(expd, msgs, rel, blocks, v)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["attention_scatter_sums"] == before + 1
    want_d, want_w = tss.attention_scatter_sums_plain(expd, msgs, rel, blocks,
                                                      v)
    torch.testing.assert_close(denom, want_d, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(weighted, want_w, rtol=1e-5, atol=1e-5)


_SORTED_WRAPPERS = ("sorted_segment_sum", "sorted_segment_sum_scaled",
                    "sorted_segment_max", "attention_scatter_sums")


@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
def test_sorted_ops_match_plain_on_card(device, stream_dtype):
    host, _, _ = _sorted_case(28)
    v, num_types, h, k = 384, 3, 36, 4
    plan = tss.ScatterPlan.from_host(host, v, num_types).to(device)
    gen = torch.Generator(device=device).manual_seed(29)
    tables0 = torch.randn((num_types * v, h + k), generator=gen,
                          device=device)
    tgt0 = torch.randn((v * num_types, k), generator=gen, device=device)
    cot = torch.randn((v, h), generator=gen, device=device)
    # Fixed cotangents: a loss whose cotangents depend on the forward sums
    # (as denom**2 would) lets the bf16 rounding of the bundle cotangent
    # land on either side of a bf16 value between the two runs.
    cot_d = torch.randn((v, k), generator=gen, device=device)

    def run():
        tables = tables0.clone().requires_grad_(True)
        tgt = tgt0.clone().requires_grad_(True)
        out = tss.typed_gather_scatter(tables[:, :h].contiguous(), plan,
                                       plan.inv_fwd, plan.inv_bwd,
                                       stream_dtype)
        bundle = tss.plan_gather_src(tables, plan, stream_dtype).float()
        logits = bundle[:, h:] + tss.plan_gather_tgt_typed(tgt, plan)
        m = tss.sorted_segment_max(logits.detach(), plan.rel_tgt,
                                   plan.tgt_blocks, v)
        expd = torch.where(plan.fwd_sentinel[:, None], 0.0,
                           torch.exp(logits - m[plan.tgtabs_idx]))
        denom, weighted = tss.attention_scatter(expd, bundle[:, :h], plan)
        loss = ((out * cot).sum() + (weighted * cot).sum()
                + (denom * cot_d).sum())
        loss.backward()
        return out.detach(), weighted.detach(), tables.grad, tgt.grad

    got = run()
    with pytest.MonkeyPatch.context() as mp:
        for name in _SORTED_WRAPPERS:
            mp.setattr(tss, name, getattr(tss, f"{name}_plain"))
        want = run()
    for name, x, y in zip(("out", "weighted", "d_tables", "d_tgt"), got,
                          want):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5, msg=name)
