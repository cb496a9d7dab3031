"""The hand-written CUDA kernels (tf2_gnn_tpu_torch/csrc/pair_stream.cu:
K1, K2, B3 and B12, one row-owner kernel over their plans' compact form,
B10 and B14, its per-head twin, B11 and B15, its max twin, and B8, its
expd twin; csrc/pair_attention.cu: B9; csrc/pair_edge_mlp.cu: B4, B5, B6
and B7; csrc/sorted_scatter.cu: B13; csrc/dyngather.cu: P3)
against their plain PyTorch versions on the card, at small shapes with a
ragged feature width, f32 and bf16 tables, plans with pad slots and an
all-padding group (sorted plans: sentinel slots, an unused trailing chunk
and an all-sentinel chunk of NaN rows; B11: targets with no in-edges and a
pad head), and through the autograd ops (the attention op in its merged
and per-type forms); K1/K2 also at a QM9-shaped plan (5 types, H = 128),
K1 in the per-type op's two call forms (``StreamTypedPlan``'s forward and
backward compact forms, at small shapes and the PPI shape, two launches
bit-equal) and through that op with spilled pairs,
B13 with a bf16 stream's rounded scale, and P1/P2 through B3's kernel on
the probe's plans; B3's kernel on its vector (16-byte) and narrow paths,
with an empty target row, targets past the output, clipped sources, a
misaligned table and two launches bit-equal; the row-owner kernel's
sub-warp split (rows of 1-16 lane units, several rows a warp, empty rows
among them); K1 at the PPI and QM9 shapes with rows that have no slot; B12
on its 16-byte, 8-byte and element paths, on a row-strided and a
misaligned stream, and in its gathered form (equal bit for bit to the
unfused one), every launch bit-equal to a second; B4, B5, B6 and B9, the
row owners over the merged plans' compact forms, in both lane units, at
the main paths' widths and odd ones, on whole and cut plans (merged-target
for B4-B6; merged and per-type for B9, also at H = 576 and 1024, its
tiled form), on misaligned tables (B4-B6) and an all-sentinel plan
(B4-B6: zeros), two launches bit-equal; B10 and B14 over their plans'
compact forms in both of B10's call forms, at a head count that does not
divide 32 for B14, two launches bit-equal, and each wrapper raising
without the form; B3 and B10 reading B8's expd by entry equal to their
by-slot launches; B11 and B15 over their forward compact forms at every
lane unit, B11 from an init as the per-type forward chains
it, B15 with non-finite values and on a row-strided view, two launches
equal bit for bit, each wrapper raising without the form, and
sorted_scatter.cu built with B13 alone; B8 over the forward compact form
by entry (the plain version at the form's slots) at every lane unit, on
merged, per-type and partly padded plans, and B7 in the forward row
owner's third mode in both lane units, each two launches bit-equal and
each wrapper raising without the form; P3 in both forms (the shared
form's 16-byte, element-staged, partial and one- and two-column strips,
no shift and more shifts than rows, a misaligned table; the global form
past a block's shared memory), each case's form asserted, two launches
bit-equal. Marked
``cuda``; each test skips without a card. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the port's
machines need not have.)

Tolerance: rtol 1e-5 / atol 1e-5; both sides sum the same f32 products,
in other orders (run-dependent where a kernel adds with atomics; K1, K2,
B3, B12, B4-B6, B9, B10 and B14 keep one order, and fuse products into
their adds),
and B8/B9 take expf of the same f32 argument as torch.exp (each within 2 ulp).
Gradients of the attention op in bf16 are rounded to bf16 after those
sums: rtol 1e-2 / atol 1e-4 there (one bf16 ulp). B15 and B11, maxes, match exactly, as
does P3 (the same f32 adds in the same order).
"""
import numpy as np
import pytest
import torch

from chip_smoke import plain_version
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
    got = tps.pair_spmm_stream_joint(tables, *fwd, compact=plan.fwd_rows)
    got_b = tps.pair_spmm_stream(cot, *bwd, compact=plan.bwd_rows)
    torch.cuda.synchronize()
    assert tps.LAUNCHES["pair_stream_joint"] == before["pair_stream_joint"] + 1
    assert tps.LAUNCHES["pair_stream"] == before["pair_stream"] + 1
    torch.testing.assert_close(got, tps.pair_spmm_stream_plain(tables, *fwd),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_b, tps.pair_spmm_stream_plain(cot, *bwd),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got_b, tps.pair_spmm_stream(cot, *bwd,
                                                   compact=plan.bwd_rows))
    _assert_empty_rows_zero(got_b, plan.bwd_rows)


def _assert_empty_rows_zero(out, compact):
    """The rows without an entry hold 0, and there is one."""
    empty = torch.diff(compact.row_ptr) == 0
    assert bool(empty.any())
    assert float(out[empty].abs().max()) == 0.0


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
        mp.setattr(tps, "pair_spmm_stream_joint",
                   plain_version(tps.pair_spmm_stream_plain))
        mp.setattr(tps, "pair_spmm_stream",
                   plain_version(tps.pair_spmm_stream_plain))
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
    got = tps.pair_spmm(table, scale, *plan.fwd, v,
                        compact=plan.fwd_rows(v, 3 * v))
    got_b = tps.pair_spmm(table[:v].contiguous(), plan.inv_bwd, *plan.bwd,
                          3 * v, compact=tps.slot_rows(*plan.bwd, v, 3 * v))
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
    compact = plan.fwd_rows(v, 3 * v)
    before = dict(tpa.LAUNCHES)
    expd = tpa.pair_attention_expd(scores, m, *plan.fwd, v, k,
                                   compact=compact)
    grads = tpa.pair_attention_bwd_fused(
        table, dw, d_denom, scores, m, *plan.bwd, v, k,
        compact=plan.bwd_rows(3 * v, v), ts_rows=plan.bwd_ts_rows(3 * v, v, v))
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["pair_attention_expd"] == \
        before["pair_attention_expd"] + 1
    assert tpa.LAUNCHES["pair_attention_bwd_fused"] == \
        before["pair_attention_bwd_fused"] + 1
    torch.testing.assert_close(
        expd, tpa.pair_attention_expd_plain(scores, m, *plan.fwd, v,
                                            k)[:, compact.slot.long()],
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
        mp.setattr(tps, "pair_spmm", plain_version(tps.pair_spmm_plain))
        mp.setattr(tpa, "pair_spmm", plain_version(tps.pair_spmm_plain))
        mp.setattr(tpa, "pair_attention_expd",
                   plain_version(tpa.pair_attention_expd_plain))
        mp.setattr(tpa, "pair_attention_bwd_fused",
                   plain_version(tpa.pair_attention_bwd_fused_plain))
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
    fwd_rows, bwd_rows = plan.fwd_rows(rows, rows), plan.bwd_rows(rows, rows)
    got = {"relu_pair_fwd": (tpem.relu_pair_fwd(a, b, sf, *plan.fwd, rows,
                                                compact=fwd_rows),),
           "relu_pair_fwd_m": tpem.relu_pair_fwd_m(
               a, b, sf, *plan.fwd, rows, compact=fwd_rows),
           "relu_pair_da": (tpem.relu_pair_da(a, b, g, sb, *plan.bwd, rows,
                                              compact=bwd_rows),),
           "relu_pair_db": (tpem.relu_pair_db(a, b, g, sf, *plan.fwd, rows,
                                              compact=fwd_rows),)}
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
            mp.setattr(tpem, name, plain_version(getattr(tpem,
                                                         f"{name}_plain")))
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
    compact = tss.sorted_rows(rel, blocks, v, tss.BLOCK_NODES)
    before = dict(tss.LAUNCHES)
    got = tss.sorted_segment_sum(msgs, rel, blocks, v, compact=compact)
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
                                                      blocks, v,
                                                      compact=compact),
                               want, rtol=1e-5, atol=1e-5)


def test_sorted_segment_sum_type_minor_rows(device):
    """B12 with rel * L + type and R = 128 * L = 384."""
    host, _, _ = _sorted_case(22)
    v, num_types = 384, 3
    plan = tss.ScatterPlan.from_host(host, v, num_types).to(device)
    gen = torch.Generator(device=device).manual_seed(23)
    g = torch.randn((plan.rel_typed.numel(), 4), generator=gen,
                    device=device)
    args = (g, plan.rel_typed, plan.tgt_blocks, v * num_types)
    compact = plan.sum_rows("fwd_typed", v * num_types)
    got = tss.sorted_segment_sum(*args, block_rows=384, compact=compact)
    torch.testing.assert_close(
        got, tss.sorted_segment_sum_plain(*args, block_rows=384),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tss.sorted_segment_sum(*args, block_rows=384,
                                                   compact=compact))


def test_sorted_segment_max_matches_exactly(device):
    host, rel_np, blocks_np = _sorted_case(24)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    gen = torch.Generator(device=device).manual_seed(25)
    vals = _stream(rel_np, 4, gen, device)
    vals[::7] = -vals[::7].abs()  # runs of negatives, and a -0.0
    vals[3, 1] = -0.0
    compact = tss.sorted_rows(rel, blocks, v, tss.BLOCK_NODES)
    before = tss.LAUNCHES["sorted_segment_max"]
    got = tss.sorted_segment_max(vals, rel, blocks, v, compact=compact)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["sorted_segment_max"] == before + 1
    want = tss.sorted_segment_max_plain(vals, rel, blocks, v)
    assert torch.equal(got, want)
    assert float(got[128:256].abs().max()) == 0.0


@pytest.mark.parametrize("k,head_dim", [(4, 80), (2, 3), (1, 4), (3, 5),
                                        (8, 40)])
def test_attention_scatter_sums_match_plain_version(device, k, head_dim):
    """B14 over the sorted plan's forward compact form (entries read
    their own stream row), with the layer's strided message view: the
    plain version's sums, 0 on rows without a slot, two launches
    bit-equal; a head count that does not divide 32 (3) takes one unit a
    lane. Without the form the wrapper raises."""
    host, rel_np, blocks_np = _sorted_case(26)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    compact = tss.sorted_rows(rel, blocks, v, tss.BLOCK_NODES)
    gen = torch.Generator(device=device).manual_seed(27)
    expd = torch.rand((rel.numel(), k), generator=gen, device=device)
    bundle = _stream(rel_np, head_dim * k + k, gen, device)
    msgs = bundle[:, :head_dim * k]  # the layer's strided message view
    before = tss.LAUNCHES["attention_scatter_sums"]
    got = tss.attention_scatter_sums(expd, msgs, rel, blocks, v,
                                     compact=compact)
    again = tss.attention_scatter_sums(expd, msgs, rel, blocks, v,
                                       compact=compact)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["attention_scatter_sums"] == before + 2
    want = tss.attention_scatter_sums_plain(expd, msgs, rel, blocks, v)
    for name, x, y, z in zip(("denom", "weighted"), got, again, want):
        assert torch.equal(x, y), name
        torch.testing.assert_close(x, z, rtol=1e-5, atol=1e-5, msg=name)
        _assert_empty_rows_zero(x, compact)
    with pytest.raises(ValueError, match="compact form"):
        tss.attention_scatter_sums(expd, msgs, rel, blocks, v)


_SORTED_WRAPPERS = ("sorted_segment_sum", "sorted_segment_sum_scaled",
                    "sorted_segment_max", "attention_scatter_sums",
                    "sorted_segment_sum_gathered")


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
                                   plan.tgt_blocks, v,
                                   compact=plan.sum_rows("fwd", v))
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
            mp.setattr(tss, name, plain_version(getattr(tss, f"{name}_plain")))
        want = run()
    for name, x, y in zip(("out", "weighted", "d_tables", "d_tgt"), got,
                          want):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5, msg=name)


def _typed_plans_empty_targets(seed, v=384, num_types=3):
    """Per-type host plans (group 16 / 8) of random edges that never enter
    a node whose id is a multiple of 5, and the merged plan of the same
    edges."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v, 4 * v)
        t = rng.randint(0, v, e)
        t[t % 5 == 0] += 1
        srcs.append(rng.randint(0, v, e))
        tgts.append(t)
        counts.append(e)
    typed = [tps.MergedPlan(*tps.build_pair_plans(
        [s], [t], [c], v, group_fwd=16, group_bwd=8).astuple(), out_rows=v)
        for s, t, c in zip(srcs, tgts, counts)]
    merged = tps.MergedPlan(*tps.build_pair_plans(
        srcs, tgts, counts, v, group_fwd=16, group_bwd=8).astuple())
    return typed, merged


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["merged", "typed"])
@pytest.mark.parametrize("k", [4, 8])
def test_max_kernel_matches_exactly(device, dtype, form, k):
    typed, merged = _typed_plans_empty_targets(40)
    v = 384
    plan = (merged if form == "merged" else typed[1]).to(device)
    rows = 3 * v if form == "merged" else v
    gen = torch.Generator(device=device).manual_seed(41)
    scores = 0.5 * torch.randn((rows, 2 * k), generator=gen, device=device)
    scores[:, k - 1] = 0.0           # the last head is a pad head
    scores[:, 2 * k - 1] = tpa.NEG
    scores[::3, 0] = -0.0            # logits of -0.0 beside positive ones
    scores[::3, k] = -0.0
    scores = scores.to(dtype)
    before = tpa.LAUNCHES["pair_attention_max"]
    got = tpa.pair_attention_max(scores, *plan.fwd, v, k,
                                 compact=plan.fwd_rows(v, rows))
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["pair_attention_max"] == before + 1
    want = tpa.pair_attention_max_plain(scores, *plan.fwd, v, k)
    assert torch.equal(got, want)
    empty = torch.arange(v, device=device) % 5 == 0
    assert bool((got[empty] == tpa.NEG).all())
    assert bool((got[~empty][:, :k - 1] > -1e3).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,head_dim", [(8, 2), (8, 8), (4, 128), (1, 160),
                                        (4, 144)])
def test_agg_kernel_matches_plain_version(device, dtype, k, head_dim):
    """Both call forms of B10 (K > 4 heads a tile: 8 heads of 8, GAT's
    layout; head_dim + 1 > 128: 4 heads of 128, and of 144, the H = 576
    layer) over the plan's forward compact form, with targets that have
    no in-edge (0 in both outputs): the plain version's sums, two
    launches bit-equal. Without the form the wrapper raises."""
    typed, _ = _typed_plans_empty_targets(42)
    v = 384
    plan = typed[2].to(device)
    compact = plan.fwd_rows(v, v)
    gen = torch.Generator(device=device).manual_seed(43)
    table = torch.randn((v, head_dim * k), generator=gen,
                        device=device).to(dtype)
    scores = (0.5 * torch.randn((v, 2 * k), generator=gen,
                                device=device)).to(dtype)
    m = tpa._stabilise(tpa._bound_stabiliser(scores, v, k), dtype)
    expd = tpa.pair_attention_expd_plain(scores, m, *plan.fwd, v, k)
    before = tpa.LAUNCHES["pair_attention_agg"]
    got = tpa.pair_attention_agg(table, expd, *plan.fwd, v, k,
                                 compact=compact)
    again = tpa.pair_attention_agg(table, expd, *plan.fwd, v, k,
                                   compact=compact)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["pair_attention_agg"] == before + 2
    want = tpa.pair_attention_agg_plain(table, expd, *plan.fwd, v, k)
    for name, x, y, z in zip(("denom", "weighted"), got, again, want):
        assert torch.equal(x, y), name
        torch.testing.assert_close(x, z, rtol=1e-5, atol=1e-5, msg=name)
        _assert_empty_rows_zero(x, compact)
    with pytest.raises(ValueError, match="compact form"):
        tpa.pair_attention_agg(table, expd, *plan.fwd, v, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stabiliser", ["bound", "exact"])
@pytest.mark.parametrize("k,head_dim", [(4, 20), (8, 4)])
def test_typed_attention_op_matches_plain_on_card(device, dtype, stabiliser,
                                                  k, head_dim):
    """``pair_attention_typed`` forward and backward through B11, B8, B3 or
    B10, and B9, against the same op on the plain versions."""
    typed, _ = _typed_plans_empty_targets(44)
    plans = [p.to(device) for p in typed]
    v = 384
    base, scores0, _, gen = _attention_inputs(device, torch.float32, 3 * v,
                                              v, k, head_dim, 45)
    cot_d = torch.randn((v, k), generator=gen, device=device)
    cot_w = torch.randn((v, head_dim * k), generator=gen, device=device)

    def run():
        t = base.to(dtype).requires_grad_(True)
        s = scores0.to(dtype).requires_grad_(True)
        denom, weighted = tpa.pair_attention_typed(t, s, plans, v, k,
                                                   stabiliser)
        ((denom * cot_d).sum() + (weighted * cot_w).sum()).backward()
        return denom.detach(), weighted.detach(), t.grad, s.grad

    before = dict(tpa.LAUNCHES)
    got = run()
    torch.cuda.synchronize()
    launched = {name: tpa.LAUNCHES[name] - before[name]
                for name in tpa.LAUNCHES}
    assert launched == {
        "pair_attention_expd": 3, "pair_attention_bwd_fused": 3,
        "pair_attention_max": 3 if stabiliser == "exact" else 0,
        "pair_attention_agg": 3 if k == 8 else 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tps, "pair_spmm", plain_version(tps.pair_spmm_plain))
        mp.setattr(tpa, "pair_spmm", plain_version(tps.pair_spmm_plain))
        for name in tpa.LAUNCHES:
            mp.setattr(tpa, name, plain_version(getattr(tpa,
                                                        f"{name}_plain")))
        want = run()
    grad_tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
                else dict(rtol=1e-2, atol=1e-4))
    for i, name in enumerate(("denom", "weighted")):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-5,
                                   msg=name)
    for i, name in ((2, "d_table"), (3, "d_scores")):
        torch.testing.assert_close(got[i].float(), want[i].float(),
                                   msg=name, **grad_tol)


def test_b13_rounds_the_scale_of_a_bf16_stream(device):
    """B13 with a bf16 stream reads each scale rounded to bf16 (the
    reference's ``bf16(onehot * scale)``): the kernel equals the plain sum
    over the rounded scales, and an f32 stream keeps its scales."""
    host, rel_np, blocks_np = _sorted_case(30)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    gen = torch.Generator(device=device).manual_seed(31)
    scale = torch.rand((rel.numel(),), generator=gen, device=device) / 3.0
    rounded = scale.to(torch.bfloat16).float()
    assert not torch.equal(rounded, scale)
    for dtype, used in ((torch.bfloat16, rounded), (torch.float32, scale)):
        msgs = _stream(rel_np, 40, gen, device, dtype)
        got = tss.sorted_segment_sum_scaled(msgs, scale, rel, blocks, v)
        want = tss.segment_sum(
            msgs.float() * used[:, None],
            tss._segment_ids(rel, blocks, v, tss.BLOCK_NODES), v)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _qm9_plan(device):
    """The per-type plans of a QM9-shaped batch (120 molecules of 18 nodes,
    5 types of 11 edges a molecule, V = 2304) in the streamed layout."""
    from tf2_gnn_tpu_torch import workloads

    batch, _, _ = workloads.build_qm9_batch(0, device=device, molecules=120,
                                            node_budget=2304)
    return batch.pair_stream_joint


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernels_at_a_qm9_shaped_plan(device, dtype):
    """K2 (forward layout, group types 0-4) and K1 (backward layout, the
    [L*V] output rows) at QM9's H = 128, and the autograd op."""
    plan = _qm9_plan(device)
    v, num_types, h = plan.v_out, plan.num_types, 128
    assert num_types == 5 and int(plan.grp_type_f.max()) == 4
    gen = torch.Generator(device=device).manual_seed(32)
    tables = torch.randn((num_types * v, h), generator=gen,
                         device=device).to(dtype)
    cot = torch.randn((v, h), generator=gen, device=device).to(dtype)
    fwd = (plan.scale_fwd, plan.rel_src_f, plan.rel_tgt_f, plan.src_blk_f,
           plan.grp_tgt_fl, plan.grp_type_f, v, v)
    bwd = (plan.scale_bwd, plan.rel_src_b, plan.rel_tgt_b, plan.src_blk_b,
           plan.grp_tgt_b, plan.type_b_zeros, v, num_types * v)
    torch.testing.assert_close(tps.pair_spmm_stream_joint(
                                   tables, *fwd, compact=plan.fwd_rows),
                               tps.pair_spmm_stream_plain(tables, *fwd),
                               rtol=1e-5, atol=1e-5)
    got_b = tps.pair_spmm_stream(cot, *bwd, compact=plan.bwd_rows)
    torch.testing.assert_close(got_b, tps.pair_spmm_stream_plain(cot, *bwd),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got_b, tps.pair_spmm_stream(cot, *bwd,
                                                   compact=plan.bwd_rows))
    _assert_empty_rows_zero(got_b, plan.bwd_rows)

    base = tables.float()

    def run():
        t = base.clone().requires_grad_(True)
        out = tps.pair_stream_joint(t, plan, True, dtype)
        (out * cot.float()).sum().backward()
        return out.detach(), t.grad

    got = run()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tps, "pair_spmm_stream_joint",
                   plain_version(tps.pair_spmm_stream_plain))
        mp.setattr(tps, "pair_spmm_stream",
                   plain_version(tps.pair_spmm_stream_plain))
        want = run()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["unrolled", "chunked"])
def test_probe_pair_spmm_through_b3(device, form):
    """P1 (8 chunks a group) and P2 (one) launch B3's kernel on the probe's
    plan; both equal the plain version and the probe's ``np.add.at``."""
    from tf2_gnn_tpu_torch.ops import probes

    rng = np.random.RandomState(33)
    v, h = 384, 200
    srcs = np.concatenate([rng.randint(0, 3 * v, 4000), np.full(300, 9)])
    tgts = np.concatenate([rng.randint(0, v, 4000), np.full(300, 2)])
    build = probes.unrolled_plan if form == "unrolled" else probes.chunked_plan
    plan = build(srcs, tgts, 3 * v, v).to(device)
    gen = torch.Generator(device=device).manual_seed(34)
    table = torch.randn((3 * v, h), generator=gen,
                        device=device).to(torch.bfloat16)
    before = tps.LAUNCHES["pair_spmm"]
    if form == "unrolled":
        got = probes.pair_spmm_unrolled(table, plan, v)
    else:
        got = probes.pair_spmm_chunked(table, plan, v)
    torch.cuda.synchronize()
    assert tps.LAUNCHES["pair_spmm"] == before + 1
    torch.testing.assert_close(
        got, tps.pair_spmm_plain(table, *plan.kernel_args, v), rtol=1e-5,
        atol=1e-5)
    ref = np.zeros((v, h), np.float32)
    np.add.at(ref, tgts, table.float().cpu().numpy()[srcs])
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-5, atol=1e-5)


# P3's cases: (rows, cols, reps) and the form each dtype takes (f32, bf16).
DYNGATHER_CASES = [
    ((8192, 128, 64), ("shared", "shared")),   # the probe's: 16-byte strips
    ((1000, 100, 7), ("shared", "shared")),    # bf16 rows of 200 bytes
    ((512, 20, 9), ("shared", "shared")),      # bf16: a partial last strip
    ((96, 20, 0), ("shared", "shared")),       # no shift: zeros
    ((96, 20, 200), ("shared", "shared")),     # more shifts than rows
    ((40000, 6, 5), ("shared", "shared")),     # strips of 1 and 2 columns
    ((65536, 4, 5), ("global", "shared")),     # f32: one column too many
    ((131072, 2, 3), ("global", "global")),    # neither fits
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,forms", DYNGATHER_CASES,
                         ids=[f"{r}x{c}x{s}" for (r, c, s), _ in
                              DYNGATHER_CASES])
def test_dyngather_matches_plain_version(device, dtype, shape, forms):
    """P3 exactly, in the form its shape takes: both sum the same f32
    values in shift order from 0; indices cover negatives and values
    beyond R (floor modulo); two launches bit-equal."""
    from tf2_gnn_tpu_torch.ops import probes

    rows, cols, reps = shape
    assert probes.dyngather_form(rows, cols, dtype) == forms[
        dtype == torch.bfloat16]
    gen = torch.Generator(device=device).manual_seed(35)
    table = torch.randn((rows, cols), generator=gen, device=device).to(dtype)
    idx = torch.randint(-rows, 2 * rows, (rows, cols), generator=gen,
                        device=device, dtype=torch.int32)
    before = probes.LAUNCHES["dyngather"]
    got = probes.dyngather(table, idx, reps)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["dyngather"] == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, probes.dyngather_plain(table, idx, reps))
    assert torch.equal(got, probes.dyngather(table, idx, reps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dyngather_on_a_misaligned_table(device, dtype):
    """A table whose start lies one element past a 16-byte boundary stages
    its strips element by element."""
    from tf2_gnn_tpu_torch.ops import probes

    rows, cols, reps = 2048, 64, 33
    gen = torch.Generator(device=device).manual_seed(36)
    table = _misaligned(torch.randn((rows, cols), generator=gen,
                                    device=device).to(dtype))
    assert table.data_ptr() % 16 != 0
    idx = torch.randint(0, rows, (rows, cols), generator=gen, device=device,
                        dtype=torch.int32)
    got = probes.dyngather(table, idx, reps)
    assert torch.equal(got, probes.dyngather_plain(table, idx, reps))


def _row_owner_plan(seed, v=384, empty_row=7):
    """A merged plan over 3 types of random edges, none into
    ``empty_row``."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(3):
        e = rng.randint(v, 6 * v)
        tgt = rng.randint(0, v, e)
        tgt[tgt == empty_row] = empty_row + 1
        srcs.append(rng.randint(0, v, e))
        tgts.append(tgt)
        counts.append(e)
    return tps.MergedPlan(*tps.build_pair_plans(srcs, tgts, counts,
                                                v).astuple())


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("dtype,h", [
    (torch.bfloat16, 320), (torch.bfloat16, 128), (torch.float32, 320),
    (torch.float32, 128), (torch.float32, 5), (torch.float32, 81),
    (torch.float32, 100), (torch.bfloat16, 5), (torch.bfloat16, 81),
    (torch.bfloat16, 100)])
def test_row_owner_kernel(device, dtype, h, cut):
    """B3's wrapper over ``slot_rows``, on the vector path (H * itemsize a
    multiple of 16 B) and the narrow one: the row without slots stores 0;
    with ``cut`` the output stops short of the plan's targets (those slots
    are dropped) and the table short of its sources (they clip); two
    launches are bit-equal."""
    v = 384
    plan = _row_owner_plan(50).to(device)
    table_rows, out_rows = (2 * v, v - 40) if cut else (3 * v, v)
    gen = torch.Generator(device=device).manual_seed(51)
    table = torch.randn((table_rows, h), generator=gen,
                        device=device).to(dtype)
    scale = torch.rand((plan.rel_src_f.numel(),), generator=gen,
                       device=device)
    compact = tps.slot_rows(*plan.fwd, table_rows, out_rows)
    assert int(compact.row_ptr[7]) == int(compact.row_ptr[8])
    src, tgt, valid = tps.slot_abs_ids(*plan.fwd)
    assert bool((valid & (tgt >= out_rows)).any()) == cut
    assert bool((valid & (src >= table_rows)).any()) == cut
    before = tps.LAUNCHES["pair_spmm"]
    got = tps.pair_spmm(table, scale, *plan.fwd, out_rows, compact=compact)
    again = tps.pair_spmm(table, scale, *plan.fwd, out_rows,
                          compact=compact)
    torch.cuda.synchronize()
    assert tps.LAUNCHES["pair_spmm"] == before + 2
    assert torch.equal(got, again)
    assert bool((got[7] == 0).all())
    torch.testing.assert_close(
        got, tps.pair_spmm_plain(table, scale, *plan.fwd, out_rows),
        rtol=1e-5, atol=1e-5)


def test_row_owner_kernel_on_a_misaligned_table(device):
    """A bf16 table whose rows are whole 16-byte vectors but whose start is
    not 16-byte aligned takes the narrow path and gives the same sums."""
    v, h = 384, 320
    plan = _row_owner_plan(52).to(device)
    gen = torch.Generator(device=device).manual_seed(53)
    flat = torch.randn((3 * v * h + 1,), generator=gen,
                       device=device).to(torch.bfloat16)
    table = flat[1:].view(3 * v, h)
    assert table.is_contiguous() and table.data_ptr() % 16 != 0
    scale = torch.rand((plan.rel_src_f.numel(),), generator=gen,
                       device=device)
    got = tps.pair_spmm(table, scale, *plan.fwd, v,
                        compact=plan.fwd_rows(v, 3 * v))
    torch.testing.assert_close(
        got, tps.pair_spmm_plain(table, scale, *plan.fwd, v), rtol=1e-5,
        atol=1e-5)


def test_k1_at_the_ppi_shape(device):
    """K1 over the PPI batch's backward plan (3 types, a bf16 [8064, 320]
    cotangent into [24192, 320]): the plain version's sums, bit-equal
    across two launches, 0 on the padded nodes' rows (no slot)."""
    from tf2_gnn_tpu_torch import workloads

    batch, _, _ = workloads.build_ppi_batch(0, device=device)
    plan = batch.pair_stream_joint
    v, num_types = plan.v_out, plan.num_types
    gen = torch.Generator(device=device).manual_seed(55)
    cot = torch.randn((v, 320), generator=gen,
                      device=device).to(torch.bfloat16)
    bwd = (plan.scale_bwd, plan.rel_src_b, plan.rel_tgt_b, plan.src_blk_b,
           plan.grp_tgt_b, plan.type_b_zeros, v, num_types * plan.v_src)
    got = tps.pair_spmm_stream(cot, *bwd, compact=plan.bwd_rows)
    again = tps.pair_spmm_stream(cot, *bwd, compact=plan.bwd_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, tps.pair_spmm_stream_plain(cot, *bwd),
                               rtol=1e-5, atol=1e-5)
    _assert_empty_rows_zero(got, plan.bwd_rows)


def _typed_forms(plan, tables, cot):
    """K1's two call forms of the per-type op on ``plan``
    (``StreamTypedPlan``): (name, kernel call, plain call)."""
    rows = plan.out_rows
    fwd = (tables, plan.scale_fwd, plan.rel_src_f, plan.rel_tgt_f,
           plan.src_blk_f, plan.grp_tgt_f, plan.grp_type_f, plan.v_src, rows)
    bwd = (cot, plan.scale_bwd, plan.rel_src_b, plan.rel_tgt_b,
           plan.src_blk_b, plan.grp_tgt_b, plan.grp_type_b, plan.v_out,
           plan.num_types * plan.v_src)
    return (("forward", lambda: tps.pair_spmm_stream(
                 *fwd, compact=plan.fwd_rows),
             lambda: tps.pair_spmm_stream_plain(*fwd), plan.fwd_rows),
            ("backward", lambda: tps.pair_spmm_stream(
                *bwd, compact=plan.bwd_rows),
             lambda: tps.pair_spmm_stream_plain(*bwd), plan.bwd_rows))


def _check_typed_forms(plan, tables, cot):
    for name, kernel, plain, compact in _typed_forms(plan, tables, cot):
        before = tps.LAUNCHES["pair_stream"]
        got = kernel()
        torch.cuda.synchronize()
        assert tps.LAUNCHES["pair_stream"] == before + 1, name
        torch.testing.assert_close(got, plain(), rtol=1e-5, atol=1e-5,
                                   msg=name)
        assert torch.equal(got, kernel()), name
        _assert_empty_rows_zero(got, compact)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [64, 100, 256])
def test_k1_per_type_forms_match_plain_versions(device, dtype, h):
    """K1 over the per-type op's forward form (sources in the stacked
    tables, global output blocks) and backward form (each type's groups
    reading its own slab of the [L * V] cotangent), against the plain
    version, two launches bit-equal."""
    rng = np.random.RandomState(8)
    v, num_types = 384, 3
    plans = []
    for _ in range(num_types):
        e = rng.randint(v, 6 * v)
        src, tgt = rng.randint(0, v, e), rng.randint(0, v, e)
        plans.append(tps.build_pair_plans([src], [tgt], [e], v, group_fwd=8,
                                          group_bwd=8).astuple())
    plan = tps.stream_typed_plan(tuple(plans), v, v).to(device)
    gen = torch.Generator(device=device).manual_seed(9)
    tables = torch.randn((num_types * v, h), generator=gen,
                         device=device).to(dtype)
    cot = torch.randn((num_types * v, h), generator=gen,
                      device=device).to(dtype)
    _check_typed_forms(plan, tables, cot)


def test_k1_per_type_forms_at_the_ppi_shape(device):
    """K1's two per-type call forms over the PPI batch's per-type plans
    (f32 [24192, 256] tables and cotangent, the shipped GNN_Edge_MLP and
    FiLM width): the plain version's sums, two launches bit-equal."""
    from tf2_gnn_tpu_torch import workloads

    batch, _, _ = workloads.build_ppi_batch(0, device=device)
    plan = batch.pair_stream_typed
    gen = torch.Generator(device=device).manual_seed(56)
    tables = torch.randn((plan.out_rows, 256), generator=gen, device=device)
    cot = torch.randn((plan.out_rows, 256), generator=gen, device=device)
    _check_typed_forms(plan, tables, cot)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
def test_per_type_op_matches_plain_on_card(device, normalize, stream_dtype):
    """The per-type autograd op with spilled pairs (its overflow term and
    its transpose): output and table gradient against the op run through
    the plain version."""
    rng = np.random.RandomState(10)
    v, num_types = 384, 3
    plans = []
    for _ in range(num_types):
        e = rng.randint(2 * v, 6 * v)
        src, tgt = rng.randint(0, v, e), rng.randint(0, v, e)
        plans.append(tps.build_pair_plans(
            [src], [tgt], [e], v, chunk_budget_fwd=8, chunk_budget_bwd=8,
            group_fwd=8, group_bwd=8,
            overflow_budget=((e + 63) // 64) * 64).astuple())
    plan = tps.stream_typed_plan(tuple(plans), v, v).to(device)
    assert int((plan.ovf_tgt < plan.out_rows).sum()) > 0
    gen = torch.Generator(device=device).manual_seed(11)
    base = torch.randn((num_types * v, 72), generator=gen, device=device)
    cot = torch.randn((num_types * v, 72), generator=gen, device=device)

    def run():
        t = base.clone().requires_grad_(True)
        out = tps.pair_stream_typed(t, plan, normalize, stream_dtype)
        (out * cot).sum().backward()
        return out.detach(), t.grad

    before = tps.LAUNCHES["pair_stream"]
    out, grad = run()
    assert tps.LAUNCHES["pair_stream"] == before + 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tps, "pair_spmm_stream",
                   plain_version(tps.pair_spmm_stream_plain))
        out_p, grad_p = run()
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad, grad_p, rtol=1e-5, atol=1e-5)


def _sparse_plan(seed, v=384):
    """A merged plan of 3 types whose edges all enter even targets below
    200: runs of rows without slots inside and after the used rows."""
    rng = np.random.RandomState(seed)
    srcs = [rng.randint(0, v, 400) for _ in range(3)]
    tgts = [2 * rng.randint(0, 100, 400) for _ in range(3)]
    return tps.MergedPlan(*tps.build_pair_plans(srcs, tgts, [400] * 3,
                                                v).astuple())


@pytest.mark.parametrize("dtype,h", [
    (torch.float32, 4), (torch.bfloat16, 16), (torch.float32, 6),
    (torch.float32, 3), (torch.bfloat16, 48), (torch.float32, 64),
    (torch.bfloat16, 128)])
def test_row_owner_sub_warp_split(device, dtype, h):
    """Rows of 1, 2, 4 (8-byte and element units), 8 and 16 lane units:
    a warp owns 32, 16, 8, 4 or 2 rows, empty rows among them; each row
    gets the plain version's sum and 0 where it has no slot, and two
    launches are bit-equal."""
    v = 384
    plan = _sparse_plan(56).to(device)
    gen = torch.Generator(device=device).manual_seed(57)
    table = torch.randn((3 * v, h), generator=gen, device=device).to(dtype)
    scale = torch.rand((plan.rel_src_f.numel(),), generator=gen,
                       device=device)
    compact = plan.fwd_rows(v, 3 * v)
    got = tps.pair_spmm(table, scale, *plan.fwd, v, compact=compact)
    again = tps.pair_spmm(table, scale, *plan.fwd, v, compact=compact)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, tps.pair_spmm_plain(table, scale, *plan.fwd, v), rtol=1e-5,
        atol=1e-5)
    _assert_empty_rows_zero(got, compact)
    assert float(got[1:200:2].abs().max()) == 0.0


def _misaligned(x):
    """A copy of ``x`` whose start lies 2 bytes past a 16-byte boundary."""
    flat = torch.empty((x.numel() + 8,), dtype=x.dtype, device=x.device)
    view = flat[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype,h,layout", [
    (torch.bfloat16, 324, "contiguous"),   # 8-byte units (648-byte rows)
    (torch.bfloat16, 320, "contiguous"),   # 16-byte units
    (torch.float32, 4, "contiguous"),      # one 16-byte unit, 32 rows a warp
    (torch.float32, 6, "contiguous"),      # three 8-byte f32 units
    (torch.bfloat16, 81, "contiguous"),    # one element a lane (odd H)
    (torch.bfloat16, 324, "strided"),      # 8-byte units, row stride 328
    (torch.float32, 320, "strided"),       # 16-byte units, row stride 324
    (torch.bfloat16, 320, "misaligned"),   # element path
])
def test_b12_unit_paths(device, dtype, h, layout):
    """B12 over the sorted plan's compact form on each of its load paths:
    the plain version's sums, 0 on the empty node block, NaN sentinel rows
    never read, two launches bit-equal."""
    _, rel_np, blocks_np = _sorted_case(58)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    gen = torch.Generator(device=device).manual_seed(59)
    pad = 4 if layout == "strided" else 0
    msgs = _stream(rel_np, h + pad, gen, device, dtype)[:, :h]
    if layout == "misaligned":
        msgs = _misaligned(msgs)
        assert msgs.data_ptr() % 16 != 0
    assert (msgs.stride(0) != h) == (layout == "strided")
    compact = tss.sorted_rows(rel, blocks, v, tss.BLOCK_NODES)
    before = tss.LAUNCHES["sorted_segment_sum"]
    got = tss.sorted_segment_sum(msgs, rel, blocks, v, compact=compact)
    again = tss.sorted_segment_sum(msgs, rel, blocks, v, compact=compact)
    torch.cuda.synchronize()
    assert tss.LAUNCHES["sorted_segment_sum"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, tss.sorted_segment_sum_plain(msgs, rel, blocks, v), rtol=1e-5,
        atol=1e-5)
    assert float(got[128:256].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b12_gathered_form_equals_the_unfused_one(device, dtype):
    """``plan_gather_src``'s gradient in one launch, reading the cotangent
    through ``bwd_to_fwd_idx``: bit-equal to B12 over the written-out
    re-ordered stream, and to a second launch; the plain version's sums."""
    host, _, _ = _sorted_case(60)
    v, num_types, h = 384, 3, 324
    plan = tss.ScatterPlan.from_host(host, v, num_types).to(device)
    rows = num_types * v
    gen = torch.Generator(device=device).manual_seed(61)
    g = torch.randn((plan.rel_tgt.numel(), h), generator=gen,
                    device=device).to(dtype)
    args = (g, plan.bwd_to_fwd_idx, plan.bwd_sentinel, plan.rel_src,
            plan.src_blocks, rows)
    before = tss.LAUNCHES["sorted_segment_sum"]
    got = tss.sorted_segment_sum_gathered(
        *args, compact=plan.sum_rows("bwd_fused", rows))
    again = tss.sorted_segment_sum_gathered(
        *args, compact=plan.sum_rows("bwd_fused", rows))
    g_b = g.index_select(0, plan.bwd_to_fwd_idx).masked_fill_(
        plan.bwd_sentinel[:, None], 0.0)
    unfused = tss.sorted_segment_sum(g_b, plan.rel_src, plan.src_blocks,
                                     rows, compact=plan.sum_rows("bwd", rows))
    torch.cuda.synchronize()
    assert tss.LAUNCHES["sorted_segment_sum"] == before + 3
    assert torch.equal(got, again) and torch.equal(got, unfused)
    torch.testing.assert_close(
        got, tss.sorted_segment_sum_gathered_plain(*args), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("dtype,h", [
    (torch.bfloat16, 320), (torch.float32, 320), (torch.bfloat16, 64),
    (torch.float32, 64), (torch.bfloat16, 5), (torch.float32, 5),
    (torch.bfloat16, 100), (torch.float32, 700), (torch.bfloat16, 322),
    (torch.float32, 65)])
def test_b4_row_owner(device, dtype, h, cut):
    """B4 over the merged-target plan's compact form (pad slots, an
    all-padding group, targets without slots), on rows of one tile or
    several (f32 H = 700 in 8-byte units, bf16 H = 322 in element units),
    in 8-byte lane units where a row is whole 8-byte units and one element
    a lane at odd widths (5, 65, 322): the plain version's R and M, 0 on
    the rows without an entry, two launches bit-equal. With ``cut`` A is
    shorter than the plan's sources (they clip), B shorter than the output
    (its rows clip) and the output shorter than the plan's targets (those
    slots drop)."""
    plan = _merged_target_plan(60).to(device)
    rows = plan.out_rows
    rows_a, rows_b, out_rows = ((rows // 2, rows // 3, rows // 2) if cut
                                else (rows, rows, rows))
    gen = torch.Generator(device=device).manual_seed(61)
    a = torch.randn((rows_a, h), generator=gen, device=device).to(dtype)
    b = torch.randn((rows_b, h), generator=gen, device=device).to(dtype)
    sf = torch.rand((plan.rel_src_f.numel(),), generator=gen, device=device)
    compact = plan.fwd_rows(out_rows, rows_a)
    src, tgt, valid = tps.slot_abs_ids(*plan.fwd)
    assert bool((valid & (tgt >= out_rows)).any()) == cut
    assert bool((valid & (src >= rows_a)).any()) == cut

    def b4():
        return tpem.relu_pair_fwd_m(a, b, sf, *plan.fwd, out_rows,
                                    compact=compact)

    before = dict(tpem.LAUNCHES)
    got, again = b4(), b4()
    torch.cuda.synchronize()
    assert tpem.LAUNCHES["relu_pair_fwd_m"] == before["relu_pair_fwd_m"] + 2
    want = tpem.relu_pair_fwd_m_plain(a, b, sf, *plan.fwd, out_rows)
    for name, x, y, z in zip(("R", "M"), got, again, want):
        assert torch.equal(x, y), name
        torch.testing.assert_close(x, z, rtol=1e-5, atol=1e-5, msg=name)
        _assert_empty_rows_zero(x, compact)


def test_b4_on_misaligned_tables(device):
    """A and B whose starts are not 8-byte aligned take the element path
    at a width that would otherwise take 8-byte units, and give the plain
    version's sums."""
    plan = _merged_target_plan(62).to(device)
    rows, h = plan.out_rows, 320
    gen = torch.Generator(device=device).manual_seed(63)
    a, b = (_misaligned(torch.randn((rows, h), generator=gen,
                                    device=device).to(torch.bfloat16))
            for _ in range(2))
    assert a.data_ptr() % 8 != 0 and b.data_ptr() % 8 != 0
    sf = torch.rand((plan.rel_src_f.numel(),), generator=gen, device=device)
    got = tpem.relu_pair_fwd_m(a, b, sf, *plan.fwd, rows,
                               compact=plan.fwd_rows(rows, rows))
    want = tpem.relu_pair_fwd_m_plain(a, b, sf, *plan.fwd, rows)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("dtype,h", [
    (torch.bfloat16, 320), (torch.float32, 320), (torch.bfloat16, 5),
    (torch.float32, 5), (torch.bfloat16, 100), (torch.float32, 700),
    (torch.bfloat16, 322)])
def test_b6_row_owner(device, dtype, h, cut):
    """B6, B4's row owner without M, over the same compact form and cases
    as ``test_b4_row_owner``: the plain version's R, 0 on the rows without
    an entry, two launches bit-equal, bit-equal to B4's R."""
    plan = _merged_target_plan(66).to(device)
    rows = plan.out_rows
    rows_a, rows_b, out_rows = ((rows // 2, rows // 3, rows // 2) if cut
                                else (rows, rows, rows))
    gen = torch.Generator(device=device).manual_seed(67)
    a = torch.randn((rows_a, h), generator=gen, device=device).to(dtype)
    b = torch.randn((rows_b, h), generator=gen, device=device).to(dtype)
    sf = torch.rand((plan.rel_src_f.numel(),), generator=gen, device=device)
    compact = plan.fwd_rows(out_rows, rows_a)

    def b6():
        return tpem.relu_pair_fwd(a, b, sf, *plan.fwd, out_rows,
                                  compact=compact)

    before = dict(tpem.LAUNCHES)
    got, again = b6(), b6()
    r4, _ = tpem.relu_pair_fwd_m(a, b, sf, *plan.fwd, out_rows,
                                 compact=compact)
    torch.cuda.synchronize()
    assert tpem.LAUNCHES["relu_pair_fwd"] == before["relu_pair_fwd"] + 2
    assert torch.equal(got, again) and torch.equal(got, r4)
    torch.testing.assert_close(
        got, tpem.relu_pair_fwd_plain(a, b, sf, *plan.fwd, out_rows),
        rtol=1e-5, atol=1e-5)
    _assert_empty_rows_zero(got, compact)


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("dtype,h", [
    (torch.bfloat16, 320), (torch.float32, 320), (torch.bfloat16, 64),
    (torch.float32, 64), (torch.bfloat16, 5), (torch.float32, 5),
    (torch.bfloat16, 100), (torch.float32, 700), (torch.bfloat16, 322),
    (torch.float32, 65)])
def test_b5_row_owner(device, dtype, h, cut):
    """B5 by A's row over the merged-target plan's backward compact form
    (pad slots, an all-padding group, rows without entries), on rows of one
    tile or several (f32 H = 700 in 8-byte units, bf16 H = 322 in element
    units), in 8-byte lane units of A and B (with g's 16 or 8 bytes) where
    a row is whole 8-byte units, one element a lane at odd widths: the
    plain version's dA, 0 on the rows without an entry, two launches
    bit-equal. With ``cut`` A and the output are shorter than the plan's
    rows u (those slots drop) and B and g shorter than its targets (they
    clip)."""
    plan = _merged_target_plan(68).to(device)
    rows = plan.out_rows
    rows_a, rows_b = (rows // 2, rows // 3) if cut else (rows, rows)
    gen = torch.Generator(device=device).manual_seed(69)
    a = torch.randn((rows_a, h), generator=gen, device=device).to(dtype)
    b = torch.randn((rows_b, h), generator=gen, device=device).to(dtype)
    g = torch.randn((rows_b, h), generator=gen, device=device)
    sb = torch.rand((plan.rel_src_b.numel(),), generator=gen, device=device)
    compact = plan.bwd_rows(rows_a, rows_b)
    t, u, valid = tps.slot_abs_ids(*plan.bwd)
    assert bool((valid & (u >= rows_a)).any()) == cut
    assert bool((valid & (t >= rows_b)).any()) == cut

    def b5():
        return tpem.relu_pair_da(a, b, g, sb, *plan.bwd, rows_a,
                                 compact=compact)

    before = dict(tpem.LAUNCHES)
    got, again = b5(), b5()
    torch.cuda.synchronize()
    assert tpem.LAUNCHES["relu_pair_da"] == before["relu_pair_da"] + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, tpem.relu_pair_da_plain(a, b, g, sb, *plan.bwd, rows_a),
        rtol=1e-5, atol=1e-5)
    _assert_empty_rows_zero(got, compact)


def test_b5_and_b6_on_misaligned_tables(device):
    """A, B and g whose starts are not 8-byte aligned (g's not 16-byte
    aligned) take the element path at a width that would otherwise take
    8-byte units, and give the plain versions' sums."""
    plan = _merged_target_plan(70).to(device)
    rows, h = plan.out_rows, 320
    gen = torch.Generator(device=device).manual_seed(71)
    a, b = (_misaligned(torch.randn((rows, h), generator=gen,
                                    device=device).to(torch.bfloat16))
            for _ in range(2))
    g = _misaligned(torch.randn((rows, h), generator=gen, device=device))
    assert a.data_ptr() % 8 and b.data_ptr() % 8 and g.data_ptr() % 16
    sf = torch.rand((plan.rel_src_f.numel(),), generator=gen, device=device)
    sb = torch.rand((plan.rel_src_b.numel(),), generator=gen, device=device)
    got6 = tpem.relu_pair_fwd(a, b, sf, *plan.fwd, rows,
                              compact=plan.fwd_rows(rows, rows))
    got5 = tpem.relu_pair_da(a, b, g, sb, *plan.bwd, rows,
                             compact=plan.bwd_rows(rows, rows))
    torch.testing.assert_close(
        got6, tpem.relu_pair_fwd_plain(a, b, sf, *plan.fwd, rows),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        got5, tpem.relu_pair_da_plain(a, b, g, sb, *plan.bwd, rows),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_pair_row_owners_on_an_all_sentinel_plan(device, dtype):
    """A merged-target plan with no edge: B4, B6 and B5 store zeros into
    their uninitialised outputs (every row is empty)."""
    host = tps.build_pair_plans([np.zeros(0, np.int32)] * 3,
                                [np.zeros(0, np.int32)] * 3, [0, 0, 0], 256,
                                merge_targets=True)
    plan = tps.MergedPlan(*host.astuple(), out_rows=768).to(device)
    a = b = torch.ones((768, 320), device=device, dtype=dtype)
    g = torch.ones((768, 320), device=device)
    outs = (tpem.relu_pair_fwd(a, b, plan.inv_fwd, *plan.fwd, 768,
                               compact=plan.fwd_rows(768, 768)),
            *tpem.relu_pair_fwd_m(a, b, plan.inv_fwd, *plan.fwd, 768,
                                  compact=plan.fwd_rows(768, 768)),
            tpem.relu_pair_da(a, b, g, plan.inv_bwd, *plan.bwd, 768,
                              compact=plan.bwd_rows(768, 768)))
    torch.cuda.synchronize()
    for out in outs:
        assert out.shape == (768, 320) and float(out.abs().max()) == 0.0


# (plan form, rows of u, rows of dw, one type's rows): B9's plans.
_B9_CASES = {"merged": ("merged", 3, 384, 384),
             "typed": ("typed", 1, 384, 384),
             "merged_cut": ("merged", 2, 256, 384)}


@pytest.mark.parametrize("case", list(_B9_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,head_dim", [(4, 80), (8, 8), (8, 40), (2, 160),
                                        (4, 128), (4, 32), (4, 3), (1, 5),
                                        (4, 144), (4, 256), (8, 73),
                                        (1, 577)])
def test_b9_row_owner(device, dtype, k, head_dim, case):
    """B9's two passes over the backward plan's compact forms, on a merged
    plan (3 types), one type's plan and a cut merged plan (source rows past
    the table drop, targets past dw's rows clip for the gathers and keep
    their d_ts row), at H = 320 with K = 4, 8 and 2, H = 64 with K = 8,
    H = 128 and 512 and odd widths: 8-byte lane units where a row has a
    warp of them (bf16 H = 128 and 320, f32 H = 64 and 128), one element a
    lane otherwise (bf16 H = 64, f32 H = 320, both at H = 512 and the odd
    widths); past the register form the tiled form, in 8-byte units (H =
    576 and 1024 with K = 4, 584 with K = 8) or one element a lane (an odd
    577). The plain version's three gradients, 0 on the rows without an
    entry, two launches bit-equal, one launch counted a call and none of
    the row owner's own."""
    form, types, v, vs = _B9_CASES[case]
    typed, merged = _typed_plans_empty_targets(64)
    plan = (merged if form == "merged" else typed[0]).to(device)
    rows = types * vs
    table, scores, m, gen = _attention_inputs(device, dtype, rows, v, k,
                                              head_dim, 65)
    dw = torch.randn((v, head_dim * k), generator=gen,
                     device=device).to(dtype)
    d_denom = torch.randn((v, k), generator=gen, device=device)
    compact = plan.bwd_rows(rows, v)
    ts = plan.bwd_ts_rows(rows, v, vs)
    args = (table, dw, d_denom, scores, m, *plan.bwd, v, k)

    def b9():
        return tpa.pair_attention_bwd_fused(*args, src_space=vs,
                                            compact=compact, ts_rows=ts)

    before = (dict(tpa.LAUNCHES), dict(tps.LAUNCHES))
    got, again = b9(), b9()
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["pair_attention_bwd_fused"] == \
        before[0]["pair_attention_bwd_fused"] + 2
    assert tps.LAUNCHES == before[1]
    want = tpa.pair_attention_bwd_fused_plain(*args, src_space=vs)
    for name, x, y, z, form_rows in zip(("d_ss", "d_ts", "d_table"), got,
                                        again, want,
                                        (compact, ts.sums, compact)):
        assert torch.equal(x, y), name
        torch.testing.assert_close(x, z, rtol=1e-5, atol=1e-5, msg=name)
        _assert_empty_rows_zero(x, form_rows)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _b11_case(device, form, k, dtype, seed=70):
    """B11's call over one type's plan or the merged plan (targets with no
    in-edges), with -0.0 beside +0.0 among the logits."""
    typed, merged = _typed_plans_empty_targets(seed)
    v = 384
    plan = (merged if form == "merged" else typed[1]).to(device)
    rows = 3 * v if form == "merged" else v
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    scores = 0.5 * torch.randn((rows, 2 * k), generator=gen, device=device)
    scores[::3, 0] = -0.0
    scores[::3, k] = -0.0
    return plan, rows, scores.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32])
def test_max_kernel_at_every_lane_unit(device, dtype, k):
    """B11 at every lane unit its launcher picks (one head up to 16 bytes
    of a score half: 8 bf16 or 4 f32 heads, column tiles past that): the
    plain version exactly, two launches equal bit for bit."""
    plan, rows, scores = _b11_case(device, "typed", k, dtype)
    v = 384
    compact = plan.fwd_rows(v, rows)
    got = tpa.pair_attention_max(scores, *plan.fwd, v, k, compact=compact)
    again = tpa.pair_attention_max(scores, *plan.fwd, v, k, compact=compact)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(got, tpa.pair_attention_max_plain(scores, *plan.fwd,
                                                         v, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["merged", "typed"])
def test_max_kernel_repeats_bit_for_bit(device, dtype, form):
    """Two launches of B11 over the forward compact form, at the lanes the
    wrapper picks, give the same bits, signs of zero included."""
    plan, rows, scores = _b11_case(device, form, 4, dtype)
    compact = plan.fwd_rows(384, rows)
    got, again = (tpa.pair_attention_max(scores, *plan.fwd, 384, 4,
                                         compact=compact) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_kernel_from_an_init(device, dtype):
    """B11 with ``init``: the plain version with the same init exactly,
    and the per-type forward's chain of three launches equals
    ``reduce(torch.maximum, ...)`` of separate plain launches."""
    typed, _ = _typed_plans_empty_targets(72)
    plans = [p.to(device) for p in typed]
    v, k = 384, 4
    gen = torch.Generator(device=device).manual_seed(73)
    scores = [(0.5 * torch.randn((v, 2 * k), generator=gen,
                                 device=device)).to(dtype) for _ in plans]
    separate = [tpa.pair_attention_max_plain(s, *p.fwd, v, k)
                for s, p in zip(scores, plans)]
    chain = None
    for s, p, plain in zip(scores, plans, separate):
        step = tpa.pair_attention_max(s, *p.fwd, v, k,
                                      compact=p.fwd_rows(v, v), init=chain)
        if chain is not None:
            assert torch.equal(step, tpa.pair_attention_max_plain(
                s, *p.fwd, v, k, init=chain))
        chain = step
    torch.cuda.synchronize()
    want = separate[0]
    for plain in separate[1:]:
        want = torch.maximum(want, plain)
    assert torch.equal(chain, want)


@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_sorted_segment_max_units_and_nonfinite_values(device, k):
    """B15 at 16-, 8- and 4-byte lane units (K = 4 and 8, the row-strided
    view of K + 2 columns, K = 1 and 3) with -inf, +inf and NaN among the
    valid slots' values: the plain version (on the CPU, whose amax takes
    a NaN over any number) exactly, 0 wherever a max is not finite; two
    launches bit-equal."""
    host, rel_np, blocks_np = _sorted_case(74)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    compact = tss.sorted_rows(rel, blocks, v, tss.BLOCK_NODES)
    gen = torch.Generator(device=device).manual_seed(75)
    wide = torch.randn((rel.numel(), k + 2), generator=gen, device=device)
    valid = compact.src_row.long()
    pick = valid[torch.randperm(valid.numel(), generator=gen,
                                device=device)[:60]]
    wide[pick[:20], 0] = -torch.inf
    wide[pick[20:40], 0] = torch.inf
    wide[pick[40:], 0] = torch.nan
    for vals in (wide[:, :k], wide[:, :k].contiguous()):
        got = tss.sorted_segment_max(vals, rel, blocks, v, compact=compact)
        again = tss.sorted_segment_max(vals, rel, blocks, v,
                                       compact=compact)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(again))
        want = tss.sorted_segment_max_plain(vals.cpu(), rel.cpu(),
                                            blocks.cpu(), v)
        assert torch.equal(got.cpu(), want)
        assert bool(torch.isfinite(got).all())


def test_max_wrappers_raise_without_compact_form(device):
    """B11 and B15 on CUDA tensors without the plan's compact form raise
    and count no launch."""
    plan, rows, scores = _b11_case(device, "typed", 4, torch.bfloat16)
    _, rel_np, blocks_np = _sorted_case(76)
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    vals = torch.randn((rel.numel(), 4), device=device)
    before = (dict(tpa.LAUNCHES), dict(tss.LAUNCHES))
    with pytest.raises(ValueError, match="compact form"):
        tpa.pair_attention_max(scores, *plan.fwd, 384, 4)
    with pytest.raises(ValueError, match="compact form"):
        tss.sorted_segment_max(vals, rel, blocks, 384)
    assert (tpa.LAUNCHES, tss.LAUNCHES) == before


def test_sorted_scatter_holds_b13_alone(device):
    """``csrc/sorted_scatter.cu`` builds with B13's entry and no other
    kernel's, and B13 still matches its plain version, f32 and bf16."""
    from tf2_gnn_tpu_torch.ops import cuda_build

    lib = cuda_build.load_library("sorted_scatter.cu")
    assert hasattr(lib, "sorted_segment_sum_scaled_launch")
    assert not hasattr(lib, "sorted_segment_max_launch")
    _, rel_np, blocks_np = _sorted_case(78)
    v = 384
    rel = torch.from_numpy(rel_np).to(device)
    blocks = torch.from_numpy(blocks_np).to(device)
    gen = torch.Generator(device=device).manual_seed(79)
    scale = torch.rand((rel.numel(),), generator=gen, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        msgs = _stream(rel_np, 40, gen, device, dtype)
        torch.testing.assert_close(
            tss.sorted_segment_sum_scaled(msgs, scale, rel, blocks, v),
            tss.sorted_segment_sum_scaled_plain(msgs, scale, rel, blocks, v),
            rtol=1e-5, atol=1e-5)


def _b8_plan(form, v=384):
    """(plan, score rows) for B8: one type's plan or the merged plan of
    ``_typed_plans_empty_targets``, or a merged plan whose last source
    block is partly padded (no source at or past node 300)."""
    if form == "padded":
        rng = np.random.RandomState(80)
        srcs = [rng.randint(0, 300, 4 * v) for _ in range(3)]
        tgts = [rng.randint(0, v, 4 * v) for _ in range(3)]
        return tps.MergedPlan(*tps.build_pair_plans(
            srcs, tgts, [4 * v] * 3, v).astuple()), 3 * v
    typed, merged = _typed_plans_empty_targets(81)
    return (merged, 3 * v) if form == "merged" else (typed[2], v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["merged", "typed", "padded"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_b8_row_owner(device, dtype, form, k):
    """B8 over the forward compact form at every lane unit its launcher
    picks (bf16: 2, 4, 8 and 16 bytes of a score half; f32: 4, 8 and 16;
    two column tiles at K = 16): f32 [K, n] by entry, the plain version at
    the form's slots (expf and torch.exp of the same f32 argument), two
    launches bit-equal, one launch counted a call; on a merged plan, one
    type's plan and a plan whose last source block is partly padded."""
    plan, rows = _b8_plan(form)
    plan = plan.to(device)
    v = 384
    gen = torch.Generator(device=device).manual_seed(82 + k)
    scores = (0.5 * torch.randn((rows, 2 * k), generator=gen,
                                device=device)).to(dtype)
    m = tpa._stabilise(tpa._bound_stabiliser(scores, v, k), dtype)
    compact = plan.fwd_rows(v, rows)
    before = tpa.LAUNCHES["pair_attention_expd"]
    got, again = (tpa.pair_attention_expd(scores, m, *plan.fwd, v, k,
                                          compact=compact) for _ in range(2))
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["pair_attention_expd"] == before + 2
    assert tuple(got.shape) == (k, compact.src_row.numel())
    assert torch.equal(got, again)
    want = tpa.pair_attention_expd_plain(scores, m, *plan.fwd, v, k)
    torch.testing.assert_close(got, want[:, compact.slot.long()], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route,k,head_dim", [("b3", 4, 80), ("b3", 1, 5),
                                              ("b10", 8, 8), ("b10", 4, 128)])
def test_b3_and_b10_read_b8s_expd_by_entry(device, dtype, route, k,
                                           head_dim):
    """B3 (one head's launch, on its head-major table) and B10 reading B8's
    expd by entry, with no slot load, give the bits of the same launch
    reading that expd put back in slot order, and the plain version's
    sums; two by-entry launches bit-equal."""
    typed, merged = _typed_plans_empty_targets(84)
    plan = (merged if route == "b3" else typed[1]).to(device)
    v = 384
    rows = 3 * v if route == "b3" else v
    table, scores, m, _ = _attention_inputs(device, dtype, rows, v, k,
                                            head_dim, 85)
    compact = plan.fwd_rows(v, rows)
    expd_e = tpa.pair_attention_expd(scores, m, *plan.fwd, v, k,
                                     compact=compact)
    expd_s = tps.by_slot(expd_e, compact)
    if route == "b3":
        head = torch.cat([table.reshape(rows, head_dim, k)[:, :, 0],
                          table.new_ones((rows, 1))], dim=1).contiguous()

        def run(by_entry):
            return (tps.pair_spmm(head, (expd_e if by_entry else expd_s)[0],
                                  *plan.fwd, v, compact=compact,
                                  by_entry=by_entry),)

        want = (tps.pair_spmm_plain(head, expd_s[0], *plan.fwd, v),)
    else:
        def run(by_entry):
            return tpa.pair_attention_agg(
                table, expd_e if by_entry else expd_s, *plan.fwd, v, k,
                compact=compact, by_entry=by_entry)

        want = tpa.pair_attention_agg_plain(table, expd_s, *plan.fwd, v, k)
    got, again, by_slot = run(True), run(True), run(False)
    torch.cuda.synchronize()
    for x, y, z, w in zip(got, again, by_slot, want):
        assert torch.equal(x, y) and torch.equal(x, z)
        torch.testing.assert_close(x, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("dtype,h,layout", [
    (torch.bfloat16, 320, "contiguous"), (torch.float32, 320, "contiguous"),
    (torch.bfloat16, 64, "contiguous"), (torch.float32, 5, "contiguous"),
    (torch.bfloat16, 322, "contiguous"), (torch.float32, 700, "contiguous"),
    (torch.bfloat16, 320, "misaligned")])
def test_b7_row_owner(device, dtype, h, layout, cut):
    """B7, the forward row owner's third mode (M times g, no R), over B4's
    compact form, in 8-byte units (with g's 16 or 8 bytes) and one element
    a lane (odd widths, misaligned A and B), on whole and cut plans: the
    plain version's dB, 0 on the rows without an entry, two launches
    bit-equal, one launch counted a call."""
    plan = _merged_target_plan(86).to(device)
    rows = plan.out_rows
    rows_a, rows_b, out_rows = ((rows // 2, rows // 3, rows // 2) if cut
                                else (rows, rows, rows))
    gen = torch.Generator(device=device).manual_seed(87)
    a = torch.randn((rows_a, h), generator=gen, device=device).to(dtype)
    b = torch.randn((rows_b, h), generator=gen, device=device).to(dtype)
    if layout == "misaligned":
        a, b = _misaligned(a), _misaligned(b)
    g = torch.randn((out_rows, h), generator=gen, device=device)
    sf = torch.rand((plan.rel_src_f.numel(),), generator=gen, device=device)
    compact = plan.fwd_rows(out_rows, rows_a)
    before = tpem.LAUNCHES["relu_pair_db"]
    got, again = (tpem.relu_pair_db(a, b, g, sf, *plan.fwd, out_rows,
                                    compact=compact) for _ in range(2))
    torch.cuda.synchronize()
    assert tpem.LAUNCHES["relu_pair_db"] == before + 2
    assert torch.equal(got, again)
    want = tpem.relu_pair_db_plain(a, b, g, sf, *plan.fwd, out_rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _assert_empty_rows_zero(got, compact)


def test_b8_and_b7_raise_without_compact_form(device):
    """B8 and B7 on CUDA tensors without the plan's compact form raise and
    count no launch."""
    plan, rows = _b8_plan("typed")
    plan = plan.to(device)
    scores = torch.randn((rows, 8), device=device)
    m = torch.zeros((384, 4), device=device)
    tplan = _merged_target_plan(88).to(device)
    trows = tplan.out_rows
    a = b = torch.randn((trows, 16), device=device)
    before = (dict(tpa.LAUNCHES), dict(tpem.LAUNCHES))
    with pytest.raises(ValueError, match="compact form"):
        tpa.pair_attention_expd(scores, m, *plan.fwd, 384, 4)
    with pytest.raises(ValueError, match="compact form"):
        tpem.relu_pair_db(a, b, torch.zeros_like(a), tplan.inv_fwd,
                          *tplan.fwd, trows)
    assert (tpa.LAUNCHES, tpem.LAUNCHES) == before


def _spilled_merged_plan(seed, merge_targets, v=384, num_types=3):
    """A merged plan of 3 types, with local or merged targets, whose chunk
    budgets (one group short of what the edges need) spill the smallest
    pairs into the overflow list and keep the rest."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(2 * v, 6 * v)
        srcs.append(rng.randint(0, v, e))
        tgts.append(rng.randint(0, v, e))
        counts.append(e)
    need_f, need_b = tps.measure_pair_chunks(
        srcs, tgts, counts, v, merge_targets=merge_targets, group_fwd=8,
        group_bwd=8)
    plan = tps.MergedPlan(*tps.build_pair_plans(
        srcs, tgts, counts, v, chunk_budget_fwd=need_f - 8,
        chunk_budget_bwd=need_b - 8, group_fwd=8, group_bwd=8,
        merge_targets=merge_targets,
        overflow_budget=((sum(counts) + 63) // 64) * 64).astuple(),
        out_rows=num_types * v if merge_targets else v)
    assert 0 < int((plan.ovf_tgt < plan.out_rows).sum()) < sum(counts) // 2
    return plan


@pytest.mark.parametrize("merge_targets", [False, True])
@pytest.mark.parametrize("h", [64, 256, 320])
def test_b3_backward_form_with_a_bf16_cotangent(device, merge_targets, h):
    """B3 over a merged plan's BACKWARD compact form (``bwd_rows``: the
    [out_rows] cotangent is the table, the [L*V] table rows the output),
    with a bf16 cotangent and the plan's backward scales, as
    ``pair_typed_gather_scatter``'s backward launches it; the plain
    version's sums, and two launches bit-equal."""
    plan = _spilled_merged_plan(90 + merge_targets, merge_targets).to(device)
    rows, out_rows = 3 * 384, plan.out_rows
    gen = torch.Generator(device=device).manual_seed(91)
    cot = torch.randn((out_rows, h), generator=gen,
                      device=device).to(torch.bfloat16)
    compact = plan.bwd_rows(rows, out_rows)
    assert compact.num_slots == plan.inv_bwd.numel() == plan.rel_src_b.numel()
    assert compact.src_row.numel() > 0
    before = tps.LAUNCHES["pair_spmm"]
    got, again = (tps.pair_spmm(cot, plan.inv_bwd, *plan.bwd, rows,
                                compact=compact) for _ in range(2))
    torch.cuda.synchronize()
    assert tps.LAUNCHES["pair_spmm"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, tps.pair_spmm_plain(cot, plan.inv_bwd, *plan.bwd, rows),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("merge_targets", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
def test_merged_op_matches_plain_on_card(device, merge_targets, normalize,
                                         stream_dtype):
    """``pair_typed_gather_scatter`` with spilled pairs (its overflow term
    and its transpose): B3 once each way, output and table gradient
    against the op run through the plain version."""
    plan = _spilled_merged_plan(92 + merge_targets, merge_targets).to(device)
    gen = torch.Generator(device=device).manual_seed(93)
    base = torch.randn((3 * 384, 72), generator=gen, device=device)
    cot = torch.randn((plan.out_rows, 72), generator=gen, device=device)

    def run():
        t = base.clone().requires_grad_(True)
        out = tps.pair_typed_gather_scatter(t, plan, normalize,
                                            stream_dtype=stream_dtype)
        (out * cot).sum().backward()
        return out.detach(), t.grad

    before = tps.LAUNCHES["pair_spmm"]
    out, grad = run()
    assert tps.LAUNCHES["pair_spmm"] == before + 2
    assert grad.dtype == torch.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tps, "pair_spmm", plain_version(tps.pair_spmm_plain))
        out_p, grad_p = run()
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad, grad_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,h", [
    (torch.float32, 256), (torch.float32, 512), (torch.bfloat16, 320)])
def test_b12_typed_form_at_model_widths(device, dtype, h):
    """B12's typed form (``plan_gather_tgt_typed``'s gradient, R = 128 *
    L) at the widths of the edge-MLP family's scatter routes: 64 to 128
    lane units a row; the plain version's sums and two launches
    bit-equal."""
    host, _, _ = _sorted_case(94)
    v, num_types = 384, 3
    plan = tss.ScatterPlan.from_host(host, v, num_types).to(device)
    gen = torch.Generator(device=device).manual_seed(95)
    g = torch.randn((plan.rel_typed.numel(), h), generator=gen,
                    device=device).to(dtype)
    args = (g, plan.rel_typed, plan.tgt_blocks, v * num_types)
    compact = plan.sum_rows("fwd_typed", v * num_types)
    got, again = (tss.sorted_segment_sum(*args, block_rows=384,
                                         compact=compact) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, tss.sorted_segment_sum_plain(*args, block_rows=384),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16])
def test_scatter_target_gathers_match_plain_on_card(device, stream_dtype):
    """The compositions of the edge-MLP family's scatter routes: the
    halves gathered by source and from the type-minor target table, a
    relu, L type-masked scatters and the FiLM-style modulation, output and
    both gradients against the same ops through the plain versions."""
    host, _, _ = _sorted_case(96)
    v, num_types, h = 384, 3, 40
    plan = tss.ScatterPlan.from_host(host, v, num_types).to(device)
    gen = torch.Generator(device=device).manual_seed(97)
    src0 = torch.randn((num_types * v, h), generator=gen, device=device)
    tgt0 = torch.randn((v * num_types, 2 * h), generator=gen, device=device)
    cot = torch.randn((num_types, v, h), generator=gen, device=device)

    def run():
        src = src0.clone().requires_grad_(True)
        tgt = tgt0.clone().requires_grad_(True)
        z = (tss.plan_gather_src(src, plan, stream_dtype)
             + tss.plan_gather_tgt_typed(tgt[:, :h], plan, stream_dtype))
        r = torch.relu(z.float()) * plan.inv_fwd[:, None]
        film = tss.plan_gather_tgt_typed(tgt, plan, stream_dtype).float()
        sums = [tss.plan_scatter(torch.where((plan.type_fwd == l)[:, None],
                                             r, 0.0), plan, stream_dtype)
                for l in range(num_types)]
        sums[0] = sums[0] + tss.plan_scatter(film[:, :h] * r + film[:, h:],
                                             plan)
        (torch.stack(sums) * cot).sum().backward()
        return torch.stack(sums).detach(), src.grad, tgt.grad

    before = tss.LAUNCHES["sorted_segment_sum"]
    got = run()
    # 4 scatters forward; the gathered form once, the typed form twice.
    assert tss.LAUNCHES["sorted_segment_sum"] == before + 7
    with pytest.MonkeyPatch.context() as mp:
        for name in _SORTED_WRAPPERS:
            mp.setattr(tss, name, plain_version(getattr(tss, f"{name}_plain")))
        want = run()
    for name, x, y in zip(("sums", "d_src", "d_tgt"), got, want):
        assert x.dtype == torch.float32
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5, msg=name)
