"""The hand-written CUDA kernels (tf2_gnn_tpu_torch/csrc/pair_stream.cu:
K1, K2 and B3; csrc/pair_attention.cu: B8 and B9; csrc/pair_edge_mlp.cu:
B4, B5, B6 and B7) against their plain PyTorch versions on the card, at
small shapes with a ragged feature width, f32 and bf16 tables, plans with
pad slots and an all-padding group, and through the autograd ops. Marked
``cuda``; each test skips without a card. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the port's
machines need not have.)

Tolerance: rtol 1e-5 / atol 1e-5; both sides sum the same f32 products,
the kernel in a run-dependent order (atomics), and B8/B9 take expf of the
same f32 argument as torch.exp (each within 2 ulp). Gradients of the
attention op in bf16 are rounded to bf16 after those sums: rtol 1e-2 /
atol 1e-4 there (one bf16 ulp).
"""
import numpy as np
import pytest
import torch

from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_edge_mlp as tpem
from tf2_gnn_tpu_torch.ops import pair_spmm as tps

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
