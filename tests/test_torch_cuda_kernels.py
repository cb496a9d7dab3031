"""The hand-written CUDA kernels (tf2_gnn_tpu_torch/csrc/pair_stream.cu)
against their plain PyTorch versions on the card, at small shapes with a
ragged feature width, f32 and bf16 tables, and through the autograd op.
Marked ``cuda``; each test skips without a card. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the port's
machines need not have.)

Tolerance: rtol 1e-5 / atol 1e-5; both sides sum the same f32 products,
the kernel in a run-dependent order (atomics).
"""
import numpy as np
import pytest
import torch

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
