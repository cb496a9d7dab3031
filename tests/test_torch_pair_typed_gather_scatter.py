"""The port's merged-plan op ``pair_typed_gather_scatter`` (B3 in both
directions over a ``MergedPlan``) against the JAX package's
``pair_typed_gather_scatter`` and its VJP on the CPU (both through their
plain versions): forward output and table gradient over merged plans with
local targets (the joint [V, H] sum) and with merged targets (the
per-type [L*V, H] aggregates), 1/deg and unit scales, f32 and bf16
streams, and plans with genuinely spilled pairs (the overflow term and
its transpose); the op's two compact forms against the plan's valid
slots.

Tolerances: as ``test_torch_pair_stream.py`` (f32 rtol 1e-5 / atol 1e-5,
the same f32 products summed in another order; bf16 rtol 2**-8, one bf16
ulp, / atol 1e-5: both sides round the same f32 tables and cotangents to
bf16 and accumulate in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu_torch.ops import pair_spmm as tps

from .test_torch_pair_stream import TOLS, _random_edges


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _merged_plans(mod, srcs, tgts, counts, v, merge_targets, spill):
    """One merged plan over all types (host tuple); under ``spill`` each
    direction's chunk budget is one group short of what the edges need,
    so the smallest pairs spill into the overflow list and the rest stay
    in the plan."""
    kwargs = dict(group_fwd=8, group_bwd=8, merge_targets=merge_targets)
    if spill:
        need_f, need_b = mod.measure_pair_chunks(
            srcs, tgts, counts, v, merge_targets=merge_targets, group_fwd=8,
            group_bwd=8)
        kwargs.update(chunk_budget_fwd=need_f - 8, chunk_budget_bwd=need_b - 8,
                      overflow_budget=((sum(counts) + 63) // 64) * 64)
    return mod.build_pair_plans(srcs, tgts, counts, v, **kwargs).astuple()


def _jax_value_and_grad(tables, cot, plans, out_rows, normalize, dtype):
    if normalize:
        scales = plans[10], plans[11], plans[12]
    else:
        scales = jps.pair_unit_scales(plans, out_rows)

    def f(t):
        out = jps.pair_typed_gather_scatter(
            t.astype(dtype), *scales, *plans[:10], out_rows)
        return jnp.vdot(out, cot), out

    (_, out), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(tables))
    return np.asarray(out), np.asarray(grad, np.float32)


def _torch_value_and_grad(tables, cot, plans, out_rows, normalize, dtype):
    t = torch.tensor(tables, requires_grad=True)
    plan = tps.MergedPlan(*plans, out_rows=out_rows).to("cpu")
    out = tps.pair_typed_gather_scatter(t, plan, normalize,
                                        stream_dtype=getattr(torch, dtype))
    torch.sum(out * torch.from_numpy(cot)).backward()
    assert out.dtype == torch.float32 and t.grad.dtype == torch.float32
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("merge_targets", [False, True])
@pytest.mark.parametrize("spill", [False, True])
def test_merged_op_matches_jax(spill, merge_targets, normalize, dtype):
    rng = np.random.RandomState(41 + 4 * spill + 2 * merge_targets
                                + normalize)
    v, num_types, h = 384, 3, 24
    srcs, tgts, counts = _random_edges(rng, num_types, v, clusters=not spill)
    out_rows = num_types * v if merge_targets else v
    tables = rng.randn(num_types * v, h).astype(np.float32)
    cot = rng.randn(out_rows, h).astype(np.float32)
    plans_j = _merged_plans(jps, srcs, tgts, counts, v, merge_targets, spill)
    plans_t = _merged_plans(tps, srcs, tgts, counts, v, merge_targets, spill)
    for a, b in zip(plans_j, plans_t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if spill:
        assert 0 < int(np.sum(plans_t[9] < out_rows)) < sum(counts) // 2

    out_j, grad_j = _jax_value_and_grad(tables, cot, plans_j, out_rows,
                                        normalize, dtype)
    out_t, grad_t = _torch_value_and_grad(tables, cot, plans_t, out_rows,
                                          normalize, dtype)
    assert out_t.shape == (out_rows, h)
    np.testing.assert_allclose(out_t, out_j, **TOLS[dtype])
    np.testing.assert_allclose(grad_t, grad_j, **TOLS[dtype])


@pytest.mark.parametrize("merge_targets", [False, True])
def test_compact_forms_are_the_plans_valid_slots(merge_targets):
    """The op's forward form (into the plan's output rows from the [L*V]
    tables) and backward form (into the [L*V] table rows from the
    cotangent's output rows) hold exactly the plan's valid slots, and with
    the overflow list every real edge once; each scale row has one value
    a slot of its direction."""
    rng = np.random.RandomState(9 + merge_targets)
    v, num_types = 384, 3
    srcs, tgts, counts = _random_edges(rng, num_types, v, clusters=False)
    out_rows = num_types * v if merge_targets else v
    rows = num_types * v
    plan = tps.MergedPlan(
        *_merged_plans(tps, srcs, tgts, counts, v, merge_targets, True),
        out_rows=out_rows).to("cpu")
    n_ovf = int((plan.ovf_tgt < out_rows).sum())
    assert 0 < n_ovf < sum(counts) // 2
    for compact, arrays, table_rows, into in (
            (plan.fwd_rows(out_rows, rows), plan.fwd, rows, out_rows),
            (plan.bwd_rows(rows, out_rows), plan.bwd, out_rows, rows)):
        src, tgt, valid = tps.slot_abs_ids(*arrays)
        keep = valid & (tgt < into)
        assert compact.table_rows == table_rows and compact.out_rows == into
        assert compact.num_slots == arrays[0].numel()
        assert compact.src_row.numel() == int(keep.sum())
        assert compact.src_row.numel() + n_ovf == sum(counts)
        assert torch.equal(torch.sort(compact.slot.long()).values,
                           torch.nonzero(keep).reshape(-1))
        assert torch.equal(torch.diff(compact.row_ptr.long()),
                           torch.bincount(tgt[keep], minlength=into))
    sf, sb, so = tps.pair_unit_scales(plan, out_rows)
    assert sf.numel() == plan.fwd_rows(out_rows, rows).num_slots
    assert sb.numel() == plan.bwd_rows(rows, out_rows).num_slots
    assert plan.inv_bwd.numel() == sb.numel()
    assert int(so.sum()) == n_ovf
