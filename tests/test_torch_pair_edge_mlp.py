"""The port's relu-pair op (tf2_gnn_tpu_torch/ops/pair_edge_mlp.py) against
the JAX package's on the CPU, over merged-target pair plans:

* the plain versions of B4, B5, B6 and B7 (the CPU side of each kernel
  wrapper) against the reference's jnp twins ``_relu_pair_*_jnp``, with f32
  and bf16 tables and random per-slot scales;
* the op (``pair_relu_mlp_aggregate``) forward and its ``a``/``b``
  gradients against ``jax.grad`` of the reference's custom VJP, with unit
  and 1/deg scales, with and without spilled edges (the overflow term), f32
  and bf16 streams;
* a bf16 stream returns f32 gradients, unrounded, as the reference's
  custom VJP does through ``astype``.

Inputs are made with numpy from a seed. Tolerance rtol/atol 1e-5: both
sides sum the same f32 terms in other orders; with a bf16 stream both round
the same f32 inputs to bf16 (round to nearest even), so nothing else
differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import pair_edge_mlp as jpem
from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu_torch.ops import pair_edge_mlp as tpem
from tf2_gnn_tpu_torch.ops import pair_spmm as tps


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
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def merged_target_plans(seed: int, v: int = 384, num_types: int = 3,
                        spill: bool = False):
    """Random per-type edges and their merged-target plans (both packages
    build byte-identical plans; the tests hold that elsewhere). ``spill``
    shrinks both chunk budgets below the data's need so that pairs spill
    into the overflow list."""
    rng = np.random.RandomState(seed)
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v, 4 * v)
        srcs.append(rng.randint(0, v, e))
        tgts.append(rng.randint(0, v, e))
        counts.append(e)
    kwargs = {"merge_targets": True, "overflow_budget": 4096}
    if spill:
        need_f, need_b = tps.measure_pair_chunks(srcs, tgts, counts, v,
                                                 merge_targets=True)
        kwargs.update(chunk_budget_fwd=need_f - tps.GROUP,
                      chunk_budget_bwd=need_b - tps.BWD_GROUP)
    plans = tps.build_pair_plans(srcs, tgts, counts, v, **kwargs)
    if spill:
        assert int(np.sum(plans.ovf_tgt < num_types * v)) > 0
    return plans, rng


def inputs(rng, rows: int, h: int):
    a = rng.randn(rows, h).astype(np.float32)
    b = rng.randn(rows, h).astype(np.float32)
    g = rng.randn(rows, h).astype(np.float32)
    return a, b, g


def as_torch(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h", [8, 33])
def test_plain_versions_match_jnp_twins(dtype, h):
    plans, rng = merged_target_plans(0)
    out_rows = 3 * 384
    a, b, g = inputs(rng, out_rows, h)
    jdt, tdt = DTYPES[dtype]
    ja, jb, jg = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt), \
        jnp.asarray(g)
    ta, tb, tg = as_torch(a).to(tdt), as_torch(b).to(tdt), as_torch(g)
    sf = rng.rand(plans.fwd.rel_src.size).astype(np.float32)
    sb = rng.rand(plans.bwd.rel_src.size).astype(np.float32)
    fwd, bwd = tuple(plans.fwd), tuple(plans.bwd)
    tfwd = tuple(as_torch(x, torch.int32) for x in fwd)
    tbwd = tuple(as_torch(x, torch.int32) for x in bwd)

    want = jpem._relu_pair_fwd_jnp(ja, jb, jnp.asarray(sf), *fwd, out_rows)
    got = tpem.relu_pair_fwd_plain(ta, tb, as_torch(sf), *tfwd, out_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    want_r, want_m = jpem._relu_pair_fwd_m_jnp(ja, jb, jnp.asarray(sf), *fwd,
                                               out_rows)
    got_r, got_m = tpem.relu_pair_fwd_m_plain(ta, tb, as_torch(sf), *tfwd,
                                              out_rows)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)
    assert float(got_m.abs().sum()) > 0

    want = jpem._relu_pair_db_jnp(ja, jb, jg, jnp.asarray(sf), *fwd, out_rows)
    got = tpem.relu_pair_db_plain(ta, tb, tg, as_torch(sf), *tfwd, out_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    want = jpem._relu_pair_da_jnp(ja, jb, jg, jnp.asarray(sb), *bwd, out_rows)
    got = tpem.relu_pair_da_plain(ta, tb, tg, as_torch(sb), *tbwd, out_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def run_jax(plans, a, b, cot, scales, out_rows, dtype):
    t = plans.astuple()
    jdt = DTYPES[dtype][0]

    def loss(a32, b32):
        out = jpem.pair_relu_mlp_aggregate(
            a32.astype(jdt), b32.astype(jdt), *scales, *t[:10], out_rows)
        return jnp.vdot(out, cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(a), jnp.asarray(b))
    return out, grads


def run_torch(plans, a, b, cot, normalize, out_rows, dtype):
    plan = tps.MergedPlan(*plans.astuple(), out_rows=out_rows).to("cpu")
    if normalize:
        scales = (plan.inv_fwd, plan.inv_bwd, plan.inv_ovf)
    else:
        scales = tps.pair_unit_scales(plan, out_rows)
    ta = as_torch(a).requires_grad_(True)
    tb = as_torch(b).requires_grad_(True)
    out = tpem.pair_relu_mlp_aggregate(ta, tb, plan, *scales, out_rows,
                                       stream_dtype=DTYPES[dtype][1])
    (out * as_torch(cot)).sum().backward()
    return out.detach(), ta.grad, tb.grad


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_and_gradients_match_jax(spill, normalize, dtype):
    plans, rng = merged_target_plans(1 + spill, spill=spill)
    out_rows = 3 * 384
    a, b, cot = inputs(rng, out_rows, 12)
    t = plans.astuple()
    if normalize:
        scales = tuple(jnp.asarray(x) for x in t[10:13])
    else:
        scales = jps.pair_unit_scales(t, out_rows)
    want_out, (want_da, want_db) = run_jax(plans, a, b, cot, scales,
                                           out_rows, dtype)
    out, da, db = run_torch(plans, a, b, cot, normalize, out_rows, dtype)
    assert out.dtype == da.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(da.numpy(), np.asarray(want_da), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), **TOL)
    # Without gradients the op takes the eval forward (B6) and agrees.
    plan = tps.MergedPlan(*t, out_rows=out_rows).to("cpu")
    with torch.no_grad():
        eval_out = tpem.pair_relu_mlp_aggregate(
            as_torch(a), as_torch(b), plan,
            *(torch.from_numpy(np.array(s)) for s in scales),
            out_rows, stream_dtype=DTYPES[dtype][1])
    np.testing.assert_allclose(eval_out.numpy(), out.numpy(), **TOL)


def test_bf16_stream_returns_unrounded_f32_gradients():
    """The cast happens inside the op, so the f32 gradient is not rounded
    to bf16 on its way out: it has entries that no bf16 value holds."""
    plans, rng = merged_target_plans(4)
    out_rows = 3 * 384
    a, b, cot = inputs(rng, out_rows, 16)
    out, da, db = run_torch(plans, a, b, cot, True, out_rows, "bfloat16")
    for grad in (da, db):
        assert grad.dtype == torch.float32
        assert not torch.equal(grad, grad.to(torch.bfloat16).float())


def test_residency_gate_matches_jax():
    for rows_a, rows_b in ((24192, 24192), (24192, 40000), (50000, 1000),
                           (1152, 1152)):
        for jdt, tdt in DTYPES.values():
            assert (tpem.pair_edge_mlp_applicable(rows_a, rows_b, tdt)
                    == jpem.pair_edge_mlp_applicable(rows_a, rows_b, jdt))
