"""``pair_stream_joint_from_typed`` of the port against the JAX package's on
the CPU (both through their plain versions: the jnp twins in JAX, the
``index_add_`` versions in the port): forward output and table gradient,
normalized and unit scales, f32 and bf16 streams, and per-type plans with
genuinely spilled pairs (the overflow term and its transpose).

Tolerances: f32 streams rtol 1e-5 / atol 1e-5 (the same f32 products summed
in another order); bf16 streams rtol 2**-8 (one bf16 ulp) / atol 1e-5:
both frameworks round the same f32 tables (forward) and cotangents
(backward) to bf16 and accumulate in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import pair_spmm as jps
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


TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2.0 ** -8, atol=1e-5)}


def _random_edges(rng, num_types, v, avg_deg=6, clusters=True):
    """Random per-type edge lists (as tests/test_pair_spmm.py); with
    clusters=True, block-diagonal-ish like packed disconnected graphs."""
    srcs, tgts, counts = [], [], []
    for _ in range(num_types):
        e = rng.randint(v // 2, v * avg_deg)
        if clusters:
            centers = rng.randint(0, v, max(e // 50, 1))
            base = centers[rng.randint(0, len(centers), e)]
            src = np.clip(base + rng.randint(-64, 64, e), 0, v - 1)
            tgt = np.clip(base + rng.randint(-64, 64, e), 0, v - 1)
        else:
            src = rng.randint(0, v, e)
            tgt = rng.randint(0, v, e)
        budget = ((e + 63) // 64) * 64
        s = np.full((budget,), v - 1, np.int32)
        t = np.full((budget,), v - 1, np.int32)
        s[:e], t[:e] = src, tgt
        srcs.append(s)
        tgts.append(t)
        counts.append(e)
    return srcs, tgts, counts


def _typed_plans(mod, srcs, tgts, counts, v, spill):
    kwargs = dict(group_fwd=8, group_bwd=8)
    plans = []
    for t in range(len(srcs)):
        if spill:
            kwargs.update(chunk_budget_fwd=jps.GROUP,
                          chunk_budget_bwd=jps.GROUP,
                          overflow_budget=((counts[t] + 63) // 64) * 64)
        plans.append(mod.build_pair_plans([srcs[t]], [tgts[t]], [counts[t]],
                                          v, **kwargs).astuple())
    return tuple(plans)


def _jax_value_and_grad(tables, cot, plans, v, normalize, dtype):
    def f(t):
        out = jps.pair_stream_joint_from_typed(
            t.astype(dtype), plans, v, normalize)
        return jnp.vdot(out, cot), out

    (_, out), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(tables))
    return np.asarray(out), np.asarray(grad)


def _torch_value_and_grad(tables, cot, plans, v, normalize, dtype):
    t = torch.tensor(tables, requires_grad=True)
    out = tps.pair_stream_joint_from_typed(t, plans, v, normalize,
                                           stream_dtype=getattr(torch, dtype))
    torch.sum(out * torch.from_numpy(cot)).backward()
    assert out.dtype == torch.float32 and t.grad.dtype == torch.float32
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("spill", [False, True])
def test_joint_stream_matches_jax(spill, normalize, dtype):
    rng = np.random.RandomState(13 + 2 * spill + normalize)
    v, num_types, h = 384, 3, 24
    srcs, tgts, counts = _random_edges(rng, num_types, v, clusters=not spill)
    tables = rng.randn(num_types * v, h).astype(np.float32)
    cot = rng.randn(v, h).astype(np.float32)
    plans_j = _typed_plans(jps, srcs, tgts, counts, v, spill)
    plans_t = _typed_plans(tps, srcs, tgts, counts, v, spill)
    if spill:
        assert sum(int(np.sum(p[9] < v)) for p in plans_t) > 0

    out_j, grad_j = _jax_value_and_grad(tables, cot, plans_j, v, normalize,
                                        dtype)
    out_t, grad_t = _torch_value_and_grad(tables, cot, plans_t, v, normalize,
                                          dtype)
    np.testing.assert_allclose(out_t, out_j, **TOLS[dtype])
    np.testing.assert_allclose(grad_t, grad_j, **TOLS[dtype])


def test_plain_version_matches_dense_reference():
    """The plain version of both kernels against a dense numpy sum, per
    type and joint, on the streamed layout."""
    rng = np.random.RandomState(5)
    v, num_types, h = 256, 3, 8
    srcs, tgts, counts = _random_edges(rng, num_types, v)
    plans = _typed_plans(tps, srcs, tgts, counts, v, spill=False)
    plan = tps.stream_joint_plan(plans, v, v).to("cpu")
    tables = rng.randn(num_types * v, h).astype(np.float32)
    joint = np.zeros((v, h))
    per_type = np.zeros((num_types * v, h))
    for l in range(num_types):
        c = counts[l]
        rows = tables[l * v + srcs[l][:c]]
        np.add.at(joint, tgts[l][:c], rows)
        np.add.at(per_type, l * v + tgts[l][:c], rows)
    ones = torch.ones_like(plan.scale_fwd)
    out = tps.pair_spmm_stream_joint(
        torch.from_numpy(tables), ones, plan.rel_src_f, plan.rel_tgt_f,
        plan.src_blk_f, plan.grp_tgt_fl, plan.grp_type_f, v, v)
    np.testing.assert_allclose(out.numpy(), joint, rtol=1e-5, atol=1e-5)
    # Per-type (global output blocks) through the stream kernel's version.
    cat = tps.concat_typed_plans(plans, v, v, normalize=False)
    args = [torch.from_numpy(np.asarray(a)) for a in cat[:8]]
    out_g = tps.pair_spmm_stream(torch.from_numpy(tables), args[0], *args[3:8],
                                 v, num_types * v)
    np.testing.assert_allclose(out_g.numpy(), per_type, rtol=1e-5, atol=1e-5)
    assert tps.LAUNCHES == {"pair_stream": 0, "pair_stream_joint": 0,
                            "pair_spmm": 0, "node_rows": 0}
