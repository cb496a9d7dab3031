"""The dual scatter plan of one edge type and ``gather_scatter_sorted``
(``ops/sorted_spmm.py``) against the JAX package's
(``spmm_pallas.py::build_dual_plans``, ``gather_scatter_sorted``, run in
its interpret mode) on the CPU.

* ``build_dual_plans`` is array-identical to the JAX planner's, on the C++
  engine and on the numpy forms, with and without padded edge slots.
* ``gather_scatter_sorted`` (B12 both ways; on the CPU its plain version)
  gives the JAX op's sums and table gradient: f32 tables at rtol 1e-5 /
  atol 1e-5 (the same f32 products summed in other orders), bf16 tables
  at rtol 1e-5 / atol 1e-4 (both sum the bf16 rows in f32); the table
  gradient leaves in f32, unrounded, as the JAX op's does.
* It counts no kernel launch on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.ops import spmm_pallas as jsp
from tf2_gnn_tpu_torch import native
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss
from tf2_gnn_tpu_torch.utils import tracing


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edges(seed, v=256, num_edges=2000, budget=2048):
    """Random edges padded to ``budget`` slots with pad-row edges."""
    rng = np.random.RandomState(seed)
    src = np.full((budget,), v - 1, np.int32)
    tgt = np.full((budget,), v - 1, np.int32)
    src[:num_edges] = rng.randint(0, v - 1, num_edges)
    tgt[:num_edges] = rng.randint(0, v - 1, num_edges)
    return src, tgt


@pytest.mark.parametrize("numpy_forms", [False, True])
@pytest.mark.parametrize("seed,num_edges", [(3, 2000), (4, 0), (5, 700)])
def test_dual_plans_array_identical(seed, num_edges, numpy_forms):
    v = 256
    src, tgt = _edges(seed, v, num_edges)
    chunks = tss.plan_chunk_budget(src.shape[0], v)
    want = jsp.build_dual_plans(src, tgt, num_edges, v, chunks).astuple()
    if numpy_forms:
        with native.numpy_forms():
            got = tss.build_dual_plans(src, tgt, num_edges, v, chunks)
    else:
        got = tss.build_dual_plans(src, tgt, num_edges, v, chunks)
    assert len(got.astuple()) == len(want) == 6
    for name, a, b in zip(tss.EdgeScatterPlan._fields, got.astuple(), want):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_scatter_sorted_matches_jax(dtype):
    v, h, num_edges = 256, 48, 2000
    src, tgt = _edges(6, v, num_edges)
    chunks = tss.plan_chunk_budget(src.shape[0], v)
    host = tss.build_dual_plans(src, tgt, num_edges, v, chunks)
    rng = np.random.RandomState(7)
    table = rng.randn(v, h).astype(np.float32)
    cot = rng.randn(v, h).astype(np.float32)

    plan_j = tuple(jnp.asarray(a) for a in host.astuple())
    jdtype = jnp.dtype(dtype)

    def jloss(t):
        out = jsp.gather_scatter_sorted(t.astype(jdtype), *plan_j, v, True)
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(table))

    plan = tss.DualScatterPlan.from_host(host, v).to("cpu")
    tracing.reset()
    t = torch.tensor(table, requires_grad=True)
    out = tss.gather_scatter_sorted(t, plan, getattr(torch, dtype))
    (out * torch.tensor(cot)).sum().backward()
    assert out.dtype == torch.float32
    assert sum(tss.LAUNCHES.values()) == 0
    atol = 1e-5 if dtype == "float32" else 1e-4
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=atol)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=atol)
