"""The port of the JAX repo's design probes (``benchmarks/pair_probe.py``,
``benchmarks/dyngather_probe.py``) on the CPU:

* ``plan_block_pairs`` and ``regroup_for_unroll`` are array-identical to
  the probe's on the PPI edges of ``workloads.build_raw_arrays(0)`` merged
  over 3 types (211,200 edges over 24,192 source rows: 2384 chunks, and
  2656 chunks in 332 groups of 8), and on a graph with repeated edges;
* P1 and P2 (``pair_spmm_unrolled`` / ``pair_spmm_chunked``, B3's plain
  version on a CPU tensor) equal the probe's own check, ``np.add.at`` of
  the f32 table rows, on a subset of those edges (rtol 1e-5 / atol 1e-5:
  the same f32 sums in another order);
* P3's plain version equals a jnp loop of ``take_along_axis`` over the
  shifts, the probe kernel's body (the probe passes no ``interpret``, so
  its kernel cannot run here), exactly, in f32 and bf16;
* P3's plain version also with no shift and with more shifts than rows;
* P3's form on the card, a function of the table's shape and dtype:
  strips of 16 bytes at the probe's shape, narrower strips where a
  16-byte one exceeds a block's shared memory or the table's columns,
  the global form where a one-column strip does not fit;
* ``tools/dyngather_variants.py`` edits the shipped source's threads a
  block into each variant's copy, and times the shipped strip widths;
* the wrappers take the plain versions on CPU tensors and count no
  launch, and refuse a plan of the other group.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import pair_probe
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.ops import cuda_build, probes
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.tools import dyngather_variants


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


V = workloads.NODE_BUDGET


@pytest.fixture(scope="module")
def ppi_edges():
    """The probe's edge list: every real edge of the PPI batch, sources in
    the merged ``l * V + u`` row space."""
    _, adjacency, _ = workloads.build_raw_arrays(0)
    srcs = np.concatenate([a[:, 0].astype(np.int64) + l * V
                           for l, a in enumerate(adjacency)])
    tgts = np.concatenate([a[:, 1] for a in adjacency])
    return srcs, tgts


def _assert_arrays_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"array {i}")


def test_plans_are_the_probe_plans(ppi_edges):
    srcs, tgts = ppi_edges
    assert srcs.shape == (211200,)
    got = probes.plan_block_pairs(srcs, tgts, 3 * V, V)
    want = pair_probe.plan_block_pairs(srcs, tgts, 3 * V, V)
    _assert_arrays_equal(got, want)
    assert got[0].shape == (2384, 128)
    regrouped = probes.regroup_for_unroll(*got, group=8)
    _assert_arrays_equal(regrouped, pair_probe.regroup_for_unroll(*want,
                                                                  group=8))
    assert regrouped[0].shape == (2656, 128) and regrouped[5].shape == (332,)
    p1 = probes.unrolled_plan(srcs, tgts, 3 * V, V)
    p2 = probes.chunked_plan(srcs, tgts, 3 * V, V)
    assert (p1.group, p2.group) == (8, 1)
    np.testing.assert_array_equal(p1.grp_tgt, regrouped[4][::8])
    np.testing.assert_array_equal(p2.grp_tgt, got[4])


@pytest.mark.parametrize("group", [1, 4, 8])
def test_plans_with_repeated_edges_match_the_probe(group):
    """Repeated (target, source) pairs and pairs of more than 128 edges."""
    rng = np.random.RandomState(group)
    v = 384
    srcs = np.concatenate([rng.randint(0, 2 * v, 900), np.full(300, 5)])
    tgts = np.concatenate([rng.randint(0, v, 900), np.full(300, 7)])
    got = probes.plan_block_pairs(srcs, tgts, 2 * v, v)
    want = pair_probe.plan_block_pairs(srcs, tgts, 2 * v, v)
    _assert_arrays_equal(got, want)
    _assert_arrays_equal(probes.regroup_for_unroll(*got, group=group),
                         pair_probe.regroup_for_unroll(*want, group=group))


@pytest.mark.parametrize("form", ["unrolled", "chunked"])
def test_p1_p2_plain_path_matches_the_probe_check(ppi_edges, form):
    srcs, tgts = ppi_edges
    keep = np.arange(srcs.shape[0]) % 7 == 0
    srcs, tgts = srcs[keep], tgts[keep]
    rng = np.random.RandomState(0)
    table = torch.from_numpy(rng.randn(3 * V, 48).astype(np.float32)
                             ).to(torch.bfloat16)
    ref = np.zeros((V, 48), np.float32)
    np.add.at(ref, tgts, table.float().numpy()[srcs])
    before = (dict(tps.LAUNCHES), dict(probes.LAUNCHES))
    if form == "unrolled":
        plan = probes.unrolled_plan(srcs, tgts, 3 * V, V).to("cpu")
        out = probes.pair_spmm_unrolled(table, plan, V)
    else:
        plan = probes.chunked_plan(srcs, tgts, 3 * V, V).to("cpu")
        out = probes.pair_spmm_chunked(table, plan, V)
    assert (dict(tps.LAUNCHES), dict(probes.LAUNCHES)) == before
    assert out.dtype == torch.float32 and tuple(out.shape) == (V, 48)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, tps.pair_spmm_plain(table, *plan.kernel_args, V))


def test_probe_wrappers_refuse_the_other_group(ppi_edges):
    srcs, tgts = ppi_edges
    table = torch.zeros((3 * V, 4))
    chunked = probes.chunked_plan(srcs[:500], tgts[:500], 3 * V, V).to("cpu")
    unrolled = probes.unrolled_plan(srcs[:500], tgts[:500], 3 * V,
                                    V).to("cpu")
    with pytest.raises(ValueError, match="expected 8"):
        probes.pair_spmm_unrolled(table, chunked, V)
    with pytest.raises(ValueError, match="expected 1"):
        probes.pair_spmm_chunked(table, unrolled, V)


def _probe_body(table, idx, reps):
    """The probe kernel's body, step by step in jnp: ``idx = (idx + c) %
    R``, ``take_along_axis`` over axis 0, added in f32 into the output
    (from zeros here)."""
    rows = table.shape[0]
    out = jnp.zeros(table.shape, jnp.float32)
    for c in range(reps):
        g = jnp.take_along_axis(table, (idx + c) % rows, axis=0)
        out = out + g.astype(jnp.float32)
    return np.asarray(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols,reps", [(256, 128, 8), (96, 20, 5),
                                            (96, 20, 0), (96, 20, 200)])
def test_dyngather_plain_matches_the_probe_body(dtype, rows, cols, reps):
    rng = np.random.RandomState(rows + reps)
    table32 = rng.randn(rows, cols).astype(np.float32)
    idx = rng.randint(0, rows, (rows, cols)).astype(np.int32)
    jtable = jnp.asarray(table32).astype(jnp.dtype(dtype))
    ttable = torch.from_numpy(table32).to(getattr(torch, dtype))
    want = _probe_body(jtable, jnp.asarray(idx), reps)
    before = dict(probes.LAUNCHES)
    got = probes.dyngather(ttable, torch.from_numpy(idx), reps)
    assert probes.LAUNCHES == before
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, probes.dyngather_plain(
        ttable, torch.from_numpy(idx), reps))


def test_dyngather_wraps_negative_and_large_indices():
    """Floor modulo, as the reference's ``%`` on int32."""
    table = torch.arange(12.0).reshape(6, 2)
    idx = torch.tensor([[-1, 7], [0, -13], [5, 6], [-6, 11], [2, 3], [0, 0]],
                       dtype=torch.int32)
    got = probes.dyngather(table, idx, 3)
    want = _probe_body(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()),
                       3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,cols,dtype,width", [
    (8192, 128, torch.float32, 4),      # the probe's shape
    (8192, 128, torch.bfloat16, 8),
    (40000, 6, torch.float32, 1),       # 16-byte strips do not fit
    (40000, 6, torch.bfloat16, 2),
    (58112, 4, torch.float32, 1),       # the largest one-column strips
    (116224, 4, torch.bfloat16, 1),
    (100, 2, torch.float32, 2),         # tables narrower than a strip
    (100, 3, torch.float32, 4),
    (100, 1, torch.bfloat16, 1),
    (58113, 4, torch.float32, 0),       # one column past the limit
    (65536, 4, torch.float32, 0),
    (116225, 4, torch.bfloat16, 0)])
def test_dyngather_form(rows, cols, dtype, width):
    assert probes.strip_cols(rows, cols, dtype) == width
    assert probes.dyngather_form(rows, cols, dtype) == (
        "shared" if width else "global")
    if width:
        assert rows * width * dtype.itemsize <= probes.MAX_STRIP_BYTES
    else:
        assert rows * dtype.itemsize > probes.MAX_STRIP_BYTES


@pytest.mark.parametrize("threads", dyngather_variants.THREADS)
def test_dyngather_variants_set_the_threads(threads, tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build" / "lib")
    root = dyngather_variants._variant_csrc(
        cuda_build, cuda_build.CSRC_DIR, f"threads {threads}",
        dyngather_variants.thread_edits(threads), dyngather_variants.SOURCE)
    text = (root / dyngather_variants.SOURCE).read_text()
    assert f"constexpr int SHARED_THREADS = {threads};" in text
    assert text.count("constexpr int SHARED_THREADS") == 1
    assert dyngather_variants.SHIPPED_THREADS in dyngather_variants.THREADS
    for dtype, width in probes.STRIP_COLS.items():
        assert width in dyngather_variants.WIDTHS[str(dtype).split(".")[1]]
