"""The port's ordered sums (``tf2_gnn_tpu_torch/ops/segment.py::
SegmentOrder``, the CSR of ones that a batch builds once for each edge
array) against the ``index_add_`` form that the node-to-graph sums keep:
within f32 rounding, 1e-5 of each segment's sum of magnitudes, on the CPU
and (``cuda``-marked) on the card. Where JAX is installed, also against
``tf2_gnn_tpu.ops.segment.segment_sum`` on the same inputs; the module
itself imports no JAX, so the card's cases run where JAX is absent.
"""
import numpy as np
import pytest
import torch

from tf2_gnn_tpu_torch.ops import segment as tseg
from tf2_gnn_tpu_torch.utils import tracing

ORDER_RTOL = 1e-5


def _order_case(case: str, trailing=(5,), seed=2):
    """(data [M, *trailing] f32, ids [M] int32, segments) of ``case``."""
    rng = np.random.RandomState(seed)
    n = 9
    if case == "ragged":
        ids = rng.randint(0, n, 60)
    elif case == "empty_segments":
        ids = rng.choice([0, 3, 8], 40)
    elif case == "dropped_ids":
        ids = rng.randint(-4, n + 4, 60)
        ids[:3] = [-1, n, 2 ** 30]
    elif case == "padded_edges":
        ids = np.concatenate([rng.randint(0, n - 1, 50), np.full(14, n - 1)])
    elif case == "spmd_discard_row":
        # Local targets with the padded slots at the discard row n, summed
        # over n + 1 segments and the discard row sliced off afterwards.
        ids = np.concatenate([rng.randint(0, n, 50), np.full(10, n)])
        n = n + 1
    elif case == "no_entries":
        ids = np.zeros(0, np.int64)
    else:
        raise KeyError(case)
    data = rng.randn(ids.shape[0], *trailing).astype(np.float32)
    return torch.from_numpy(data), torch.from_numpy(ids.astype(np.int32)), n


ORDER_CASES = ["ragged", "empty_segments", "dropped_ids", "padded_edges",
               "spmd_discard_row", "no_entries"]


def _assert_within_magnitudes(got, data, ids, n):
    want = tseg.segment_sum(data.double(), ids, n)
    scale = tseg.segment_sum(data.double().abs(), ids, n)
    assert got.dtype == data.dtype and got.shape == want.shape
    assert torch.all((got.double() - want).abs()
                     <= ORDER_RTOL * scale + 1e-30)


@pytest.mark.parametrize("trailing", [(), (5,), (2, 3)],
                         ids=["M", "M_C", "M_K_D"])
@pytest.mark.parametrize("case", ORDER_CASES)
def test_ordered_sum_matches_index_add(case, trailing):
    data, ids, n = _order_case(case, trailing)
    order = tseg.SegmentOrder.build(ids, n)
    got = tseg.segment_sum(data, ids, n, order=order)
    _assert_within_magnitudes(got, data, ids, n)
    torch.testing.assert_close(got, tseg.segment_sum(data, ids, n),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ORDER_CASES)
def test_ordered_sum_matches_jax(case):
    """The ordered sum against the JAX package's ``segment_sum``, which
    drops the same out-of-range ids."""
    pytest.importorskip("jax")
    from tf2_gnn_tpu.ops import segment as jseg

    data, ids, n = _order_case(case, (2, 3))
    got = tseg.segment_sum(data, ids, n,
                           order=tseg.SegmentOrder.build(ids, n))
    want = np.asarray(jseg.segment_sum(data.numpy(), ids.numpy(), n))
    scale = tseg.segment_sum(data.double().abs(), ids, n).numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got.numpy().astype(np.float64) - want)
                  <= ORDER_RTOL * scale + 1e-30)


@pytest.mark.parametrize("case", ORDER_CASES)
def test_ordered_sum_gradient_matches_index_add(case):
    data, ids, n = _order_case(case)
    order = tseg.SegmentOrder.build(ids, n)
    g = torch.randn((n, data.shape[1]), generator=torch.Generator()
                    .manual_seed(3))
    leaf = data.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(
        (tseg.segment_sum(leaf, ids, n, order=order) * g).sum(), leaf)
    (want,) = torch.autograd.grad(
        (tseg.segment_sum(leaf, ids, n) * g).sum(), leaf)
    assert torch.equal(got, want)
    dropped = (ids < 0) | (ids >= n)
    assert torch.all(got[dropped] == 0)


@pytest.mark.parametrize("name", ["sum", "mean", "max", "sqrt_n"])
@pytest.mark.parametrize("case", ["ragged", "empty_segments",
                                  "dropped_ids"])
def test_aggregations_over_an_order_match_their_scatter_form(name, case):
    data, ids, n = _order_case(case)
    fn = tseg.get_aggregation_function(name)
    order = tseg.SegmentOrder.build(ids, n)
    torch.testing.assert_close(fn(data, ids, n, order=order),
                               fn(data, ids, n), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        tseg.segment_count(ids, n, order=order), tseg.segment_count(ids, n),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "dropped_ids"])
def test_gather_rows_backward_over_an_order(case, dtype):
    """The gather's gradient summed over the indices' order against its
    index_add_ form: out-of-range indices clamp forward and drop backward,
    and a bf16 cotangent sums in f32, rounded once."""
    _, ids, n = _order_case(case)
    gen = torch.Generator().manual_seed(4)
    table = torch.randn((n, 6), generator=gen).to(dtype).requires_grad_(True)
    cot = torch.randn((ids.shape[0], 6), generator=gen).to(dtype)
    order = tseg.SegmentOrder.build(ids, n)
    out = tseg.gather_rows(table, ids, order)
    assert torch.equal(out, tseg.gather_rows(table, ids))
    (got,) = torch.autograd.grad((out.float() * cot.float()).sum(), table)
    (want,) = torch.autograd.grad(
        (tseg.gather_rows(table, ids).float() * cot.float()).sum(), table)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_ordered_sum_refuses_another_shape_and_counts():
    data, ids, n = _order_case("ragged")
    tracing.reset()
    order = tseg.SegmentOrder.build(ids, n)
    with pytest.raises(ValueError):
        tseg.segment_sum(data, ids, n + 1, order=order)
    with pytest.raises(ValueError):
        tseg.segment_sum(data[:-1], ids[:-1], n, order=order)
    tseg.segment_sum(data, ids, n, order=order)
    tseg.segment_mean(data, ids, n, order=order)
    tseg.segment_sum(data, ids, n)
    assert tracing.counters("segment") == {
        "order.build": 1, "sum.ordered": 2, "sum.scatter": 1}


@pytest.mark.parametrize("seed", [2, 3, 7])
def test_ordered_sum_over_a_pad_row_layout(seed):
    """A batch's pad-row layout (real segments, a stretch of empty ones,
    then one segment holding a fifth of the entries, and a few dropped
    ids): the sum within f32 rounding of the index_add_ form, and the
    order's CSR of ones holding each segment's entries in their order,
    the dropped ones in the discard row, with int32 indices (12 bytes an
    entry)."""
    rng = np.random.RandomState(seed)
    n, real = 60, 40
    ids = np.concatenate([rng.randint(0, real, 300), np.full(80, n - 1),
                          rng.randint(-2, 0, 5)])
    ids = torch.from_numpy(rng.permutation(ids).astype(np.int32))
    data = torch.from_numpy(rng.randn(ids.shape[0], 4).astype(np.float32))
    order = tseg.SegmentOrder.build(ids, n)
    _assert_within_magnitudes(
        tseg.segment_sum(data, ids, n, order=order), data, ids, n)
    rows = order.matrix.crow_indices()
    cols = order.matrix.col_indices()
    assert rows.dtype == cols.dtype == order.ids.dtype == torch.int32
    assert torch.equal(rows.diff()[:n].float(), tseg.segment_count(ids, n))
    assert int(rows[-1] - rows[-2]) == 5
    for s in (0, real - 1, n - 1, n):
        run = cols[int(rows[s]):int(rows[s + 1])]
        assert torch.all(run.diff() > 0)
        assert torch.all(order.ids[run.long()] == s)
    entry_bytes = sum(t.numel() * t.element_size() for t in (
        order.ids, cols, order.matrix.values()))
    assert entry_bytes == 12 * ids.shape[0]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "dropped_ids", "discard_row",
                                  "no_entries", "ppi_rows"])
def test_ordered_sums_on_card_match_index_add(device, case):
    """The ordered sum on the card against ``index_add_`` within 1e-5 of
    each segment's sum of magnitudes, its gradient and a gather's backward
    against their index_add_ forms."""
    gen = torch.Generator(device=device).manual_seed(5)
    n, m, h = 517, 9000, 100
    ids = torch.randint(0, n, (m,), generator=gen, device=device)
    if case == "dropped_ids":
        ids[:50] = torch.randint(-9, 0, (50,), generator=gen, device=device)
        ids[50:100] = n + 3
    elif case == "discard_row":
        ids[-500:] = n
        n += 1
    elif case == "no_entries":
        ids = ids[:0]
    elif case == "ppi_rows":
        # Segments of about 29 rows of 320 columns, as the PPI batch's.
        n, h = 4096, 320
        ids = torch.randint(0, n, (29 * n,), generator=gen, device=device)
    ids = ids.to(torch.int32)
    data = torch.randn((ids.shape[0], h), generator=gen, device=device)
    order = tseg.SegmentOrder.build(ids, n)
    leaf = data.clone().requires_grad_(True)
    got = tseg.segment_sum(leaf, ids, n, order=order)
    want = tseg.segment_sum(data.double(), ids, n)
    scale = tseg.segment_sum(data.double().abs(), ids, n)
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-30)
    g = torch.randn(got.shape, generator=gen, device=device)
    (d_got,) = torch.autograd.grad((got * g).sum(), leaf)
    leaf2 = data.clone().requires_grad_(True)
    (d_want,) = torch.autograd.grad(
        (tseg.segment_sum(leaf2, ids, n) * g).sum(), leaf2)
    assert torch.equal(d_got, d_want)

    table = torch.randn((n, h), generator=gen, device=device)
    table = table.to(torch.bfloat16).requires_grad_(True)
    cot = torch.randn((ids.shape[0], h), generator=gen, device=device)

    def gather_grad(order):
        out = tseg.gather_rows(table, ids, order).float()
        return torch.autograd.grad((out * cot).sum(), table)[0]

    torch.testing.assert_close(gather_grad(order), gather_grad(None),
                               rtol=1e-2, atol=1e-4)
