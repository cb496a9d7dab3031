"""``TypedLinear``'s all-types form (x [V, D] against the stacked [L, D, H]
kernel) on the CPU: the same output and gradients as ``torch.matmul``, no
copy of an [L, V, H]- or [L, H, V]-sized table in either direction (the
copies of ``torch.matmul``'s fold), and the ``typed_linear.shared_input``
counter, once a layer in a train step and never in the other forms (nor
where the pair-joint route's tables hold only the rows its plan reads).

Tolerances: f32 within 1e-6 of the largest entry (the same products, f32
sums in other orders); bf16 operands bit-equal to the rounded ones, the
output as f32, and the gradients, rounded to bf16 from f32 sums in other
orders, within one bf16 step (2**-7 relative).
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tf2_gnn_tpu_torch.data import DataFold
from tf2_gnn_tpu_torch.data.ppi_dataset import PPIDataset
from tf2_gnn_tpu_torch.harness import training
from tf2_gnn_tpu_torch.layers.message_passing import gnn_edge_mlp
from tf2_gnn_tpu_torch.layers.message_passing.typed_linear import (
    TypedLinear,
    _rounded,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.utils import tracing
from tf2_gnn_tpu_torch.workloads import write_ppi_dataset

LAYERS = 2
COPIES = ("aten::clone", "aten::copy_")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layer(num_types, d, h, compute_dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    layer = TypedLinear(num_types, d, h, compute_dtype=compute_dtype)
    with torch.no_grad():
        layer.kernel.copy_(torch.randn(layer.kernel.shape, generator=gen))
    x = torch.randn((57, d), generator=gen).requires_grad_(True)
    g = torch.randn((num_types, 57, h), generator=gen)
    return layer, x, g


def _close(got, want, rtol):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", [(19, 23), (40, 24)])
@pytest.mark.parametrize("num_types", [1, 3, 5])
def test_all_types_matches_matmul(num_types, d, h, compute_dtype):
    layer, x, g = _layer(num_types, d, h, compute_dtype)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = layer(x)
    y.backward(g)
    got = (y.detach(), x.grad.clone(), layer.kernel.grad.clone())
    assert y.shape == (num_types, 57, h) and y.is_contiguous()

    x.grad = layer.kernel.grad = None
    x_r = _rounded(x, layer.operand_dtype)
    kernel_r = _rounded(layer.kernel, layer.operand_dtype)
    want_y = torch.matmul(x_r, kernel_r)
    want_y.backward(g)
    want = (want_y.detach(), x.grad, layer.kernel.grad)

    if compute_dtype == "bfloat16":
        # The product's operands are the rounded ones, bit for bit.
        assert any(t.shape == x.shape and torch.equal(t, x_r)
                   for t in saved)
        assert any(t.shape == layer.kernel.shape and torch.equal(t, kernel_r)
                   for t in saved)
        assert not torch.equal(x_r, x.detach())
    _close(got[0], want[0], 1e-6)
    grad_rtol = 1e-6 if compute_dtype == "float32" else 2.0 ** -7
    _close(got[1], want[1], grad_rtol)
    _close(got[2], want[2], grad_rtol)


def _table_copies(run, num_types, v, h):
    """The copy ops of ``run`` (forward and backward) with an operand of
    [L, V, H] or [L, H, V]."""
    tables = ([num_types, v, h], [num_types, h, v])
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        run()
    return [(e.name, e.input_shapes) for e in prof.events()
            if e.name in COPIES
            and any(list(s) in tables for s in e.input_shapes)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_all_types_copies_no_table(compute_dtype):
    num_types, d, h = 3, 24, 40
    layer, x, g = _layer(num_types, d, h, compute_dtype)

    def new():
        layer(x).backward(g)

    def fold():
        torch.matmul(_rounded(x, layer.operand_dtype),
                     _rounded(layer.kernel, layer.operand_dtype)).backward(g)

    assert _table_copies(new, num_types, 57, h) == []
    # The check sees the fold's copies: one each way.
    names = sorted(n for n, _ in _table_copies(fold, num_types, 57, h))
    assert names.count("aten::clone") == 2


@pytest.fixture(scope="module")
def ppi_path(tmp_path_factory):
    return write_ppi_dataset(tmp_path_factory.mktemp("ppi"),
                             graphs_per_fold=3, nodes_per_graph=40,
                             feature_dim=5)


@pytest.mark.parametrize("plans,gate", [(True, 0.0), (False, None),
                                        (True, None)],
                         ids=["planned", "unfused", "planned_read_rows"])
def test_a_train_step_counts_one_shared_input_a_layer(plans, gate, ppi_path,
                                                      monkeypatch):
    """The all-types form once a layer in a train step, on the pair-joint
    route over full tables (``COMPACT_TABLES_BELOW`` at 0) and on the
    unfused route; where the pair-joint route's tables hold only the rows
    the plan reads (this batch's, at the shipped gate), never: its rows
    form is counted as ``pair_tables.rows_computed`` instead."""
    if gate is not None:
        monkeypatch.setattr(gnn_edge_mlp, "COMPACT_TABLES_BELOW", gate)
    params = {**PPIDataset.get_default_hyperparameters(),
              "max_nodes_per_batch": 400, "use_pair_spmm": plans,
              "pair_per_type": True}
    dataset = PPIDataset(params, rng=np.random.RandomState(0))
    dataset.load_data(ppi_path)
    model_params = NodeMulticlassTask.get_default_hyperparameters("rgcn")
    model_params.update({"gnn_hidden_dim": 16, "gnn_num_layers": LAYERS})
    model = NodeMulticlassTask.from_dataset(model_params, dataset,
                                            device="cpu", seed=1)
    host = next(iter(dataset.batch_iterator(DataFold.TRAIN)))
    batch, labels = training.to_device(*host, "cpu")
    state, train_step, _ = training.build_training(model, model_params,
                                                   seed=0)
    tracing.reset()
    try:
        with tracing.enabled():
            train_step(state, batch, labels)
        read_rows = plans and gate is None
        assert tracing.counters("typed_linear") == (
            {} if read_rows else {"shared_input": LAYERS})
        rows = tracing.counters("pair_tables")
        if plans:
            assert rows["rows_full"] == LAYERS * 3 * batch.num_nodes_padded
            assert (rows["rows_computed"] < rows["rows_full"]) == read_rows
        else:
            assert rows == {}
    finally:
        tracing.drain()
        tracing.reset()


def test_other_forms_count_no_shared_input():
    layer, x, g = _layer(3, 19, 23, "float32")
    tracing.reset()
    layer(x.detach().expand(3, -1, -1)).backward(g)
    layer(x, edge_type=1).sum().backward()
    assert tracing.counters("typed_linear") == {}
    layer(x)
    assert tracing.counters("typed_linear") == {"shared_input": 1}
    tracing.reset()
