"""The port's unfused per-edge path against the JAX package's on the CPU.

Where the reference's ``_fused_sum_aggregate`` returns None (a batch
without plans, an aggregation other than sum, the activation before the
aggregation, a target-state edge MLP with two or more hidden layers, or
GNN-FiLM's target-state input with hidden edge-MLP layers), both packages
compute each edge's message and aggregate with a segment op. Each model
case runs the JAX model and the port's, from weights bridged out of the
flax params, every dropout at 0, 2 layers of hidden 16, on
``small_workload``'s PPI-shaped batch with every plan stripped (a few
cases keep per-type plans that the options send off the fused routes),
or, for the shipped GraphRegression_GNN_Edge_MLP, on the small QM9 batch
of ``test_torch_graph_tasks.py`` without its plans. It compares logits,
loss and every parameter's gradient, checks with a spy on the JAX
flavour's ``_compute_messages_per_type`` that the reference took its
unfused path, and that every port layer's ``_route`` names ``"unfused"``.
The new segment ops are held against ``tf2_gnn_tpu/ops/segment.py``
directly, and the strict bridge against the parameter layouts that this
path opens.

Tolerances are ``test_torch_flavours.py``'s: f32 edge streams rtol 1e-4 /
atol 1e-5 on everything; bf16 streams rtol 2e-3 / atol 1e-4 on the loss,
logits at ``BF16_LOGIT_ATOL`` (observed up to 1.7e-3, the shipped GGNN's
unnormalised sums, as on its fused route). bf16 gradients are held to a
share of each tensor's largest |entry|, ``BF16_UNFUSED_GRAD_SHARE`` =
2**-7 (observed up to 4.1e-3 of it, PPI_GGNN): the reference's gather
gradient is an XLA scatter-add of the bf16 cotangent, which rounds to
bf16 at every add, where the port's sums in f32 and rounds once
(``ops/segment.py::gather_rows``). With the reference's backward summing
in f32 too, the same cases differ by at most 8.5e-4 of the largest
entry; the f32 cases by at most 2.1e-6 of it.
"""
import dataclasses
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.layers.message_passing import base as jbase
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu.ops import segment as jseg
from tf2_gnn_tpu_torch.harness.import_jax import (
    flax_params_to_state_dict,
    load_flax_params,
)
from tf2_gnn_tpu_torch.ops import segment as tseg
from tf2_gnn_tpu_torch.utils.constants import SMALL_NUMBER

from .test_torch_flavours import assert_matches_jax
from .test_torch_flavours import build_pair as build_node_pair
from .test_torch_graph_tasks import F32_TOL, LOSS_RTOL, qm9_workload
from .test_torch_graph_tasks import build_pair as build_task_pair
from .test_torch_graph_tasks import edge_mlp_task_params
from .test_torch_rgcn_model import small_workload


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
BF16_UNFUSED_GRAD_SHARE = 2.0 ** -7
SHIPPED = {"rgcn": "PPI_RGCN.json", "ggnn": "PPI_GGNN.json",
           "rgin": "PPI_RGIN.json", "rgat": "PPI_RGAT.json",
           "gnn_edge_mlp": "PPI_GNN_Edge_MLP.json",
           "gnn_film": "PPI_GNN_FiLM.json"}
BEFORE = {"gnn_message_activation_before_aggregation": True}

# case: (style, shipped file or None for the JAX package's defaults,
# overrides, the batch's plans: None, or "typed" for per-type plans that
# the options send off the fused routes)
CASES = {
    **{f"{style}_shipped": (style, SHIPPED[style], {}, None)
       for style in SHIPPED},
    "edge_mlp_reference_default": ("gnn_edge_mlp", None, {}, None),
    # The probe's bf16 edge stream, which the target-state per-edge chain
    # ignores in both packages.
    "edge_mlp_reference_default_bf16": ("gnn_edge_mlp", None,
                                        {"gnn_edge_dtype": "bfloat16"},
                                        None),
    "edge_mlp_target_2_hidden": ("gnn_edge_mlp", SHIPPED["gnn_edge_mlp"],
                                 {"gnn_num_edge_MLP_hidden_layers": 2},
                                 None),
    "film_target_1_hidden": ("gnn_film", SHIPPED["gnn_film"],
                             {"gnn_num_edge_MLP_hidden_layers": 1}, None),
    **{f"{style}_{aggr}": (style, SHIPPED[style],
                           {"gnn_aggregation_function": aggr}, None)
       for style in ("rgcn", "rgin") for aggr in ("mean", "max", "sqrt_n")},
    "rgcn_activation_before": ("rgcn", SHIPPED["rgcn"], BEFORE, None),
    "edge_mlp_target_activation_before": (
        "gnn_edge_mlp", SHIPPED["gnn_edge_mlp"], BEFORE, None),
    # relu messages before a max tie at 0 on many targets.
    "rgcn_relu_before_max_f32": ("rgcn", SHIPPED["rgcn"], dict(
        BEFORE, gnn_aggregation_function="max",
        gnn_edge_dtype="float32"), None),
    # Plans on the batch, options off the fused routes.
    "rgcn_mean_on_per_type_plans": ("rgcn", SHIPPED["rgcn"],
                                    {"gnn_aggregation_function": "mean"},
                                    "typed"),
    "rgat_activation_before_on_per_type_plans": ("rgat", SHIPPED["rgat"],
                                                 BEFORE, "typed"),
    "film_target_1_hidden_on_per_type_plans": (
        "gnn_film", SHIPPED["gnn_film"],
        {"gnn_num_edge_MLP_hidden_layers": 1}, "typed"),
}


def case_params(case: str):
    """The case's configuration over the JAX package's defaults, cut to 2
    layers of hidden 16, dropout 0."""
    style, shipped, overrides, _ = CASES[case]
    params = JaxNodeMulticlassTask.get_default_hyperparameters(style)
    if shipped:
        params.update(json.loads(
            (REPO / "tf2_gnn_tpu" / "harness" / "default_hypers" / shipped)
            .read_text())["model_params"])
    params.update({"gnn_num_layers": 2, "gnn_hidden_dim": 16,
                   "gnn_layer_input_dropout_rate": 0.0})
    params.update(overrides)
    return params


@pytest.fixture(scope="module")
def workloads_by_plans():
    """``small_workload``'s batch with per-type plans and bare."""
    jbatch, tbatch, labels = small_workload(seed=17)
    return {"typed": (jbatch, tbatch, labels),
            None: (jbatch.replace(pair_plans_typed=None),
                   tbatch.replace(pair_plans_typed=None), labels)}


@pytest.fixture
def spy_jax_unfused(monkeypatch):
    """``spy(style)`` wraps the JAX flavour's ``_compute_messages_per_type``
    (the reference's unfused path) and returns the list its calls fill."""
    def spy(style):
        cls = jbase.get_message_passing_class(style)
        real = cls._compute_messages_per_type
        calls = []

        def wrapper(self, *args, **kwargs):
            calls.append(style)
            return real(self, *args, **kwargs)
        monkeypatch.setattr(cls, "_compute_messages_per_type", wrapper)
        return calls
    return spy


def assert_layers_unfused(layers, batch, num_layers: int):
    for i in range(num_layers):
        assert getattr(layers, f"mp_layer_{i}")._route(batch) == "unfused"


@pytest.mark.parametrize("case", list(CASES))
def test_unfused_path_matches_jax(case, workloads_by_plans, spy_jax_unfused):
    style, _, _, plans = CASES[case]
    params = case_params(case)
    jbatch, tbatch, labels = workloads_by_plans[plans]
    calls = spy_jax_unfused(style)
    tmodel = assert_matches_jax(params, jbatch, tbatch, labels,
                                grad_share=BF16_UNFUSED_GRAD_SHARE)
    # init and the differentiated apply each run every layer unfused.
    assert calls == [style] * (2 * params["gnn_num_layers"])
    assert_layers_unfused(tmodel.gnn, tbatch, params["gnn_num_layers"])


@pytest.mark.parametrize("case", ["edge_mlp_target_2_hidden", "rgat_shipped"])
def test_per_edge_chains_ignore_the_edge_dtype(case, workloads_by_plans):
    """The target-state per-edge chain and RGAT's per-edge path stay f32
    whatever ``edge_dtype`` says (reference gnn_edge_mlp.py:88-120,
    rgat.py:309-376): the same weights give the same bits in f32 and
    bf16."""
    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )

    _, bare, _ = workloads_by_plans[None]
    outs = []
    for edge_dtype in ("float32", "bfloat16"):
        model = NodeMulticlassTask.from_params(
            dict(case_params(case), gnn_edge_dtype=edge_dtype),
            input_dim=bare.node_features.shape[1], num_edge_types=3,
            device="cpu", num_labels=7)
        with torch.no_grad():
            outs.append(model(bare, False)[0])
    assert torch.equal(*outs)


def test_graph_regression_edge_mlp_on_the_bare_qm9_batch(spy_jax_unfused):
    """The shipped GraphRegression_GNN_Edge_MLP (0-hidden target-state
    input, gelu, LayerNorm, f32) at 2 layers of hidden 16 on the QM9 batch
    without plans, its dataset default."""
    jbatch, tbatch, labels = qm9_workload(seed=2)
    jbatch = jbatch.replace(pair_plans_typed=None)
    tbatch = tbatch.replace(pair_plans_typed=None)
    params = edge_mlp_task_params(gnn_num_layers=2, gnn_hidden_dim=16)
    task = "graph_regression-gnn_edge_mlp"
    calls = spy_jax_unfused("gnn_edge_mlp")
    jmodel, jparams, tmodel = build_task_pair(task, params, jbatch)
    target = labels["regression"]

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        metrics = jmodel.compute_task_metrics(
            jbatch, out, {"target_value": jnp.asarray(target)})
        return metrics["loss"], out

    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    out = tmodel(tbatch, False)
    loss = tmodel.compute_task_metrics(
        tbatch, out, {"target_value": torch.from_numpy(target)})["loss"]
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **F32_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        # A parameter the output does not reach (the last layer's
        # LayerNorm, under the intermediate readout) has no gradient here
        # and a zero one in the reference.
        mine = got[name].grad
        mine = np.zeros_like(grad.numpy()) if mine is None else mine.numpy()
        np.testing.assert_allclose(mine, grad.numpy(), err_msg=name,
                                   **F32_TOL)
    assert calls == ["gnn_edge_mlp"] * 4
    assert_layers_unfused(tmodel.gnn, tbatch, 2)


# ---------------------------------------------------------------- segment ops
NUM_SEGMENTS = 9


def _segment_case(trailing, seed=0):
    """40 rows over segments 0-5 (6-8 empty) and one id past the end,
    which both packages drop; weights of a scalar loss over the output."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 6, 40).astype(np.int32)
    ids[7] = NUM_SEGMENTS
    data = rng.randn(40, *trailing).astype(np.float32)
    weights = rng.randn(NUM_SEGMENTS, *trailing).astype(np.float32)
    return ids, data, weights


def _value_and_grad(jfn, tfn, ids, data, weights, prep=None):
    """Each package's output and the gradient of sum(output * weights)
    with respect to ``data`` (through ``prep`` first, if given); an
    aggregation's weights are per segment, the log-softmax's per row."""
    jprep, tprep = prep or (lambda x: x, lambda x: x)

    def jloss(d):
        out = jfn(jprep(d), jnp.asarray(ids), NUM_SEGMENTS)
        return (out * weights).sum(), out

    (_, jval), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(data))
    x = torch.tensor(data, requires_grad=True)
    tval = tfn(tprep(x), torch.from_numpy(ids), NUM_SEGMENTS)
    (tval * torch.from_numpy(weights)).sum().backward()
    return (np.asarray(jval), np.asarray(jgrad),
            tval.detach().numpy(), x.grad.numpy())


@pytest.mark.parametrize("trailing", [(), (3,)], ids=["M", "M_K"])
@pytest.mark.parametrize("name", ["sum", "mean", "max", "sqrt_n"])
def test_aggregations_match_jax(name, trailing):
    """Values and gradients, empty segments (0) and a dropped id
    included."""
    ids, data, weights = _segment_case(trailing)
    jval, jgrad, tval, tgrad = _value_and_grad(
        jseg.get_aggregation_function(name),
        tseg.get_aggregation_function(name), ids, data, weights)
    np.testing.assert_allclose(tval, jval, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-6, atol=1e-6)
    assert not tval[6:].any()
    assert tseg.get_known_aggregation_names() == \
        jseg.get_known_aggregation_names()


def test_unknown_aggregation_raises():
    with pytest.raises(ValueError, match="Unknown aggregation function"):
        tseg.get_aggregation_function("min")


def test_segment_count_matches_jax():
    ids, _, _ = _segment_case(())
    np.testing.assert_array_equal(
        tseg.segment_count(torch.from_numpy(ids), NUM_SEGMENTS).numpy(),
        np.asarray(jseg.segment_count(jnp.asarray(ids), NUM_SEGMENTS)))


def test_segment_max_splits_tied_gradients():
    """Ties share the gradient evenly, in both packages: ids [0, 0, 0, 2],
    values [1, 1, 0.5, 2] and weights [1, 5, 3] give [0.5, 0.5, 0, 3]."""
    ids = np.array([0, 0, 0, 2], np.int32)
    data = np.array([1.0, 1.0, 0.5, 2.0], np.float32)
    weights = np.array([1.0, 5.0, 3.0], np.float32)

    def jfn(d):
        return (jseg.segment_max(d, jnp.asarray(ids), 3) * weights).sum()

    x = torch.tensor(data, requires_grad=True)
    (tseg.segment_max(x, torch.from_numpy(ids), 3)
     * torch.from_numpy(weights)).sum().backward()
    want = np.array([0.5, 0.5, 0.0, 3.0], np.float32)
    np.testing.assert_array_equal(np.asarray(jax.grad(jfn)(data)), want)
    np.testing.assert_array_equal(x.grad.numpy(), want)


@pytest.mark.parametrize("trailing", [(), (4,)], ids=["M", "M_K"])
def test_segment_max_of_relu_ties_at_zero_matches_jax(trailing):
    """relu messages before a max aggregation: most rows of a segment tie
    at 0 (the inputs are shifted negative), and the gradient reaching the
    pre-activation splits over the tied rows as in the reference."""
    ids, data, weights = _segment_case(trailing, seed=3)
    data = data - 1.2
    jval, jgrad, tval, tgrad = _value_and_grad(
        jseg.segment_max, tseg.segment_max, ids, data, weights,
        prep=(jax.nn.relu, torch.relu))
    assert (np.maximum(data, 0.0) == 0.0).mean() > 0.75
    np.testing.assert_allclose(tval, jval, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("trailing", [(), (3,)], ids=["M", "M_K"])
def test_segment_log_softmax_matches_jax(trailing):
    """Values and gradients; single-entry segments give exactly 0 (1
    after ``exp``), since the epsilon stands under the log as ``max(sum,
    eps)``, where ``segment_softmax``'s ``sum + eps`` denominator gives
    1 / (1 + eps)."""
    ids, data, _ = _segment_case(trailing, seed=5)
    ids[:3] = 6, 7, 8   # one entry each
    ids[7] = 0          # its ids index its rows back: all in range
    weights = np.random.RandomState(6).randn(*data.shape).astype(np.float32)
    jval, jgrad, tval, tgrad = _value_and_grad(
        jseg.segment_log_softmax, tseg.segment_log_softmax, ids,
        3.0 * data, weights)
    np.testing.assert_allclose(tval, jval, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tval[:3], np.zeros_like(tval[:3]))
    np.testing.assert_array_equal(jval[:3], tval[:3])
    soft = tseg.segment_softmax(torch.from_numpy(data[:3]),
                                torch.from_numpy(ids[:3]), NUM_SEGMENTS)
    np.testing.assert_allclose(soft.numpy(), 1.0 / (1.0 + SMALL_NUMBER),
                               rtol=1e-7)


# ---------------------------------------------------------------- the bridge
# case: (flax path under gnn/mp_layer_1, the leaves' shape)
NEW_LAYOUTS = {
    "edge_mlp_target_2_hidden": (("edge_mlp_layer_1", "edge_mlp_layer_2"),
                                 (3, 16, 16)),
    "film_target_1_hidden": (("edge_mlp_layer_1",), (3, 16, 16)),
}


@pytest.mark.parametrize("case", list(NEW_LAYOUTS))
def test_bridge_loads_the_new_layouts_strictly(case, workloads_by_plans):
    """The per-edge layers of the deep target-state edge MLP and of the
    target-state FiLM with a hidden edge-MLP layer: [L, H, H] kernels
    placed as they are, beside the split first layer; a leaf the model
    lacks raises, and so does a model without a leaf the tree holds."""
    jbatch, _, _ = workloads_by_plans[None]
    _, jparams, tmodel = build_node_pair(case_params(case), jbatch)
    flax = jax.device_get(jparams)
    own = tmodel.state_dict()
    node = flax["gnn"]["mp_layer_1"]
    modules, shape = NEW_LAYOUTS[case]
    for module in modules + ("edge_mlp_src_0", "edge_mlp_tgt_0"):
        value = np.asarray(node[module]["kernel"])
        if module in modules:
            assert value.shape == shape
        np.testing.assert_array_equal(
            own[f"gnn.mp_layer_1.{module}.kernel"].numpy(), value)
    extra = jax.tree_util.tree_map(lambda x: x, flax)
    extra["gnn"]["mp_layer_1"][f"edge_mlp_layer_{len(modules) + 1}"] = {
        "kernel": np.zeros(shape, np.float32)}
    with pytest.raises(ValueError, match=f"edge_mlp_layer_{len(modules) + 1}"):
        load_flax_params(tmodel, extra)
    missing = jax.tree_util.tree_map(lambda x: x, flax)
    del missing["gnn"]["mp_layer_1"][modules[-1]]
    with pytest.raises(RuntimeError, match=modules[-1]):
        load_flax_params(tmodel, missing)


# ---------------------------------------------------------------- the head
def test_node_loss_gradient_at_zero_logits_matches_jax():
    """A real node whose representation is all zeros has logits of exactly
    0 (relu messages that are all negative, then ``tanh`` of 0: 2 of 300
    nodes of the one-layer hidden-8 PPI_GNN_FiLM of
    ``test_torch_guards.py::test_unfused_routes_raise``). The port's loss
    takes the reference's derivatives there (``jnp.maximum``'s 1/2,
    ``jnp.abs``'s 1): d loss / d x = -z / N."""
    from tf2_gnn_tpu.models.node_multiclass_task import NodeMulticlassTask
    from tf2_gnn_tpu_torch.data.graph_batch import GraphBatch
    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask as TorchNodeMulticlassTask,
    )

    x = np.array([[0.0, 0.0, 1.5], [-2.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                 np.float32)
    z = np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]],
                 np.float32)
    jbatch = types.SimpleNamespace(node_mask=jnp.asarray([1.0, 1.0, 0.0]),
                                   num_nodes=jnp.asarray(2),
                                   num_graphs=jnp.asarray(1), spmd_axis=None)
    want = jax.grad(lambda v: NodeMulticlassTask.compute_task_metrics(
        jbatch, (v,), {"node_labels": jnp.asarray(z)})["loss"])(
        jnp.asarray(x))
    tbatch = GraphBatch(node_features=torch.zeros(3, 1), edge_sources=(),
                        edge_targets=(), node_to_graph=torch.zeros(3),
                        num_nodes=2, num_edges=None, num_graphs=1,
                        num_graphs_padded=2)
    logits = torch.tensor(x, requires_grad=True)
    TorchNodeMulticlassTask.compute_task_metrics(
        tbatch, (logits,), {"node_labels": torch.from_numpy(z)}
    )["loss"].backward()
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(logits.grad.numpy()[0, :2],
                                  -z[0, :2] / 2.0)


def _unfused_rgcn_steps(tbatch, labels, steps: int, profile=None):
    """``steps`` train steps of the shipped PPI_RGCN at 2 layers of 16 on
    a fresh copy of the bare batch (no edge order built yet); the segment
    counters of each step, and with ``profile`` the profiler's events of
    the last one."""
    from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
    from tf2_gnn_tpu_torch.harness.training import (
        create_train_state,
        make_train_step,
    )
    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )
    from tf2_gnn_tpu_torch.utils import tracing

    from .test_torch_rgcn_model import FEATURES, NUM_LABELS

    params = case_params("rgcn_shipped")
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer, seed=0)
    step = make_train_step(model, optimizer)
    batch = dataclasses.replace(tbatch)
    tlabels = {"node_labels": torch.from_numpy(labels)}
    counts, events = [], None
    for k in range(steps):
        tracing.reset()
        if profile and k == steps - 1:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU],
                    record_shapes=True) as prof:
                state, _ = step(state, batch, tlabels)
            events = prof.events()
        else:
            state, _ = step(state, batch, tlabels)
        counts.append(tracing.counters("segment"))
    assert_layers_unfused(model.gnn, batch, params["gnn_num_layers"])
    return params, batch, counts, events


def test_unfused_train_step_sums_over_the_edge_orders(workloads_by_plans):
    """A two-layer unfused RGCN train step sums every layer's messages and
    every gather's gradient over the batch's orders, none by index_add_;
    the orders are built in the batch's first step (the targets' and each
    type's sources') and read in the next."""
    _, tbatch, labels = workloads_by_plans[None]
    params, batch, counts, _ = _unfused_rgcn_steps(tbatch, labels, 2)
    layers, types_ = params["gnn_num_layers"], batch.num_edge_types
    ordered = layers * (1 + types_)
    assert counts[0] == {"order.build": 1 + types_, "sum.ordered": ordered}
    assert counts[1] == {"sum.ordered": ordered}
    assert sorted(batch._edge_orders) == sorted(
        [("targets", None, batch.aggregation_segments)]
        + [("edge_sources", l, batch.num_nodes_padded)
           for l in range(types_)])


def _edge_index_adds(events, batch, hidden):
    """The profiler's ``aten::index_add_`` calls on an operand of one row
    an edge (of a type, or of all types) and ``hidden`` columns."""
    rows = {int(s.shape[0]) for s in batch.edge_sources}
    rows.add(sum(rows_l.shape[0] for rows_l in batch.edge_sources))
    return [e for e in events if e.name == "aten::index_add_"
            and any(len(shape) == 2 and shape[0] in rows
                    and shape[1] == hidden for shape in e.input_shapes)]


@pytest.mark.parametrize("orders", [True, False],
                         ids=["ordered", "scatter_control"])
def test_unfused_train_step_runs_no_index_add_over_edges(
        orders, workloads_by_plans, monkeypatch):
    """Under the profiler, the steady-state step shows no
    ``aten::index_add_`` on an [E, H] operand; the control, with the
    batch's orders taken away (today's scatter form), shows them, so the
    check catches them."""
    from tf2_gnn_tpu_torch.data.graph_batch import GraphBatch

    if not orders:
        monkeypatch.setattr(GraphBatch, "_edge_order",
                            lambda self, *args: None)
    _, tbatch, labels = workloads_by_plans[None]
    params, batch, counts, events = _unfused_rgcn_steps(tbatch, labels, 2,
                                                        profile=True)
    found = _edge_index_adds(events, batch, params["gnn_hidden_dim"])
    if orders:
        assert found == []
        assert counts[-1].get("sum.scatter", 0) == 0
    else:
        layers = params["gnn_num_layers"]
        assert len(found) == layers * (1 + batch.num_edge_types)
        assert counts[-1].get("sum.ordered", 0) == 0
