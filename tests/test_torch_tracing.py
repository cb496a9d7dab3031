"""The port's spans and counter registry (``utils/tracing.py``) on the CPU:
tracing off records nothing and tracing on changes no number; one train
step records the span tree of its layers on the fused and the unfused
route; the registry holds every module's counters and resets them; a
plan's compact forms are built once; a span's host times hold its own
profiler range (one clock); an RGAT layer on the pair-attention route
records its score, attention and normalising spans inside its messages,
and every RGAT forward counts its route, traced or not."""
import threading

import numpy as np
import pytest
import torch

from tf2_gnn_tpu_torch import native
from tf2_gnn_tpu_torch.data import DataFold
from tf2_gnn_tpu_torch.data.ppi_dataset import PPIDataset
from tf2_gnn_tpu_torch.harness import training
from tf2_gnn_tpu_torch.layers.message_passing.gnn_edge_mlp import (
    GNN_Edge_MLP,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_edge_mlp as tpem
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import probes as tprobes
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss
from tf2_gnn_tpu_torch.parallel import collectives
from tf2_gnn_tpu_torch.utils import tracing
from tf2_gnn_tpu_torch.workloads import write_ppi_dataset

LAYERS = 2
ROUTES = {True: "pair_joint", False: "unfused"}   # by use_pair_spmm


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and nothing recorded."""
    tracing.set_enabled(False)
    tracing.drain()
    yield
    tracing.set_enabled(False)
    tracing.drain()


@pytest.fixture(scope="module")
def ppi_path(tmp_path_factory):
    torch.set_num_threads(1)
    return write_ppi_dataset(tmp_path_factory.mktemp("ppi"),
                             graphs_per_fold=3, nodes_per_graph=40,
                             feature_dim=5)


def _dataset(path, plans: bool):
    params = {**PPIDataset.get_default_hyperparameters(),
              "max_nodes_per_batch": 400, "use_pair_spmm": plans,
              "pair_per_type": True}
    dataset = PPIDataset(params, rng=np.random.RandomState(0))
    dataset.load_data(path)
    return dataset


def _training(path, plans: bool):
    """(state, train_step, the first TRAIN batch on the CPU) of a two-layer
    RGCN with dropout."""
    dataset = _dataset(path, plans)
    params = NodeMulticlassTask.get_default_hyperparameters("rgcn")
    params.update({"gnn_hidden_dim": 16, "gnn_num_layers": LAYERS,
                   "gnn_layer_input_dropout_rate": 0.1})
    model = NodeMulticlassTask.from_dataset(params, dataset, device="cpu",
                                            seed=1)
    host = next(iter(dataset.batch_iterator(DataFold.TRAIN)))
    batch, labels = training.to_device(*host, "cpu")
    state, train_step, _ = training.build_training(model, params, seed=0)
    return state, train_step, batch, labels


def _run(path, plans: bool, steps: int = 2):
    """Losses, last gradients and weights of ``steps`` train steps."""
    state, train_step, batch, labels = _training(path, plans)
    losses = []
    for _ in range(steps):
        state, metrics = train_step(state, batch, labels)
        losses.append(metrics["loss"])
    model = state.model
    return (torch.stack(losses),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def test_off_returns_the_shared_no_op():
    assert not tracing.is_enabled()
    first = tracing.span("step", step=0)
    assert first is tracing.span("gnn.layer", layer=1)
    assert tracing.begin("data.plan") is first
    with first as opened:
        opened.note(route="unfused")
    first.close()
    x = torch.ones(2, requires_grad=True)
    y = x * 2
    tracing.backward_bracket(y, x, "gnn.messages.backward")
    y.sum().backward()
    assert tracing.drain() == []


@pytest.mark.parametrize("plans", [True, False], ids=ROUTES.get)
def test_tracing_changes_no_number(plans, ppi_path):
    """Off, a step records nothing; on, the losses, gradients and updated
    weights are bit-equal to those of the steps run with it off."""
    off = _run(ppi_path, plans)
    assert tracing.drain() == []
    with tracing.enabled():
        on = _run(ppi_path, plans)
    assert tracing.drain()
    assert torch.equal(off[0], on[0])
    for a, b in zip(off[1:], on[1:]):
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("plans", [True, False], ids=ROUTES.get)
def test_a_step_records_its_span_tree(plans, ppi_path):
    state, train_step, batch, labels = _training(ppi_path, plans)
    state, _ = train_step(state, batch, labels)   # builds the compact forms
    with tracing.enabled():
        train_step(state, batch, labels)
    records = tracing.drain()
    by_id = {r.id: r for r in records}

    def children(parent, name):
        return [r for r in records if r.parent == parent.id
                and r.name == name]

    (step,) = [r for r in records if r.name == "step"]
    assert step.parent is None and step.attrs == {"step": 1}
    assert {r.step for r in records} == {1}
    for r in records:
        if r is not step:
            parent = by_id[r.parent]
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    (forward,) = children(step, "step.forward")
    (backward,) = children(step, "step.backward")
    (update,) = children(step, "step.optimizer")
    assert update.attrs == {"optimizer": "Adam"}
    assert forward.end_ns <= backward.start_ns <= backward.end_ns \
        <= update.start_ns
    layers = children(forward, "gnn.layer")
    assert [r.attrs["layer"] for r in layers] == list(range(LAYERS))
    for i, layer in enumerate(layers):
        (messages,) = children(layer, "gnn.messages")
        assert messages.attrs == {"layer": i, "route": ROUTES[plans]}
    assert len(children(forward, "gnn.readout")) == 1
    backwards = children(backward, "gnn.messages.backward")
    assert [r.attrs for r in backwards] == [
        {"route": ROUTES[plans], "layer": i}
        for i in reversed(range(LAYERS))]
    assert len(records) == 5 + 3 * LAYERS


@pytest.mark.parametrize("plans", [True, False], ids=ROUTES.get)
def test_batch_assembly_records_pack_plan_and_move(plans, ppi_path):
    dataset = _dataset(ppi_path, plans)
    with tracing.enabled():
        host = next(iter(dataset.batch_iterator(DataFold.TRAIN)))
        training.to_device(*host, "cpu")
    records = tracing.drain()
    assert [r.name for r in records] == ["data.pack", "data.plan",
                                         "data.move"]
    pack, plan, _ = records
    assert pack.attrs == {"nodes": host[0].num_nodes}
    assert plan.attrs == {"nodes": host[0].num_nodes,
                          "edges": int(np.sum(host[0].num_edges))}
    assert pack.end_ns <= plan.start_ns
    assert all(r.parent is None and r.step is None for r in records)


def test_each_thread_keeps_its_own_stack():
    """A span another thread opens while one is open here is no child of
    it."""
    opened = threading.Event()
    with tracing.enabled():
        with tracing.span("step", step=7):
            def work():
                with tracing.span("data.pack"):
                    with tracing.span("data.plan"):
                        opened.set()
            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive() and opened.is_set()
    inner, outer, step = tracing.drain()
    assert (inner.name, outer.name, step.name) == ("data.plan", "data.pack",
                                                   "step")
    assert outer.parent is None and outer.step is None
    assert inner.parent == outer.id
    assert outer.thread != step.thread


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.reset()
    with tracing.enabled():
        for _ in range(5):
            with tracing.span("data.move"):
                pass
    assert len(tracing.drain()) == 3
    assert tracing.counters()["span.dropped"] == 2


def test_the_registry_holds_and_resets_every_counter():
    stores = {"launch": [tps.LAUNCHES, tpa.LAUNCHES, tpem.LAUNCHES,
                         tss.LAUNCHES, tprobes.LAUNCHES],
              "planned": [native.PLANNED]}
    for module_stores in stores.values():
        for store in module_stores:
            for key in store:
                store[key] += 3
    native.PLANNED["pair binding"] += 2
    collectives.COUNTS["psum"]["calls"] += 1
    collectives.COUNTS["psum"]["bytes"] += 16
    tracing.count("compact.build.merged.fwd", 2)
    snapshot = tracing.counters()
    for namespace, module_stores in stores.items():
        for store in module_stores:
            for key, value in store.items():
                assert snapshot[f"{namespace}.{key}"] == value
    for name, counts in collectives.COUNTS.items():
        for key, value in counts.items():
            assert snapshot[f"collective.{name}.{key}"] == value
    assert snapshot["collective.psum.bytes"] >= 16
    assert tracing.counters("compact.build") == {"merged.fwd": 2}
    assert tracing.counters("launch")["pair_stream_joint"] \
        == tps.LAUNCHES["pair_stream_joint"]
    launches_before = tps.LAUNCHES
    tracing.reset()
    assert tps.LAUNCHES is launches_before
    assert not any(tracing.counters().values())
    assert set(tracing.counters()) >= {
        f"launch.{k}" for store in stores["launch"] for k in store}


def test_compact_forms_are_built_once(ppi_path):
    """The first step builds each direction's compact form once; a second
    step over the same batch builds none."""
    state, train_step, batch, labels = _training(ppi_path, True)
    tracing.reset()
    state, _ = train_step(state, batch, labels)
    built = tracing.counters("compact.build")
    tracing.reset()
    train_step(state, batch, labels)
    assert tracing.counters("compact.build") == {}
    # The batch's read rows are below the gate: the tables hold only the
    # rows the plan reads, whose two forms are built once too.
    assert GNN_Edge_MLP.compact_rows(batch) is not None
    assert built == {"stream_joint.fwd": 1, "stream_joint.bwd": 1,
                     "stream_joint.read": 1, "stream_joint.read_bwd": 1}


def test_a_span_holds_its_profiler_range():
    """Host times and the profiler's events are on one clock: the span's
    interval holds its own ``record_function`` range, within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.enabled():
            for _ in range(3):
                with tracing.span("gnn.readout"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    origin = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name == "gnn.readout")
    spans = tracing.drain()
    assert len(ranges) == len(spans) == 3
    for (start_us, end_us), record in zip(ranges, spans):
        host_start = (record.start_ns - origin) / 1e3
        host_end = (record.end_ns - origin) / 1e3
        assert host_start - 50 <= start_us <= end_us <= host_end + 50


def _rgat(path, **params):
    """(model, the first TRAIN batch on the CPU) of a two-layer RGAT of 4
    heads over a merged plan, the benchmark cell's form."""
    dataset_params = {**PPIDataset.get_default_hyperparameters(),
                      "max_nodes_per_batch": 400, "use_pair_spmm": True}
    dataset = PPIDataset(dataset_params, rng=np.random.RandomState(0))
    dataset.load_data(path)
    model_params = NodeMulticlassTask.get_default_hyperparameters("rgat")
    model_params.update({"gnn_hidden_dim": 16, "gnn_num_layers": LAYERS,
                         "gnn_num_heads": 4, "gnn_edge_dtype": "bfloat16",
                         **params})
    model = NodeMulticlassTask.from_dataset(model_params, dataset,
                                            device="cpu", seed=1)
    host = next(iter(dataset.batch_iterator(DataFold.TRAIN)))
    batch, _ = training.to_device(*host, "cpu")
    return model, batch


def test_rgat_records_its_attention_spans_inside_the_messages(ppi_path):
    model, batch = _rgat(ppi_path)
    with tracing.enabled():
        model(batch, training=False)
    records = tracing.drain()
    by_id = {r.id: r for r in records}
    messages = [r for r in records if r.name == "gnn.messages"]
    assert [r.attrs for r in messages] == [
        {"layer": i, "route": "pair_attention"} for i in range(LAYERS)]
    names = ("rgat.scores", "rgat.attention", "rgat.normalise")
    for layer, outer in enumerate(messages):
        inner = [r for r in records if r.parent == outer.id]
        assert [r.name for r in inner] == list(names)
        assert all(r.attrs == {"layer": layer} for r in inner)
        for a, b in zip(inner, inner[1:]):
            assert a.end_ns <= b.start_ns
        for r in inner:
            assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
            assert by_id[r.parent] is outer


@pytest.mark.parametrize("plans", [True, False],
                         ids=["pair_attention", "unfused"])
def test_rgat_counts_its_route_once_a_layer_with_tracing_off(plans,
                                                             ppi_path):
    model, batch = _rgat(ppi_path, **({} if plans else {
        "gnn_aggregation_function": "mean"}))
    tracing.reset()
    model(batch, training=False)
    model(batch, training=False)
    route = "pair_attention" if plans else "unfused"
    assert tracing.counters("rgat.route") == {route: 2 * LAYERS}
    assert tracing.counters()[f"rgat.route.{route}"] == 2 * LAYERS
    assert tracing.drain() == []
    tracing.reset()
    assert tracing.counters("rgat.route") == {}
