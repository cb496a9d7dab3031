"""The port's training harness against the JAX package's on the CPU.

* Config: the shipped JSONs, the merge order, hyperdrive coercion and
  override parsing match ``tf2_gnn_tpu.harness.config``; the task registry
  holds the same four tasks over the port's classes; the CLI resolves the
  same dataset and model parameters as the JAX package's.
* Checkpoints: a save/load round trip restores the weights bit for bit,
  on a fresh model; resuming from a checkpoint with the optimizer state
  continues exactly as the uninterrupted run.
* ``predict`` concatenates the real rows of every batch.
* ``train_loop``: two epochs at dropout 0 from weights bridged out of the
  JAX model, with the TRAIN shuffles seeded alike, against the JAX
  ``train_loop``: per-epoch train and valid losses and metrics, and the
  final weights. PPI RGCN on per-type plans (f32 edge stream) and
  GraphRegression on the unfused path (no plans).
* The command-line entries ``cli/train.py::run`` and ``cli/test.py::run``
  end to end with ``--device cpu``: PPI on the shipped PPI_RGCN.json
  narrowed by ``--model-params-override`` (with the hyperdrive overrides
  ``--gnn_use_remat True --gnn_dense_dtype bfloat16``, a profiler trace,
  a resume and a weights-only start), and GraphRegression on JSONL files.

Tolerances of the loop: losses and metrics rtol 1e-4 (the same f32
products summed in other orders; observed at most 5.6e-6 relative), final
weights atol 5e-5: Adam's normalised step m / (sqrt(v) + 1e-7) turns a
small relative difference in a gradient entry near zero into a share of
the learning rate (1e-3) a step, over 8 steps (GraphRegression) and 4
(PPI) here (observed 1.2e-5 after GraphRegression's loop, 1.2e-7 after
PPI's; ``tests/test_torch_train.py`` holds three steps to 1e-5).
"""
import json

import jax
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.data import DataFold as JDataFold
from tf2_gnn_tpu.data import JsonLGraphPropertyDataset as JJsonLProperty
from tf2_gnn_tpu.data import PPIDataset as JPPI
from tf2_gnn_tpu.harness import config as jconfig
from tf2_gnn_tpu.harness import run as jrun
from tf2_gnn_tpu.harness import tasks as jtasks
from tf2_gnn_tpu.harness import training as jtraining
from tf2_gnn_tpu.models.graph_regression_task import (
    GraphRegressionTask as JGraphRegression,
)
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JNodeMulticlass,
)
from tf2_gnn_tpu_torch.cli import test as cli_test
from tf2_gnn_tpu_torch.cli import train as cli_train
from tf2_gnn_tpu_torch.data import DataFold
from tf2_gnn_tpu_torch.data import JsonLGraphPropertyDataset as TJsonLProperty
from tf2_gnn_tpu_torch.data import PPIDataset as TPPI
from tf2_gnn_tpu_torch.harness import checkpoint, config, run, tasks, training
from tf2_gnn_tpu_torch.harness.import_jax import (
    flax_params_to_state_dict,
    load_flax_params,
)
from tf2_gnn_tpu_torch.models.graph_regression_task import GraphRegressionTask
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask

from .synthetic_data import write_jsonl_property_dataset, write_ppi_dataset

SEED = 3
RTOL = 1e-4
WEIGHT_ATOL = 5e-5
SHIPPED = ("GraphRegression_GNN_Edge_MLP", "PPI_GGNN", "PPI_GNN_Edge_MLP",
           "PPI_GNN_FiLM", "PPI_RGAT", "PPI_RGCN", "PPI_RGIN", "QM9_RGCN")
PPI_DATA = {"max_nodes_per_batch": 400}
SMALL_MODEL = {"gnn_hidden_dim": 16, "gnn_num_layers": 2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and these small ops then run
    many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {
        "ppi": write_ppi_dataset(root / "ppi", graphs_per_fold=5,
                                 nodes_per_graph=150, edges_per_graph=600,
                                 seed=2),
        "jsonl": write_jsonl_property_dataset(root / "jsonl", num_graphs=30,
                                              num_fwd_edge_types=2, seed=2),
    }


# ---- config and tasks -------------------------------------------------------
def test_config_matches_jax(tmp_path):
    for name in SHIPPED:
        task, model = name.split("_", 1)
        assert (config.load_default_hypers(task, model)
                == jconfig.load_default_hypers(task, model)), name
    assert (config.load_default_hypers("PPI", "NoSuchModel")
            == jconfig.load_default_hypers("PPI", "NoSuchModel"))
    layers = [{"a": 1, "b": 2}, None, {"b": 3}, {}, {"c": [1]}]
    assert config.merge_params(*layers) == jconfig.merge_params(*layers)
    current = {"flag": False, "n": 3, "rate": 0.5, "layers": [1, 2],
               "pair": (1, 2), "name": "x", "unset": None}
    overrides = {"flag": "True", "n": "7.0", "rate": "0.25",
                 "layers": "[4, 5]", "pair": "[3, 4]", "name": "y",
                 "unset": "z", "absent": "1"}
    assert (config.apply_hyperdrive_overrides(current, overrides)
            == jconfig.apply_hyperdrive_overrides(current, overrides))
    for value, text in ((True, "no"), (1, "2"), (1.5, "3"), ([1], "[2]")):
        assert (config.coerce_hyperdrive_value(value, text)
                == jconfig.coerce_hyperdrive_value(value, text))
    for bad in ((True, "maybe"), ([1], "3")):
        with pytest.raises(ValueError):
            config.coerce_hyperdrive_value(*bad)
    spec = tmp_path / "override.json"
    spec.write_text('{"gnn_hidden_dim": 8}')
    for text in (None, '{"a": 1}', str(spec)):
        assert (config.parse_params_override(text)
                == jconfig.parse_params_override(text))


def test_task_registry_matches_jax():
    assert tasks.get_known_tasks() == jtasks.get_known_tasks()
    for name in jtasks.get_known_tasks():
        for port_fn, jax_fn in (
                (tasks.task_name_to_dataset_class,
                 jtasks.task_name_to_dataset_class),
                (tasks.task_name_to_model_class,
                 jtasks.task_name_to_model_class)):
            (cls, hypers), (jcls, jhypers) = (port_fn(name.lower()),
                                              jax_fn(name.lower()))
            assert cls.__name__ == jcls.__name__ and hypers == jhypers
            assert cls.__module__.startswith("tf2_gnn_tpu_torch.")
            if hasattr(cls, "get_default_hyperparameters"):
                assert (cls.get_default_hyperparameters()
                        == jcls.get_default_hyperparameters()), name
    with pytest.raises(ValueError, match="Unknown task"):
        tasks.task_name_to_dataset_class("NoSuchTask")


@pytest.mark.parametrize("argv", [
    ["RGCN", "PPI", "--data-params-override", json.dumps(PPI_DATA),
     "--model-params-override", json.dumps(SMALL_MODEL),
     "--gnn_use_remat", "True", "--gnn_dense_dtype", "bfloat16",
     "--pair_overflow_budget", "96"],
    ["GNN_Edge_MLP", "GraphRegression", "--learning_rate", "0.01"],
], ids=["ppi_rgcn", "graph_regression_edge_mlp"])
def test_cli_resolves_the_jax_parameters(argv, data):
    """The CLI's layered parameters (class defaults, task defaults, the
    shipped JSON, the JSON overrides, the hyperdrive leftovers) as the JAX
    package resolves them from the same command line."""
    path = str(data["ppi" if "PPI" in argv else "jsonl"])
    argv = argv[:2] + [path] + argv[2:] + ["--device", "cpu"]
    args, leftovers = run.get_train_cli_arg_parser().parse_known_args(argv)
    jargs, jleftovers = jrun.get_train_cli_arg_parser().parse_known_args(
        [a for a in argv if a not in ("--device", "cpu")])
    overrides = run.parse_hyperdrive_leftovers(leftovers)
    assert overrides == jrun.parse_hyperdrive_leftovers(jleftovers)
    model, params, dataset = run.get_model_and_dataset_from_args(
        args, overrides)
    _, jparams, jdataset = jrun.get_model_and_dataset_from_args(
        jargs, overrides)
    assert params == jparams
    assert dataset.params == jdataset.params
    assert next(model.parameters()).device.type == "cpu"


# ---- checkpoints and predict --------------------------------------------------
def small_ppi(path, **extra):
    params = {**TPPI.get_default_hyperparameters(), **PPI_DATA,
              "use_pair_spmm": True, "pair_per_type": True, **extra}
    dataset = TPPI(params, rng=np.random.RandomState(SEED))
    dataset.load_data(path)
    model_params = NodeMulticlassTask.get_default_hyperparameters("rgcn")
    model_params.update(SMALL_MODEL)
    model = NodeMulticlassTask.from_dataset(model_params, dataset,
                                            device="cpu", seed=1)
    return dataset, model, model_params


def steps(state, train_step, batches):
    for batch, labels in training.device_prefetch(batches, "cpu"):
        state, _ = train_step(state, batch, labels)
    return state


def test_checkpoint_round_trip_and_exact_resume(data, tmp_path):
    dataset, model, params = small_ppi(data["ppi"])
    batches = list(dataset.batch_iterator(DataFold.VALIDATION))
    state, train_step, _ = training.build_training(model, params, seed=0)
    state = steps(state, train_step, batches)
    path = tmp_path / "model.pkl"
    checkpoint.save_model(path, model, params, dataset,
                          optimizer=state.optimizer, step=state.step)
    saved = checkpoint.load_checkpoint_metadata(path)
    for key in ("model_class", "model_params", "dataset_class",
                "dataset_params", "dataset_metadata", "num_edge_types",
                "node_feature_shape", "padding_config", "weights",
                "opt_state", "step"):
        assert key in saved, key
    assert saved["step"] == len(batches)

    restored_ds = checkpoint.restore_dataset(saved)
    assert restored_ds.padding_config == dataset.padding_config
    restored_ds.load_data(data["ppi"], {DataFold.VALIDATION})
    fresh, _ = checkpoint.restore_model_and_params(saved, restored_ds,
                                                   device="cpu")
    checkpoint.load_weights_verbosely(saved, fresh, log=lambda _: None)
    for (name, p), (_, q) in zip(model.state_dict().items(),
                                 fresh.state_dict().items()):
        assert torch.equal(p, q), name

    # Resume: the restored model and optimizer take the same next steps
    # as the uninterrupted ones, bit for bit.
    resumed, resumed_step, _ = training.build_training(fresh, params, seed=0)
    assert checkpoint.restore_opt_state(saved, resumed.optimizer)
    resumed.step = saved["step"]
    state = steps(state, train_step, batches)
    resumed = steps(resumed, resumed_step, batches)
    assert resumed.step == state.step
    for (name, p), (_, q) in zip(model.state_dict().items(),
                                 fresh.state_dict().items()):
        assert torch.equal(p, q), name

    warnings = []
    other = dict(saved, weights={"unused": np.zeros(2, np.float32),
                                 "node_to_labels.bias": np.zeros(3)})
    checkpoint.load_weights_verbosely(other, fresh, log=warnings.append)
    assert any("unused" in w for w in warnings)
    assert any("node_to_labels.bias" in w and "shape" in w for w in warnings)
    assert any("not found" in w for w in warnings)


def test_predict_concatenates_the_real_rows(data):
    dataset, model, _ = small_ppi(data["ppi"])
    batches = list(dataset.batch_iterator(DataFold.VALIDATION))
    assert len(batches) > 1
    (logits,) = training.predict(model, batches, "cpu")
    step = training.make_predict_step(model)
    want = [step(batch.to("cpu"))[0][:batch.num_nodes].numpy()
            for batch, _ in batches]
    assert logits.shape == (sum(b.num_nodes for b, _ in batches), 121)
    np.testing.assert_array_equal(logits, np.concatenate(want))


# ---- train_loop against the JAX package ---------------------------------------
class EpochLog:
    """A metrics logger recording each epoch's (fold, loss, metric)."""

    def __init__(self):
        self.epochs = []

    def log_epoch(self, epoch, fold, loss, metric, metric_str, speed,
                  extra=None):
        self.epochs.append((epoch, fold, float(loss), float(metric)))


LOOP_CASES = {
    "ppi_rgcn_per_type": (
        JPPI, TPPI, JNodeMulticlass, NodeMulticlassTask, "ppi", "rgcn",
        {**PPI_DATA, "use_pair_spmm": True, "pair_per_type": True},
        {**SMALL_MODEL, "gnn_layer_input_dropout_rate": 0.0,
         "gnn_edge_dtype": "float32"}),
    "graph_regression_unfused": (
        JJsonLProperty, TJsonLProperty, JGraphRegression, GraphRegressionTask,
        "jsonl", "rgcn", {"max_nodes_per_batch": 60, "num_fwd_edge_types": 2},
        {**SMALL_MODEL, "gnn_layer_input_dropout_rate": 0.0,
         "gnn_global_exchange_every_num_layers": 10000,
         "graph_aggregation_dropout_rate": 0.0,
         "regression_mlp_dropout": 0.0}),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_train_loop_matches_jax(case, data):
    (jds_cls, tds_cls, jmodel_cls, tmodel_cls, data_key, style, data_params,
     model_params) = LOOP_CASES[case]
    jdataset = jds_cls({**jds_cls.get_default_hyperparameters(),
                        **data_params})
    tdataset = tds_cls({**tds_cls.get_default_hyperparameters(),
                        **data_params}, rng=np.random.RandomState(SEED))
    jdataset.load_data(data[data_key], {JDataFold.TRAIN, JDataFold.VALIDATION})
    tdataset.load_data(data[data_key], {DataFold.TRAIN, DataFold.VALIDATION})
    params = jmodel_cls.get_default_hyperparameters(style)
    params.update(model_params)

    jmodel = jmodel_cls.from_params(params, jdataset)
    example = next(jdataset.batch_iterator(JDataFold.VALIDATION))[0]
    jstate, jtrain, jeval = jtraining.build_training(jmodel, params, example)
    tmodel = tmodel_cls.from_dataset(params, tdataset, device="cpu")
    load_flax_params(tmodel, jax.device_get(jstate.params))
    tstate, ttrain, teval = training.build_training(tmodel, params)

    jlog, tlog = EpochLog(), EpochLog()
    np.random.seed(SEED)
    jstate, jbest = jtraining.train_loop(
        jmodel, jstate, jtrain, jeval, jdataset, max_epochs=2, patience=5,
        log_fun=lambda _: None, metrics_logger=jlog)
    tstate, tbest = training.train_loop(
        tmodel, tstate, ttrain, teval, tdataset, max_epochs=2, patience=5,
        log_fun=lambda _: None, metrics_logger=tlog)

    assert [e[:2] for e in tlog.epochs] == [e[:2] for e in jlog.epochs]
    assert len(tlog.epochs) == 4
    np.testing.assert_allclose([e[2:] for e in tlog.epochs],
                               [e[2:] for e in jlog.epochs], rtol=RTOL)
    np.testing.assert_allclose(tbest, jbest, rtol=RTOL)
    assert tstate.step == int(jstate.step)
    want = flax_params_to_state_dict(jax.device_get(jstate.params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=WEIGHT_ATOL, err_msg=name)


# ---- the command-line entries -------------------------------------------------
def test_cli_train_and_test_ppi(data, tmp_path):
    out = tmp_path / "out"
    common = ["--device", "cpu", "--save-dir", str(out), "--quiet",
              "--data-params-override", json.dumps(PPI_DATA),
              "--model-params-override", json.dumps(SMALL_MODEL)]
    best = cli_train.run(
        ["RGCN", "PPI", str(data["ppi"]), "--max-epochs", "2",
         "--run-name", "first", "--profile-dir", str(tmp_path / "trace"),
         "--disable-tf-func", "--run-test"] + common
        + ["--gnn_use_remat", "True", "--gnn_dense_dtype", "bfloat16"])
    assert best == out / "first_best.pkl" and best.is_file()
    saved = checkpoint.load_checkpoint_metadata(best)
    assert saved["model_params"]["gnn_use_remat"] is True
    assert saved["model_params"]["gnn_dense_dtype"] == "bfloat16"
    assert saved["padding_config"]["pair_chunks_typed"] is not None
    assert list((tmp_path / "trace").glob("*.json"))
    log = (out / "first.log").read_text()
    assert "runs eagerly" in log and "Test:" in log
    epochs = [json.loads(line) for line in
              (out / "first_metrics.jsonl").read_text().splitlines()]
    assert [e["fold"] for e in epochs if e["event"] == "epoch"] == [
        "train", "valid"] * 2

    metric = cli_test.run([str(best), str(data["ppi"]), "--device", "cpu"])
    assert np.isfinite(metric) and -1.0 <= metric <= 0.0
    assert metric == run.test_model(best, data["ppi"], log=lambda _: None,
                                    device="cpu")

    resumed = cli_train.run(["RGCN", "PPI", str(data["ppi"]),
                             "--max-epochs", "1", "--run-name", "resumed",
                             "--load-saved-model", str(best)] + common)
    assert checkpoint.load_checkpoint_metadata(resumed)["step"] >= 0
    warm = cli_train.run(["RGCN", "PPI", str(data["ppi"]), "--max-epochs",
                          "1", "--run-name", "warm", "--load-weights-only",
                          str(best)] + common)
    assert warm.is_file()


def test_cli_train_and_test_graph_regression(data, tmp_path):
    out = tmp_path / "out"
    best = cli_train.run(
        ["RGCN", "GraphRegression", str(data["jsonl"]), "--device", "cpu",
         "--max-epochs", "2", "--save-dir", str(out), "--run-name", "gr",
         "--no-worker-threads",
         "--model-params-override", json.dumps(SMALL_MODEL)])
    saved = checkpoint.load_checkpoint_metadata(best)
    assert saved["dataset_class"] is TJsonLProperty
    assert saved["model_class"] is GraphRegressionTask
    lines = []
    mae = run.test_model(best, data["jsonl"], log=lines.append, device="cpu")
    assert np.isfinite(mae) and mae > 0
    assert any(line.startswith("Metrics: mae") for line in lines)
    assert cli_test.run([str(best), str(data["jsonl"]), "--device",
                         "cpu"]) == mae


def test_hyperdrive_leftovers_and_debug_wrapper():
    assert run.parse_hyperdrive_leftovers(["--a", "1", "--b", "x"]) == {
        "a": "1", "b": "x"}
    with pytest.raises(ValueError, match="Unmatched"):
        run.parse_hyperdrive_leftovers(["--a"])
    with pytest.raises(ValueError, match="must start with"):
        run.parse_hyperdrive_leftovers(["a", "1"])
    with pytest.raises(ZeroDivisionError):
        run.run_and_debug(lambda: 1 / 0, enable_debugging=False)
    assert run.make_run_id("RGCN", "PPI", "named") == "named"
    assert run.make_run_id("RGCN", "PPI").startswith("RGCN_PPI__")
