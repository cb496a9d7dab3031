"""The test-process side of the port's scale-out tests: each case's inputs
(numpy, from a seed), the weights bridged out of the JAX model, and its
references, computed here: the JAX package's own partitioned run on the
conftest's virtual CPU devices (``tf2_gnn_tpu.parallel``) and the port's
single-process run of the same graph or batches. ``run_cluster`` hands
the cases to one gloo cluster (``tests/torch_parallel_worker.py``).

Tolerances (the forwards' and the loss's those of ``tests/test_spmd.py``,
which holds the JAX package's partitioned runs to its single-device
ones): forwards rtol 2e-4 / atol 2e-5, on the plan routes atol 2e-4 (the
same f32 products summed in shard order, in other orders and, across
packages, by XLA and PyTorch); one SGD step: loss rtol 1e-4, F1 atol
5e-3 (near-zero logits of an untrained model may flip under that noise),
and its update (``UPDATE_SHARE``): each parameter's change within 1e-3
of its reference's largest |change|.
"""
import warnings
from typing import Any, Dict, List, Tuple

import jax
import numpy as np
import torch

from tf2_gnn_tpu import parallel as jparallel
from tf2_gnn_tpu.data import graph_batch as jgb
from tf2_gnn_tpu.harness.optimizers import make_optimizer as jmake_optimizer
from tf2_gnn_tpu.harness.training import create_train_state as jcreate_state
from tf2_gnn_tpu.models.graph_regression_task import (
    GraphRegressionTask as JaxGraphRegressionTask,
)
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu_torch.data import graph_batch as tgb
from tf2_gnn_tpu_torch.harness.import_jax import flax_params_to_state_dict
from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_train_step,
)
from tf2_gnn_tpu_torch.parallel.launch import run_ranks

from .test_spmd import _giant_graph, _model_params
from .torch_parallel_worker import _model, run_cases

NUM_LABELS = 121
FEATURES = 12
FWD_TOLS = dict(rtol=2e-4, atol=2e-5)
PLAN_FWD_TOLS = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 1e-4
F1_ATOL = 5e-3
# A step's update (each parameter after the step less its initial value)
# within this share of the largest |entry| of the reference's update of
# that parameter: the healthy cases read 4e-6 to 9.2e-5, the planted
# faults 0.78 to 3 (tests/test_torch_parallel.py, ``FAULTS``).
UPDATE_SHARE = 1e-3

TASKS = {"node": JaxNodeMulticlassTask, "regression": JaxGraphRegressionTask}


def model_params(task: str, flavour: str, **extra) -> Dict[str, Any]:
    """test_spmd's hyperparameters (hidden 12, 3 layers, dropout 0) with
    one SGD step of lr 0.05, and ``extra``; ``gnn_edge_mlp0`` is the
    0-hidden target-state edge MLP."""
    if flavour == "gnn_edge_mlp0":
        flavour = "gnn_edge_mlp"
        extra = {"gnn_num_edge_MLP_hidden_layers": 0, **extra}
    params = _model_params(TASKS[task], flavour, **extra)
    params.update({"optimizer": "SGD", "momentum": 0.0,
                   "learning_rate": 0.05})
    params.update(extra)
    return params


def node_labels(num_nodes: int, seed: int) -> np.ndarray:
    return (np.random.RandomState(seed).rand(num_nodes, NUM_LABELS)
            > 0.9).astype(np.float32)


def single_batch(module, nf, adj, n2g, num_graphs, num_graphs_padded=4):
    """test_spmd's single-device padding of the whole graph, by either
    package's ``graph_batch`` module."""
    config = module.PaddingConfig(
        num_nodes=nf.shape[0] + 8, num_graphs=num_graphs_padded,
        edge_budgets=tuple(a.shape[0] + 16 for a in adj))
    return module.pad_batch_arrays(nf, adj, n2g, num_graphs, config)


def dp_batches(module, seed: int):
    """Four padded batches of 1-3 small random graphs each (one edge type,
    5 features), by either package's ``graph_batch`` module, with their
    regression targets."""
    rng = np.random.RandomState(seed)
    config = module.PaddingConfig(num_nodes=64, num_graphs=4,
                                  edge_budgets=(128,))
    out = []
    for b in range(4):
        graphs = 1 + b % 3
        sizes = rng.randint(5, 15, graphs)
        n = int(sizes.sum())
        n2g = np.repeat(np.arange(graphs, dtype=np.int32), sizes)
        src = rng.randint(0, n, 3 * n)
        tgt = rng.randint(0, n, 3 * n)
        adj = [np.stack([src, tgt], 1).astype(np.int32)]
        nf = rng.randn(n, 5).astype(np.float32)
        batch = module.pad_batch_arrays(nf, adj, n2g, graphs, config)
        target = np.zeros((4,), np.float32)
        target[:graphs] = rng.randn(graphs)
        out.append((batch, {"target_value": target}))
    return out


def _state_dict(params) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in
            flax_params_to_state_dict(jax.device_get(params)).items()}


def _floats(metrics) -> Dict[str, float]:
    return {k: float(np.asarray(v)) for k, v in metrics.items()}


def _port_model(case):
    return _model(case, torch.device("cpu"))


def _partition(module, graph, labels, num_shards, partition):
    nf, adj, n2g, g = graph
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return module.partition_graph(
            nf, adj, n2g, g, num_shards,
            node_labels={"node_labels": labels}, **partition)


def spmd_case(name: str, task: str, flavour: str, num_shards: int,
              partition: Dict[str, Any], graph=None, train: bool = False,
              evaluate: bool = False, **extra) -> Tuple[dict, dict]:
    """(cluster case, references) of one graph partitioned over
    ``num_shards`` ranks: the JAX package's partitioned forward (restored
    to the node order; per-graph outputs as shard 0 holds them), train
    step and eval metrics, and the port's single-process forward and train
    step."""
    graph = graph or _giant_graph(num_nodes=200, seed=21)
    nf, adj, n2g, g = graph
    labels = node_labels(nf.shape[0], 1)
    params = model_params(task, flavour, **extra)
    jmodel = TASKS[task].from_params(params)
    jsingle = single_batch(jgb, nf, adj, n2g, g)
    jparams = jmodel.init(jax.random.PRNGKey(0), jsingle, False)["params"]
    case = dict(name=name, kind="spmd", task=task, params=params,
                input_dim=FEATURES, num_edge_types=len(adj),
                num_labels=NUM_LABELS, state=_state_dict(jparams),
                graph=graph, node_labels=labels, partition=partition,
                train=train, eval=evaluate)

    mesh = jparallel.make_mesh(jax.devices()[:num_shards], axis_name="nodes")
    sharded, sharded_labels = _partition(jparallel, graph, labels,
                                         num_shards, partition)
    jout = jparallel.make_spmd_forward(jmodel, mesh)(jparams, sharded)
    ref: Dict[str, Any] = {"num_nodes": nf.shape[0],
                           "initial": case["state"]}
    if task == "node":
        ref["jax_forward"] = jparallel.restore_node_order(jout[0], sharded)
    else:
        ref["jax_forward"] = np.asarray(jout)[0]
    tmodel = _port_model(case)
    tsingle = single_batch(tgb, nf, adj, n2g, g).to("cpu")
    with torch.no_grad():
        out = tmodel(tsingle, False)
    ref["port_forward"] = (out[0] if task == "node" else out).numpy()
    if evaluate:
        ref["jax_eval"] = _floats(jparallel.make_spmd_eval_step(
            jmodel, mesh)(jparams, sharded, sharded_labels))
    if train:
        optimizer = jmake_optimizer(params)
        state = jcreate_state(jmodel, jsingle, optimizer, seed=0)
        state = state.replace(params=jparams)
        state, metrics = jparallel.make_spmd_train_step(
            jmodel, optimizer, mesh)(state, sharded, sharded_labels)
        ref["jax_metrics"] = _floats(metrics)
        ref["jax_params"] = _state_dict(state.params)
        ref["port_metrics"], ref["port_params"] = port_single_step(
            case, tsingle, {"node_labels": torch.as_tensor(
                tgb.pad_node_label_array(labels,
                                         tsingle.num_nodes_padded))})
    return case, ref


def port_single_step(case, batch, labels):
    """The port's single-process SGD step: (metrics, state dict)."""
    model = _port_model(case)
    optimizer = make_optimizer(case["params"], model.parameters())
    state = create_train_state(model, optimizer, seed=0)
    _, metrics = make_train_step(model, optimizer)(state, batch, labels)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in model.state_dict().items()})


def run_cluster(cases: List[dict], world: int) -> List[List[dict]]:
    """Every case on one gloo cluster of ``world`` CPU ranks: results
    [rank][case]."""
    return run_ranks(run_cases, world, (cases,), device="cpu")


def assert_close(got, want, tols, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tols)


def assert_update_matches(got_params, want_params, initial, what,
                          share: float = UPDATE_SHARE):
    """Each parameter's update ``got - initial`` within ``share`` of the
    largest |entry| of ``want - initial``."""
    assert sorted(got_params) == sorted(want_params) == sorted(initial)
    for key in want_params:
        start = np.asarray(initial[key], np.float64)
        want = np.asarray(want_params[key], np.float64) - start
        got = np.asarray(got_params[key], np.float64) - start
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        assert err <= share * scale, (
            f"{what}: {key}'s update is off by {err:.3g}, against its "
            f"largest |entry| {scale:.3g} (limit {share:.3g} of it)")


def assert_step_matches(got_metrics, got_params, want_metrics, want_params,
                        initial, what):
    """A train step: the loss and F1 (taken before the update), and the
    update itself (``assert_update_matches``)."""
    np.testing.assert_allclose(got_metrics["loss"], want_metrics["loss"],
                               rtol=LOSS_RTOL, err_msg=f"{what}: loss")
    np.testing.assert_allclose(got_metrics["f1_score"],
                               want_metrics["f1_score"], atol=F1_ATOL,
                               err_msg=f"{what}: f1")
    assert_update_matches(got_params, want_params, initial, what)


def assert_replicated(results, case_index: int, key: str):
    """Every rank holds rank 0's values under ``key`` (a dict of floats or
    of arrays), bit for bit."""
    first = results[0][case_index][key]
    for rank, per_rank in enumerate(results[1:], start=1):
        other = per_rank[case_index][key]
        assert sorted(other) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(
                np.asarray(other[k]), np.asarray(first[k]),
                err_msg=f"rank {rank}: {key}[{k}]")
