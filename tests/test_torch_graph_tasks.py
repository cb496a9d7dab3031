"""The port's graph-level task heads and its RMSProp and SGD against the JAX
package on the CPU, from weights bridged out of the flax params:

* QM9RegressionTask (the gated per-node readout), GraphRegressionTask (two
  weighted-sum readouts over the intermediate representations, and over
  the final ones) and GraphBinaryClassificationTask on a small QM9-shaped
  batch (40 molecules of 18 nodes, 5 edge types on per-type pair plans,
  V = 768): 3 RGCN layers at hidden 32 in QM9_RGCN's layout (leaky_relu,
  residual every 2, LayerNorm, dense at layer 0, the GRU exchange after
  layer 2), f32 and bf16 edge streams, every dropout at 0: outputs, loss
  and the gradient of every parameter; the same for the shipped
  GraphRegression_GNN_Edge_MLP (the port's copy of its JSON, whose
  0-hidden target-state edge MLP takes the factorised form) cut to 3
  layers of hidden 32;
* optax's RMSProp and SGD: parameters along 3 updates, with and without
  clipping and schedules, and small gradients, where optax's eps inside
  the square root sets the step size;
* 3 QM9 train steps (RMSProp, clipping by value at 1.0) along the
  reference's loss trajectory;
* the epoch reductions, and the weight bridge's strictness on the heads'
  leaves.

Tolerances. f32 streams: rtol 1e-4 / atol 1e-5 on outputs and gradients
(the same products summed in other orders through three layers, the
exchange and the readouts), losses rtol 1e-4. bf16 streams: the tables
are rounded to bf16 from f32 values that differ in their last bits, so an
entry may land on the neighbouring bf16 value (2**-8 relative), and
LayerNorm and three layers carry that on: the reference itself, with its
weights scaled by 1 + 1e-7 noise, moves its gradients by up to 1.3% of
each tensor's largest entry. So outputs within 2**-8 of the largest
|output| (observed 1.8e-4 of it), each gradient tensor within 5e-2 of its
largest |entry| (observed up to 3.1e-2), losses rtol 1e-4 (observed
3.6e-5). Optimizer updates rtol 1e-5 / atol 1e-8.
"""
import functools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf2_gnn_tpu.data import graph_batch as jgb
from tf2_gnn_tpu.harness import optimizers as joptimizers
from tf2_gnn_tpu.harness.training import create_train_state as jcreate
from tf2_gnn_tpu.harness.training import make_train_step as jmake_step
from tf2_gnn_tpu.layers import global_exchange as jge
from tf2_gnn_tpu.models import qm9_regression_task as jqm9
from tf2_gnn_tpu.models.graph_binary_classification_task import (
    GraphBinaryClassificationTask as JaxBinary,
)
from tf2_gnn_tpu.models.graph_regression_task import (
    GraphRegressionTask as JaxRegression,
)
from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu_torch.data import graph_batch as tgb
from tf2_gnn_tpu_torch.harness.import_jax import (
    flax_params_to_state_dict,
    load_flax_params,
)
from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tf2_gnn_tpu_torch.layers.mlp import MLP
from tf2_gnn_tpu_torch.models import qm9_regression_task as tqm9
from tf2_gnn_tpu_torch.models.graph_binary_classification_task import (
    GraphBinaryClassificationTask,
)
from tf2_gnn_tpu_torch.models.graph_regression_task import (
    GraphRegressionTask,
)
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


REPO = Path(__file__).resolve().parents[1]
MOLECULES, NODES, TYPES, EDGES, FEATURES, V_PAD = 40, 18, 5, 11, 32, 768
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_OUT_SHARE, BF16_GRAD_SHARE = 2.0 ** -8, 5e-2
LOSS_RTOL = 1e-4
TASKS = {
    "qm9": (jqm9.QM9RegressionTask, tqm9.QM9RegressionTask),
    "regression": (JaxRegression, GraphRegressionTask),
    "binary": (JaxBinary, GraphBinaryClassificationTask),
    "graph_regression-gnn_edge_mlp": (JaxRegression, GraphRegressionTask),
}
EDGE_MLP_JSON = "GraphRegression_GNN_Edge_MLP.json"


def qm9_workload(seed: int):
    """A QM9-shaped batch at small size (``bench.py::build_qm9_batch``'s
    construction at 40 molecules), padded and planned by both packages,
    and per-graph labels: a regression target and a binary one."""
    rng = np.random.RandomState(seed)
    base = (np.arange(MOLECULES) * NODES)[:, None]
    adjacency = []
    for _ in range(TYPES):
        src = rng.randint(0, NODES, (MOLECULES, EDGES)) + base
        tgt = rng.randint(0, NODES, (MOLECULES, EDGES)) + base
        adjacency.append(np.stack([src.reshape(-1), tgt.reshape(-1)],
                                  axis=1).astype(np.int32))
    features = rng.randn(MOLECULES * NODES, FEATURES).astype(np.float32)
    node_to_graph = np.repeat(np.arange(MOLECULES, dtype=np.int32), NODES)
    budgets = tuple(((a.shape[0] + 511) // 512) * 512 for a in adjacency)

    def planned(gb_mod, ps_mod):
        batch = gb_mod.pad_batch_arrays(
            features, adjacency, node_to_graph, MOLECULES,
            gb_mod.PaddingConfig(num_nodes=V_PAD, num_graphs=MOLECULES + 1,
                                 edge_budgets=budgets))
        srcs = [np.asarray(s) for s in batch.edge_sources]
        tgts = [np.asarray(t) for t in batch.edge_targets]
        cnts = [int(c) for c in np.asarray(batch.num_edges)]
        gf, gb = ps_mod.choose_pair_groups([srcs[0]], [tgts[0]], [cnts[0]],
                                           V_PAD)
        return batch.replace(pair_plans_typed=tuple(
            ps_mod.build_pair_plans([srcs[t]], [tgts[t]], [cnts[t]], V_PAD,
                                    group_fwd=gf, group_bwd=gb).astuple()
            for t in range(TYPES)))

    values = rng.randn(MOLECULES).astype(np.float32)
    labels = {
        "regression": tgb.pad_graph_label_array(values, MOLECULES + 1),
        "binary": tgb.pad_graph_label_array(
            (values > 0).astype(np.float32), MOLECULES + 1),
    }
    return planned(jgb, jps), planned(tgb, tps).to("cpu"), labels


def edge_mlp_task_params(edge_dtype: str = "float32", **extra):
    """The port's copy of the shipped GraphRegression_GNN_Edge_MLP over the
    JAX package's defaults, at 3 layers and hidden 32, every dropout at
    0."""
    params = JaxRegression.get_default_hyperparameters("gnn_edge_mlp")
    params.update(json.loads((REPO / "tf2_gnn_tpu_torch" / "harness"
                              / "default_hypers" / EDGE_MLP_JSON)
                             .read_text())["model_params"])
    params.update({
        "gnn_num_layers": 3, "gnn_hidden_dim": 32,
        "gnn_edge_dtype": edge_dtype,
        "gnn_layer_input_dropout_rate": 0.0,
        "gnn_global_exchange_dropout_rate": 0.0,
        "graph_aggregation_dropout_rate": 0.0,
        "regression_mlp_dropout": 0.0,
    })
    params.update(extra)
    return params


def task_params(task: str, edge_dtype: str = "float32", **extra):
    """QM9_RGCN's layout at 3 layers and hidden 32, every dropout at 0
    (the shipped GraphRegression_GNN_Edge_MLP's for its task)."""
    if task == "graph_regression-gnn_edge_mlp":
        return edge_mlp_task_params(edge_dtype, **extra)
    jcls, _ = TASKS[task]
    params = jcls.get_default_hyperparameters("rgcn")
    params.update({
        "gnn_num_layers": 3, "gnn_hidden_dim": 32,
        "gnn_residual_every_num_layers": 2,
        "gnn_layer_input_dropout_rate": 0.0,
        "gnn_message_activation_function": "leaky_relu",
        "gnn_dense_every_num_layers": 32,
        "gnn_use_inter_layer_layernorm": True,
        "gnn_edge_dtype": edge_dtype,
        "gnn_global_exchange_dropout_rate": 0.0,
        "graph_aggregation_dropout_rate": 0.0,
        "regression_mlp_dropout": 0.0,
    })
    params.update(extra)
    return params


def build_pair(task: str, params, jbatch, seed=0):
    """The JAX task with its flax params, and the port's with those params
    bridged in (its MLPs' dropout at 0, as the reference's is patched)."""
    jcls, tcls = TASKS[task]
    jmodel = jcls.from_params(params)
    jparams = jmodel.init(jax.random.PRNGKey(seed), jbatch, False)["params"]
    tmodel = tcls.from_params(params, input_dim=FEATURES,
                              num_edge_types=TYPES, device="cpu")
    load_flax_params(tmodel, jax.device_get(jparams))
    for module in tmodel.modules():
        if isinstance(module, MLP):
            module.dropout_rate = 0.0
    return jmodel, jparams, tmodel


def _labels(task, labels):
    return labels["binary" if task == "binary" else "regression"]


@pytest.mark.parametrize("task,edge_dtype,extra", [
    ("qm9", "float32", {}),
    ("qm9", "bfloat16", {}),
    ("qm9", "float32", {"use_intermediate_gnn_results": True}),
    ("regression", "float32", {}),
    ("regression", "bfloat16", {}),
    ("regression", "float32", {"use_intermediate_gnn_results": False}),
    ("binary", "float32", {}),
    ("binary", "bfloat16", {}),
    ("graph_regression-gnn_edge_mlp", "float32", {}),
])
def test_task_matches_jax(task, edge_dtype, extra):
    jbatch, tbatch, labels = qm9_workload(seed=1)
    params = task_params(task, edge_dtype, **extra)
    jmodel, jparams, tmodel = build_pair(task, params, jbatch)
    target = _labels(task, labels)

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        metrics = jmodel.compute_task_metrics(
            jbatch, out, {"target_value": jnp.asarray(target)})
        return metrics["loss"], (out, metrics)

    (jl, (jout, jmetrics)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(jparams)
    out = tmodel(tbatch, False)
    metrics = tmodel.compute_task_metrics(
        tbatch, out, {"target_value": torch.from_numpy(target)})
    metrics["loss"].backward()
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}

    assert tuple(out.shape) == (MOLECULES + 1,)
    assert_close(out.detach().numpy(), np.asarray(jout), edge_dtype,
                 BF16_OUT_SHARE, "outputs")
    np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                               rtol=LOSS_RTOL)
    assert set(metrics) == set(jmetrics)
    for key in set(metrics) - {"loss", "num_correct", "batch_acc"}:
        np.testing.assert_allclose(float(torch.as_tensor(metrics[key])),
                                   float(jmetrics[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        # A parameter the output does not reach (with intermediates, the
        # last layer's exchange and LayerNorm) has no gradient here and a
        # zero one in the reference.
        mine = got[name].grad
        mine = np.zeros_like(grad.numpy()) if mine is None else mine.numpy()
        assert_close(mine, grad.numpy(), edge_dtype, BF16_GRAD_SHARE, name)


def assert_close(got, want, edge_dtype: str, bf16_share: float, what: str):
    """f32: elementwise at ``F32_TOL``; bf16: the largest difference within
    ``bf16_share`` of the largest |value|."""
    if edge_dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)
        return
    err, largest = np.abs(got - want).max(), np.abs(want).max()
    assert err <= bf16_share * largest, (what, err, largest)


def test_graph_regression_edge_mlp_copy_and_params():
    """The port's copy of the JSON is the JAX package's, and
    ``workloads.graph_regression_edge_mlp_params`` is its model params over
    the task's defaults for the flavour, the JAX package's."""
    from tf2_gnn_tpu_torch import workloads

    port = REPO / "tf2_gnn_tpu_torch" / "harness" / "default_hypers"
    ref = REPO / "tf2_gnn_tpu" / "harness" / "default_hypers"
    shipped = json.loads((ref / EDGE_MLP_JSON).read_text())
    assert json.loads((port / EDGE_MLP_JSON).read_text()) == shipped
    want = JaxRegression.get_default_hyperparameters("gnn_edge_mlp")
    assert GraphRegressionTask.get_default_hyperparameters(
        "gnn_edge_mlp") == want
    want.update(shipped["model_params"])
    got = workloads.graph_regression_edge_mlp_params()
    assert got == want
    assert (got["optimizer"], got["learning_rate"],
            got["gradient_clip_value"]) == ("Adam", 0.0001, 1.0)
    assert got["gnn_use_target_state_as_input"]
    assert got["gnn_num_edge_MLP_hidden_layers"] == 0


def test_readout_width_counts_the_intermediates():
    """Flax infers the readouts' input width; the port states it: the raw
    features and every layer's output (``D + L * H``), or the raw features
    and the final states (``D + H``)."""
    for use, width in ((True, FEATURES + 3 * 32), (False, FEATURES + 32)):
        model = GraphRegressionTask.from_params(
            task_params("regression", use_intermediate_gnn_results=use),
            input_dim=FEATURES, num_edge_types=TYPES, device="cpu")
        assert model.use_intermediate_gnn_results is use
        for readout in (model.weighted_avg_readout,
                        model.weighted_sum_readout):
            assert readout.transformation_mlp.hidden_0.in_features == width
            assert readout.scoring_mlp.hidden_0.in_features == width
    qm9 = tqm9.QM9RegressionTask.from_params(
        task_params("qm9"), input_dim=FEATURES, num_edge_types=TYPES,
        device="cpu", task_id=3)
    assert qm9.task_id == 3
    assert qm9.regression_gate.out.in_features == FEATURES + 32
    assert qm9.regression_transform.out.in_features == 32


def test_bridge_stays_strict_on_the_head_leaves():
    jbatch, _, _ = qm9_workload(seed=2)
    _, jparams, tmodel = build_pair("qm9", task_params("qm9"), jbatch)
    tree = jax.device_get(jparams)
    assert set(tree) == {"gnn", "regression_transform", "regression_gate"}
    extra = dict(tree, regression_gate=dict(
        tree["regression_gate"], hidden_0={"kernel": np.zeros((4, 4))}))
    with pytest.raises(ValueError, match="regression_gate.hidden_0"):
        load_flax_params(tmodel, extra)
    missing = {k: v for k, v in tree.items() if k != "regression_transform"}
    with pytest.raises(RuntimeError, match="regression_transform"):
        load_flax_params(tmodel, missing)


OPTIMIZER_CASES = [
    {"optimizer": "RMSProp"},
    {"optimizer": "RMSProp", "gradient_clip_value": 1.0},
    {"optimizer": "RMSProp", "momentum": 0.0, "rmsprop_rho": 0.9,
     "learning_rate_warmup_steps": 2},
    {"optimizer": "SGD"},
    {"optimizer": "SGD", "gradient_clip_global_norm": 0.5,
     "learning_rate_decay_steps": 3},
]


def _run_optimizers(hypers, grad_scale: float, steps: int = 3):
    """Parameters of optax's and the port's optimizer after each of
    ``steps`` updates with the same gradients (N(0, 1) * ``grad_scale``)."""
    rng = np.random.RandomState(5)
    shapes = {"a": (4, 3), "b": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jopt = joptimizers.make_optimizer(hypers)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in init.items()}
    topt = make_optimizer(hypers, tparams.values())
    trajectory = []
    for step in range(steps):
        grads = {k: (rng.randn(*s) * grad_scale * (1 + step)).astype(
            np.float32) for k, s in shapes.items()}
        updates, jstate = jopt.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        topt.step(step)
        trajectory.append(({k: p.detach().numpy().copy()
                            for k, p in tparams.items()},
                           {k: np.asarray(v) for k, v in jparams.items()}))
    return init, trajectory


@pytest.mark.parametrize("extra", OPTIMIZER_CASES,
                         ids=lambda e: "-".join(f"{k}={v}"
                                                for k, v in e.items()))
def test_optimizer_updates_match_optax(extra):
    hypers = {"learning_rate": 0.01, **extra}
    _, trajectory = _run_optimizers(hypers, grad_scale=1.0)
    for step, (got, want) in enumerate(trajectory):
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8,
                                       err_msg=f"{k} step {step}")


def test_rmsprop_puts_eps_inside_the_root():
    """With gradients of 1e-4, nu stays near 1e-10 after a few updates, so
    ``rsqrt(nu + 1e-7)`` (optax, the port) and ``1 / (sqrt(nu) + 1e-7)``
    (``torch.optim.RMSprop``'s form) differ by a factor of about 20 in the
    step size: the port follows the first."""
    hypers = {"optimizer": "RMSProp", "learning_rate": 0.01}
    init, trajectory = _run_optimizers(hypers, grad_scale=1e-4)
    for got, want in trajectory:
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-9)
    outside = optax.chain(
        optax.scale_by_rms(decay=0.98, eps=1e-7, eps_in_sqrt=False),
        optax.scale_by_learning_rate(0.01), optax.trace(decay=0.85))
    rng = np.random.RandomState(5)
    rng.randn(4, 3), rng.randn(5)  # the initial parameters' draws
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = outside.init(params)
    for step in range(len(trajectory)):
        grads = {k: jnp.asarray((rng.randn(*v.shape) * 1e-4 * (1 + step))
                                .astype(np.float32)) for k, v in init.items()}
        updates, state = outside.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    got = trajectory[-1][0]
    moved = {k: np.abs(got[k] - init[k]).max() for k in init}
    moved_outside = {k: np.abs(np.asarray(params[k]) - init[k]).max()
                     for k in init}
    for k in init:
        assert moved_outside[k] > 10 * moved[k], (moved, moved_outside)


def test_three_qm9_steps_follow_jax(monkeypatch):
    """RMSProp with clipping by value at 1.0 (QM9_RGCN's optimizer) on the
    QM9 head; the exchange's readout MLPs drop out at a hard-wired 0.2 in
    training, set to 0 on both sides."""
    monkeypatch.setattr(jge, "WeightedSumGraphRepresentation",
                        functools.partial(jge.WeightedSumGraphRepresentation,
                                          scoring_mlp_dropout_rate=0.0,
                                          transformation_mlp_dropout_rate=0.0))
    jbatch, tbatch, labels = qm9_workload(seed=3)
    params = task_params("qm9", optimizer="RMSProp", learning_rate=0.000572,
                         rmsprop_rho=0.98, momentum=0.85,
                         gradient_clip_value=1.0)
    jmodel, jparams, tmodel = build_pair("qm9", params, jbatch)
    joptimizer = joptimizers.make_optimizer(params)
    jstate = jcreate(jmodel, jbatch, joptimizer, seed=0)
    jstate = jstate.replace(params=jparams,
                            opt_state=joptimizer.init(jparams))
    jstep = jmake_step(jmodel, joptimizer)
    jlabels = {"target_value": jnp.asarray(labels["regression"])}

    optimizer = make_optimizer(params, tmodel.parameters())
    state = create_train_state(tmodel, optimizer, seed=0)
    step = make_train_step(tmodel, optimizer)
    tlabels = {"target_value": torch.from_numpy(labels["regression"])}

    jlosses, losses = [], []
    for _ in range(3):
        jstate, jmetrics = jstep(jstate, jbatch, jlabels)
        jlosses.append(float(jmetrics["loss"]))
        state, metrics = step(state, tbatch, tlabels)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    want = flax_params_to_state_dict(jax.device_get(jstate.params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    assert math.isfinite(float(make_eval_step(tmodel)(tbatch,
                                                      tlabels)["loss"]))


def test_epoch_metrics_match_jax():
    results = [{"num_graphs": 3.0, "batch_absolute_error": 0.6,
                "batch_squared_error": 0.2, "num_correct": 2.0},
               {"num_graphs": 5.0, "batch_absolute_error": 1.4,
                "batch_squared_error": 0.9, "num_correct": 4.0}]
    pairs = [(JaxRegression.compute_epoch_metrics,
              GraphRegressionTask.compute_epoch_metrics),
             (jqm9.QM9RegressionTask.compute_epoch_metrics,
              tqm9.QM9RegressionTask.compute_epoch_metrics),
             (JaxBinary.compute_epoch_metrics,
              GraphBinaryClassificationTask.compute_epoch_metrics)]
    pairs += [(jqm9.QM9RegressionTask.make_epoch_metrics_fn(t),
               tqm9.QM9RegressionTask.make_epoch_metrics_fn(t))
              for t in (0, 12)]
    for jfn, tfn in pairs:
        assert tfn(results) == jfn(results)
    assert (tqm9.CHEMICAL_ACC_NORMALISING_FACTORS
            == jqm9.CHEMICAL_ACC_NORMALISING_FACTORS)
    for cls in (tqm9.QM9RegressionTask, GraphRegressionTask,
                GraphBinaryClassificationTask):
        jcls = {tqm9.QM9RegressionTask: jqm9.QM9RegressionTask,
                GraphRegressionTask: JaxRegression,
                GraphBinaryClassificationTask: JaxBinary}[cls]
        assert (cls.get_default_hyperparameters("rgcn")
                == jcls.get_default_hyperparameters("rgcn"))
