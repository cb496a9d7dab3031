"""The port's reference-default GNN_Edge_MLP (target-state input, one
hidden edge-MLP layer, GRU global exchange) against the JAX package's on
the CPU, from weights bridged out of the flax params, on a merged-target
PPI-shaped batch:

* the message-passing layer alone: output and parameter gradients, with
  and without the 1/deg normalisation, f32 and bf16 edge streams;
* the whole ``edge_mlp_probe.py`` model at small width (3 layers, so the
  GRU exchange runs after layer 2 as at full depth): eval logits (the
  no-grad route, B6) and loss, the gradient of every parameter (the
  training route, B4 and B5), and three Adam steps along the reference's
  loss trajectory with every dropout at 0 (the two frameworks' dropout bits
  cannot match; the readout MLPs' hard-wired 0.2 is patched to 0 on both
  sides);
* ``workloads.edge_mlp_default_params()`` equal to the probe's dict;
* the model on the scatter-plan route (``_scatter_target_state_one_hidden``:
  per-edge gathers, a relu and L type-masked scatters through B12), with
  and without 1/deg, f32 and bf16 streams; and on a batch carrying both a
  merged-target plan and scatter plans, with the relu-pair gate failing
  on the port's side only, the port routes to the scatter-plan form and
  still matches the JAX package, which takes the relu-pair op there.

Tolerances. f32 edge streams: rtol 1e-4 / atol 1e-6 for the layer (the
same products summed in other orders), atol 1e-5 for the whole model
(MODEL_F32_TOL's reason). bf16 edge streams: rtol
1e-2 / atol 1e-3 on outputs and rtol 2e-2 / atol 3e-5 on gradients, as
for RGAT: both sides round A and B to bf16 from f32 values that differ in
their last bits, so an entry may land on the neighbouring bf16 value (2**-8
relative), and a relu mask may flip on a near-zero z. Losses along the Adam
steps: rtol 1e-4 (f32).
"""
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.harness import optimizers as joptimizers
from tf2_gnn_tpu.harness.training import create_train_state as jcreate
from tf2_gnn_tpu.harness.training import make_train_step as jmake_step
from tf2_gnn_tpu.layers import global_exchange as jge
from tf2_gnn_tpu.layers.message_passing import (
    get_message_passing_class as jget_mp,
)
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu_torch import workloads
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
from tf2_gnn_tpu_torch.layers.message_passing import (
    get_message_passing_class,
)
from tf2_gnn_tpu_torch.layers.mlp import MLP
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_edge_mlp as tpem
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss

from .test_torch_rgcn_model import FEATURES, NUM_LABELS, small_workload
from .test_torch_sorted_models import scatter_workload, with_scatter_plans

TOLS = {"float32": (dict(rtol=1e-4, atol=1e-6), dict(rtol=1e-4, atol=1e-6)),
        "bfloat16": (dict(rtol=1e-2, atol=1e-3), dict(rtol=2e-2, atol=3e-5))}
# The whole model in f32: three layers, the exchange's softmax and GRU and
# the head add reorderings (observed 3e-6 absolute on logits near 1e-3).
MODEL_F32_TOL = dict(rtol=1e-4, atol=1e-5)
# The whole model on the scatter-plan route with a bf16 stream: its
# unnormalised sums of up to a dozen relu messages reach logits of 3.5,
# and the JAX package's own logits move by 7.0e-3 (2.0e-3 of the largest)
# when its weights are scaled by 1 + 1e-7 noise, the bf16 re-rounding of
# A and B that the two frameworks' f32 matmuls reach as well. So logits
# within 2**-8 of the largest |logit| (observed 2.3e-3 of it) and each
# gradient tensor within 2**-6 of its largest |entry| (observed 6.4e-3).
SCATTER_BF16_SHARES = (2.0 ** -8, 2.0 ** -6)


def probe_params(edge_dtype: str = "bfloat16", hidden: int = 24,
                 layers: int = 3):
    """``benchmarks/edge_mlp_probe.py``'s configuration, built with the JAX
    package, at ``hidden``/``layers`` and every dropout rate at 0."""
    params = JaxNodeMulticlassTask.get_default_hyperparameters("gnn_edge_mlp")
    params.update({"gnn_hidden_dim": hidden, "gnn_num_layers": layers,
                   "learning_rate": 0.001,
                   "gnn_num_edge_MLP_hidden_layers": 1,
                   "gnn_edge_dtype": edge_dtype,
                   "gnn_global_exchange_dropout_rate": 0.0})
    return params


def test_edge_mlp_default_params_are_the_probe_config():
    want = JaxNodeMulticlassTask.get_default_hyperparameters("gnn_edge_mlp")
    want.update({"gnn_hidden_dim": 320, "gnn_num_layers": 4,
                 "learning_rate": 0.001,
                 "gnn_num_edge_MLP_hidden_layers": 1,
                 "gnn_edge_dtype": "bfloat16"})
    got = workloads.edge_mlp_default_params()
    assert got == want
    assert got["gnn_use_target_state_as_input"]
    assert got["gnn_global_exchange_mode"] == "gru"
    assert got["gnn_global_exchange_every_num_layers"] == 2


@pytest.fixture
def no_readout_dropout(monkeypatch):
    """The exchange's readout MLPs drop out at 0.2 in training, a rate no
    hyperparameter reaches; set it to 0 in the JAX package for this test."""
    monkeypatch.setattr(jge, "WeightedSumGraphRepresentation",
                        functools.partial(jge.WeightedSumGraphRepresentation,
                                          scoring_mlp_dropout_rate=0.0,
                                          transformation_mlp_dropout_rate=0.0))


def build_pair(params, jbatch, seed=0):
    jmodel = JaxNodeMulticlassTask.from_params(
        params, types.SimpleNamespace(num_node_target_labels=NUM_LABELS))
    jparams = jmodel.init(jax.random.PRNGKey(seed), jbatch, False)["params"]
    tmodel = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    load_flax_params(tmodel, jax.device_get(jparams))
    for module in tmodel.modules():
        if isinstance(module, MLP):
            module.dropout_rate = 0.0
    return jmodel, jparams, tmodel


def test_bridge_round_trips_the_new_leaves():
    """Each flax leaf of the model lands in the port's parameter of the
    same path: the edge-MLP halves and W2 as they are ([L, D, H]), the GRU
    cell's four leaves as they are (flax's packed [in, 3H] layout), the
    readout's Dense kernels transposed into ``nn.Linear``."""
    jbatch, _, _ = small_workload(seed=7, merged=True, merge_targets=True)
    _, jparams, tmodel = build_pair(probe_params("float32", hidden=8),
                                    jbatch)
    flax = jax.device_get(jparams)
    own = tmodel.state_dict()
    layer = flax["gnn"]["mp_layer_1"]
    for name in ("edge_mlp_src_0", "edge_mlp_tgt_0", "edge_mlp_layer_1"):
        np.testing.assert_array_equal(
            own[f"gnn.mp_layer_1.{name}.kernel"].numpy(),
            layer[name]["kernel"])
    exchange = flax["gnn"]["global_exchange_2"]
    for leaf, value in exchange["gru_cell"].items():
        np.testing.assert_array_equal(
            own[f"gnn.global_exchange_2.gru_cell.{leaf}"].numpy(), value)
    readout = exchange["node_to_graph_representation"]
    for mlp in ("scoring_mlp", "transformation_mlp"):
        for dense in ("hidden_0", "out"):
            np.testing.assert_array_equal(
                own[f"gnn.global_exchange_2.node_to_graph_representation."
                    f"{mlp}.{dense}.weight"].numpy(),
                readout[mlp][dense]["kernel"].T)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_layer_matches_jax(normalize, edge_dtype):
    jbatch, tbatch, _ = small_workload(seed=2, merged=True,
                                       merge_targets=True)
    hp = jget_mp("gnn_edge_mlp").get_default_hyperparameters()
    hp.update({"hidden_dim": 16, "edge_dtype": edge_dtype,
               "normalize_by_num_incoming": normalize})
    rng = np.random.RandomState(5)
    states = rng.randn(tbatch.num_nodes_padded, 20).astype(np.float32)
    cot = rng.randn(tbatch.num_nodes_padded, 16).astype(np.float32)

    jlayer = jget_mp("gnn_edge_mlp").from_params(hp)
    jparams = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(states), jbatch,
                          False)["params"]
    assert set(jparams) == {"edge_mlp_src_0", "edge_mlp_tgt_0",
                            "edge_mlp_layer_1"}

    def jloss(p, x):
        out = jlayer.apply({"params": p}, x, jbatch, False)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, jout), (jgrads, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(states))

    layer = get_message_passing_class("gnn_edge_mlp").from_params(
        hp, num_edge_types=3, input_dim=20)
    layer.load_state_dict(flax_params_to_state_dict(jax.device_get(jparams)))
    x = torch.from_numpy(states).requires_grad_(True)
    out = layer(x, tbatch, False)
    (out * torch.from_numpy(cot)).sum().backward()

    out_tol, grad_tol = TOLS[edge_dtype]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **out_tol)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **grad_tol)
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    for name, param in layer.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **grad_tol)
    with torch.no_grad():
        np.testing.assert_allclose(layer(x, tbatch, False).numpy(),
                                   out.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_model_forward_and_gradients_match_jax(edge_dtype):
    jbatch, tbatch, labels = small_workload(seed=3, merged=True,
                                            merge_targets=True)
    params = probe_params(edge_dtype)
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    assert "global_exchange_2" in jparams["gnn"]
    assert set(jparams["gnn"]["global_exchange_2"]["gru_cell"]) == {
        "kernel", "recurrent_kernel", "input_bias", "recurrent_bias"}
    out_tol, grad_tol = TOLS[edge_dtype]
    if edge_dtype == "float32":
        out_tol = grad_tol = MODEL_F32_TOL
    jlabels = {"node_labels": jnp.asarray(labels)}
    tlabels = {"node_labels": torch.from_numpy(labels)}

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        return jmodel.compute_task_metrics(jbatch, out, jlabels)["loss"], out[0]

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    out = tmodel(tbatch, False)
    metrics = tmodel.compute_task_metrics(tbatch, out, tlabels)
    metrics["loss"].backward()
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jlogits),
                               **out_tol)
    np.testing.assert_allclose(float(metrics["loss"].detach()), float(jl),
                               rtol=out_tol["rtol"])
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), grad.numpy(),
                                   err_msg=name, **grad_tol)

    # The eval step runs without gradients: the eval forward (B6).
    eval_metrics = make_eval_step(tmodel)(tbatch, tlabels)
    np.testing.assert_allclose(float(eval_metrics["loss"]), float(jl),
                               rtol=out_tol["rtol"])


def test_three_adam_steps_follow_jax(no_readout_dropout):
    jbatch, tbatch, labels = small_workload(seed=6, merged=True,
                                            merge_targets=True)
    params = probe_params("float32")
    jmodel, jparams, tmodel = build_pair(params, jbatch)

    joptimizer = joptimizers.make_optimizer(params)
    jstate = jcreate(jmodel, jbatch, joptimizer, seed=0)
    jstate = jstate.replace(params=jparams,
                            opt_state=joptimizer.init(jparams))
    jstep = jmake_step(jmodel, joptimizer)
    jlabels = {"node_labels": jnp.asarray(labels)}

    optimizer = make_optimizer(params, tmodel.parameters())
    state = create_train_state(tmodel, optimizer, seed=0)
    step = make_train_step(tmodel, optimizer)
    tlabels = {"node_labels": torch.from_numpy(labels)}

    jlosses, losses = [], []
    for _ in range(3):
        jstate, jmetrics = jstep(jstate, jbatch, jlabels)
        jlosses.append(float(jmetrics["loss"]))
        state, metrics = step(state, tbatch, tlabels)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert math.isfinite(float(make_eval_step(tmodel)(tbatch,
                                                      tlabels)["loss"]))


def test_routes_by_grad_mode():
    """With gradients the layer runs the training forward (B4, whose mask
    sum feeds the backward); under ``torch.no_grad`` the eval forward
    (B6). Counted through the wrappers' plain versions here."""
    _, tbatch, _ = small_workload(seed=4, merged=True, merge_targets=True)
    hp = get_message_passing_class("gnn_edge_mlp").get_default_hyperparameters()
    hp["hidden_dim"] = 8
    layer = get_message_passing_class("gnn_edge_mlp").from_params(
        hp, num_edge_types=3, input_dim=8)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    calls = []

    def spy(name):
        real = getattr(tpem, name)

        def wrapper(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return wrapper

    x = torch.randn(tbatch.num_nodes_padded, 8)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("relu_pair_fwd", "relu_pair_fwd_m", "relu_pair_da"):
            mp.setattr(tpem, name, spy(name))
        layer(x, tbatch, False).sum().backward()
        assert calls == ["relu_pair_fwd_m", "relu_pair_da"]
        calls.clear()
        with torch.no_grad():
            layer(x, tbatch, False)
        assert calls == ["relu_pair_fwd"]


def _share_close(got, want, share: float, what: str) -> None:
    err, largest = np.abs(got - want).max(), np.abs(want).max()
    assert err <= share * largest, (what, err, largest, err / largest)


def _model_matches_jax(params, jbatch, tbatch, labels):
    """Logits, loss and every parameter gradient of the whole model:
    f32 streams at ``MODEL_F32_TOL``; bf16 streams (the scatter-plan
    route) each tensor within ``SCATTER_BF16_SHARES`` of its largest
    |entry|, the loss at rtol 1e-2."""
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    edge_dtype = params["gnn_edge_dtype"]
    out_tol = grad_tol = MODEL_F32_TOL
    jlabels = {"node_labels": jnp.asarray(labels)}

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        return jmodel.compute_task_metrics(jbatch, out, jlabels)["loss"], out[0]

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    out = tmodel(tbatch, False)
    metrics = tmodel.compute_task_metrics(
        tbatch, out, {"node_labels": torch.from_numpy(labels)})
    metrics["loss"].backward()
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    if edge_dtype == "bfloat16":
        out_share, grad_share = SCATTER_BF16_SHARES
        _share_close(out[0].detach().numpy(), np.asarray(jlogits), out_share,
                     "logits")
        np.testing.assert_allclose(float(metrics["loss"].detach()),
                                   float(jl), rtol=1e-2)
        for name, param in tmodel.named_parameters():
            _share_close(param.grad.numpy(), want[name].numpy(), grad_share,
                         name)
        return tmodel
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jlogits),
                               **out_tol)
    np.testing.assert_allclose(float(metrics["loss"].detach()), float(jl),
                               rtol=out_tol["rtol"])
    for name, param in tmodel.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **grad_tol)
    return tmodel


def _spy_scatters(monkeypatch):
    """Record the calls of ``plan_scatter`` (B12's stream form)."""
    calls = []
    real = tss.plan_scatter

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tss, "plan_scatter", spy)
    from tf2_gnn_tpu_torch.layers.message_passing import gnn_edge_mlp

    monkeypatch.setattr(gnn_edge_mlp, "plan_scatter", spy)
    return calls


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_scatter_route_matches_jax(normalize, edge_dtype, monkeypatch):
    """The model on scatter plans alone: per layer L type-masked scatters
    forward."""
    jbatch, tbatch, labels = scatter_workload(seed=8)
    params = dict(probe_params(edge_dtype),
                  gnn_normalize_by_num_incoming=normalize)
    calls = _spy_scatters(monkeypatch)
    tmodel = _model_matches_jax(params, jbatch, tbatch, labels)
    assert tmodel.gnn.mp_layer_0._route(tbatch) == "scatter_one_hidden"
    assert len(calls) == 3 * params["gnn_num_layers"]


def test_failed_relu_pair_gate_routes_to_scatter_plans(monkeypatch):
    """A batch with a merged-target plan and scatter plans: with the
    relu-pair gate passing the port takes the relu-pair op, as the JAX
    package does; with the port's gate failing (its budget set to 0) the
    scatter-plan form, which gives the JAX package's results all the
    same."""
    jbatch, tbatch, labels = with_scatter_plans(
        *small_workload(seed=9, merged=True, merge_targets=True))
    params = probe_params("float32")
    calls = _spy_scatters(monkeypatch)
    tmodel = _model_matches_jax(params, jbatch, tbatch, labels)
    assert tmodel.gnn.mp_layer_0._route(tbatch) == "relu_pair" and not calls
    monkeypatch.setattr(tpem, "VMEM_DUAL_TABLE_BUDGET_BYTES", 0)
    tmodel = _model_matches_jax(params, jbatch, tbatch, labels)
    assert tmodel.gnn.mp_layer_0._route(tbatch) == "scatter_one_hidden"
    assert len(calls) == 3 * params["gnn_num_layers"]


def test_unported_forms_raise():
    """Two hidden layers need per-edge matmuls; the one-hidden form on a
    merged plan with local targets, or with the relu-pair gate failing,
    and no scatter plans takes the unfused path in the JAX package: each
    raises, naming it."""
    params = probe_params("float32", hidden=8, layers=2)
    _, merged_batch, _ = small_workload(seed=5, merged=True)
    _, targets_batch, _ = small_workload(seed=5, merged=True,
                                         merge_targets=True)
    with pytest.raises(NotImplementedError, match="one hidden layer"):
        NodeMulticlassTask.from_params(
            dict(params, gnn_num_edge_MLP_hidden_layers=2),
            input_dim=FEATURES, num_edge_types=3, device="cpu")
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    with pytest.raises(NotImplementedError, match="merged-target"):
        model(merged_batch, False)
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tpem, "VMEM_DUAL_TABLE_BUDGET_BYTES", 0)
            model(targets_batch, False)
