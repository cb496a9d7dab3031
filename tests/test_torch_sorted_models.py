"""The port's NodeMulticlassTask on the scatter-plan route against the JAX
package's on the CPU (whose sorted-scatter Pallas kernels run in interpret
mode here), from weights bridged out of the flax params, dropout 0:

* RGCN (source-only edge MLP over ``typed_gather_scatter``, B13) and RGAT
  (the sorted fallback: B12, B14, B15), 2 layers at hidden 16: logits,
  loss and the gradient of every parameter; RGCN also with a bf16 stream
  and 1/deg scales, whose scales B13 rounds to bf16 as the reference does;
* three Adam steps of the RGCN task along the reference's loss trajectory;
* one set of bridged RGAT weights serving both routes (merged pair plans
  and scatter plans), each against the reference on the same batch;
* ``workloads.rgcn_sorted_params()`` equal to the dict that ``bench.py``
  builds for its ``"sorted"`` path.

The same batch without its scatter plans, and the target-state edge MLP
without ``fused_target_gather``, take the unfused per-edge path in both
packages and match.

Tolerances. f32 edge streams: rtol 1e-4 / atol 1e-5 on logits and
gradients (the same products summed in other orders), losses rtol 1e-4.
bf16 edge streams (RGAT): logits rtol 1e-2 / atol 1e-3, gradients rtol
2e-2 / atol 3e-5, loss rtol 1e-3, as in ``test_torch_rgat_model.py``: the
bundle is rounded to bf16 from f32 values that differ in their last bits,
so an entry may land on the neighbouring bf16 value (2**-8 relative).
"""
import ast
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.harness import optimizers as joptimizers
from tf2_gnn_tpu.harness.training import create_train_state as jcreate
from tf2_gnn_tpu.harness.training import make_train_step as jmake_step
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu.ops import spmm_pallas as jsp
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
from tf2_gnn_tpu_torch.layers.message_passing import rgat as trgat
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss

from .test_torch_rgat_model import make_params as rgat_params
from .test_torch_rgcn_model import FEATURES, NUM_LABELS, small_workload


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
TOLS = {"float32": (dict(rtol=1e-4, atol=1e-5), dict(rtol=1e-4, atol=1e-5)),
        "bfloat16": (dict(rtol=1e-2, atol=1e-3), dict(rtol=2e-2, atol=3e-5))}
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}


def scatter_workload(seed: int):
    """``small_workload``'s batch with the merged scatter plan instead of
    pair plans, planned by each package (the form of
    ``bench.py::build_batch(use_pallas=True, use_pairs=False)``)."""
    jbatch, tbatch, labels = small_workload(seed)
    return with_scatter_plans(jbatch.replace(pair_plans_typed=None),
                              tbatch.replace(pair_plans_typed=None), labels)


def with_scatter_plans(jbatch, tbatch, labels):
    """The batches with the merged scatter plan added, planned by each
    package (beside whatever pair plans they carry)."""
    srcs = [np.asarray(s) for s in jbatch.edge_sources]
    tgts = [np.asarray(t) for t in jbatch.edge_targets]
    cnts = [int(c) for c in np.asarray(jbatch.num_edges)]
    v = tbatch.num_nodes_padded
    jbatch = jbatch.replace(
        scatter_plans=jsp.build_merged_plans(srcs, tgts, cnts, v).astuple())
    tbatch = tbatch.replace(
        scatter_plans=tss.build_merged_plans(srcs, tgts, cnts,
                                             v).astuple()).to("cpu")
    return jbatch, tbatch, labels


def rgcn_params(normalize: bool = True):
    params = JaxNodeMulticlassTask.get_default_hyperparameters("rgcn")
    params.update({"gnn_num_layers": 2, "gnn_hidden_dim": 16,
                   "gnn_normalize_by_num_incoming": normalize,
                   "gnn_dense_every_num_layers": 10000,
                   "gnn_residual_every_num_layers": 10000,
                   "gnn_global_exchange_every_num_layers": 10000,
                   "gnn_layer_input_dropout_rate": 0.0})
    return params


def sorted_rgat_params(edge_dtype: str):
    """The shipped PPI_RGAT layout at 2 layers, hidden 16, 4 heads."""
    params = rgat_params("h24_k4", edge_dtype)
    params.update({"gnn_num_layers": 2, "gnn_hidden_dim": 16})
    return params


def build_pair(params, jbatch, seed=0):
    jmodel = JaxNodeMulticlassTask.from_params(
        params, types.SimpleNamespace(num_node_target_labels=NUM_LABELS))
    jparams = jmodel.init(jax.random.PRNGKey(seed), jbatch, False)["params"]
    tmodel = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    load_flax_params(tmodel, jax.device_get(jparams))
    return jmodel, jparams, tmodel


def assert_matches_jax(jmodel, jparams, tmodel, jbatch, tbatch, labels,
                       edge_dtype: str, tols=None, loss_rtol=None):
    """Logits, loss and every parameter gradient of one forward (at the
    edge dtype's tolerances unless ``tols`` = (logits, gradients) and
    ``loss_rtol`` are given)."""
    out_tol, grad_tol = tols or TOLS[edge_dtype]

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        metrics = jmodel.compute_task_metrics(
            jbatch, out, {"node_labels": jnp.asarray(labels)})
        return metrics["loss"], out[0]

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tmodel.zero_grad()
    out = tmodel(tbatch, False)
    metrics = tmodel.compute_task_metrics(
        tbatch, out, {"node_labels": torch.from_numpy(labels)})
    metrics["loss"].backward()
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jlogits),
                               **out_tol)
    np.testing.assert_allclose(float(metrics["loss"].detach()), float(jl),
                               rtol=loss_rtol or LOSS_RTOL[edge_dtype])
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), grad.numpy(),
                                   err_msg=name, **grad_tol)


def _spy_launches(monkeypatch, names):
    """Record the calls of the sorted wrappers the layers reach (through
    the ops module, or imported into the RGAT layer's)."""
    calls = []
    for name in names:
        real = getattr(tss, name)

        def wrapper(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        for module in (tss, trgat):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("normalize", [True, False])
def test_rgcn_on_scatter_plans_matches_jax(normalize, monkeypatch):
    jbatch, tbatch, labels = scatter_workload(seed=3)
    params = rgcn_params(normalize)
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    calls = _spy_launches(monkeypatch, ["sorted_segment_sum_scaled"])
    assert_matches_jax(jmodel, jparams, tmodel, jbatch, tbatch, labels,
                       "float32")
    # B13 once per layer forward and once per layer backward.
    assert calls == ["sorted_segment_sum_scaled"] * 4


def test_bf16_rgcn_on_scatter_plans_rounds_the_scale_as_jax(monkeypatch):
    """RGCN with a bf16 edge stream and 1/deg scales: the reference's B13
    rounds ``onehot * scale`` to bf16 before its product, so the port
    rounds each 1/deg scale to bf16 before B13 (or its plain version)
    reads it. Both sides then sum the same bf16 products in f32, and the
    tolerance is that of the per-type bf16 RGCN model test (rtol 2e-3 /
    atol 1e-4) with the loss at rtol 1e-5. With the scale kept in f32
    the logits differ by up to 5.4e-3 and the gradients by up to 1.7e-3
    (rounded scales: 2.4e-7 and 1e-7)."""
    jbatch, tbatch, labels = scatter_workload(seed=3)
    params = dict(rgcn_params(normalize=True), gnn_edge_dtype="bfloat16")
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    calls = _spy_launches(monkeypatch, ["sorted_segment_sum_scaled"])
    tol = dict(rtol=2e-3, atol=1e-4)
    assert_matches_jax(jmodel, jparams, tmodel, jbatch, tbatch, labels,
                       "bfloat16", tols=(tol, tol), loss_rtol=1e-5)
    assert calls == ["sorted_segment_sum_scaled"] * 4


@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_rgat_on_scatter_plans_matches_jax(edge_dtype, monkeypatch):
    jbatch, tbatch, labels = scatter_workload(seed=4)
    params = sorted_rgat_params(edge_dtype)
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    calls = _spy_launches(monkeypatch, [
        "sorted_segment_sum", "sorted_segment_max", "attention_scatter_sums"])
    assert_matches_jax(jmodel, jparams, tmodel, jbatch, tbatch, labels,
                       edge_dtype)
    # Per layer: B15 and B14 forward, B12 twice backward.
    assert sorted(calls) == sorted(
        ["sorted_segment_max", "attention_scatter_sums"] * 2
        + ["sorted_segment_sum"] * 4)


def test_one_set_of_rgat_weights_serves_both_routes():
    """Weights initialised by the reference on a merged-pair-plan batch and
    bridged once drive the port on that batch (pair attention) and on the
    scatter-plan batch of the same graph (the sorted fallback); each
    matches the reference on the same batch."""
    jpair, tpair, labels = small_workload(seed=5, merged=True)
    jscatter, tscatter, labels_s = scatter_workload(seed=5)
    np.testing.assert_array_equal(labels, labels_s)
    params = sorted_rgat_params("float32")
    jmodel, jparams, tmodel = build_pair(params, jpair)
    for jbatch, tbatch in ((jpair, tpair), (jscatter, tscatter)):
        with torch.no_grad():
            (logits,) = tmodel(tbatch, False)
        (jlogits,) = jmodel.apply({"params": jparams}, jbatch, False)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOLS["float32"][0])
    with torch.no_grad():
        pair_logits = tmodel(tpair, False)[0]
        sorted_logits = tmodel(tscatter, False)[0]
    # The two routes differ only in the softmax stabiliser (bound vs exact)
    # and in the division's epsilon.
    np.testing.assert_allclose(sorted_logits.numpy(), pair_logits.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_three_adam_steps_of_the_sorted_rgcn_follow_jax():
    jbatch, tbatch, labels = scatter_workload(seed=6)
    params = rgcn_params()
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


def _bench_sorted_params():
    """The dict ``bench.py::main``'s ``measure`` builds with
    ``use_pairs=False`` (read from its source: the function is local)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    measure = next(node for node in ast.walk(tree)
                   if isinstance(node, ast.FunctionDef)
                   and node.name == "measure")
    update = next(node for node in ast.walk(measure)
                  if isinstance(node, ast.Call)
                  and getattr(node.func, "attr", None) == "update"
                  and isinstance(node.args[0], ast.Dict))
    params = JaxNodeMulticlassTask.get_default_hyperparameters("rgcn")
    params.update(ast.literal_eval(update.args[0]))
    return params


def test_rgcn_sorted_params_are_the_bench_sorted_config():
    want = _bench_sorted_params()
    got = workloads.rgcn_sorted_params()
    assert got == want
    assert got["gnn_edge_dtype"] == "float32"
    assert got["gnn_hidden_dim"] == 320 and got["gnn_num_layers"] == 4
    assert got["gnn_normalize_by_num_incoming"] is True


def test_batches_without_plans_raise():
    """Without its scatter plans, the batch takes the unfused per-edge
    path, and so does the target-state edge MLP on scatter plans without
    ``fused_target_gather`` (the reference's switch); each matches the
    JAX package on the same batch (the test's name is its id from when
    these raised)."""
    jbatch, tbatch, labels = scatter_workload(seed=7)
    jbare = jbatch.replace(scatter_plans=None)
    bare = tbatch.replace(scatter_plans=None, scatter_merged=None)
    edge_mlp = dict(JaxNodeMulticlassTask.get_default_hyperparameters(
        "gnn_edge_mlp"), gnn_hidden_dim=8, gnn_num_layers=2,
        gnn_global_exchange_every_num_layers=10000,
        gnn_layer_input_dropout_rate=0.0)
    for params, edge_dtype in (
            (rgcn_params(), "float32"),
            (sorted_rgat_params("float32"), "float32"),
            (dict(edge_mlp, gnn_fused_target_gather=True), "float32")):
        jmodel, jparams, model = build_pair(params, jbatch)
        assert model.gnn.mp_layer_0._route(tbatch) != "unfused"
        assert_matches_jax(jmodel, jparams, model, jbare, bare, labels,
                           edge_dtype)
        assert model.gnn.mp_layer_0._route(bare) == "unfused"
    jmodel, jparams, model = build_pair(
        dict(edge_mlp, gnn_fused_target_gather=False), jbatch)
    assert_matches_jax(jmodel, jparams, model, jbatch, tbatch, labels,
                       "float32")
    assert model.gnn.mp_layer_0._route(tbatch) == "unfused"
