"""The port's NodeMulticlassTask with RGAT (pair attention over a merged
plan, or over per-type plans) against the JAX package's on the CPU, from
weights bridged out of the flax params: logits, loss and the gradient of
every parameter, at hidden 24 with 4 heads and at hidden 12 with 3 heads
(padded to 4) on merged plans; on per-type plans under both stabilisers;
at hidden 16 with 8 heads (whose attention sums take the hk-major
aggregation kernel, B10) on both plan forms; one layer at hidden 576 with
4 heads (wider than B9's register row) on a batch with pair plans only;
and three Adam steps along the
reference's loss trajectory, on merged plans and on per-type plans with the
"exact" stabiliser (B11). Dropout is 0, since the two frameworks' dropout
bits cannot match.

Tolerances. f32 edge streams: rtol 1e-4 / atol 1e-6 (the same products
summed in other orders; observed 1e-7 absolute on logits, 1e-8 on
gradients). bf16 edge streams: logits rtol 1e-2 / atol 1e-3, gradients
rtol 2e-2 / atol 3e-5: the tables and scores are rounded to bf16 from f32
values that differ in their last bits, so an entry may round to the
neighbouring bf16 value (2**-8 relative), and both sides round the
attention gradients to bf16 too (observed 2.5e-4 absolute on logits of
magnitude ~1, 9e-6 on gradients of magnitude up to 3e-2). Losses along the
Adam steps: rtol 1e-4 (f32) and 1e-3 (bf16).
"""
import json
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
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask

from .test_torch_rgcn_model import FEATURES, NUM_LABELS, small_workload

REPO = Path(__file__).resolve().parents[1]
TOLS = {"float32": (dict(rtol=1e-4, atol=1e-6), dict(rtol=1e-4, atol=1e-6)),
        "bfloat16": (dict(rtol=1e-2, atol=1e-3), dict(rtol=2e-2, atol=3e-5))}
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
WIDTHS = {"h24_k4": (24, 4), "h12_k3": (12, 3)}
EIGHT_HEADS = (16, 8)   # head_dim 2: K = 8 > 4 heads a 128-column tile
WIDE = (576, 4)         # wider than B9's register row (512 columns)


def make_params(width, edge_dtype: str, stabiliser: str = "bound"):
    """The shipped PPI_RGAT layout at small width (a name of ``WIDTHS`` or
    a (hidden, heads) pair), dropout 0."""
    hidden, heads = WIDTHS[width] if isinstance(width, str) else width
    params = JaxNodeMulticlassTask.get_default_hyperparameters("rgat")
    shipped = json.loads((REPO / "tf2_gnn_tpu_torch" / "harness"
                          / "default_hypers" / "PPI_RGAT.json").read_text())
    params.update(shipped["model_params"])
    params.update({"gnn_hidden_dim": hidden, "gnn_num_heads": heads,
                   "gnn_edge_dtype": edge_dtype,
                   "gnn_attention_stabiliser": stabiliser,
                   "gnn_layer_input_dropout_rate": 0.0})
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


def test_default_hypers_are_the_shipped_file():
    ours = REPO / "tf2_gnn_tpu_torch" / "harness" / "default_hypers"
    theirs = REPO / "tf2_gnn_tpu" / "harness" / "default_hypers"
    assert (json.loads((ours / "PPI_RGAT.json").read_text())
            == json.loads((theirs / "PPI_RGAT.json").read_text()))


def check_forward_loss_and_gradients(params, edge_dtype, jbatch, tbatch,
                                     labels):
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    out_tol, grad_tol = TOLS[edge_dtype]

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        metrics = jmodel.compute_task_metrics(
            jbatch, out, {"node_labels": jnp.asarray(labels)})
        return metrics["loss"], out[0]

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    out = tmodel(tbatch, False)
    metrics = tmodel.compute_task_metrics(
        tbatch, out, {"node_labels": torch.from_numpy(labels)})
    metrics["loss"].backward()

    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jlogits),
                               **out_tol)
    np.testing.assert_allclose(float(metrics["loss"].detach()), float(jl),
                               rtol=LOSS_RTOL[edge_dtype])
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    assert any("edge_attention_parameters" in name for name in want)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), grad.numpy(),
                                   err_msg=name, **grad_tol)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_forward_loss_and_gradients_match_jax(width, edge_dtype):
    jbatch, tbatch, labels = small_workload(seed=3, merged=True)
    check_forward_loss_and_gradients(make_params(width, edge_dtype),
                                     edge_dtype, jbatch, tbatch, labels)


@pytest.mark.parametrize("stabiliser", ["bound", "exact"])
@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_per_type_plans_match_jax(stabiliser, edge_dtype):
    """Per-type plans: ``pair_attention_typed``, one launch per type."""
    jbatch, tbatch, labels = small_workload(seed=7)
    assert tbatch.pair_merged is None and len(tbatch.pair_typed) == 3
    check_forward_loss_and_gradients(
        make_params("h24_k4", edge_dtype, stabiliser), edge_dtype, jbatch,
        tbatch, labels)


def test_per_type_device_forms_built_at_first_read():
    """A per-type batch builds each device form of its plans only when a
    model reads it, once; a host batch has none."""
    tbatch = small_workload(seed=7)[1]
    host = tbatch.replace(node_features=tbatch.node_features.numpy())
    assert host.pair_typed is None and host.pair_stream_joint is None
    assert tbatch._typed_forms == {}
    typed = tbatch.pair_typed
    assert list(tbatch._typed_forms) == ["typed"]
    assert tbatch.pair_typed is typed
    assert all(p.fwd[0].device.type == "cpu" for p in typed)
    assert tbatch.pair_stream_joint is not None
    assert sorted(tbatch._typed_forms) == ["joint", "typed"]
    assert tbatch.replace()._typed_forms == {}


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_eight_heads_match_jax(merged, edge_dtype):
    """8 heads of 2 features: the attention sums take B10 on both plan
    forms."""
    jbatch, tbatch, labels = small_workload(seed=8, merged=merged)
    check_forward_loss_and_gradients(make_params(EIGHT_HEADS, edge_dtype),
                                     edge_dtype, jbatch, tbatch, labels)


@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_layer_wider_than_b9s_register_row_matches_jax(edge_dtype):
    """One layer of 4 heads of 144 features (H = 576: B10 for the sums,
    since a head does not fit a 128-column tile, and B9's tiled form on
    the card) on a batch with pair plans only, the form of the shipped
    PPI_RGAT batches, where the port once raised."""
    jbatch, tbatch, labels = small_workload(seed=11, merged=True)
    assert tbatch.scatter_merged is None
    params = dict(make_params(WIDE, edge_dtype), gnn_num_layers=1)
    check_forward_loss_and_gradients(params, edge_dtype, jbatch, tbatch,
                                     labels)


def check_three_adam_steps(params, edge_dtype, jbatch, tbatch, labels):
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
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL[edge_dtype])
    assert losses[-1] < losses[0]
    assert math.isfinite(float(make_eval_step(tmodel)(tbatch,
                                                      tlabels)["loss"]))


@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_three_adam_steps_follow_jax(edge_dtype):
    jbatch, tbatch, labels = small_workload(seed=6, merged=True)
    check_three_adam_steps(make_params("h24_k4", edge_dtype), edge_dtype,
                           jbatch, tbatch, labels)


@pytest.mark.parametrize("edge_dtype", ["float32", "bfloat16"])
def test_three_adam_steps_per_type_exact_follow_jax(edge_dtype):
    jbatch, tbatch, labels = small_workload(seed=9)
    check_three_adam_steps(make_params("h24_k4", edge_dtype, "exact"),
                           edge_dtype, jbatch, tbatch, labels)


def test_attention_parameters_get_batch_axis_glorot_init():
    params = make_params("h24_k4", "float32")
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    attention = model.gnn.mp_layer_0.edge_attention_parameters.detach()
    assert tuple(attention.shape) == (3, 4, 12)
    limit = math.sqrt(6.0 / (4 + 12))  # fans: heads in, 2 * head_dim out
    assert float(attention.abs().max()) <= limit
    assert float(attention.abs().max()) > 0.5 * limit
    assert float(attention.std()) > 0.25 * limit


def test_unported_routes_raise():
    """The per-type route and the exact stabiliser are ported now; what
    still raises: a batch with no plans, merged targets (outside the pair
    path, without the scatter plans of the B14 fallback), a hidden width
    the heads do not divide, and an unknown stabiliser."""
    params = make_params("h24_k4", "float32")
    _, typed_batch, _ = small_workload(seed=5)
    _, merged_batch, _ = small_workload(seed=5, merged=True)
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURES, num_edge_types=3, device="cpu",
        num_labels=NUM_LABELS)
    (logits,) = model(typed_batch, False)
    assert bool(torch.isfinite(logits).all())
    bare = merged_batch.replace(pair_plans=None, pair_merged=None)
    with pytest.raises(NotImplementedError, match="merged pair plans"):
        model(bare, False)
    with pytest.raises(NotImplementedError, match="B14"):
        model(merged_batch.replace(pair_targets_merged=True), False)
    exact = NodeMulticlassTask.from_params(
        dict(params, gnn_attention_stabiliser="exact"), input_dim=FEATURES,
        num_edge_types=3, device="cpu", num_labels=NUM_LABELS)
    assert bool(torch.isfinite(exact(merged_batch, False)[0]).all())
    unknown = NodeMulticlassTask.from_params(
        dict(params, gnn_attention_stabiliser="max"), input_dim=FEATURES,
        num_edge_types=3, device="cpu", num_labels=NUM_LABELS)
    with pytest.raises(ValueError, match="unknown stabiliser"):
        unknown(merged_batch, False)
    with pytest.raises(ValueError, match="divisible"):
        NodeMulticlassTask.from_params(
            dict(params, gnn_hidden_dim=25), input_dim=FEATURES,
            num_edge_types=3, device="cpu")
