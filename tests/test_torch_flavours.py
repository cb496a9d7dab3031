"""The port's GGNN, RGIN, the 0-hidden target-state GNN_Edge_MLP and
GNN-FiLM against the JAX package's on the CPU, each in its shipped PPI
configuration (``harness/default_hypers/PPI_*.json``) cut to 2 layers of
hidden 16 with every dropout at 0, on a small per-type-plan PPI-shaped
batch, from weights bridged out of the flax params: logits, loss and the
gradient of every parameter; the same on the other plan kinds, each route
as the JAX package takes it on the same batch (``ROUTES``: RGCN, GGNN,
RGIN and the source-only GNN_Edge_MLP over a merged pair plan with local
targets, ``pair_typed_gather_scatter``; the factorised forms over a
merged-target plan; the 0-hidden target-state GNN_Edge_MLP and the
source-only GNN-FiLM over scatter plans); the flavours' own flax leaves
(GGNN's ``gru_cell``, RGIN's ``aggregation_mlp``, FiLM's
``film_mlp_layer_i``) landing where the strict bridge puts them; the
port's copies of the five JSONs equal to the JAX package's; and the routes
that stay unported raising.

Tolerances, as ``test_torch_rgcn_model.py``: f32 edge streams rtol 1e-4 /
atol 1e-5 (the same products summed in other orders by XLA and PyTorch);
bf16 edge streams rtol 2e-3 / atol 1e-4 (an entry rounded to bf16 from
f32 values that differ in their last bits may land on the neighbouring
bf16 value, 2**-8 relative, and carry that downstream). The shipped bf16
GGNN sums its messages unnormalised and RGIN's LayerNorm rescales them,
so such a flip moves a logit further: by 1.7e-3 (GGNN, logits up to 1.9)
and 8.9e-4 (RGIN), exactly what nudging the port's own f32 tables by one
f32 ulp before the cast moves them; their logits get atol
``BF16_LOGIT_ATOL`` = 4e-3 (gradients and loss keep the bf16 tolerance:
observed 7.5e-5 and 1.5e-6 relative). On ``ROUTES``' batch the shipped
bf16 RGIN's gradients take one such flip further: two entries of
``edge_mlp_layer_1``'s kernel gradient differ by 1.4e-4 (3% of
themselves), on per-type plans (the route the first table holds) exactly
as on the merged plan, while the same route with an f32 stream matches at
the f32 tolerance. So the bf16 routes' gradients are held, instead of
elementwise, to ``BF16_ROUTE_GRAD_SHARE`` = 2**-8 of each tensor's
largest |entry| (observed 5.1e-4 of it), as ``test_torch_graph_tasks.py``
holds its bf16 gradients.
"""
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.harness.import_jax import (
    flax_params_to_state_dict,
    load_flax_params,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask

from .test_torch_rgcn_model import FEATURES, NUM_LABELS, TOLS, small_workload
from .test_torch_sorted_models import scatter_workload

REPO = Path(__file__).resolve().parents[1]
BF16_LOGIT_ATOL = 4e-3
BF16_ROUTE_GRAD_SHARE = 2.0 ** -8
SHIPPED = {"rgcn": "PPI_RGCN.json", "ggnn": "PPI_GGNN.json",
           "rgin": "PPI_RGIN.json",
           "gnn_edge_mlp": "PPI_GNN_Edge_MLP.json",
           "gnn_film": "PPI_GNN_FiLM.json"}

# (style, overrides of the shipped configuration)
CASES = {
    "ggnn": ("ggnn", {}),
    "ggnn_f32": ("ggnn", {"gnn_edge_dtype": "float32",
                          "gnn_normalize_by_num_incoming": True}),
    "rgin": ("rgin", {}),
    "rgin_aggr_mlp": ("rgin", {"gnn_num_aggr_MLP_hidden_layers": 1,
                               "gnn_edge_dtype": "float32"}),
    "edge_mlp_target_0": ("gnn_edge_mlp", {}),
    "edge_mlp_target_0_norm": ("gnn_edge_mlp",
                               {"gnn_normalize_by_num_incoming": True}),
    "film_target": ("gnn_film", {}),
    "film_target_film_hidden": ("gnn_film", {
        "gnn_film_parameter_MLP_hidden_layers": [16],
        "gnn_normalize_by_num_incoming": True}),
    "film_source": ("gnn_film", {"gnn_use_target_state_as_input": False}),
    "film_source_film_hidden": ("gnn_film", {
        "gnn_use_target_state_as_input": False,
        "gnn_num_edge_MLP_hidden_layers": 1,
        "gnn_film_parameter_MLP_hidden_layers": [8]}),
}


# The routes over the other plan kinds: (style, overrides of the shipped
# configuration, plan kind, the port's route).
ROUTES = {
    "rgcn_pairs": ("rgcn", {}, "pairs", "pair_merged"),
    "rgcn_merged_targets": ("rgcn", {"gnn_edge_dtype": "float32"},
                            "merged_targets", "pair_merged"),
    "ggnn_pairs": ("ggnn", {}, "pairs", "pair_merged"),
    "rgin_pairs": ("rgin", {}, "pairs", "pair_merged"),
    "edge_mlp_source_pairs": ("gnn_edge_mlp", {
        "gnn_use_target_state_as_input": False,
        "gnn_normalize_by_num_incoming": True}, "pairs", "pair_merged"),
    "edge_mlp_target_0_merged_targets": ("gnn_edge_mlp", {},
                                         "merged_targets", "factorised"),
    "edge_mlp_target_0_norm_bf16_merged_targets": ("gnn_edge_mlp", {
        "gnn_normalize_by_num_incoming": True,
        "gnn_edge_dtype": "bfloat16"}, "merged_targets", "factorised"),
    "film_target_merged_targets": ("gnn_film", {}, "merged_targets",
                                   "factorised"),
    "film_source_norm_merged_targets": ("gnn_film", {
        "gnn_use_target_state_as_input": False,
        "gnn_normalize_by_num_incoming": True}, "merged_targets",
        "factorised"),
    "edge_mlp_target_0_scatter": ("gnn_edge_mlp", {}, "scatter",
                                  "scatter_zero_hidden"),
    "edge_mlp_target_0_norm_bf16_scatter": ("gnn_edge_mlp", {
        "gnn_normalize_by_num_incoming": True,
        "gnn_edge_dtype": "bfloat16"}, "scatter", "scatter_zero_hidden"),
    "film_source_scatter": ("gnn_film", {
        "gnn_use_target_state_as_input": False}, "scatter", "scatter_film"),
    "film_source_film_hidden_norm_bf16_scatter": ("gnn_film", {
        "gnn_use_target_state_as_input": False,
        "gnn_num_edge_MLP_hidden_layers": 1,
        "gnn_film_parameter_MLP_hidden_layers": [8],
        "gnn_normalize_by_num_incoming": True,
        "gnn_edge_dtype": "bfloat16"}, "scatter", "scatter_film"),
}
PLAN_KINDS = {
    "pairs": dict(merged=True),
    "merged_targets": dict(merged=True, merge_targets=True),
}


def plan_workload(kind: str, seed: int):
    """``small_workload``'s batch, planned by both packages, with the plan
    kind of a route: a merged pair plan with local (``"pairs"``) or merged
    targets, or the merged scatter plan (``"scatter"``)."""
    if kind == "scatter":
        return scatter_workload(seed)
    return small_workload(seed, **PLAN_KINDS[kind])


def case_params(name: str):
    """The shipped configuration of the case's flavour over the JAX
    package's defaults, cut to 2 layers of hidden 16, dropout 0, and the
    case's overrides."""
    style, overrides = (CASES[name] if name in CASES
                        else ROUTES[name][:2])
    params = JaxNodeMulticlassTask.get_default_hyperparameters(style)
    shipped = json.loads((REPO / "tf2_gnn_tpu" / "harness" / "default_hypers"
                          / SHIPPED[style]).read_text())
    params.update(shipped["model_params"])
    params.update({"gnn_num_layers": 2, "gnn_hidden_dim": 16,
                   "gnn_layer_input_dropout_rate": 0.0})
    params.update(overrides)
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


@pytest.fixture(scope="module")
def workload():
    return small_workload(seed=11)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_gradients_match_jax(case, workload):
    assert_matches_jax(case_params(case), *workload)


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_jax(route):
    """Each route over another plan kind against the JAX package on the
    same batch, which takes its own fused route there."""
    _, _, kind, port_route = ROUTES[route]
    jbatch, tbatch, labels = plan_workload(kind, seed=13)
    tmodel = assert_matches_jax(case_params(route), jbatch, tbatch, labels,
                                grad_share=BF16_ROUTE_GRAD_SHARE)
    assert tmodel.gnn.mp_layer_0._route(tbatch) == port_route


def assert_matches_jax(params, jbatch, tbatch, labels, grad_share=None):
    """Logits, loss and every parameter gradient of the port's model
    against the JAX package's, at the edge dtype's tolerance (bf16 logits
    at ``BF16_LOGIT_ATOL``; with ``grad_share``, bf16 gradients within
    that share of each tensor's largest |entry| instead). Returns the
    port's model."""
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    tols = TOLS[params["gnn_edge_dtype"]]

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

    logit_tols = (dict(tols, atol=BF16_LOGIT_ATOL)
                  if params["gnn_edge_dtype"] == "bfloat16" else tols)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jlogits),
                               **logit_tols)
    np.testing.assert_allclose(float(metrics["loss"].detach()), float(jl),
                               **tols)
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        mine, grad = got[name].grad.numpy(), grad.numpy()
        if grad_share and params["gnn_edge_dtype"] == "bfloat16":
            err, largest = np.abs(mine - grad).max(), np.abs(grad).max()
            assert err <= grad_share * largest, (name, err, largest)
        else:
            np.testing.assert_allclose(mine, grad, err_msg=name, **tols)
    return tmodel


FLAVOUR_LEAVES = {
    # case: (flax path under gnn/mp_layer_1, leaf names, port module)
    "ggnn": (("gru_cell",), ("kernel", "recurrent_kernel", "input_bias",
                             "recurrent_bias")),
    "rgin_aggr_mlp": (("aggregation_mlp", "hidden_0"), ("kernel",)),
    "film_target_film_hidden": (("film_mlp_layer_1",), ("kernel",)),
    "edge_mlp_target_0": (("edge_mlp_tgt_0",), ("kernel",)),
}


@pytest.mark.parametrize("case", list(FLAVOUR_LEAVES))
def test_bridge_loads_the_flavour_strictly(case, workload):
    """The strict bridge places each flavour's own flax leaves: the GRU
    cell's four as they are (flax's packed [in, 3H]), the aggregation
    MLP's Dense kernels transposed into ``nn.Linear``, the FiLM and edge
    MLPs' [L, D, H] kernels as they are; a leaf the model lacks raises."""
    jbatch, _, _ = workload
    _, jparams, tmodel = build_pair(case_params(case), jbatch)
    flax = jax.device_get(jparams)
    own = tmodel.state_dict()
    path, leaves = FLAVOUR_LEAVES[case]
    node = flax["gnn"]["mp_layer_1"]
    for key in path:
        node = node[key]
    prefix = "gnn.mp_layer_1." + ".".join(path)
    for leaf in leaves:
        value = np.asarray(node[leaf])
        if path[0] == "aggregation_mlp":
            got = own[f"{prefix}.weight"].numpy().T
        else:
            got = own[f"{prefix}.{leaf}"].numpy()
        np.testing.assert_array_equal(got, value)
    extra = jax.tree_util.tree_map(lambda x: x, flax)
    extra["gnn"]["mp_layer_1"]["edge_mlp_layer_7"] = {
        "kernel": np.zeros((3, 16, 16), np.float32)}
    with pytest.raises(ValueError, match="edge_mlp_layer_7"):
        load_flax_params(tmodel, extra)


@pytest.mark.parametrize("style", list(SHIPPED))
def test_shipped_json_copies_are_the_jax_packages(style):
    """The port's copy of the flavour's shipped JSON is the JAX package's,
    its defaults are the JAX package's, and ``workloads.shipped_params``
    is the JSON over those defaults with Adam at lr 1e-3."""
    name = SHIPPED[style]
    port = REPO / "tf2_gnn_tpu_torch" / "harness" / "default_hypers" / name
    ref = REPO / "tf2_gnn_tpu" / "harness" / "default_hypers" / name
    shipped = json.loads(ref.read_text())
    assert json.loads(port.read_text()) == shipped
    defaults = JaxNodeMulticlassTask.get_default_hyperparameters(style)
    assert NodeMulticlassTask.get_default_hyperparameters(style) == defaults
    want = dict(defaults, **shipped["model_params"], learning_rate=0.001)
    assert workloads.shipped_params(name, style) == want
    assert want["gnn_message_calculation_class"] == style


def test_unported_routes_raise(workload):
    """GNN-FiLM and the 0-hidden target-state edge MLP need per-type sums:
    on a merged plan with local targets (and no scatter plans) and on a
    batch without plans they raise, naming the unfused path the JAX
    package takes there; FiLM's target-state form with a hidden edge-MLP
    layer and GGNN on a state narrower than hidden_dim raise too."""
    _, local_targets, _ = small_workload(seed=12, merged=True)
    _, typed, _ = workload
    bare = typed.replace(pair_plans_typed=None)
    for case in ("film_target", "edge_mlp_target_0"):
        model = NodeMulticlassTask.from_params(
            case_params(case), input_dim=FEATURES, num_edge_types=3,
            device="cpu", num_labels=NUM_LABELS)
        for batch in (local_targets, bare):
            with pytest.raises(NotImplementedError,
                               match="queue A item 6"):
                model(batch, False)
    with pytest.raises(NotImplementedError, match="per-edge path"):
        NodeMulticlassTask.from_params(
            dict(case_params("film_target"),
                 gnn_num_edge_MLP_hidden_layers=1),
            input_dim=FEATURES, num_edge_types=3, device="cpu")
    from tf2_gnn_tpu_torch.layers.message_passing import GGNN

    layer = GGNN(num_edge_types=3, input_dim=8, hidden_dim=16)
    with pytest.raises(ValueError, match="hidden_dim"):
        layer(torch.zeros(typed.num_nodes_padded, 8), typed, False)
