"""The port's scale-out over a 4-rank gloo cluster of CPU processes
(``tf2_gnn_tpu_torch.parallel``) against the JAX package's on 4 of the
conftest's virtual CPU devices, and against the port's single-process
runs, as ``tests/test_spmd.py`` and ``tests/test_data_parallel.py`` hold
the JAX package:

* every flavour's node-partitioned forward on the dense all_to_all and the
  ring halo;
* one SGD step through the halo collectives' backward on both wire
  forms (RGCN, GGNN), and on the fused routes: merged pair plans (RGCN,
  RGIN; B3 both ways), per-type plans (K2 forward, K1 backward), the
  relu-pair form of the reference-default GNN_Edge_MLP and GNN-FiLM's
  factorised form (merged targets), RGAT's pair attention, and scatter
  plans (RGCN and the 0-hidden target-state GNN_Edge_MLP with the halo,
  RGCN with the all_gather, ``halo=False``);
  parameters stay equal on every rank (no global exchange in training:
  its readout keeps a dropout of 0.2 in both packages);
* the global exchange (a GRU every layer) with LayerNorm; the
  graph-regression readout,
  replicated on every rank; the eval metrics, replicated;
* data parallelism over 4 batches of different graph counts (eval
  metrics and one step) against JAX DP;
* the hybrid 2 x 2 ("data", "nodes") step against JAX's.

Faults planted in a step (``FAULTS``: the halo's gradients lost on the
dense, the ring and the per-type plan route, the ring's backward sent
the wrong way, the pmean left out) must fail the step's check.

One cluster runs every case (``run_cluster``, a 600 s timeout) in a module
fixture. Tolerances (``tests/torch_parallel_cases.py``, the forwards'
those of ``tests/test_spmd.py``): forwards rtol 2e-4 / atol 2e-5, atol
2e-4 on the plan routes; a step's loss rtol 1e-4, F1 atol 5e-3, and its
update within 1e-3 of each parameter's largest update entry (the DP and
hybrid steps too); DP's eval metrics and loss rtol 1e-5 against JAX DP;
every rank's parameters and metrics bit-equal to rank 0's.
"""
import numpy as np
import pytest
import torch

from .torch_parallel_cases import (
    FEATURES,
    FWD_TOLS,
    dp_batches,
    PLAN_FWD_TOLS,
    assert_close,
    assert_replicated,
    assert_step_matches,
    assert_update_matches,
    run_cluster,
    spmd_case,
)

WORLD = 4
FLAVOURS = ("rgcn", "ggnn", "rgat", "rgin", "gnn_edge_mlp", "gnn_film")
NO_REORDER = dict(num_graphs_padded=4, reorder=False)

FORWARD_CASES = {
    f"{flavour}_{halo}": ("node", flavour, dict(NO_REORDER, halo=halo), {})
    for flavour in FLAVOURS for halo in ("dense", "ring")
}
# No global exchange in training: its readout's scoring and transformation
# MLPs keep their dropout of 0.2 in both packages, whose masks cannot
# match.
NO_EXCHANGE = {"gnn_global_exchange_every_num_layers": 10000}
# (task, flavour, partition, extra hyperparameters, the first layer's route)
TRAIN_CASES = {
    "rgcn_dense": ("node", "rgcn", dict(NO_REORDER, halo="dense"), {},
                   "unfused"),
    "rgcn_ring": ("node", "rgcn", dict(NO_REORDER, halo="ring"), {},
                  "unfused"),
    "rgcn_pairs": ("node", "rgcn", dict(NO_REORDER, halo="dense",
                                        build_pair_plans=True), {},
                   "pair_merged"),
    "rgcn_typed_pairs": ("node", "rgcn", dict(
        NO_REORDER, halo="ring", build_pair_plans=True, pair_per_type=True),
        {}, "pair_joint"),
    "edge_mlp_relu_pair": ("node", "gnn_edge_mlp", dict(
        NO_REORDER, halo="dense", build_pair_plans=True,
        pair_merge_targets=True), {}, "relu_pair"),
    "rgat_pair_attention": ("node", "rgat", dict(
        NO_REORDER, halo="ring", build_pair_plans=True), {},
        "pair_attention"),
    "rgcn_scatter": ("node", "rgcn", dict(NO_REORDER, halo="dense",
                                          build_scatter_plans=True), {},
                     "scatter_sum"),
    "rgcn_scatter_all_gather": ("node", "rgcn", dict(
        NO_REORDER, halo=False, build_scatter_plans=True), {},
        "scatter_sum"),
    "ggnn_ring": ("node", "ggnn", dict(NO_REORDER, halo="ring"), {},
                  "unfused"),
    "rgin_pairs": ("node", "rgin", dict(NO_REORDER, halo="dense",
                                        build_pair_plans=True), {},
                   "pair_merged"),
    "film_merged_targets": ("node", "gnn_film", dict(
        NO_REORDER, halo="ring", build_pair_plans=True,
        pair_merge_targets=True), {}, "factorised"),
    "edge_mlp0_scatter": ("node", "gnn_edge_mlp0", dict(
        NO_REORDER, halo="dense", build_scatter_plans=True), {},
        "scatter_zero_hidden"),
}
# Faults planted in a train case's step (``torch_parallel_worker._patches``),
# which its check must refuse: (train case, fault).
FAULTS = {
    "halo_backward_dense": ("rgcn_dense", "halo_backward"),
    "halo_backward_ring": ("rgcn_ring", "halo_backward"),
    "halo_backward_typed_pairs": ("rgcn_typed_pairs", "halo_backward"),
    "ring_inverse": ("rgcn_ring", "ring_inverse"),
    "gradient_factor": ("rgcn_ring", "gradient_factor"),
}
EXCHANGE_CASE = ("node", "rgcn", dict(num_graphs_padded=4), {
    "gnn_global_exchange_every_num_layers": 1,
    "gnn_use_inter_layer_layernorm": True,
    "gnn_global_exchange_mode": "gru"})
READOUT_CASE = ("regression", "rgcn", dict(num_graphs_padded=4), {})
EVAL_CASE = ("node", "rgin", dict(num_graphs_padded=4), {})


def _dp_case():
    import jax

    from tf2_gnn_tpu import parallel as jparallel
    from tf2_gnn_tpu.data import graph_batch as jgb
    from tf2_gnn_tpu.harness.optimizers import make_optimizer
    from tf2_gnn_tpu.harness.training import create_train_state
    from tf2_gnn_tpu_torch.data import graph_batch as tgb

    from .torch_parallel_cases import TASKS, _floats, _state_dict, model_params

    params = model_params("regression", "rgcn", gnn_hidden_dim=8,
                          gnn_num_layers=2)
    jmodel = TASKS["regression"].from_params(params)
    jpairs = dp_batches(jgb, 5)
    optimizer = make_optimizer(params)
    state = create_train_state(jmodel, jpairs[0][0], optimizer, seed=0)
    case = dict(name="dp", kind="dp", task="regression", params=params,
                input_dim=5, num_edge_types=1, num_labels=None,
                state=_state_dict(state.params),
                batches=dp_batches(tgb, 5))
    mesh = jparallel.make_mesh(jax.devices()[:WORLD])
    stacked, labels = jparallel.stack_batches([b for b, _ in jpairs],
                                              [l for _, l in jpairs])
    ref = {"jax_eval": _floats(jparallel.make_dp_eval_step(jmodel, mesh)(
        state.params, stacked, labels))}
    state, metrics = jparallel.make_dp_train_step(jmodel, optimizer, mesh)(
        state, stacked, labels)
    ref["jax_metrics"] = _floats(metrics)
    ref["jax_params"] = _state_dict(state.params)
    ref["initial"] = case["state"]
    return case, ref


def _hybrid_case():
    import jax

    from tf2_gnn_tpu import parallel as jparallel
    from tf2_gnn_tpu.data import graph_batch as jgb
    from tf2_gnn_tpu.harness.optimizers import make_optimizer
    from tf2_gnn_tpu.harness.training import create_train_state

    from .test_spmd import _giant_graph
    from .torch_parallel_cases import (
        TASKS,
        _floats,
        _state_dict,
        model_params,
        node_labels,
        single_batch,
    )

    params = model_params("node", "rgcn", **NO_EXCHANGE)
    jmodel = TASKS["node"].from_params(params)
    replicas = []
    for r in range(2):
        nf, adj, n2g, g = _giant_graph(seed=20 + r)
        replicas.append((nf, adj, n2g, g, node_labels(nf.shape[0], 30 + r)))
    partition = dict(num_graphs_padded=4, halo="dense", reorder=False)
    parts = [jparallel.partition_graph(nf, adj, n2g, g, 2,
                                       node_labels={"node_labels": lab},
                                       **partition)
             for nf, adj, n2g, g, lab in replicas]
    batch2d, labels2d = jparallel.stack_partitioned_batches(
        [b for b, _ in parts], [l for _, l in parts])
    optimizer = make_optimizer(params)
    nf, adj, n2g, g, _ = replicas[0]
    state = create_train_state(jmodel, single_batch(jgb, nf, adj, n2g, g),
                               optimizer, seed=0)
    case = dict(name="hybrid", kind="hybrid", task="node", params=params,
                input_dim=FEATURES, num_edge_types=2, num_labels=121,
                state=_state_dict(state.params), replicas=replicas,
                partition=partition)
    mesh = jparallel.make_hybrid_mesh(2, 2, jax.devices()[:WORLD])
    state, metrics = jparallel.make_hybrid_train_step(
        jmodel, optimizer, mesh)(state, batch2d, labels2d)
    return case, {"jax_metrics": _floats(metrics),
                  "jax_params": _state_dict(state.params),
                  "initial": case["state"]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cluster(one_torch_thread):
    """(names, references, results[rank][case]) of every case, from one
    cluster of WORLD ranks."""
    cases, refs = [], []
    for name, (task, flavour, partition, extra) in FORWARD_CASES.items():
        case, ref = spmd_case(f"forward_{name}", task, flavour, WORLD,
                              partition, **extra)
        cases.append(case)
        refs.append(ref)
    for name, (task, flavour, partition, extra, _) in TRAIN_CASES.items():
        case, ref = spmd_case(f"train_{name}", task, flavour, WORLD,
                              partition, train=True, **NO_EXCHANGE,
                              **extra)
        cases.append(case)
        refs.append(ref)
    for name, (train, fault) in FAULTS.items():
        i = [c["name"] for c in cases].index(f"train_{train}")
        cases.append(dict(cases[i], name=f"fault_{name}", fault=fault))
        refs.append(refs[i])
    for name, (task, flavour, partition, extra), kw in (
            ("exchange_layernorm", EXCHANGE_CASE, {}),
            ("readout", READOUT_CASE, {}),
            ("eval", EVAL_CASE, {"evaluate": True})):
        case, ref = spmd_case(name, task, flavour, WORLD, partition,
                              **kw, **extra)
        cases.append(case)
        refs.append(ref)
    for build in (_dp_case, _hybrid_case):
        case, ref = build()
        cases.append(case)
        refs.append(ref)
    results = run_cluster(cases, WORLD)
    return [c["name"] for c in cases], refs, results


def _get(cluster, name):
    names, refs, results = cluster
    i = names.index(name)
    return i, refs[i], results


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_forward_matches_jax_and_single_process(cluster, name):
    i, ref, results = _get(cluster, f"forward_{name}")
    got = results[0][i]["forward"]
    n = ref["num_nodes"]
    assert_close(got, ref["jax_forward"], FWD_TOLS, "against JAX's SPMD")
    assert_close(got[:n], ref["port_forward"][:n], FWD_TOLS,
                 "against the port's single process")
    halo = FORWARD_CASES[name][2]["halo"]
    counts = results[0][i]["forward_counts"]
    wire = "ppermute" if halo == "ring" else "all_to_all"
    other = "all_to_all" if halo == "ring" else "ppermute"
    assert counts[wire]["calls"] > 0 and counts[other]["calls"] == 0


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step_matches_jax_and_single_process(cluster, name):
    i, ref, results = _get(cluster, f"train_{name}")
    got = results[0][i]
    assert got["route"] == TRAIN_CASES[name][4]
    tols = FWD_TOLS if got["route"] == "unfused" else PLAN_FWD_TOLS
    assert_close(got["forward"], ref["jax_forward"], tols, "forward")
    assert_step_matches(got["metrics"], got["params"], ref["jax_metrics"],
                        ref["jax_params"], ref["initial"],
                        "against JAX's SPMD step")
    assert_step_matches(got["metrics"], got["params"], ref["port_metrics"],
                        ref["port_params"], ref["initial"],
                        "against the single process")
    assert_replicated(results, i, "params")
    assert_replicated(results, i, "metrics")


@pytest.mark.parametrize("name", list(FAULTS))
def test_train_step_check_refuses_a_planted_fault(cluster, name):
    """The step's check sees a lost boundary-row gradient, a wrong inverse
    of the ring, and a missing pmean: the loss and F1, taken before the
    update, still match; the update does not."""
    i, ref, results = _get(cluster, f"fault_{name}")
    got = results[0][i]
    for want, want_params in (("jax", ref["jax_params"]),
                              ("port", ref["port_params"])):
        with pytest.raises(AssertionError, match="update is off"):
            assert_step_matches(got["metrics"], got["params"],
                                ref[f"{want}_metrics"], want_params,
                                ref["initial"], f"fault {name} ({want})")


def test_exchange_with_layernorm_matches_jax(cluster):
    i, ref, results = _get(cluster, "exchange_layernorm")
    got = results[0][i]["forward"]
    n = ref["num_nodes"]
    assert_close(got, ref["jax_forward"], FWD_TOLS, "against JAX's SPMD")
    assert_close(got[:n], ref["port_forward"][:n], FWD_TOLS,
                 "against the port's single process")
    # A softmax readout in each layer but the first: its max (pmax).
    counts = results[0][i]["forward_counts"]
    assert counts["pmax"]["calls"] == 2


def test_readout_replicated_and_matches_jax(cluster):
    i, ref, results = _get(cluster, "readout")
    stacked = results[0][i]["stacked"]           # [S, G]
    for s in range(1, WORLD):
        np.testing.assert_allclose(stacked[s], stacked[0], atol=1e-6)
    g = 3
    assert_close(stacked[0][:g], ref["jax_forward"][:g], FWD_TOLS, "JAX")
    assert_close(stacked[0][:g], ref["port_forward"][:g], FWD_TOLS,
                 "single process")


def test_eval_metrics_replicated_and_match_jax(cluster):
    i, ref, results = _get(cluster, "eval")
    got = results[0][i]["eval"]
    assert_replicated(results, i, "eval")
    np.testing.assert_allclose(got["loss"], ref["jax_eval"]["loss"],
                               rtol=1e-5)
    for key in ("f1_tp", "f1_fp", "f1_fn"):
        assert got[key] == ref["jax_eval"][key], key
    assert 0.0 <= got["f1_score"] <= 1.0


def test_data_parallel_matches_jax(cluster):
    i, ref, results = _get(cluster, "dp")
    got = results[0][i]
    for key, value in ref["jax_eval"].items():
        np.testing.assert_allclose(got["eval"][key], value, rtol=1e-5,
                                   err_msg=key)
    assert got["metrics"]["num_graphs"] == 1 + 2 + 3 + 1
    np.testing.assert_allclose(got["metrics"]["loss"],
                               ref["jax_metrics"]["loss"], rtol=1e-5)
    assert_update_matches(got["params"], ref["jax_params"], ref["initial"],
                          "against JAX DP")
    assert_replicated(results, i, "params")


def test_hybrid_matches_jax(cluster):
    i, ref, results = _get(cluster, "hybrid")
    got = results[0][i]
    np.testing.assert_allclose(got["metrics"]["loss"],
                               ref["jax_metrics"]["loss"], rtol=1e-4)
    assert_update_matches(got["params"], ref["jax_params"], ref["initial"],
                          "against JAX hybrid")
    assert_replicated(results, i, "params")
