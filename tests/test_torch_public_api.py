"""The port's public surface against the JAX package's, on the CPU.

* Exports: every name of each JAX ``__all__`` (the package and its
  ``data``, ``layers``, ``layers.message_passing``, ``models``, ``ops``,
  ``harness`` and ``utils`` packages) is in the port's ``__all__`` of the
  same package under the same name, or in ``NO_COUNTERPART`` with its
  reason; that table names nothing the port has. ``parallel`` exports
  all twenty names of the JAX package's ``__all__``.
* The registries: ``get_known_message_passing_classes``,
  ``get_known_activation_names``, ``MODEL_CLASSES`` / ``get_model_class``
  / ``register_model_class`` give the JAX package's names; the
  ``harness`` names the port shares are its own training functions.
* ``masked_micro_f1`` equals the JAX package's on seeded logits.
* ``GNNInput`` / ``batch_from_gnn_input``: array-identical to the JAX
  package's batch on seeded inputs, with derived and with pinned
  budgets; the batch takes the unfused route and the encoder's outputs
  match those on the same graphs batched by a dataset.
* ``WASGraphRepresentation`` matches the JAX module with bridged weights
  (rtol 1e-5), forward and gradients.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf2_gnn_tpu.parallel as jparallel
from tf2_gnn_tpu.layers import gnn_input as jgnn_input
from tf2_gnn_tpu.layers.readout import WASGraphRepresentation as JaxWAS
from tf2_gnn_tpu.models.node_multiclass_task import (
    masked_micro_f1 as jax_masked_micro_f1,
)
from tf2_gnn_tpu_torch.data import PaddingConfig
from tf2_gnn_tpu_torch.harness import training
from tf2_gnn_tpu_torch.harness.import_jax import flax_params_to_state_dict
from tf2_gnn_tpu_torch.layers import (
    GNN,
    GNNInput,
    WASGraphRepresentation,
    batch_from_gnn_input,
)

PACKAGES = ("", ".data", ".layers", ".layers.message_passing", ".models",
            ".ops", ".harness", ".utils", ".parallel")

# JAX names with no counterpart in the port, by package, with the reason.
NO_COUNTERPART = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "top")
def test_exports_match_jax(package):
    jmod = importlib.import_module("tf2_gnn_tpu" + package)
    tmod = importlib.import_module("tf2_gnn_tpu_torch" + package)
    reasons = NO_COUNTERPART.get(package, {})
    missing = [n for n in jmod.__all__
               if n not in reasons
               and (n not in tmod.__all__ or not hasattr(tmod, n))]
    assert not missing, f"tf2_gnn_tpu_torch{package} lacks {missing}"
    stale = [n for n in reasons if hasattr(tmod, n)]
    assert not stale, f"listed without a counterpart but present: {stale}"
    for name in tmod.__all__:
        assert hasattr(tmod, name), name
        if name in jmod.__all__:
            assert (isinstance(getattr(jmod, name), type)
                    == isinstance(getattr(tmod, name), type)), name


def test_parallel_exports_every_name():
    import tf2_gnn_tpu_torch.parallel as tparallel

    assert sorted(tparallel.__all__) == sorted(jparallel.__all__)
    assert len(tparallel.__all__) == 20
    for name in jparallel.__all__:
        assert callable(getattr(tparallel, name)), name
    assert not NO_COUNTERPART.get(".parallel")


def test_registries_match_jax():
    import tf2_gnn_tpu.layers as jlayers
    import tf2_gnn_tpu.models as jmodels
    import tf2_gnn_tpu.ops as jops
    import tf2_gnn_tpu_torch.layers as tlayers
    import tf2_gnn_tpu_torch.models as tmodels
    import tf2_gnn_tpu_torch.ops as tops

    def own(registry, package):
        """The names a package's own modules registered (other test files
        in this worker may have registered classes of their own)."""
        return sorted(name for name, cls in registry.items()
                      if cls.__module__.startswith(package + "."))

    assert (tlayers.get_known_message_passing_classes()
            == sorted(tlayers.MESSAGE_PASSING_IMPLEMENTATIONS))
    assert (own(tlayers.MESSAGE_PASSING_IMPLEMENTATIONS, "tf2_gnn_tpu_torch")
            == own(jlayers.MESSAGE_PASSING_IMPLEMENTATIONS, "tf2_gnn_tpu")
            == ["ggnn", "gnn_edge_mlp", "gnn_film", "rgat", "rgcn", "rgin"])
    assert tops.get_known_activation_names() == jops.get_known_activation_names()
    assert (tops.get_known_aggregation_names()
            == jops.get_known_aggregation_names())
    assert (own(tmodels.MODEL_CLASSES, "tf2_gnn_tpu_torch")
            == own(jmodels.MODEL_CLASSES, "tf2_gnn_tpu"))
    for name in own(tmodels.MODEL_CLASSES, "tf2_gnn_tpu_torch"):
        assert tmodels.get_model_class(name) is tmodels.MODEL_CLASSES[name]
    with pytest.raises(ValueError, match="Unknown model class 'Nope'"):
        tmodels.get_model_class("Nope")

    class MyTask(tmodels.GraphRegressionTask):
        pass

    tmodels.register_model_class(MyTask)
    try:
        assert tmodels.get_model_class("MyTask") is MyTask
    finally:
        del tmodels.MODEL_CLASSES["MyTask"]
    import tf2_gnn_tpu_torch.harness as tharness
    for name in ("TrainState", "make_train_step", "make_eval_step",
                 "make_predict_step", "create_train_state", "build_training"):
        assert getattr(tharness, name) is getattr(training, name)


def test_masked_micro_f1_matches_jax():
    from tf2_gnn_tpu_torch.models import masked_micro_f1

    rng = np.random.RandomState(2)
    logits = rng.randn(50, 7).astype(np.float32)
    labels = (rng.rand(50, 7) > 0.6).astype(np.float32)
    mask = (np.arange(50) < 41).astype(np.float32)
    got = masked_micro_f1(torch.from_numpy(logits), torch.from_numpy(labels),
                          torch.from_numpy(mask))
    want = jax_masked_micro_f1(jnp.asarray(logits), jnp.asarray(labels),
                               jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---- GNNInput -------------------------------------------------------------------
def seeded_input(seed: int, num_graphs: int = 4, num_types: int = 3):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(3, 12, num_graphs)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    adjacency = []
    for t in range(num_types):
        edges = [rng.randint(0, n, (rng.randint(0 if t else 1, 3 * n), 2))
                 + off for n, off in zip(sizes, offsets)]
        adjacency.append(np.concatenate(edges).astype(np.int64))
    return dict(
        node_features=rng.randn(int(sizes.sum()), 5).astype(np.float64),
        adjacency_lists=adjacency,
        node_to_graph_map=np.repeat(np.arange(num_graphs), sizes),
        num_graphs=num_graphs)


def config_kwargs(num_types: int):
    return dict(num_nodes=128, num_graphs=9, edge_budgets=(256,) * num_types)


@pytest.mark.parametrize("pinned", [False, True], ids=["derived", "pinned"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_from_gnn_input_matches_jax(seed, pinned):
    from tf2_gnn_tpu.data.graph_batch import PaddingConfig as JPaddingConfig

    arrays = seeded_input(seed)
    got = batch_from_gnn_input(
        GNNInput(**arrays),
        PaddingConfig(**config_kwargs(3)) if pinned else None)
    want = jgnn_input.batch_from_gnn_input(
        jgnn_input.GNNInput(**arrays),
        JPaddingConfig(**config_kwargs(3)) if pinned else None)
    for name in ("node_features", "node_to_graph", "num_edges",
                 "in_degrees"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("edge_sources", "edge_targets"):
        for t, (a, b) in enumerate(zip(getattr(got, name),
                                       getattr(want, name))):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{t}]")
    assert got.num_nodes == int(want.num_nodes)
    assert got.num_graphs == int(want.num_graphs)
    assert got.num_graphs_padded == want.num_graphs_padded
    assert got.pair_plans is got.scatter_plans is got.pair_plans_typed is None


def test_gnn_input_batch_runs_unfused_like_the_dataset_batch():
    """The encoder on a ``batch_from_gnn_input`` batch (no plans: the
    unfused route) gives the same real rows as on the same graphs padded
    to another budget with per-type pair plans (the fused route's plain
    versions on the CPU)."""
    from tf2_gnn_tpu_torch.data.graph_batch import pad_batch_arrays
    from tf2_gnn_tpu_torch.ops.pair_spmm import build_pair_plans

    arrays = seeded_input(4)
    batch = batch_from_gnn_input(GNNInput(**arrays))
    params = GNN.get_default_hyperparameters("rgcn")
    params.update(hidden_dim=16, num_layers=2, use_inter_layer_layernorm=True)
    gnn = GNN.from_params(params, input_dim=5, num_edge_types=3)
    gnn.reset_parameters(torch.Generator().manual_seed(0))
    assert gnn.mp_layer_0._route(batch.to("cpu")) == "unfused"
    other = pad_batch_arrays(
        np.asarray(arrays["node_features"], np.float32),
        [np.asarray(a, np.int32) for a in arrays["adjacency_lists"]],
        np.asarray(arrays["node_to_graph_map"], np.int32), 4,
        PaddingConfig(**config_kwargs(3)))
    other.pair_plans_typed = tuple(
        build_pair_plans([other.edge_sources[t]], [other.edge_targets[t]],
                         [int(other.num_edges[t])], 128).astuple()
        for t in range(3))
    other = other.to("cpu")
    assert gnn.mp_layer_0._route(other) == "pair_joint"
    v = batch.num_nodes
    final, reps = gnn(batch.to("cpu"))
    final_o, reps_o = gnn(other)
    torch.testing.assert_close(final[:v], final_o[:v], rtol=1e-5, atol=1e-6)
    for a, b in zip(reps, reps_o):
        torch.testing.assert_close(a[:v], b[:v], rtol=1e-5, atol=1e-6)


# ---- WASGraphRepresentation -----------------------------------------------------
@pytest.mark.parametrize("layers", [(10, 9), (12,)])
def test_was_readout_matches_jax(layers):
    rng = np.random.RandomState(7)
    nodes = rng.randn(60, 12).astype(np.float32)
    ids = np.sort(rng.randint(0, 5, 60)).astype(np.int32)
    cot = rng.randn(6, 8).astype(np.float32)
    kwargs = dict(graph_representation_size=8, num_heads=4,
                  pooling_mlp_layers=layers)
    jread = JaxWAS(**kwargs)
    read = WASGraphRepresentation(12, **kwargs)
    params = jread.init(jax.random.PRNGKey(0), jnp.asarray(nodes),
                        jnp.asarray(ids), 6)["params"]
    assert sorted(params) == ["out_projection", "weighted_avg",
                              "weighted_sum"]
    read.load_state_dict(flax_params_to_state_dict(jax.device_get(params)),
                         strict=True)

    def jfn(p):
        out = jread.apply({"params": p}, jnp.asarray(nodes), jnp.asarray(ids),
                          6)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    got = read(torch.from_numpy(nodes), torch.from_numpy(ids), 6)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    want_grads = flax_params_to_state_dict(jax.device_get(jgrads))
    for name, param in read.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(),
                                   want_grads[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_was_readout_initialises_every_parameter():
    read = WASGraphRepresentation(12, graph_representation_size=8,
                                  num_heads=4, pooling_mlp_layers=(10,))
    for p in read.parameters():
        torch.nn.init.constant_(p, float("nan"))
    read.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in read.parameters())
    assert read.out_projection.bias is None
