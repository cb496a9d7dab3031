"""The port's counterparts of the JAX package's last public helpers, held
against the JAX functions on the CPU with inputs made with numpy from a
seed, and the input-feature hook.

* ``data/io.py::make_staging_resolver``: the JAX package's own end-to-end
  test (``tests/test_metrics_and_io.py``) against the port's
  ``read_by_file_suffix``, and the same paths as the JAX resolver's.
* ``GraphBatch.pad_node_index`` / ``edge_mask``: equal to JAX's on the
  padded PPI-shaped and QM9-shaped batches of ``workloads.py``, on a
  host batch and on one moved with ``.to``.
* ``GraphDataset.num_batches``: equal to JAX's on each fold of the
  synthetic JSONL, PPI and QM9 loaders; on TRAIN, JAX after
  ``np.random.seed(s)`` and the port with ``rng=RandomState(s)``, and
  the next epoch's batches still match.
* ``harness/run.py::set_seeds``: the same ``random`` and ``np.random``
  draws as JAX's after it; ``run_train_from_args`` calls it before it
  builds the model and the dataset.
* ``ops/pair_spmm.py``: ``pair_chunk_budget`` exactly; the slot ids of
  ``pair_slot_abs_ids`` exactly; ``pair_normalisation_scales`` at rtol
  1e-6 against JAX's and against the plans' host-built ``inv_*``.
* ``GraphTaskModel.compute_initial_node_features``: a subclass that
  builds its own input matches the same JAX subclass at
  ``tests/test_torch_rgcn_model.py``'s ``TOLS`` on the fused route
  (PPI_RGCN, per-type plans, f32 and bf16 edge streams) and on the
  unfused one (GGNN without plans); an identity hook gives the base
  model's output bit for bit; ``GraphBatch.replace(node_features=...)``
  keeps the per-type plan forms, any other change or a move drops them,
  so a hook builds the joint plan once for a batch.
"""
import json
import random
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.data import DataFold as JDataFold
from tf2_gnn_tpu.data import JsonLGraphPropertyDataset as JJsonLProperty
from tf2_gnn_tpu.data import PPIDataset as JPPI
from tf2_gnn_tpu.data import QM9Dataset as JQM9
from tf2_gnn_tpu.data import graph_batch as jgb
from tf2_gnn_tpu.data import io as jio
from tf2_gnn_tpu.harness import run as jrun
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.data import DataFold
from tf2_gnn_tpu_torch.data import JsonLGraphPropertyDataset as TJsonLProperty
from tf2_gnn_tpu_torch.data import PPIDataset as TPPI
from tf2_gnn_tpu_torch.data import QM9Dataset as TQM9
from tf2_gnn_tpu_torch.data import graph_batch as tgb
from tf2_gnn_tpu_torch.data import io as tio
from tf2_gnn_tpu_torch.harness import run as trun
from tf2_gnn_tpu_torch.harness.import_jax import (
    flax_params_to_state_dict,
    load_flax_params,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.utils.constants import SMALL_NUMBER

from .synthetic_data import (
    write_jsonl_property_dataset,
    write_ppi_dataset,
    write_qm9_dataset,
)
from .test_pair_spmm import _random_edges
from .test_torch_flavours import case_params
from .test_torch_rgcn_model import (
    FEATURES,
    NUM_LABELS,
    TOLS,
    make_params,
    small_workload,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# make_staging_resolver


def test_staging_resolver_end_to_end(tmp_path):
    """The JAX package's end-to-end test of its resolver, against the
    port's: a staged read, a cache hit that leaves the staged copy alone,
    a changed source staged again, a missing object that raises, and the
    in-place form."""
    remote = tmp_path / "mnt"
    (remote / "bucket" / "ds").mkdir(parents=True)
    obj = remote / "bucket" / "ds" / "data.json"
    obj.write_text('{"k": 1}')
    cache = tmp_path / "cache"

    tio.register_path_resolver("azure",
                               tio.make_staging_resolver(remote, cache))
    try:
        uri = "azure://bucket/ds/data.json"
        assert tio.read_by_file_suffix(uri) == {"k": 1}
        staged = cache / "bucket" / "ds" / "data.json"
        assert staged.exists()

        before = staged.stat().st_mtime_ns
        assert tio.read_by_file_suffix(uri) == {"k": 1}
        assert staged.stat().st_mtime_ns == before

        time.sleep(0.01)
        obj.write_text(json.dumps({"k": 2}))
        assert tio.read_by_file_suffix(uri) == {"k": 2}

        with pytest.raises(FileNotFoundError, match="azure://"):
            tio.read_by_file_suffix("azure://bucket/missing.json")
    finally:
        tio._PATH_RESOLVERS.pop("azure", None)

    tio.register_path_resolver("gs", tio.make_staging_resolver(remote))
    try:
        assert tio.read_by_file_suffix("gs://bucket/ds/data.json") == {"k": 2}
    finally:
        tio._PATH_RESOLVERS.pop("gs", None)
    assert not list(cache.rglob("*.staging"))


@pytest.mark.parametrize("cached", [False, True])
def test_staging_resolver_gives_jax_paths(tmp_path, cached):
    """The port's resolver and JAX's map a URI to the same path, staged
    (each into its own cache) or in place, and stage again for a source
    of another size."""
    remote = tmp_path / "mnt"
    (remote / "b").mkdir(parents=True)
    (remote / "b" / "x.jsonl").write_text('{"a": 1}\n')
    caches = ((tmp_path / "jax", tmp_path / "port") if cached
              else (None, None))
    jres = jio.make_staging_resolver(remote, caches[0])
    tres = tio.make_staging_resolver(str(remote), caches[1])
    for text in ('{"a": 1}\n', '{"a": 22}\n{"a": 3}\n'):
        (remote / "b" / "x.jsonl").write_text(text)
        got, want = tres("s3://b/x.jsonl"), jres("s3://b/x.jsonl")
        if cached:
            assert got.relative_to(caches[1]) == want.relative_to(caches[0])
        else:
            assert got == want == remote / "b" / "x.jsonl"
        assert got.read_text() == want.read_text() == text


# ---------------------------------------------------------------------------
# GraphBatch.pad_node_index / edge_mask


def _jax_twin(batch):
    """The JAX package's batch of a port host batch's real arrays, padded
    to the same budgets."""
    v = batch.num_nodes
    counts = [int(c) for c in batch.num_edges]
    adjacency = [np.stack([s[:c], t[:c]], axis=1) for s, t, c in zip(
        batch.edge_sources, batch.edge_targets, counts)]
    config = jgb.PaddingConfig(
        num_nodes=batch.num_nodes_padded,
        num_graphs=batch.num_graphs_padded,
        edge_budgets=tuple(s.shape[0] for s in batch.edge_sources))
    return jgb.pad_batch_arrays(batch.node_features[:v], adjacency,
                                batch.node_to_graph[:v], batch.num_graphs,
                                config)


@pytest.fixture(scope="module")
def shaped_batches():
    ppi, _, _ = workloads.build_ppi_batch_host(0, plans=False)
    qm9, _, _ = workloads.build_qm9_batch_host(0, plans=False)
    return {"ppi": (ppi, _jax_twin(ppi)), "qm9": (qm9, _jax_twin(qm9))}


MASK_CASES = [("ppi", t) for t in range(3)] + [
    ("qm9", t) for t in range(workloads.QM9_EDGE_TYPES)]


@pytest.mark.parametrize("shape,edge_type", MASK_CASES)
def test_pad_node_index_and_edge_mask_match_jax(shape, edge_type,
                                                shaped_batches):
    host, jbatch = shaped_batches[shape]
    want = np.asarray(jbatch.edge_mask(edge_type))
    moved = host.to("cpu")
    for batch in (host, moved):
        assert batch.pad_node_index == jbatch.pad_node_index
        assert batch.pad_node_index == batch.num_nodes_padded - 1
        got = batch.edge_mask(edge_type)
        assert got.dtype == torch.float32
        assert got.device == moved.node_features.device
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.shape[0]


# ---------------------------------------------------------------------------
# GraphDataset.num_batches

SEED = 5
LOADERS = {
    "jsonl": (JJsonLProperty, TJsonLProperty, write_jsonl_property_dataset,
              dict(num_graphs=40, num_fwd_edge_types=2),
              {"max_nodes_per_batch": 30}),
    "ppi": (JPPI, TPPI, write_ppi_dataset,
            dict(graphs_per_fold=3, nodes_per_graph=150,
                 edges_per_graph=600),
            {"max_nodes_per_batch": 400}),
    "qm9": (JQM9, TQM9, write_qm9_dataset, dict(num_graphs=40),
            {"max_nodes_per_batch": 40}),
}
FOLDS = {"TRAIN": (JDataFold.TRAIN, DataFold.TRAIN),
         "VALIDATION": (JDataFold.VALIDATION, DataFold.VALIDATION),
         "TEST": (JDataFold.TEST, DataFold.TEST)}


@pytest.fixture(scope="module")
def loader_dirs(tmp_path_factory):
    return {name: writer(tmp_path_factory.mktemp(name), seed=1, **kwargs)
            for name, (_, _, writer, kwargs, _) in LOADERS.items()}


def _dataset_pair(loader, path):
    jcls, tcls, _, _, params = LOADERS[loader]
    jds = jcls({**jcls.get_default_hyperparameters(), **params})
    tds = tcls({**tcls.get_default_hyperparameters(), **params},
               rng=np.random.RandomState(SEED))
    jds.load_data(path)
    tds.load_data(path)
    return jds, tds


@pytest.mark.parametrize("fold", list(FOLDS))
@pytest.mark.parametrize("loader", list(LOADERS))
def test_num_batches_matches_jax(loader, fold, loader_dirs):
    jds, tds = _dataset_pair(loader, loader_dirs[loader])
    jfold, tfold = FOLDS[fold]
    np.random.seed(SEED)
    want = jds.num_batches(jfold)
    got = tds.num_batches(tfold)
    assert got == want > 1
    # The next epoch draws the same permutation on both sides, so its
    # batches match: num_batches consumed exactly what JAX's did.
    jepoch = list(jds.batch_iterator(jfold))
    tepoch = list(tds.batch_iterator(tfold))
    assert len(tepoch) == len(jepoch)
    for (jb, _), (tb, _) in zip(jepoch, tepoch):
        np.testing.assert_array_equal(tb.node_features,
                                      np.asarray(jb.node_features))
        np.testing.assert_array_equal(tb.node_to_graph,
                                      np.asarray(jb.node_to_graph))
    if fold != "TRAIN":
        assert got == len(tepoch)


# ---------------------------------------------------------------------------
# set_seeds


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_set_seeds_matches_jax(seed):
    jrun.set_seeds(seed)
    want = (random.random(), random.randint(0, 10**9), np.random.rand(5))
    trun.set_seeds(seed)
    got = (random.random(), random.randint(0, 10**9), np.random.rand(5))
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


def test_run_seeds_before_building(monkeypatch, tmp_path):
    """``run_train_from_args`` seeds the global generators before it
    builds the model and the dataset, where JAX's does."""
    calls = []

    class Built(Exception):
        pass

    def build(*args, **kwargs):
        calls.append("build")
        raise Built()

    monkeypatch.setattr(trun, "set_seeds", lambda s: calls.append(("seed", s)))
    monkeypatch.setattr(trun, "get_model_and_dataset_from_args", build)
    args = types.SimpleNamespace(model="RGCN", task="PPI", random_seed=3,
                                 save_dir=str(tmp_path), run_name="seeds")
    with pytest.raises(Built):
        trun.run_train_from_args(args)
    assert calls == [("seed", 3), "build"]


# ---------------------------------------------------------------------------
# pair_chunk_budget, pair_slot_abs_ids, pair_normalisation_scales


@pytest.mark.parametrize("edges,out_rows,inflation", [
    (1000, 512, 2.0), (0, 128, 2.0), (1, 0, 2.0), (211200, 8064, 2.0),
    (50000, 8064, 1.5), (7, 129, 3.0), (102000, 24192, 1.0)])
def test_pair_chunk_budget_matches_jax(edges, out_rows, inflation):
    got = tps.pair_chunk_budget(edges, out_rows, inflation)
    assert got == jps.pair_chunk_budget(edges, out_rows, inflation)
    assert got % tps.GROUP == 0
    assert got * tps.E_C >= inflation * edges


def _planned(seed: int, clusters: bool):
    """(port plans, JAX plans, [L * V] 1/(deg + eps) table, V) for
    ``tests/test_pair_spmm.py``'s random edges."""
    rng = np.random.RandomState(seed)
    v, num_types = 512, 3
    srcs, tgts, counts = _random_edges(rng, num_types, v, clusters=clusters)
    deg = np.zeros((num_types * v,), np.float32)
    for l, (t, c) in enumerate(zip(tgts, counts)):
        deg += np.bincount(t[:c] + l * v, minlength=num_types * v)
    inv = (1.0 / (deg + SMALL_NUMBER)).astype(np.float32)
    return (tps.build_pair_plans(srcs, tgts, counts, v),
            jps.build_pair_plans(srcs, tgts, counts, v), inv, v)


@pytest.mark.parametrize("clusters", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_slot_abs_ids_match_jax(seed, clusters):
    tplans, jplans, _, _ = _planned(seed, clusters)
    for which in ("fwd", "bwd"):
        want = jps.pair_slot_abs_ids(jplans.astuple(), which)
        for arrays in (tplans.astuple(),
                       tuple(torch.as_tensor(a) for a in tplans.astuple())):
            got = tps.pair_slot_abs_ids(arrays, which)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("clusters", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_normalisation_scales_match_jax(seed, clusters):
    tplans, jplans, inv, v = _planned(seed, clusters)
    want = jps.pair_normalisation_scales(jplans.astuple(), jnp.asarray(inv),
                                         v)
    host = (tplans.inv_fwd, tplans.inv_bwd, tplans.inv_ovf)
    for arrays in (tplans.astuple(),
                   tuple(torch.as_tensor(a) for a in tplans.astuple())):
        got = tps.pair_normalisation_scales(arrays, torch.from_numpy(inv), v)
        for g, w, h in zip(got, want, host):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
            np.testing.assert_allclose(g.numpy(), h, rtol=1e-6)


def test_pair_normalisation_scales_clip_like_jax():
    """A table shorter than the ids reach clips them to its last entry, as
    ``jnp.take(..., mode="clip")`` does, and a wider ``src_space`` maps
    the sources to their types as JAX's does."""
    tplans, jplans, inv, v = _planned(0, True)
    short = inv[: 2 * v + 5]
    want = jps.pair_normalisation_scales(jplans.astuple(),
                                         jnp.asarray(short), v)
    got = tps.pair_normalisation_scales(tplans.astuple(),
                                        torch.from_numpy(short), v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    want = jps.pair_normalisation_scales(jplans.astuple(), jnp.asarray(inv),
                                         v, src_space=384)
    got = tps.pair_normalisation_scales(tplans.astuple(),
                                        torch.from_numpy(inv), v,
                                        src_space=384)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ---------------------------------------------------------------------------
# compute_initial_node_features


class JaxScaledInput(JaxNodeMulticlassTask):
    def compute_initial_node_features(self, batch, training):
        return jnp.abs(batch.node_features) * 1.5


class ScaledInput(NodeMulticlassTask):
    def compute_initial_node_features(self, batch, training,
                                      generator=None):
        return torch.abs(batch.node_features) * 1.5


class SameInput(NodeMulticlassTask):
    def compute_initial_node_features(self, batch, training,
                                      generator=None):
        return batch.node_features


class CopiedInput(NodeMulticlassTask):
    """A new tensor with the same values: ``forward`` replaces the
    batch."""

    def compute_initial_node_features(self, batch, training,
                                      generator=None):
        return batch.node_features.clone()


def _hook_params(case: str):
    if case == "ggnn_unfused":
        return case_params("ggnn_f32")
    params = make_params("ppi", case.split("_")[1])
    params["gnn_num_layers"] = 2
    return params


@pytest.fixture(scope="module")
def hook_workload():
    return small_workload(seed=21)


@pytest.mark.parametrize("case", ["rgcn_float32", "rgcn_bfloat16",
                                  "ggnn_unfused"])
def test_hook_subclass_matches_jax(case, hook_workload):
    """The same override in both packages: logits, loss and every
    parameter's gradient at the edge stream's tolerance."""
    jbatch, tbatch, labels = hook_workload
    if case == "ggnn_unfused":
        jbatch = jbatch.replace(pair_plans_typed=None)
        tbatch = tbatch.replace(pair_plans_typed=None)
    params = _hook_params(case)
    tols = TOLS[params["gnn_edge_dtype"]]
    jmodel = JaxScaledInput.from_params(
        params, types.SimpleNamespace(num_node_target_labels=NUM_LABELS))
    jparams = jmodel.init(jax.random.PRNGKey(0), jbatch, False)["params"]
    tmodel = ScaledInput.from_params(params, input_dim=FEATURES,
                                     num_edge_types=3, device="cpu",
                                     num_labels=NUM_LABELS)
    load_flax_params(tmodel, jax.device_get(jparams))
    assert tmodel.gnn.mp_layer_0._route(tbatch) == (
        "unfused" if case == "ggnn_unfused" else "pair_joint")

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        metrics = jmodel.compute_task_metrics(
            jbatch, out, {"node_labels": jnp.asarray(labels)})
        return metrics["loss"], out[0]

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    out = tmodel(tbatch, False)
    loss = tmodel.compute_task_metrics(
        tbatch, out, {"node_labels": torch.from_numpy(labels)})["loss"]
    loss.backward()
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jlogits),
                               **tols)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **tols)
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), grad.numpy(),
                                   err_msg=name, **tols)


@pytest.mark.parametrize("hook", [SameInput, CopiedInput, ScaledInput])
def test_hook_output_against_the_base_model(hook, hook_workload):
    """An identity hook, and one that returns a copy, give the base
    model's output bit for bit; a scaling hook gives the base model's on
    the batch transformed beforehand, bit for bit."""
    _, tbatch, _ = hook_workload
    params = _hook_params("rgcn_float32")
    kwargs = dict(input_dim=FEATURES, num_edge_types=3, device="cpu",
                  num_labels=NUM_LABELS)
    base = NodeMulticlassTask.from_params(params, **kwargs)
    hooked = hook.from_params(params, **kwargs)
    hooked.load_state_dict(base.state_dict())
    features = tbatch.node_features
    if hook is ScaledInput:
        features = torch.abs(features) * 1.5
    with torch.no_grad():
        got = hooked(tbatch, False)[0]
        want = base(tbatch.replace(node_features=features), False)[0]
    assert torch.equal(got, want)


def test_heads_see_the_replaced_batch(hook_workload):
    """The task head reads the batch the GNN ran on."""
    _, tbatch, _ = hook_workload
    seen = []

    class Recording(ScaledInput):
        def compute_task_output(self, batch, node_representations, training,
                                generator=None):
            seen.append(batch)
            return super().compute_task_output(batch, node_representations,
                                               training, generator)

    model = Recording.from_params(_hook_params("rgcn_float32"),
                                  input_dim=FEATURES, num_edge_types=3,
                                  device="cpu", num_labels=NUM_LABELS)
    with torch.no_grad():
        model(tbatch, False)
    (batch,) = seen
    assert batch is not tbatch
    assert torch.equal(batch.node_features,
                       torch.abs(tbatch.node_features) * 1.5)
    assert batch.node_to_graph is tbatch.node_to_graph


FORMS = ("pair_stream_joint", "pair_stream_typed", "pair_typed")


def _fresh(tbatch):
    return tbatch.replace(pair_plans_typed=tbatch.pair_plans_typed)


def test_replaced_features_keep_the_plan_forms(hook_workload):
    _, tbatch, _ = hook_workload
    batch = _fresh(tbatch)
    forms = [getattr(batch, name) for name in FORMS]
    assert all(f is not None for f in forms)
    for features in (batch.node_features * 2.0,
                     batch.node_features.to(torch.bfloat16)):
        replaced = batch.replace(node_features=features)
        assert all(getattr(replaced, name) is form
                   for name, form in zip(FORMS, forms))
    # A form first built on the replaced batch serves the original too.
    other = _fresh(tbatch)
    joint = other.replace(node_features=other.node_features + 1.0
                          ).pair_stream_joint
    assert other.pair_stream_joint is joint


@pytest.mark.parametrize("change", ["edge_sources", "features_and_edges",
                                    "fewer_rows", "host_features", "to"])
def test_other_changes_drop_the_plan_forms(change, hook_workload):
    _, tbatch, _ = hook_workload
    batch = _fresh(tbatch)
    forms = [getattr(batch, name) for name in FORMS]
    features = batch.node_features * 2.0
    if change == "edge_sources":
        new = batch.replace(edge_sources=tuple(batch.edge_sources))
    elif change == "features_and_edges":
        new = batch.replace(node_features=features,
                            edge_sources=tuple(batch.edge_sources))
    elif change == "fewer_rows":
        new = batch.replace(node_features=features[:-128])
    elif change == "host_features":
        new = batch.replace(node_features=features.numpy())
        assert new.pair_stream_joint is None
        return
    else:
        new = batch.to("cpu")
    assert all(getattr(new, name) is not form
               for name, form in zip(FORMS, forms))


def test_hook_builds_the_joint_plan_once(hook_workload, monkeypatch):
    """Three forwards of a hook that returns a new tensor build the joint
    plan once for the batch."""
    _, tbatch, _ = hook_workload
    batch = _fresh(tbatch)
    builds = []
    real = tgb.stream_joint_plan

    def counted(*args, **kwargs):
        builds.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tgb, "stream_joint_plan", counted)
    model = ScaledInput.from_params(_hook_params("rgcn_float32"),
                                    input_dim=FEATURES, num_edge_types=3,
                                    device="cpu", num_labels=NUM_LABELS)
    with torch.no_grad():
        for _ in range(3):
            model(batch, False)
    assert len(builds) == 1
