"""The port's dataset pipeline against the JAX package's on the CPU.

For each of the four loaders, on files from ``tests/synthetic_data.py``'s
writers: the same samples, the same ``PaddingConfig`` (pair budgets,
per-type budgets and groups included), and array-identical batches for
every fold, for two shuffled TRAIN epochs under one seed (the JAX loaders
shuffle with the global ``np.random``, the port's with its dataset's
``rng``; ``np.random.seed(s)`` and ``RandomState(s)`` draw the same
permutations). "Array-identical" covers node features, edges,
``node_to_graph``, in-degrees, labels and the per-type, merged,
merged-target and scatter plan arrays. Also: ``pack_nodes`` /
``pack_edges`` against the JAX package's numpy fallbacks and its native
engine, the eval-batch cache, and ``use_worker_threads``.

Overflow: a dataset of PPI-format graphs of varied sizes whose reshuffled
TRAIN batch spills edges of the per-type plans into the overflow term;
the JAX batch's overflow slots hold real edges, and the port's loss and
gradients on that batch match the JAX package's at the f32 tolerances of
``tests/test_torch_rgcn_model.py`` (rtol 1e-4 / atol 1e-5). With the
reference's overflow budget of 64 the same batch raises in both.
"""
import doctest
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu import native as jnative
from tf2_gnn_tpu.data import io as jio
from tf2_gnn_tpu.data import preprocess as jpreprocess
from tf2_gnn_tpu.data import DataFold as JDataFold
from tf2_gnn_tpu.data import JsonLGraphDataset as JJsonL
from tf2_gnn_tpu.data import JsonLGraphPropertyDataset as JJsonLProperty
from tf2_gnn_tpu.data import PPIDataset as JPPI
from tf2_gnn_tpu.data import QM9Dataset as JQM9
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu_torch import native as tnative
from tf2_gnn_tpu_torch.data import DataFold
from tf2_gnn_tpu_torch.data import JsonLGraphDataset as TJsonL
from tf2_gnn_tpu_torch.data import JsonLGraphPropertyDataset as TJsonLProperty
from tf2_gnn_tpu_torch.data import PPIDataset as TPPI
from tf2_gnn_tpu_torch.data import QM9Dataset as TQM9
from tf2_gnn_tpu_torch.data import io as tio
from tf2_gnn_tpu_torch.data import preprocess as tpreprocess
from tf2_gnn_tpu_torch.harness.import_jax import (
    flax_params_to_state_dict,
    load_flax_params,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask

from .synthetic_data import (
    write_jsonl_property_dataset,
    write_ppi_dataset,
    write_qm9_dataset,
)

SEED = 5
FOLDS = ((JDataFold.TRAIN, DataFold.TRAIN),
         (JDataFold.VALIDATION, DataFold.VALIDATION),
         (JDataFold.TEST, DataFold.TEST))
TOLS = dict(rtol=1e-4, atol=1e-5)

# (loader, dataset parameters): the plan forms each case builds.
CASES = {
    # Per-type pair plans (the shipped PPI configurations).
    "ppi_per_type": ("ppi", {"max_nodes_per_batch": 400,
                             "use_pair_spmm": True, "pair_per_type": True}),
    # Per-type pair plans and the scatter plan (QM9_RGCN's layout).
    "qm9_per_type_scatter": ("qm9", {"max_nodes_per_batch": 40,
                                     "use_pair_spmm": True,
                                     "pair_per_type": True,
                                     "use_pallas_spmm": True}),
    # One merged pair plan over all types and the scatter plan.
    "jsonl_property_merged": ("jsonl_property",
                              {"max_nodes_per_batch": 30,
                               "use_pair_spmm": True,
                               "use_pallas_spmm": True}),
    # The merged-target pair plan.
    "jsonl_merged_targets": ("jsonl", {"max_nodes_per_batch": 30,
                                       "use_pair_spmm": True,
                                       "pair_merge_targets": True}),
    # No plans (the unfused path), binarised targets.
    "jsonl_property_bare": ("jsonl_property",
                            {"max_nodes_per_batch": 25,
                             "threshold_for_classification": 1.5}),
}
LOADERS = {
    "ppi": (JPPI, TPPI, write_ppi_dataset,
            dict(graphs_per_fold=3, nodes_per_graph=150, edges_per_graph=600)),
    "qm9": (JQM9, TQM9, write_qm9_dataset, dict(num_graphs=40)),
    "jsonl_property": (JJsonLProperty, TJsonLProperty,
                       write_jsonl_property_dataset,
                       dict(num_graphs=40, num_fwd_edge_types=2)),
    "jsonl": (JJsonL, TJsonL, write_jsonl_property_dataset,
              dict(num_graphs=40, num_fwd_edge_types=2)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and these small ops then run
    many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_pair(loader: str, params: dict, path, **dataset_kwargs):
    """The JAX and the port's dataset of ``loader`` over the files in
    ``path``, with ``params`` over each class's defaults."""
    jcls, tcls, _, _ = LOADERS[loader]
    jparams = {**jcls.get_default_hyperparameters(), **params}
    tparams = {**tcls.get_default_hyperparameters(), **params}
    if loader == "jsonl":
        jparams["num_fwd_edge_types"] = tparams["num_fwd_edge_types"] = 2
    assert jparams == tparams
    jds = jcls(jparams)
    tds = tcls(tparams, rng=np.random.RandomState(SEED), **dataset_kwargs)
    jds.load_data(path)
    tds.load_data(path)
    return jds, tds


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """One directory of files per loader, written once for the module."""
    dirs = {}
    for loader, (_, _, writer, kwargs) in LOADERS.items():
        if loader == "jsonl":
            continue
        dirs[loader] = writer(tmp_path_factory.mktemp(loader), seed=1,
                              **kwargs)
    dirs["jsonl"] = dirs["jsonl_property"]
    return dirs


def assert_same_arrays(a, b, what: str):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_batch(jpair, tpair, what: str):
    (jb, jlabels), (tb, tlabels) = jpair, tpair
    for name in ("node_features", "node_to_graph", "num_edges", "in_degrees"):
        assert_same_arrays(getattr(jb, name), getattr(tb, name),
                           f"{what} {name}")
    for name in ("edge_sources", "edge_targets"):
        ja, ta = getattr(jb, name), getattr(tb, name)
        assert len(ja) == len(ta)
        for t, (x, y) in enumerate(zip(ja, ta)):
            assert_same_arrays(x, y, f"{what} {name}[{t}]")
    assert int(jb.num_nodes) == tb.num_nodes
    assert int(jb.num_graphs) == tb.num_graphs
    assert jb.num_graphs_padded == tb.num_graphs_padded
    assert bool(jb.pair_targets_merged) == tb.pair_targets_merged
    for name in ("pair_plans", "scatter_plans"):
        ja, ta = getattr(jb, name), getattr(tb, name)
        assert (ja is None) == (ta is None), f"{what} {name}"
        for i, (x, y) in enumerate(zip(ja or (), ta or ())):
            assert_same_arrays(x, y, f"{what} {name}[{i}]")
    assert (jb.pair_plans_typed is None) == (tb.pair_plans_typed is None)
    for t, (jp, tp) in enumerate(zip(jb.pair_plans_typed or (),
                                     tb.pair_plans_typed or ())):
        for i, (x, y) in enumerate(zip(jp, tp)):
            assert_same_arrays(x, y, f"{what} pair_plans_typed[{t}][{i}]")
    assert sorted(jlabels) == sorted(tlabels)
    for key in jlabels:
        assert_same_arrays(jlabels[key], tlabels[key], f"{what} {key}")


def assert_same_epoch(jbatches, tbatches, what: str):
    jbatches, tbatches = list(jbatches), list(tbatches)
    assert len(jbatches) == len(tbatches) > 0, what
    for i, (jpair, tpair) in enumerate(zip(jbatches, tbatches)):
        assert_same_batch(jpair, tpair, f"{what} batch {i}")


def assert_same_samples(jds, tds):
    for jfold, tfold in FOLDS:
        jsamples, tsamples = jds._loaded_data[jfold], tds._loaded_data[tfold]
        assert len(jsamples) == len(tsamples)
        for js, ts in zip(jsamples, tsamples):
            assert_same_arrays(js.node_features, ts.node_features, "features")
            assert_same_arrays(js.type_to_node_to_num_inedges,
                               ts.type_to_node_to_num_inedges, "in-degrees")
            assert len(js.adjacency_lists) == len(ts.adjacency_lists)
            for x, y in zip(js.adjacency_lists, ts.adjacency_lists):
                assert_same_arrays(x, y, "adjacency")
            for attr in ("node_labels", "target_value"):
                if hasattr(js, attr):
                    assert_same_arrays(getattr(js, attr), getattr(ts, attr),
                                       attr)


def assert_same_config(jconfig, tconfig):
    for name in ("num_nodes", "num_graphs", "edge_budgets", "pair_chunks_fwd",
                 "pair_chunks_bwd", "pair_overflow", "pair_chunks_typed",
                 "pair_group_fwd", "pair_group_bwd"):
        assert getattr(jconfig, name) == getattr(tconfig, name), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_match_jax(case, data_dirs):
    loader, params = CASES[case]
    jds, tds = make_pair(loader, params, data_dirs[loader])
    assert jds.num_edge_types == tds.num_edge_types
    assert tuple(jds.node_feature_shape) == tuple(tds.node_feature_shape)
    assert_same_samples(jds, tds)
    assert_same_config(jds.padding_config, tds.padding_config)
    for jfold, tfold in FOLDS[1:]:
        assert_same_epoch(jds.batch_iterator(jfold), tds.batch_iterator(tfold),
                          f"{case} {tfold.name}")
    np.random.seed(SEED)
    for epoch in range(2):
        assert_same_epoch(jds.batch_iterator(JDataFold.TRAIN),
                          tds.batch_iterator(DataFold.TRAIN),
                          f"{case} TRAIN epoch {epoch}")


@pytest.mark.parametrize("self_loop_type", [0, 2, -1, -3, 5, -8])
@pytest.mark.parametrize("tied", [{0}, set(), {0, 1}])
def test_preprocess_matches_jax(self_loop_type, tied):
    """Backward edges and self loops, the self-loop type counted from the
    end where negative (range [-(L+1), L]); out of range raises in both."""
    rng = np.random.RandomState(0)
    lists = [rng.randint(0, 6, (4, 2)).tolist(), [], [(1, 2)]]
    args = (lists, 6, True, tied, self_loop_type)
    num_types = 3 + 3 - len(tied)
    if not -(num_types + 1) <= self_loop_type <= num_types:
        for module in (jpreprocess, tpreprocess):
            with pytest.raises(AssertionError, match="Self loop"):
                module.process_adjacency_lists(*args)
        return
    want_edges, want_deg = jpreprocess.process_adjacency_lists(*args)
    got_edges, got_deg = tpreprocess.process_adjacency_lists(*args)
    assert len(got_edges) == len(want_edges) == num_types + 1
    for x, y in zip(got_edges, want_edges):
        assert_same_arrays(x, y, "edges")
    assert_same_arrays(got_deg, want_deg, "in-degrees")
    assert doctest.testmod(tpreprocess).failed == 0


IO_RECORDS = [{"graph": [[0, 1, 2]], "targets": [[0.5]]}, {"k": [1, 2]}]


@pytest.mark.parametrize("suffix", [".jsonl.gz", ".json.gz", ".json",
                                    ".jsonl", ".npy", ".pkl.gz", ".pkl"])
def test_io_reads_like_jax(suffix, tmp_path):
    """``read_by_file_suffix`` reads each suffix as the JAX package's does,
    also through a registered ``<scheme>://`` resolver; a scheme with no
    resolver raises."""
    import gzip
    import pickle

    path = tmp_path / f"data{suffix}"
    if suffix == ".jsonl.gz":
        tio.write_jsonl_gz(path, IO_RECORDS)
    elif suffix == ".jsonl":
        path.write_text("".join(json.dumps(r) + "\n\n" for r in IO_RECORDS))
    elif suffix == ".npy":
        np.save(path, np.arange(6, dtype=np.float32).reshape(2, 3))
    else:
        opener = gzip.open if suffix.endswith(".gz") else open
        pickled = ".pkl" in suffix
        with opener(path, "wb" if pickled else "wt") as f:
            if pickled:
                pickle.dump(IO_RECORDS, f)
            else:
                json.dump(IO_RECORDS, f)
    want = jio.read_by_file_suffix(path)
    uri = f"fixture://{path.name}"
    tio.register_path_resolver("fixture", lambda u: tmp_path / u[10:])
    try:
        for got in (tio.read_by_file_suffix(path),
                    tio.read_by_file_suffix(uri)):
            if suffix == ".npy":
                assert_same_arrays(got, want, "npy")
            else:
                assert got == want
    finally:
        tio._PATH_RESOLVERS.pop("fixture")
    with pytest.raises(NotImplementedError, match="fixture://"):
        tio.read_by_file_suffix(uri)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_pack_nodes_and_edges_match_jax(native, monkeypatch):
    """The port's numpy ``pack_nodes`` / ``pack_edges`` against the JAX
    package's native engine and its numpy fallbacks (``_load`` patched to
    report no library)."""
    if native:
        assert jnative.available()
    else:
        monkeypatch.setattr(jnative, "_load", lambda: None)
    rng = np.random.RandomState(0)
    sizes = [5, 1, 9, 3]
    feats = [rng.randn(n, 4).astype(np.float32) for n in sizes]
    edges = [rng.randint(0, n, (rng.randint(0, 7), 2)) for n in sizes]
    for got, want in zip(tnative.pack_nodes(feats, 32, 7),
                         jnative.pack_nodes(feats, 32, 7)):
        assert_same_arrays(got, want, "pack_nodes")
    got, want = (tnative.pack_edges(edges, sizes, 40, 31),
                 jnative.pack_edges(edges, sizes, 40, 31))
    assert got[2] == want[2]
    for x, y in zip(got[:2], want[:2]):
        assert_same_arrays(x, y, "pack_edges")
    empty = [np.zeros((0, 2), np.int32)] * 2
    got, want = (tnative.pack_edges(empty, [2, 3], 8, 7),
                 jnative.pack_edges(empty, [2, 3], 8, 7))
    assert got[2] == want[2] == 0
    assert_same_arrays(got[0], want[0], "pack_edges of no edges")
    with pytest.raises(ValueError, match="overflowed"):
        tnative.pack_edges(edges, sizes, 2, 31)


def test_eval_cache_and_worker_threads(data_dirs):
    """Eval folds replay identical cached batches (the same objects, only
    after a fully drained epoch); ``use_worker_threads`` yields the same
    batches as the main thread, TRAIN shuffles included."""
    loader, params = CASES["qm9_per_type_scatter"]
    _, tds = make_pair(loader, params, data_dirs[loader])
    _, threaded = make_pair(loader, params, data_dirs[loader],
                            use_worker_threads=True)
    partial = tds.batch_iterator(DataFold.VALIDATION)
    next(partial)
    assert DataFold.VALIDATION not in tds._batch_cache
    first = list(tds.batch_iterator(DataFold.VALIDATION))
    second = list(tds.batch_iterator(DataFold.VALIDATION))
    assert len(first) > 1
    assert all(a is b for a, b in zip(first, second))
    assert_same_epoch(first, threaded.batch_iterator(DataFold.VALIDATION),
                      "threaded VALIDATION")
    for epoch in range(2):
        assert_same_epoch(tds.batch_iterator(DataFold.TRAIN),
                          threaded.batch_iterator(DataFold.TRAIN),
                          f"threaded TRAIN epoch {epoch}")
    tds.set_padding_config(tds.padding_config)
    assert not tds._batch_cache


def write_varied_ppi_dataset(path, seed: int, graphs=None, lo=60, hi=220,
                             features=5):
    """DGL-format PPI files of graphs with ``lo``..``hi`` nodes and 1-10
    random links a node, so repacked batches put graphs at other block
    offsets."""
    graphs = graphs or {"train": 8, "valid": 2, "test": 2}
    rng = np.random.RandomState(seed)
    path.mkdir(parents=True, exist_ok=True)
    for fold, count in graphs.items():
        sizes = rng.randint(lo, hi, count)
        base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        links = []
        for g in range(count):
            num = int(sizes[g] * rng.uniform(1, 10))
            src = base[g] + rng.randint(0, sizes[g], num)
            tgt = base[g] + rng.randint(0, sizes[g], num)
            links += [{"source": int(s), "target": int(t)}
                      for s, t in zip(src, tgt)]
        with open(path / f"{fold}_graph.json", "w") as f:
            json.dump({"links": links}, f)
        total = int(sizes.sum())
        np.save(path / f"{fold}_feats.npy",
                rng.randn(total, features).astype(np.float32))
        np.save(path / f"{fold}_labels.npy",
                (rng.rand(total, 121) > 0.9).astype(np.float32))
        np.save(path / f"{fold}_graph_id.npy",
                np.repeat(np.arange(count), sizes))
    return path


# The files' seed and the shuffle seed whose first reshuffled TRAIN batch
# spills (found by search; budgets derived at slack 1.0).
SPILL_FILES_SEED, SPILL_SHUFFLE_SEED = 3, 2
SPILL_PARAMS = {"max_nodes_per_batch": 500, "use_pair_spmm": True,
                "pair_per_type": True, "padding_slack": 1.0}


def spilled_pair(path, overflow_budget: int):
    """The JAX and the port's datasets over the spilling files, their
    shuffles seeded alike."""
    params = dict(SPILL_PARAMS, pair_overflow_budget=overflow_budget)
    jds = JPPI({**JPPI.get_default_hyperparameters(), **params})
    tds = TPPI({**TPPI.get_default_hyperparameters(), **params},
               rng=np.random.RandomState(SPILL_SHUFFLE_SEED))
    jds.load_data(path)
    tds.load_data(path)
    np.random.seed(SPILL_SHUFFLE_SEED)
    return jds, tds


def test_spilled_batch_matches_jax(tmp_path):
    path = write_varied_ppi_dataset(tmp_path / "ppi", SPILL_FILES_SEED)
    jds, tds = spilled_pair(path, overflow_budget=64)
    with pytest.raises(ValueError, match="overflow budget is 64"):
        next(jds.batch_iterator(JDataFold.TRAIN))
    with pytest.raises(ValueError, match="overflow budget is 64"):
        next(tds.batch_iterator(DataFold.TRAIN))

    jds, tds = spilled_pair(path, overflow_budget=1024)
    jpair = next(jds.batch_iterator(JDataFold.TRAIN))
    tpair = next(tds.batch_iterator(DataFold.TRAIN))
    assert_same_batch(jpair, tpair, "spilled batch")
    jbatch, jlabels = jpair
    v = jbatch.num_nodes_padded
    spilled = [int((np.asarray(p[9]) < v).sum())
               for p in jbatch.pair_plans_typed]
    assert sum(spilled) > 0, spilled
    for p in jbatch.pair_plans_typed:
        real = np.asarray(p[9]) < v
        # Real edges: sources and targets among the batch's real nodes.
        assert (np.asarray(p[8])[real] < int(jbatch.num_nodes)).all()
        assert (np.asarray(p[9])[real] < int(jbatch.num_nodes)).all()

    params = JaxNodeMulticlassTask.get_default_hyperparameters("rgcn")
    params.update({"gnn_num_layers": 2, "gnn_hidden_dim": 16,
                   "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000})
    jmodel = JaxNodeMulticlassTask.from_params(params, jds)
    jparams = jmodel.init(jax.random.PRNGKey(0), jbatch, False)["params"]
    tmodel = NodeMulticlassTask.from_dataset(params, tds, device="cpu")
    load_flax_params(tmodel, jax.device_get(jparams))
    labels = jnp.asarray(jlabels["node_labels"])

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        return jmodel.compute_task_metrics(
            jbatch, out, {"node_labels": labels})["loss"]

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    tbatch = tpair[0].to("cpu")
    out = tmodel(tbatch, False)
    loss = tmodel.compute_task_metrics(
        tbatch, out, {"node_labels": torch.from_numpy(tpair[1]["node_labels"])}
    )["loss"]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOLS)
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOLS)
