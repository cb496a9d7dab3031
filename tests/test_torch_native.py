"""The port's C++ host engine (``tf2_gnn_tpu_torch/native``) on the CPU.

* The library builds with g++ into the git-ignored ``build/`` under a
  name hashed from the source and the flags; concurrent first builds (in
  threads and in processes) agree; a failed build raises with the
  compiler's output and nothing falls back to numpy.
* Each bound function is array-identical to its numpy form and to the JAX
  package's engine (``tf2_gnn_tpu.native``) on seeded inputs: the packers,
  the sort, the in-degrees, the scatter planner (with its overflow), the
  pair planner of one direction (parametrised over the budget overflow,
  where the numpy planner spills) and its chunk count, and the RCM order
  (also against the JAX package's numpy ``parallel/reorder.py`` form).
* A dataset's batches and plans are identical with the binding and with
  the numpy forms (``native.numpy_forms()``, compared as
  ``chip_smoke.check_same_batch`` compares them in phase 12), and
  ``native.PLANNED`` names the planner that ran.
"""
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tf2_gnn_tpu import native as jnative
from tf2_gnn_tpu.ops import pair_spmm as jps
from tf2_gnn_tpu.ops import spmm_pallas as jsp
from tf2_gnn_tpu.parallel import reorder as jreorder
from tf2_gnn_tpu_torch import native
from tf2_gnn_tpu_torch.data import DataFold, PPIDataset, QM9Dataset
from tf2_gnn_tpu_torch.native import plain
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss

from .synthetic_data import write_ppi_dataset, write_qm9_dataset

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's engine on its numpy fallbacks."""
    monkeypatch.setattr(jnative, "_load", lambda: None)


def assert_same(a, b, what: str):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_all_same(results, what: str):
    """Every entry of ``results`` ({form: tuple of arrays}) equals the
    first."""
    forms = list(results)
    first = results[forms[0]]
    for form in forms[1:]:
        assert len(results[form]) == len(first)
        for i, (x, y) in enumerate(zip(results[form], first)):
            assert_same(x, y, f"{what}[{i}]: {form} vs {forms[0]}")


def three_ways(call):
    """``call(engine)`` through the port's binding, the port's numpy forms
    and the JAX package's native engine."""
    out = {"binding": call(native)}
    with native.numpy_forms():
        out["numpy"] = call(native)
    assert jnative.available()
    out["jax native"] = call(jnative)
    return {k: v if isinstance(v, tuple) else (v,) for k, v in out.items()}


# ---- the build ----------------------------------------------------------------
def test_library_builds_into_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.exists()
    assert path.parent == REPO / "build" / "tf2_gnn_tpu_torch"
    assert path.name.startswith("libgraphpack_") and path.suffix == ".so"
    # The port builds its own copy of the engine, byte for byte below its
    # header.
    port = native.SOURCE.read_text()
    jax_src = (REPO / "native" / "src" / "graphpack.cc").read_text()
    body = "#include <algorithm>"
    assert port[port.index(body):] == jax_src[jax_src.index(body):]
    assert "-march" not in " ".join(native.CXX_FLAGS)


def test_concurrent_first_builds_agree(tmp_path, monkeypatch):
    """Four processes and four threads build into empty directories at
    once: each set leaves one library, no temporary file, and every
    library loads."""
    procs_dir, threads_dir = tmp_path / "procs", tmp_path / "threads"
    script = ("import sys; from pathlib import Path; "
              "import tf2_gnn_tpu_torch.native as n; "
              "n.BUILD_DIR = Path(sys.argv[1]); n.build(); "
              "print(n.library_path().name)")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(procs_dir)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    names = {p.communicate(timeout=120)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    monkeypatch.setattr(native, "BUILD_DIR", threads_dir)
    errors = []

    def build():
        try:
            native.build()
        except Exception as err:  # pragma: no cover - reported below
            errors.append(err)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert names == {native.library_path().name}
    for built in (procs_dir, threads_dir):
        files = sorted(p.name for p in built.iterdir())
        assert files == [native.library_path().name], files
        lib = __import__("ctypes").CDLL(str(built / files[0]))
        assert hasattr(lib, "gp_pair_plan")


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "graphpack.cc"
    broken.write_text("extern \"C\" int gp_broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building graphpack.cc failed"
                       "(.|\n)*error"):
        native.build()
    # Nothing falls back to numpy: the packers and planners raise too.
    with pytest.raises(RuntimeError, match="building graphpack.cc failed"):
        native.pack_nodes([np.ones((2, 3), np.float32)], 4, 1)
    with pytest.raises(RuntimeError, match="building graphpack.cc failed"):
        tss.plan_sorted_scatter(np.arange(10), 10, 128, 8)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_numpy_forms_is_scoped():
    assert native.binding_on()
    with native.numpy_forms():
        assert not native.binding_on()
        with pytest.raises(KeyError):
            with native.numpy_forms():
                raise KeyError("inner")
        assert not native.binding_on()
    assert native.binding_on()


# ---- the packers ----------------------------------------------------------------
def ragged(seed: int, sizes):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(n, 6).astype(np.float32) for n in sizes]
    edges = [rng.randint(0, n, (rng.randint(0, 3 * n + 1), 2))
             for n in sizes]
    labels = [rng.rand(n, 5).astype(np.float32) for n in sizes]
    return feats, edges, labels


SIZES = {"mixed": [5, 1, 9, 3], "one": [7], "many": [2] * 40,
         "large": [300, 257, 511]}


@pytest.mark.parametrize("sizes", sorted(SIZES))
@pytest.mark.parametrize("seed", [0, 1])
def test_packers_match(sizes, seed):
    sizes = SIZES[sizes]
    feats, edges, labels = ragged(seed, sizes)
    v_pad = sum(sizes) + 17
    budget = sum(e.shape[0] for e in edges) + 9
    assert_all_same(three_ways(lambda e: e.pack_nodes(feats, v_pad, 11)),
                    "pack_nodes")
    assert_all_same(
        three_ways(lambda e: e.pack_edges(edges, sizes, budget, v_pad - 1)),
        "pack_edges")
    assert_all_same(three_ways(lambda e: e.pack_labels(labels, v_pad)),
                    "pack_labels")
    scalar = [l[:, 0].copy() for l in labels]
    assert_all_same(three_ways(lambda e: e.pack_labels(scalar, v_pad)),
                    "pack_labels of scalars")
    flat = np.concatenate(edges).astype(np.int32)
    assert_all_same(
        three_ways(lambda e: e.sort_by_target(flat[:, 0], flat[:, 1])),
        "sort_by_target")
    assert_all_same(three_ways(lambda e: e.in_degrees(flat, max(sizes))),
                    "in_degrees")


@pytest.mark.parametrize("form", ["binding", "numpy"])
def test_pack_edges_overflow_and_empty(form):
    edges = [np.array([[0, 1], [1, 2], [2, 0]], np.int32)]
    engine = native if form == "binding" else plain
    with pytest.raises(ValueError, match="overflowed"):
        engine.pack_edges(edges, [3], budget=2, pad_node=5)
    empty = [np.zeros((0, 2), np.int32)] * 2
    src, tgt, count = engine.pack_edges(empty, [2, 3], 8, 7)
    assert count == 0
    assert_same(src, np.full((8,), 7, np.int32), "empty src")
    assert_same(tgt, np.full((8,), 7, np.int32), "empty tgt")


# ---- the planners ---------------------------------------------------------------
def targets_case(kind: str, seed: int):
    """(targets, real edge count, padded nodes) of one scatter stream."""
    rng = np.random.RandomState(seed)
    v = 1024
    n = {"random": 5000, "hot": 3000, "empty": 0, "one_block": 700}[kind]
    tgt = np.full((n + 64,), v - 1, np.int64)
    if kind == "random":
        tgt[:n] = rng.randint(0, v - 1, n)
    elif kind == "hot":
        tgt[:n] = rng.choice([3, 500, 501], n)
    elif kind == "one_block":
        tgt[:n] = rng.randint(128, 256, n)
    return tgt, n, v


@pytest.mark.parametrize("kind", ["random", "hot", "empty", "one_block"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_plan_matches(kind, seed):
    tgt, n, v = targets_case(kind, seed)
    chunks = tss.plan_chunk_budget(n, v)
    before = dict(native.PLANNED)
    got = tss.plan_sorted_scatter(tgt, n, v, chunks)
    assert native.PLANNED["scatter binding"] == before.get(
        "scatter binding", 0) + 1
    forms = {"binding": got,
             "numpy": tss.plan_sorted_scatter_numpy(tgt, n, v, chunks),
             "jax native": jsp.plan_sorted_scatter(tgt, n, v, chunks)}
    assert_all_same(forms, f"scatter plan {kind}")
    with native.numpy_forms():
        assert_all_same({"via numpy_forms": tss.plan_sorted_scatter(
            tgt, n, v, chunks), "binding": got}, "numpy_forms scatter plan")


def test_scatter_plan_overflow_raises():
    tgt, n, v = targets_case("random", 0)
    for fn in (tss.plan_sorted_scatter, tss.plan_sorted_scatter_numpy):
        with pytest.raises(ValueError, match="Scatter plan overflow"):
            fn(tgt, n, v, 4)


def pair_case(kind: str, seed: int):
    """(src, tgt) of one plan direction in a merged row space."""
    rng = np.random.RandomState(seed)
    v, types = 640, 3
    if kind == "dense_pairs":
        n = 6000
        src = rng.randint(0, 256, n) + 1024
        tgt = rng.randint(0, 256, n)
    elif kind == "hot_target":
        n = 3000
        src = rng.randint(0, types * v, n)
        tgt = rng.randint(0, 3, n)
    elif kind == "selfloop":
        src = tgt = np.arange(v)
    else:
        n = 5000
        src = rng.randint(0, types * v, n)
        tgt = rng.randint(0, v, n)
    return np.asarray(src, np.int64), np.asarray(tgt, np.int64)


PAIR_KINDS = ("random", "dense_pairs", "hot_target", "selfloop")


@pytest.mark.parametrize("budget", ["fits", "overflows"])
@pytest.mark.parametrize("group", [8, 16])
@pytest.mark.parametrize("kind", PAIR_KINDS)
def test_pair_plan_matches(kind, group, budget, jax_numpy):
    """One direction through the binding (or, where the edges overflow the
    budget, the numpy spill path), the numpy planner and the JAX package's
    planner on its numpy fallback (its native path is
    ``test_pair_plan_matches_jax_native``)."""
    src, tgt = pair_case(kind, 0)
    need = tps._plan_one_direction_numpy(src, tgt, None, group)[0]
    need = need.src_blk.shape[0]
    assert need > group
    chunks = need if budget == "fits" else need - group
    before = native.PLANNED.copy()
    got = tps._plan_one_direction(src, tgt, chunks, group)
    ran = native.PLANNED - before
    if budget == "fits":
        assert ran == {"pair binding": 1}
        assert not got[1].any()
    else:
        assert ran == {"pair numpy spill": 1}
        assert got[1].any()
    want = tps._plan_one_direction_numpy(src, tgt, chunks, group)
    ref = jps._plan_one_direction(src, tgt, chunks, group)
    forms = {name: tuple(p[0]) + tuple(p[1:])
             for name, p in (("binding", got), ("numpy", want),
                             ("jax numpy", ref))}
    assert_all_same(forms, f"pair plan {kind}")


@pytest.mark.parametrize("kind", PAIR_KINDS)
def test_pair_plan_matches_jax_native(kind):
    src, tgt = pair_case(kind, 1)
    chunks = tps._plan_one_direction_numpy(src, tgt, None,
                                           16)[0].src_blk.shape[0]
    assert jnative.available()
    forms = {name: tuple(p[0]) + tuple(p[1:]) for name, p in (
        ("binding", tps._plan_one_direction(src, tgt, chunks, 16)),
        ("jax native", jps._plan_one_direction(src, tgt, chunks, 16)))}
    assert_all_same(forms, f"pair plan {kind}")
    raw = native.pair_plan(src, tgt, chunks - 16, 16, tps.BLK, tps.E_C)
    assert raw[0] == -1  # an overflow returns -1; the caller spills


@pytest.mark.parametrize("merge_targets", [False, True])
@pytest.mark.parametrize("kind", ["random", "empty_type", "no_edges"])
def test_pair_chunk_count_matches(kind, merge_targets, monkeypatch):
    """``measure_pair_chunks`` through the binding's count, the numpy
    planner, and the JAX package's native count and numpy fallback."""
    rng = np.random.RandomState(3)
    v = 512
    counts = {"random": [900, 40, 300], "empty_type": [0, 700, 0],
              "no_edges": [0, 0, 0]}[kind]
    srcs = [np.concatenate([rng.randint(0, v - 1, c), [v - 1] * 8])
            for c in counts]
    tgts = [np.concatenate([rng.randint(0, v - 1, c), [v - 1] * 8])
            for c in counts]
    args = (srcs, tgts, counts, v)
    kwargs = dict(merge_targets=merge_targets, group_fwd=8, group_bwd=16)
    got = {"binding": tps.measure_pair_chunks(*args, **kwargs)}
    with native.numpy_forms():
        got["numpy"] = tps.measure_pair_chunks(*args, **kwargs)
    assert jnative.available()
    got["jax native"] = jps.measure_pair_chunks(*args, **kwargs)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    got["jax numpy"] = jps.measure_pair_chunks(*args, **kwargs)
    assert len(set(got.values())) == 1, got


@pytest.mark.parametrize("kind", ["random", "chain", "isolated"])
def test_rcm_order_matches(kind):
    rng = np.random.RandomState(5)
    n = 300
    if kind == "chain":
        edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    elif kind == "isolated":
        edges = rng.randint(0, n // 3, (200, 2))
    else:
        edges = rng.randint(0, n, (2000, 2))
    edges = edges.astype(np.int32)
    got = native.rcm_order(edges, n)
    assert jnative.available()
    assert_same(got, jnative.rcm_order(edges, n), "rcm vs jax native")
    assert_same(got, jreorder.locality_reorder([edges], n).astype(np.int32),
                "rcm vs jax reorder")
    assert sorted(got.tolist()) == list(range(n))


def test_rcm_order_matches_jax_numpy(jax_numpy):
    edges = np.random.RandomState(6).randint(0, 200, (900, 2)).astype(
        np.int32)
    assert_same(native.rcm_order(edges, 200),
                jreorder.locality_reorder([edges], 200).astype(np.int32),
                "rcm vs the JAX package's numpy form")


# ---- a dataset, both ways ---------------------------------------------------------
DATASETS = {
    "ppi_per_type": (PPIDataset, {"use_pair_spmm": True,
                                  "pair_per_type": True,
                                  "max_nodes_per_batch": 400}),
    "ppi_merged_targets": (PPIDataset, {"use_pair_spmm": True,
                                        "pair_merge_targets": True,
                                        "max_nodes_per_batch": 400}),
    "ppi_scatter": (PPIDataset, {"use_pallas_spmm": True,
                                 "max_nodes_per_batch": 400}),
    "qm9_merged": (QM9Dataset, {"use_pair_spmm": True,
                                "max_nodes_per_batch": 200}),
}


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_data")
    return {
        PPIDataset: write_ppi_dataset(root / "ppi", graphs_per_fold=4,
                                      nodes_per_graph=150,
                                      edges_per_graph=700, seed=4),
        QM9Dataset: write_qm9_dataset(root / "qm9", num_graphs=60,
                                      feature_dim=8, seed=4),
    }


def batches_of(cls, params, path):
    dataset = cls({**cls.get_default_hyperparameters(), **params},
                  rng=np.random.RandomState(0))
    dataset.load_data(path)
    batches = {fold: list(dataset.batch_iterator(fold))
               for fold in (DataFold.TRAIN, DataFold.VALIDATION)}
    return dataset.padding_config, batches


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_dataset_plans_identical_both_ways(case, data_dirs):
    cls, params = DATASETS[case]
    before = native.PLANNED.copy()
    config, got = batches_of(cls, params, data_dirs[cls])
    ran = native.PLANNED - before
    with native.numpy_forms():
        before = native.PLANNED.copy()
        config_np, want = batches_of(cls, params, data_dirs[cls])
        ran_np = native.PLANNED - before
    assert config == config_np
    if params.get("use_pair_spmm"):
        assert ran["pair binding"] > 0 and not ran_np["pair binding"]
        assert ran_np["pair numpy"] == ran["pair binding"] + ran[
            "pair numpy spill"]
    else:
        assert ran["scatter binding"] > 0 and not ran_np["scatter binding"]
        assert ran_np["scatter numpy"] == ran["scatter binding"]
    for fold in got:
        assert len(got[fold]) == len(want[fold]) > 0
        for i, ((gb, gl), (wb, wl)) in enumerate(zip(got[fold],
                                                      want[fold])):
            chip_smoke.check_same_batch(f"{case} {fold.name} batch {i}",
                                        gb, wb)
            assert sorted(gl) == sorted(wl)
            for key in gl:
                assert_same(gl[key], wl[key], f"{case} label {key}")


def test_packers_refuse_buffers_that_do_not_fit():
    feats = [np.ones((3, 4), np.float32), np.ones((2, 5), np.float32)]
    with pytest.raises(ValueError, match="columns"):
        native.pack_nodes(feats, 8, 7)
    with pytest.raises(ValueError, match="overflow the padded 4"):
        native.pack_nodes([np.ones((3, 4), np.float32)] * 2, 4, 3)
    with pytest.raises(ValueError, match="overflow the padded 2"):
        native.pack_labels([np.ones((3,), np.float32)], 2)
    with pytest.raises(ValueError, match="buffers too small"):
        native.scatter_plan(np.zeros(4, np.int32), np.arange(4, dtype=np.int32),
                            2, 512, 128, np.empty(512, np.int32),
                            np.empty(1024, np.int32), np.empty(2, np.int32))
