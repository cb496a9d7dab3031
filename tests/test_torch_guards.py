"""Guards of the PyTorch port:

* no module of ``tf2_gnn_tpu_torch`` (``parallel/`` included) and not
  ``chip_smoke.py`` imports jax, flax, optax, the JAX package, ``bench``,
  the tests, ``chip_smoke`` or ``portbench``, at the top or inside a
  function, nor the deprecated ``torch.distributed.nn``: the package
  depends on none of the scripts beside it;
* the entry points default to the card and raise without one instead of
  running on the CPU, the command-line train and test runs too (without
  ``--device cpu``), and ``initialize_multiprocess`` without ``device``;
* a CUDA tensor given to a kernel wrapper whose library cannot be built
  raises; it does not fall back to the plain version; nor does a CUDA call
  of a row-owner wrapper (K1, K2, B3, B12 in both forms, B4, B5, B6, B9)
  without the plan's compact form (B9: either of its two);
* a batch with neither pair plans nor a scatter plan, and every edge-MLP
  form on a batch where the JAX package takes its unfused per-edge path
  (the target-state forms on scatter plans with
  ``fused_target_gather=False``, the target-state GNN-FiLM on scatter
  plans, the 0-hidden target-state form on a merged plan with local
  targets, and the target-state form with 2 hidden layers), take the
  port's unfused path (``_route`` names ``"unfused"``) and match the JAX
  package's on the same batch (``test_torch_flavours.py::
  assert_matches_jax``);
* a batch with plans whose kernel library cannot be built on the card
  raises; it does not drop to the unfused path.
"""
import ast
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import tf2_gnn_tpu_torch
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.models.graph_binary_classification_task import (
    GraphBinaryClassificationTask,
)
from tf2_gnn_tpu_torch.models.graph_regression_task import (
    GraphRegressionTask,
)
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.models.qm9_regression_task import QM9RegressionTask
from tf2_gnn_tpu_torch.ops import cuda_build
from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_edge_mlp as tpem
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import probes as tprobes
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss
from tf2_gnn_tpu_torch.utils.device import resolve_device


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
PACKAGE = Path(tf2_gnn_tpu_torch.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tf2_gnn_tpu", "bench",
             "tests", "chip_smoke", "portbench"}
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def forbidden_imports(path: Path):
    return sorted(set(imported_roots(path)) & FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    bad = forbidden_imports(path)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("body", [
    "import {name}\n",
    "def main():\n    import {name}\n",
    "def main():\n    from {name}.sub import thing\n",
], ids=["top", "function", "function-from"])
@pytest.mark.parametrize("name", ["chip_smoke", "portbench"])
def test_guard_refuses_the_scripts_beside_the_package(name, body, tmp_path):
    module = tmp_path / "module.py"
    module.write_text("import torch\n\n" + body.format(name=name))
    assert forbidden_imports(module) == [name]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_avoids_torch_distributed_nn(path):
    bad = [m for m in imported_modules(path)
           if m.startswith("torch.distributed.nn")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_has_its_own_modules():
    expected = [
        "utils/constants.py", "utils/shapes.py", "utils/schedules.py",
        "data/graph_batch.py", "ops/pair_spmm.py", "ops/activations.py",
        "layers/gnn.py", "layers/message_passing/base.py",
        "layers/message_passing/typed_linear.py",
        "layers/message_passing/gnn_edge_mlp.py",
        "layers/message_passing/rgcn.py", "models/graph_task_model.py",
        "models/node_multiclass_task.py", "harness/optimizers.py",
        "harness/training.py", "harness/import_jax.py", "workloads.py",
        "csrc/pair_stream.cu", "ops/pair_attention.py", "utils/init.py",
        "layers/message_passing/rgat.py", "csrc/pair_attention.cu",
        "harness/default_hypers/PPI_RGAT.json", "ops/pair_edge_mlp.py",
        "csrc/pair_edge_mlp.cu", "ops/segment.py", "ops/gru.py",
        "layers/mlp.py", "layers/readout.py", "layers/global_exchange.py",
        "layers/dropout.py", "ops/sorted_spmm.py", "csrc/sorted_scatter.cu",
        "csrc/lane_units.cuh", "models/graph_regression_task.py",
        "models/qm9_regression_task.py",
        "models/graph_binary_classification_task.py",
        "harness/default_hypers/QM9_RGCN.json", "ops/probes.py",
        "csrc/dyngather.cu", "layers/message_passing/ggnn.py",
        "layers/message_passing/rgin.py",
        "layers/message_passing/gnn_film.py",
        "harness/default_hypers/PPI_GGNN.json",
        "harness/default_hypers/PPI_RGIN.json",
        "harness/default_hypers/PPI_GNN_Edge_MLP.json",
        "harness/default_hypers/PPI_GNN_FiLM.json",
        "harness/import_reference.py", "harness/reference_parity.py",
        "layers/gnn_input.py", "native/__init__.py", "native/plain.py",
        "native/graphpack.cc", "parallel/__init__.py",
        "parallel/collectives.py", "parallel/data_parallel.py",
        "parallel/hybrid.py", "parallel/launch.py",
        "parallel/multiprocess.py", "parallel/reorder.py",
        "parallel/spmd.py",
    ]
    missing = [p for p in expected if not (PACKAGE / p).is_file()]
    assert not missing


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this guards the card-less path")


def test_default_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workloads.build_ppi_batch(0)
    params = NodeMulticlassTask.get_default_hyperparameters("rgcn")
    params["gnn_global_exchange_every_num_layers"] = 10000
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NodeMulticlassTask.from_params(params, input_dim=4, num_edge_types=3)
    batch, _, _ = workloads.build_ppi_batch_host(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.to()


def test_edge_mlp_entry_points_default_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workloads.build_ppi_batch(0, merged=True, merge_targets=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NodeMulticlassTask.from_params(workloads.edge_mlp_default_params(),
                                       input_dim=4, num_edge_types=3)


def test_sorted_entry_points_default_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workloads.build_ppi_batch(0, scatter=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NodeMulticlassTask.from_params(workloads.rgcn_sorted_params(),
                                       input_dim=4, num_edge_types=3)


def test_qm9_entry_points_default_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workloads.build_qm9_batch(0, molecules=4, node_budget=128)
    for cls in (QM9RegressionTask, GraphRegressionTask,
                GraphBinaryClassificationTask):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls.from_params(workloads.qm9_shipped_params(), input_dim=4,
                            num_edge_types=5)


def test_parallel_entry_points_default_to_the_card(no_card, tmp_path):
    """Joining a group without a device, asking for this rank's device
    before joining, or spawning ranks without a device raises before any
    rendezvous or process; the scaling workload's host arrays need no
    device."""
    from tf2_gnn_tpu_torch.parallel import collectives, launch, multiprocess

    with pytest.raises(RuntimeError, match="device='cpu'"):
        multiprocess.initialize_multiprocess(
            f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collectives.process_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run_ranks(len, 2)
    batch, labels = workloads.scaling_partition(2, nodes_per_shard=64,
                                                edges_per_shard=256)
    assert batch.spmd_num_shards == 2 and batch.pair_plans is not None


def test_cli_runs_default_to_the_card(no_card, tmp_path):
    """The command-line training and test runs without ``--device cpu``
    raise before reading any data; with it they would run on the CPU."""
    from tf2_gnn_tpu_torch.cli import test as cli_test
    from tf2_gnn_tpu_torch.cli import train as cli_train
    from tf2_gnn_tpu_torch.harness import run

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.run(["RGCN", "PPI", str(tmp_path / "absent"),
                       "--save-dir", str(tmp_path / "out")])
    args = run.get_train_cli_arg_parser().parse_args(
        ["RGCN", "PPI", str(tmp_path), "--save-dir", str(tmp_path / "out")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.run_train_from_args(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_test.run([str(tmp_path / "absent.pkl"), str(tmp_path)])


class _CudaTensorStandIn:
    """What a wrapper sees of a CUDA tensor before it loads the library:
    its device and dtype. (This machine's torch cannot allocate CUDA
    tensors.)"""

    device = torch.device("cuda", 0)
    dtype = torch.float32


# What a wrapper sees of a plan's compact form before it loads the library:
# that it was given.
_COMPACT_STAND_IN = object()

# Every kernel wrapper: its launch counts and the positional arguments
# after its first tensor (K1, K2, B3, B12, B4, B5, B6, B7, B8, B10, B11,
# B14 and B15 end with the plan's compact form, B9 with its two; the node
# sum takes the read rows, which hold its form).
WRAPPERS = {
    tps.pair_spmm_stream: (
        tps.LAUNCHES, (None,) * 6 + (128, 128, _COMPACT_STAND_IN)),
    tps.pair_spmm_stream_joint: (
        tps.LAUNCHES, (None,) * 6 + (128, 128, _COMPACT_STAND_IN)),
    tps.pair_spmm: (tps.LAUNCHES, (None,) * 5 + (128, _COMPACT_STAND_IN)),
    tps.pair_spmm_stream_rows: (tps.LAUNCHES, (None, _COMPACT_STAND_IN, 128)),
    tps.pair_spmm_stream_joint_rows: (
        tps.LAUNCHES, (None, _COMPACT_STAND_IN, 128)),
    tps.pair_spmm_node_rows: (
        tps.LAUNCHES,
        (types.SimpleNamespace(node_rows=types.SimpleNamespace(
            out_rows=128)),)),
    tpa.pair_attention_expd: (
        tpa.LAUNCHES, (None,) * 5 + (128, 4, None, _COMPACT_STAND_IN)),
    tpa.pair_attention_bwd_fused: (
        tpa.LAUNCHES,
        (None,) * 8 + (128, 4, None, _COMPACT_STAND_IN, _COMPACT_STAND_IN)),
    tpa.pair_attention_max: (
        tpa.LAUNCHES, (None,) * 4 + (128, 4, None, _COMPACT_STAND_IN)),
    tpa.pair_attention_agg: (
        tpa.LAUNCHES, (None,) * 5 + (128, 4, _COMPACT_STAND_IN)),
    tpem.relu_pair_fwd: (
        tpem.LAUNCHES, (None,) * 6 + (128, _COMPACT_STAND_IN)),
    tpem.relu_pair_fwd_m: (
        tpem.LAUNCHES, (None,) * 6 + (128, _COMPACT_STAND_IN)),
    tpem.relu_pair_da: (
        tpem.LAUNCHES, (None,) * 7 + (128, _COMPACT_STAND_IN)),
    tpem.relu_pair_db: (
        tpem.LAUNCHES, (None,) * 7 + (128, _COMPACT_STAND_IN)),
    tss.sorted_segment_sum: (
        tss.LAUNCHES, (None,) * 2 + (128, None, _COMPACT_STAND_IN)),
    tss.sorted_segment_sum_scaled: (tss.LAUNCHES, (None,) * 3 + (128,)),
    tss.sorted_segment_max: (
        tss.LAUNCHES, (None,) * 2 + (128, _COMPACT_STAND_IN)),
    tss.attention_scatter_sums: (
        tss.LAUNCHES, (None,) * 3 + (128, _COMPACT_STAND_IN)),
    tprobes.dyngather: (tprobes.LAUNCHES, (None, 64)),
    tss.sorted_segment_sum_gathered: (
        tss.LAUNCHES, (None,) * 4 + (128, _COMPACT_STAND_IN)),
}


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_cuda_tensor_without_library_raises(wrapper, monkeypatch, tmp_path):
    launches, args = WRAPPERS[wrapper]
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    before = dict(launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wrapper(_CudaTensorStandIn(), *args)
    assert launches == before


@pytest.mark.parametrize("wrapper", [tps.pair_spmm_stream_joint,
                                     tps.pair_spmm, tps.pair_spmm_stream,
                                     tss.sorted_segment_sum,
                                     tss.sorted_segment_sum_gathered,
                                     tpem.relu_pair_fwd_m,
                                     tpem.relu_pair_fwd, tpem.relu_pair_da,
                                     tpem.relu_pair_db,
                                     tpa.pair_attention_expd,
                                     tpa.pair_attention_bwd_fused,
                                     tpa.pair_attention_agg,
                                     tss.attention_scatter_sums,
                                     tpa.pair_attention_max,
                                     tss.sorted_segment_max])
def test_cuda_call_without_compact_form_raises(wrapper, monkeypatch,
                                               tmp_path):
    """K1, K2, B3, B12 (both forms), B4, B6, B5, B7, B8, B9 (without its
    second form, ``ts_rows``), B10, B14, B11 and B15 on a CUDA tensor
    without the plan's compact form raise
    before they load the library: no per-call build, no fallback to the
    plain version, no launch counted."""
    launches, args = WRAPPERS[wrapper]
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    before = dict(launches)
    with pytest.raises(ValueError, match="needs the plan's compact form"):
        wrapper(_CudaTensorStandIn(), *args[:-1])
    assert launches == before
    assert not (tmp_path / "build").exists()


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 4), device="meta")
    for wrapper, (_, args) in WRAPPERS.items():
        with pytest.raises(TypeError, match="unsupported device"):
            wrapper(meta, *args)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper returns its plain version's result and counts
    no launch."""
    rng = np.random.RandomState(0)
    v = 128
    src = rng.randint(0, v, 300)
    tgt = rng.randint(0, v, 300)
    plans = (tps.build_pair_plans([src], [tgt], [300], v).astuple(),)
    plan = tps.stream_joint_plan(plans, v, v).to("cpu")
    tables = torch.randn(v, 8)
    args = (plan.scale_fwd, plan.rel_src_f, plan.rel_tgt_f, plan.src_blk_f,
            plan.grp_tgt_fl, plan.grp_type_f, v, v)
    before = dict(tps.LAUNCHES)
    got = tps.pair_spmm_stream_joint(tables, *args)
    assert torch.equal(got, tps.pair_spmm_stream_plain(tables, *args))
    assert tps.LAUNCHES == before


def test_cpu_tensors_take_the_plain_versions_of_the_attention_kernels():
    """B3, B8 and B9 on CPU tensors, with and without the plan's compact
    forms: the plain versions' results (B8's at the forward form's slots,
    B3's over a by-entry scale put back in slot order), no launch
    counted."""
    rng = np.random.RandomState(1)
    v, k = 128, 4
    src = rng.randint(0, v, (2, 200))
    tgt = rng.randint(0, v, (2, 200))
    plan = tps.MergedPlan(*tps.build_pair_plans(
        list(src), list(tgt), [200, 200], v).astuple()).to("cpu")
    table = torch.randn(2 * v, 8 * k)
    scores = torch.randn(2 * v, 2 * k)
    maxes = torch.randn(v, k)
    scale = torch.rand(plan.rel_src_f.numel())
    dw, d_denom = torch.randn(v, 8 * k), torch.randn(v, k)
    fwd_rows = plan.fwd_rows(v, 2 * v)
    slot = fwd_rows.slot.long()
    before = (dict(tps.LAUNCHES), dict(tpa.LAUNCHES))
    want3 = tps.pair_spmm_plain(table, scale, *plan.fwd, v)
    assert torch.equal(tps.pair_spmm(table, scale, *plan.fwd, v), want3)
    assert torch.equal(tps.pair_spmm(table, scale, *plan.fwd, v,
                                     compact=fwd_rows), want3)
    valid = tps.slot_abs_ids(*plan.fwd)[2]
    assert torch.equal(
        tps.pair_spmm(table, scale[slot], *plan.fwd, v, compact=fwd_rows,
                      by_entry=True),
        tps.pair_spmm_plain(table, scale * valid, *plan.fwd, v))
    want8 = tpa.pair_attention_expd_plain(scores, maxes, *plan.fwd, v, k)
    assert torch.equal(
        tpa.pair_attention_expd(scores, maxes, *plan.fwd, v, k), want8)
    assert torch.equal(
        tpa.pair_attention_expd(scores, maxes, *plan.fwd, v, k,
                                compact=fwd_rows), want8[:, slot])
    bwd_args = (table, dw, d_denom, scores, maxes, *plan.bwd, v, k)
    for compact, ts_rows in ((None, None),
                             (plan.bwd_rows(2 * v, v),
                              plan.bwd_ts_rows(2 * v, v, v))):
        for got, want in zip(
                tpa.pair_attention_bwd_fused(*bwd_args, compact=compact,
                                             ts_rows=ts_rows),
                tpa.pair_attention_bwd_fused_plain(*bwd_args)):
            assert torch.equal(got, want)
    assert (dict(tps.LAUNCHES), dict(tpa.LAUNCHES)) == before


def test_cpu_tensors_take_the_plain_versions_of_max_and_agg_kernels():
    """B11 and B10 on CPU tensors, in the merged form and on one type's
    plan, without and with the forward compact form (B10 also with B8's
    expd by entry): the plain versions' results, no launch counted."""
    rng = np.random.RandomState(4)
    v, k = 128, 8
    src = rng.randint(0, v, (2, 200))
    tgt = rng.randint(0, v, (2, 200))
    merged = tps.MergedPlan(*tps.build_pair_plans(
        list(src), list(tgt), [200, 200], v).astuple()).to("cpu")
    typed = tps.MergedPlan(*tps.build_pair_plans(
        [src[0]], [tgt[0]], [200], v).astuple(), out_rows=v).to("cpu")
    before = dict(tpa.LAUNCHES)
    for plan, rows in ((merged, 2 * v), (typed, v)):
        fwd_rows = plan.fwd_rows(v, rows)
        scores = torch.randn(rows, 2 * k)
        want = tpa.pair_attention_max_plain(scores, *plan.fwd, v, k)
        for compact in (None, fwd_rows):
            assert torch.equal(tpa.pair_attention_max(
                scores, *plan.fwd, v, k, compact=compact), want)
        table = torch.randn(rows, 2 * k)
        valid = tps.slot_abs_ids(*plan.fwd)[2]
        expd = torch.rand(k, plan.rel_src_f.numel()) * valid
        want = tpa.pair_attention_agg_plain(table, expd, *plan.fwd, v, k)
        for got in (tpa.pair_attention_agg(table, expd, *plan.fwd, v, k),
                    tpa.pair_attention_agg(
                        table, expd[:, fwd_rows.slot.long()], *plan.fwd, v,
                        k, compact=fwd_rows, by_entry=True)):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(tpa.LAUNCHES) == before


def test_cpu_tensors_take_the_plain_versions_of_the_relu_pair_kernels():
    """B4, B5, B6 and B7 on CPU tensors, with the plans' compact forms: the
    plain versions' results, no launch counted."""
    rng = np.random.RandomState(2)
    v = 128
    src = rng.randint(0, v, (2, 200))
    tgt = rng.randint(0, v, (2, 200))
    plan = tps.MergedPlan(*tps.build_pair_plans(
        list(src), list(tgt), [200, 200], v,
        merge_targets=True).astuple()).to("cpu")
    a, b, g = (torch.randn(2 * v, 8) for _ in range(3))
    sf, sb = plan.inv_fwd, plan.inv_bwd
    fwd_rows, bwd_rows = plan.fwd_rows(2 * v, 2 * v), plan.bwd_rows(2 * v,
                                                                    2 * v)
    before = dict(tpem.LAUNCHES)
    pairs = (
        (tpem.relu_pair_fwd(a, b, sf, *plan.fwd, 2 * v, compact=fwd_rows),
         tpem.relu_pair_fwd_plain(a, b, sf, *plan.fwd, 2 * v)),
        (tpem.relu_pair_fwd_m(a, b, sf, *plan.fwd, 2 * v, compact=fwd_rows),
         tpem.relu_pair_fwd_m_plain(a, b, sf, *plan.fwd, 2 * v)),
        (tpem.relu_pair_da(a, b, g, sb, *plan.bwd, 2 * v, compact=bwd_rows),
         tpem.relu_pair_da_plain(a, b, g, sb, *plan.bwd, 2 * v)),
        (tpem.relu_pair_db(a, b, g, sf, *plan.fwd, 2 * v, compact=fwd_rows),
         tpem.relu_pair_db_plain(a, b, g, sf, *plan.fwd, 2 * v)))
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tpem.LAUNCHES == before


def test_cpu_tensors_take_the_plain_versions_of_the_sorted_kernels():
    """B12 (both forms), B13, B14 and B15 on CPU tensors: the plain
    versions' results, no launch counted."""
    rng = np.random.RandomState(3)
    v, k = 256, 4
    srcs = list(rng.randint(0, v, (2, 300)))
    tgts = list(rng.randint(0, v, (2, 300)))
    host = tss.build_merged_plans(srcs, tgts, [300, 300], v)
    plan = tss.ScatterPlan.from_host(host, v, 2).to("cpu")
    slots = plan.rel_tgt.numel()
    msgs = torch.randn(slots, 8 * k)
    scale, expd = torch.rand(slots), torch.rand(slots, k)
    fwd = (plan.rel_tgt, plan.tgt_blocks, v)
    bwd = (plan.bwd_to_fwd_idx, plan.bwd_sentinel, plan.rel_src,
           plan.src_blocks, 2 * v)
    before = dict(tss.LAUNCHES)
    pairs = (
        (tss.sorted_segment_sum(msgs, *fwd),
         tss.sorted_segment_sum_plain(msgs, *fwd)),
        (tss.sorted_segment_sum(msgs[:, :k], plan.rel_typed,
                                plan.tgt_blocks, 2 * v, block_rows=256),
         tss.sorted_segment_sum_plain(msgs[:, :k], plan.rel_typed,
                                      plan.tgt_blocks, 2 * v,
                                      block_rows=256)),
        (tss.sorted_segment_sum_scaled(msgs, scale, *fwd),
         tss.sorted_segment_sum_scaled_plain(msgs, scale, *fwd)),
        (tss.sorted_segment_max(expd, *fwd),
         tss.sorted_segment_max_plain(expd, *fwd)),
        (tss.attention_scatter_sums(expd, msgs, *fwd),
         tss.attention_scatter_sums_plain(expd, msgs, *fwd)),
        (tss.sorted_segment_sum_gathered(msgs, *bwd),
         tss.sorted_segment_sum_gathered_plain(msgs, *bwd)))
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tss.LAUNCHES == before


def test_cpu_tensors_take_the_plain_versions_of_the_probes():
    """P3 on CPU tensors, and P1 / P2 through B3's wrapper: the plain
    versions' results, no launch counted."""
    rng = np.random.RandomState(5)
    v = 256
    src, tgt = rng.randint(0, 2 * v, 700), rng.randint(0, v, 700)
    table = torch.randn(2 * v, 8)
    idx = torch.from_numpy(rng.randint(0, v, (v, 8)).astype(np.int32))
    before = (dict(tps.LAUNCHES), dict(tprobes.LAUNCHES))
    for plan, fn in ((tprobes.unrolled_plan(src, tgt, 2 * v, v),
                      tprobes.pair_spmm_unrolled),
                     (tprobes.chunked_plan(src, tgt, 2 * v, v),
                      tprobes.pair_spmm_chunked)):
        plan = plan.to("cpu")
        assert torch.equal(fn(table, plan, v),
                           tps.pair_spmm_plain(table, *plan.kernel_args, v))
    assert torch.equal(tprobes.dyngather(table[:v], idx, 16),
                       tprobes.dyngather_plain(table[:v], idx, 16))
    assert (dict(tps.LAUNCHES), dict(tprobes.LAUNCHES)) == before


@pytest.mark.parametrize("style", ["rgcn", "rgat"])
def test_batch_without_any_plan_raises(style):
    """A batch with neither pair plans nor a scatter plan takes the
    unfused per-edge path, which matches the JAX package's (the test's
    name is its id from when this path raised)."""
    from .test_torch_flavours import assert_matches_jax
    from .test_torch_rgcn_model import small_workload

    jbatch, tbatch, labels = small_workload(seed=21)
    jbatch = jbatch.replace(pair_plans_typed=None)
    bare = tbatch.replace(pair_plans_typed=None)
    params = NodeMulticlassTask.get_default_hyperparameters(style)
    params.update({"gnn_hidden_dim": 8, "gnn_num_layers": 1,
                   "gnn_num_heads": 2, "gnn_layer_input_dropout_rate": 0.0,
                   "gnn_global_exchange_every_num_layers": 10000})
    model = assert_matches_jax(params, jbatch, bare, labels)
    assert model.gnn.mp_layer_0._route(bare) == "unfused"


# (shipped file, style, overrides, plan kind), each a route the JAX package
# leaves to its unfused path.
UNFUSED_CASES = {
    "edge_mlp_0_hidden_no_fused_target_gather": (
        "PPI_GNN_Edge_MLP.json", "gnn_edge_mlp",
        {"gnn_fused_target_gather": False}, "scatter"),
    "edge_mlp_1_hidden_no_fused_target_gather": (
        "PPI_GNN_Edge_MLP.json", "gnn_edge_mlp",
        {"gnn_fused_target_gather": False,
         "gnn_num_edge_MLP_hidden_layers": 1}, "scatter"),
    "film_target_state_on_scatter_plans": (
        "PPI_GNN_FiLM.json", "gnn_film", {}, "scatter"),
    "edge_mlp_0_hidden_on_local_targets": (
        "PPI_GNN_Edge_MLP.json", "gnn_edge_mlp", {}, "pairs"),
    "edge_mlp_2_hidden": (
        "PPI_GNN_Edge_MLP.json", "gnn_edge_mlp",
        {"gnn_num_edge_MLP_hidden_layers": 2}, None),
}


@pytest.mark.parametrize("case", list(UNFUSED_CASES))
def test_unfused_routes_raise(case):
    """Each route runs the port's unfused path, as the JAX package does on
    the same batch, and matches it (the test's name is its id from when
    these routes raised)."""
    from .test_torch_flavours import assert_matches_jax
    from .test_torch_rgcn_model import small_workload
    from .test_torch_sorted_models import scatter_workload

    hypers, style, overrides, kind = UNFUSED_CASES[case]
    params = dict(workloads.shipped_params(hypers, style),
                  gnn_hidden_dim=8, gnn_num_layers=1,
                  gnn_layer_input_dropout_rate=0.0, **overrides)
    if kind == "scatter":
        jbatch, tbatch, labels = scatter_workload(seed=22)
    else:
        jbatch, tbatch, labels = small_workload(seed=22,
                                                merged=kind == "pairs")
        if kind is None:
            jbatch = jbatch.replace(pair_plans_typed=None)
            tbatch = tbatch.replace(pair_plans_typed=None)
    model = assert_matches_jax(params, jbatch, tbatch, labels)
    assert model.gnn.mp_layer_0._route(tbatch) == "unfused"


def test_cuda_batch_with_plans_does_not_drop_to_the_unfused_path(
        monkeypatch, tmp_path):
    """A batch with per-type plans whose kernel library cannot be built
    on the card: the model raises where K2 would launch (its wrapper, over
    the plan arrays or over the read rows' form, sees a CUDA tensor), and
    the unfused path never runs."""
    from tf2_gnn_tpu_torch.layers.message_passing import GNN_Edge_MLP

    from .test_torch_rgcn_model import small_workload

    _, batch, _ = small_workload(seed=23)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    for name in ("pair_spmm_stream_joint", "pair_spmm_stream_joint_rows"):
        monkeypatch.setattr(
            tps, name,
            lambda tables, *args, _real=getattr(tps, name), **kwargs: _real(
                _CudaTensorStandIn(), *args, **kwargs))
    unfused = []
    monkeypatch.setattr(GNN_Edge_MLP, "_compute_messages_per_type",
                        lambda *args: unfused.append(args))
    params = dict(workloads.shipped_params("PPI_RGCN.json", "rgcn"),
                  gnn_hidden_dim=8, gnn_num_layers=1)
    model = NodeMulticlassTask.from_params(
        params, input_dim=batch.node_features.shape[1], num_edge_types=3,
        device="cpu", num_labels=7)
    assert model.gnn.mp_layer_0._route(batch) == "pair_joint"
    before = dict(tps.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        model(batch, False)
    assert not unfused and tps.LAUNCHES == before
