"""``chip_smoke.py`` phase 12 (``cli_path``) on the CPU, at cut sizes: the
three command-line training runs and the two test-entry reloads pass,
with K1, K2 and the node sums counted through their plain versions (K2
twice a layer and step under remat; at these sizes every run's tables
hold only the rows its plans read, so the node sum runs once a layer and
step, and the first TRAIN batch's three launches over those rows' forms
are checked), every batch planned through the C++ binding and the
first epoch's batches identical on the numpy forms, each run's
``num_batches`` equal to its epochs' counts; and the phase fails when K2
launches more often than the model's layers ask for, when the binding's
plans differ from the numpy planner's, or when ``num_batches`` miscounts
or draws TRAIN's permutation twice.

Sizes: PPI graphs of 150 nodes and 1500 forward links (6 / 3 / 3 graphs
a fold, one batch a fold at the JSON's ``max_nodes_per_batch``), QM9 40 /
20 / 20 molecules, each run's hidden width cut to 32 by
``--model-params-override`` (the shipped layer counts kept); the CUDA
clock, memory and synchronisation calls are stubbed with host stand-ins.
"""
import time

import pytest
import torch

import chip_smoke
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.ops import pair_spmm as tps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and these small ops then run
    many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _HostEvent:
    """``torch.cuda.Event``'s record / elapsed_time on the host clock."""

    def __init__(self, **kwargs):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _counted(name, wrapper, per_call=1):
    def call(*args, compact=None, **kwargs):
        tps.LAUNCHES[name] += per_call
        return wrapper(*args, **kwargs)
    return call


NARROW = ["--model-params-override", '{"gnn_hidden_dim": 32}']


@pytest.fixture
def cut_phase(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    # At the cut sizes every run's plans read fewer of the tables' rows
    # than ``COMPACT_TABLES_BELOW``: the tables hold only those rows, and
    # the products' input gradient is summed by node once a layer.
    monkeypatch.setattr(chip_smoke, "CLI_RUNS", tuple(
        (name, head, tail + NARROW, *rest, 1)
        for name, head, tail, *rest, _ in chip_smoke.CLI_RUNS))
    monkeypatch.setattr(workloads, "NODES_PER_GRAPH", 150)
    monkeypatch.setattr(workloads, "FWD_EDGES_PER_GRAPH", 1500)
    monkeypatch.setattr(workloads, "QM9_FOLD_MOLECULES",
                        {"train": 40, "valid": 20, "test": 20})
    for name, value in (("Event", _HostEvent),
                        ("synchronize", lambda *a: None),
                        ("reset_peak_memory_stats", lambda *a: None),
                        ("max_memory_allocated", lambda *a: 0),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    for name in ("pair_spmm_stream", "pair_spmm_stream_rows"):
        monkeypatch.setattr(tps, name,
                            _counted("pair_stream", getattr(tps, name)))
    monkeypatch.setattr(tps, "pair_spmm_node_rows",
                        _counted("node_rows", tps.pair_spmm_node_rows))
    return monkeypatch


def _count_k2(phase, per_call=1):
    """Both K2 wrappers (over the plan arrays and over the read rows'
    form) counted, ``per_call`` launches a call."""
    for name in ("pair_spmm_stream_joint", "pair_spmm_stream_joint_rows"):
        phase.setattr(tps, name, _counted("pair_stream_joint",
                                          getattr(tps, name), per_call))


def test_cli_phase_passes(cut_phase, capsys):
    _count_k2(cut_phase)
    chip_smoke.cli_path(torch.device("cpu"), [])
    out = capsys.readouterr().out
    assert "PPI_GGNN_remat_bf16 epoch 1: 1 steps" in out
    assert "K1 3, K2 6, node sums 3" in out
    assert out.count("kernel check (") == 3
    assert out.count("test entry on") == 2
    # Every batch planned through the C++ binding, the first epoch's also
    # through the numpy forms, and both agreed.
    assert out.count("binding vs numpy forms") == 3
    assert out.count("planners a batch") == 3
    assert "'pair binding'" in out and "'pair numpy'" not in out
    # Each run's num_batches equals its epochs' counts, fold by fold.
    assert out.count("num_batches against the epoch's batches") == 3
    assert out.count("TRAIN's shuffle draws in step: True") == 3


def test_cli_phase_catches_plans_that_differ(cut_phase):
    """A binding whose pair plans differ from the numpy planner's (one
    chunk's source block moved) fails the phase."""
    from tf2_gnn_tpu_torch import native

    real = native.pair_plan

    def moved(*args):
        used, rel_src, rel_tgt, src_blk, tgt_blk, edge_slot = real(*args)
        src_blk[0] += 1
        return used, rel_src, rel_tgt, src_blk, tgt_blk, edge_slot

    cut_phase.setattr(chip_smoke, "CLI_RUNS", chip_smoke.CLI_RUNS[:1])
    cut_phase.setattr(native, "pair_plan", moved)
    _count_k2(cut_phase)
    with pytest.raises(AssertionError, match="binding vs numpy forms"):
        chip_smoke.cli_path(torch.device("cpu"), [])


def test_cli_phase_catches_a_miscount(cut_phase):
    cut_phase.setattr(chip_smoke, "CLI_RUNS", chip_smoke.CLI_RUNS[:1])
    _count_k2(cut_phase, per_call=2)
    with pytest.raises(AssertionError, match="expected K1"):
        chip_smoke.cli_path(torch.device("cpu"), [])


@pytest.mark.parametrize("fault", ["count", "draws"])
def test_cli_phase_catches_num_batches_faults(cut_phase, fault):
    """A ``num_batches`` one off, or one that draws TRAIN's permutation
    twice, fails the phase."""
    from tf2_gnn_tpu_torch.data.graph_dataset import GraphDataset

    real = GraphDataset.num_batches

    def faulty(self, fold):
        if fault == "count":
            return real(self, fold) + 1
        self._graph_iterator(fold)
        return real(self, fold)

    cut_phase.setattr(chip_smoke, "CLI_RUNS", chip_smoke.CLI_RUNS[:1])
    cut_phase.setattr(GraphDataset, "num_batches", faulty)
    _count_k2(cut_phase)
    with pytest.raises(AssertionError, match="num_batches by fold"):
        chip_smoke.cli_path(torch.device("cpu"), [])
