"""``chip_smoke.py`` phase 12 (``cli_path``) on the CPU, at cut sizes: the
three command-line training runs and the two test-entry reloads pass,
with K1 and K2 counted through their plain versions (K2 twice a layer and
step under remat), every batch planned through the C++ binding and the
first epoch's batches identical on the numpy forms; and the phase fails
when K2 launches more often than the model's layers ask for, or when the
binding's plans differ from the numpy planner's.

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
    monkeypatch.setattr(chip_smoke, "CLI_RUNS", tuple(
        (name, head, tail + NARROW, *rest)
        for name, head, tail, *rest in chip_smoke.CLI_RUNS))
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
    monkeypatch.setattr(tps, "pair_spmm_stream",
                        _counted("pair_stream", tps.pair_spmm_stream))
    return monkeypatch


def test_cli_phase_passes(cut_phase, capsys):
    cut_phase.setattr(tps, "pair_spmm_stream_joint",
                      _counted("pair_stream_joint",
                               tps.pair_spmm_stream_joint))
    chip_smoke.cli_path(torch.device("cpu"), [])
    out = capsys.readouterr().out
    assert "PPI_GGNN_remat_bf16 epoch 1: 1 steps" in out
    assert "K1 3, K2 6" in out
    assert out.count("test entry on") == 2
    # Every batch planned through the C++ binding, the first epoch's also
    # through the numpy forms, and both agreed.
    assert out.count("binding vs numpy forms") == 3
    assert out.count("planners a batch") == 3
    assert "'pair binding'" in out and "'pair numpy'" not in out


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
    cut_phase.setattr(tps, "pair_spmm_stream_joint",
                      _counted("pair_stream_joint",
                               tps.pair_spmm_stream_joint))
    with pytest.raises(AssertionError, match="binding vs numpy forms"):
        chip_smoke.cli_path(torch.device("cpu"), [])


def test_cli_phase_catches_a_miscount(cut_phase):
    cut_phase.setattr(chip_smoke, "CLI_RUNS", chip_smoke.CLI_RUNS[:1])
    cut_phase.setattr(tps, "pair_spmm_stream_joint",
                      _counted("pair_stream_joint",
                               tps.pair_spmm_stream_joint, per_call=2))
    with pytest.raises(AssertionError, match="expected K1"):
        chip_smoke.cli_path(torch.device("cpu"), [])
