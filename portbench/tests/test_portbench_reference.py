"""The plain reference against the port at a tiny size on the CPU, the
controls (the reference with TF32 products in the program's place; for
QM9_RGCN the program's own bf16-operand products) and the planted faults
a one-chip training cell can have (a step that leaves its state
unchanged, half of the batch left out of the loss, the loss altered where
it is produced), each driven through the rest of a run (``run_cell``)
until ``correct`` comes out.

The tiny cells keep each configuration's layers, flavour, heads,
optimizer and edge dtype, at hidden 16 (PPI) or 64 (QM9) over a few
small graphs. Their limits are this size's own, set from the readings
that these seeds give (deterministic on the CPU): PPI_RGCN's program
readings are at most 5e-6 (loss), 6e-6 (gradient norm), 1.5e-4 (gradient
difference), 5e-4 (change norm) and 2.4e-2 (change difference) against
the control's 5e-6, 1.8e-3, 2.8e-2, 3.2e-3 and 8.9e-2; QM9_RGCN's (8 bf16
layers under RMSProp, whose later steps amplify the stream's re-rounding)
1.5e-3, 1.2e-4, 2.0e-3, 6.1e-3 and 0.14 against the control's 7e-3,
1.2e-2, 0.13, 2.4e-2 and 0.45. An update of the wrong sign reads 2.0
(Adam) and 7.6 (RMSProp) on the change difference.
"""
import copy
import dataclasses
import json
import sys
import time
import types

import pytest
import torch

from portbench import harness, system
from portbench.check import compare, judge
from tf2_gnn_tpu_torch.harness import optimizers
from tf2_gnn_tpu_torch.models import NodeMulticlassTask, QM9RegressionTask

CPU = torch.device("cpu")
TINY_LIMITS = {
    "ppi": {"loss_gap": 1e-4, "grad_gap": 1e-4, "grad_diff": 2e-3,
            "change_gap": 1e-3, "change_diff": 0.5},
    "qm9": {"loss_gap": 5e-3, "grad_gap": 2e-3, "grad_diff": 2e-2,
            "change_gap": 1.2e-2, "change_diff": 0.5},
}
WORKLOADS = ("ppi_rgcn.train", "ppi_rgcn.unfused", "qm9_rgcn.train")


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.load_cell(workload)
    config = copy.deepcopy(cell.config)
    layout = cell.traffic["layout"]
    if layout == "ppi":
        config["model_params"]["gnn_hidden_dim"] = 16
        config["task_params"]["max_nodes_per_batch"] = 256
        traffic = dict(cell.traffic, draws=4, graphs_per_draw=2,
                       nodes_per_graph=100, fwd_edges_per_graph=400)
    else:
        config["model_params"]["gnn_hidden_dim"] = 64
        config["task_params"]["max_nodes_per_batch"] = 1024
        traffic = dict(cell.traffic, draws=4, molecules_per_draw=56)
    return dataclasses.replace(cell, config=config, traffic=traffic,
                               limits=TINY_LIMITS[layout])


def run(cell, seed=1, trace=False):
    lines = []
    result = harness.run_cell(cell, seed, 0.2, trace, CPU,
                              time.perf_counter(), lines.append)
    return result, lines


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_agrees_with_the_port(workload, seed):
    result, lines = run(tiny_cell(workload), seed)
    check = result["check"]
    assert result["correct"], check
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_graphs_per_s",
                                      "train_step_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert any(line.startswith("losses:") for line in lines)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [1, 2])
def test_control_in_tf32_is_not_correct(workload, seed):
    cell = tiny_cell(workload)
    session = harness.Session(cell, seed, CPU)
    session.free()
    args = (cell.config, session.draws[:harness.CHECKED_STEPS],
            session.weights, session.dropout_seed, CPU)
    reference = cell.reference.train_readings(*args)
    control = cell.reference.train_readings(*args, precision="tf32")
    _, correct = judge(compare(control, reference), cell.limits)
    assert not correct


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_with_an_fp8_stream_is_not_correct(workload):
    """The reference with its bfloat16 edge stream in fp8 (e4m3, scaled
    per tensor), the step below the configuration's stream."""
    cell = tiny_cell(workload)
    session = harness.Session(cell, 1, CPU)
    session.free()
    args = (cell.config, session.draws[:harness.CHECKED_STEPS],
            session.weights, session.dropout_seed, CPU)
    reference = cell.reference.train_readings(*args)
    control = cell.reference.train_readings(*args, precision="fp8_stream")
    numbers = compare(control, reference)
    _, correct = judge(numbers, cell.limits)
    assert not correct
    assert numbers["grad_diff"] > 10 * cell.limits["grad_diff"]


def test_fp8_stream_rounding_scales_by_the_largest_magnitude():
    from portbench.reference.rgcn import FP8, stream_round

    x = torch.tensor([1e-6, -2e-6, 4e-6])
    # Unscaled, fp8 flushes these to zero; scaled, 4e-6 maps to 448.
    assert stream_round(x, FP8)[2] == pytest.approx(4e-6)
    assert stream_round(x, FP8)[0] == pytest.approx(1e-6, rel=0.07)
    assert stream_round(x, torch.bfloat16).tolist() == x.to(
        torch.bfloat16).float().tolist()


def test_qm9_control_with_bf16_products_is_not_correct(monkeypatch):
    """QM9_RGCN's control: the program built with its own bf16-operand
    products (``gnn_dense_dtype: bfloat16``), driven through a run whose
    reference keeps the configuration's float32."""
    as_configured = system.model_params

    def with_bf16_products(config):
        return dict(as_configured(config), gnn_dense_dtype="bfloat16")

    monkeypatch.setattr(system, "model_params", with_bf16_products)
    result, _ = run(tiny_cell("qm9_rgcn.train"))
    assert not result["correct"], result["check"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from portbench.reference.rgcn import round_tf32

    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                      -3.0 - 2.0**-12])
    assert round_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9,
                                      -3.0]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        workload, monkeypatch):
    monkeypatch.setattr(optimizers.Optimizer, "step",
                        lambda self, step: None)
    result, _ = run(tiny_cell(workload))
    assert not result["correct"]
    assert result["check"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_update_of_the_wrong_sign_is_not_correct(workload, monkeypatch):
    """The optimizer's state as it should be, each parameter moved the
    other way: every norm stays, and the change difference reads 2 or
    more."""
    step = optimizers.Optimizer.step

    def ascent(self, k):
        params = [p for g in self.torch_optimizer.param_groups
                  for p in g["params"]]
        before = [p.detach().clone() for p in params]
        step(self, k)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(2.0 * b - p)

    monkeypatch.setattr(optimizers.Optimizer, "step", ascent)
    result, _ = run(tiny_cell(workload))
    assert not result["correct"]
    check = result["check"]
    assert check["change_diff"]["value"] > 1.9
    assert check["grad_gap"]["value"] <= check["grad_gap"]["limit"]


def _half_batch(metrics):
    def half(batch, task_output, labels):
        batch = dataclasses.replace(batch, num_nodes=batch.num_nodes // 2,
                                    num_graphs=batch.num_graphs // 2)
        return metrics(batch, task_output, labels)
    return staticmethod(half)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_of_the_batch_left_out_is_not_correct(workload, monkeypatch):
    for task in (NodeMulticlassTask, QM9RegressionTask):
        monkeypatch.setattr(task, "compute_task_metrics",
                            _half_batch(task.compute_task_metrics))
    result, _ = run(tiny_cell(workload))
    assert not result["correct"], result["check"]


def _altered_loss(metrics):
    def altered(batch, task_output, labels):
        out = metrics(batch, task_output, labels)
        return dict(out, loss=out["loss"] * 1.01)
    return staticmethod(altered)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_loss_altered_where_it_is_produced_is_not_correct(workload,
                                                            monkeypatch):
    for task in (NodeMulticlassTask, QM9RegressionTask):
        monkeypatch.setattr(task, "compute_task_metrics",
                            _altered_loss(task.compute_task_metrics))
    result, _ = run(tiny_cell(workload))
    assert not result["correct"], result["check"]


def test_traced_run_reports_per_layer_metrics():
    result, _ = run(tiny_cell("ppi_rgcn.train"), trace=True)
    assert result["correct"]
    # On the CPU no device activity is traced: the readers of the host
    # clock report, the device readers report nothing but the idle share.
    assert set(result["metrics"]) == {"step_dispatch_ms", "batch_prep_ms",
                                      "device_idle_pct"}
    assert result["device"]["busy_s"] == 0.0
    assert result["device"]["window_s"] > 0.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "check"


def test_a_loaded_jax_module_stops_the_run(monkeypatch, capsys):
    result, _ = run(tiny_cell("ppi_rgcn.train"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    lines = []
    assert harness.emit(result, lines.append) == 3
    assert capsys.readouterr().out == ""
    assert "jax" in lines[-1]
    monkeypatch.delitem(sys.modules, "jax")
    assert harness.emit(result, lines.append) == 0
    assert json.loads(capsys.readouterr().out) == result
    assert lines[-1].startswith("check ")


def test_main_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code = harness.main(["--workload", "ppi_rgcn.train", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "CUDA" in out.err


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell("ppi_rgcn.train")
    result = harness.run_cell(cell, 3, 1.0, True, torch.device("cuda", 0),
                              time.perf_counter(), lambda line: None)
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0.0
    assert "gemm_device_ms" in result["metrics"]
    assert json.dumps(result)
