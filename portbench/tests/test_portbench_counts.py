"""FLOP and byte counts against hand-worked shapes, and the per-layer
readers and the trace arithmetic on synthetic windows."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import generator, harness
from portbench.reference import rgcn
from portbench.trace import Trace

BENCH = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def full_draw(traffic):
    spec = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    return generator.generate(dict(spec, draws=1), 0)[0]


def test_ppi_rgcn_model_flops():
    # 48,000 nodes, 50 features, hidden 320, 3 edge types, 121 labels,
    # 1,408,000 edges, 4 layers, a dense layer after layer 0 only.
    initial = 2 * 48000 * 50 * 320                 # 1,536,000,000
    edge_mlps = 4 * 3 * (2 * 48000 * 320 * 320)    # 117,964,800,000
    dense = 2 * 48000 * 320 * 320                  # 9,830,400,000
    head = 2 * 48000 * 320 * 121                   # 3,717,120,000
    aggregations = 4 * 2 * (2 * 1408000 * 320)     # 7,208,960,000
    want = 3 * (initial + edge_mlps + dense + head) + aggregations
    assert want == 406_353_920_000
    assert rgcn.model_flops(config("ppi_rgcn"),
                            full_draw("ppi_train")) == want


def test_qm9_rgcn_model_flops():
    m = 131058
    initial = 2 * m * 32 * 128
    edge_mlps = 8 * 5 * (2 * m * 128 * 128)
    dense = 2 * m * 128 * 128
    # Exchanges after layers 2, 4, 6: scoring MLP (128 -> 128 -> 4),
    # transformation MLP (128 -> 128 -> 128), the GRU's two [128, 384].
    exchange = (2 * m * 128 * 128 + 2 * m * 128 * 4 + 2 * m * 128 * 128
                + 2 * m * 128 * 128 + 2 * (2 * m * 128 * 384))
    head = 2 * m * 128 * 1 + 2 * m * 160 * 1
    aggregations = 8 * 2 * (2 * 400455 * 128)
    want = 3 * (initial + edge_mlps + dense + 3 * exchange + head) \
        + aggregations
    assert want == 882_375_186_816
    assert rgcn.model_flops(config("qm9_rgcn"),
                            full_draw("qm9_train")) == want


def test_aggregation_bytes_hand_worked():
    draw = generator.Draw(
        node_features=np.zeros((4, 50), np.float32),
        edges=[np.array([[0, 1], [2, 1]], np.int32),
               np.array([[1, 0]], np.int32)],
        graph_nodes=[4], graph_edges=[[2], [1]],
        node_labels=np.zeros((4, 121), np.float32))
    # Forward: 3 distinct table rows (0, 2 of type 0; 4 + 1 of type 1) in
    # bf16, 8 B an edge, 5 row pointers, 4 f32 output rows of 320.
    forward = 3 * 320 * 2 + 3 * 8 + 5 * 4 + 4 * 320 * 4
    # Backward: 2 distinct cotangent rows (targets 0, 1), 9 row pointers,
    # 2 * 4 f32 table-gradient rows.
    backward = 2 * 320 * 2 + 3 * 8 + 9 * 4 + 8 * 320 * 4
    assert (forward, backward) == (7084, 11580)
    assert rgcn.aggregation_bytes(config("ppi_rgcn"), draw) == 4 * (
        forward + backward)
    assert rgcn.aggregation_flops(config("ppi_rgcn"), draw) == (
        4 * 2 * 2 * 3 * 320)


def synthetic_trace():
    # A 1000 us window of 2 steps: a gemm 0-300, a row owner 250-400
    # (overlapping it), an index_add 600-700; idle 400-600 and 700-1000.
    return Trace(
        steps=2, window=(0.0, 1000.0),
        device=[("sm90_xmma_gemm_f32f32", 0.0, 300.0),
                ("void row_owner_kernel<float>", 250.0, 400.0),
                ("index_add_kernel", 600.0, 700.0),
                ("before the window", -50.0, -10.0)])


def test_trace_union_gaps_and_ops():
    trace = synthetic_trace()
    assert trace.busy_intervals() == [
        (0.0, 400.0, "sm90_xmma_gemm_f32f32"),
        (600.0, 700.0, "index_add_kernel")]
    assert trace.busy_s == pytest.approx(500e-6)
    assert trace.window_s == pytest.approx(1e-3)
    gaps = trace.idle_gaps()
    assert [g[0] for g in gaps] == ["end of the window",
                                    "before index_add_kernel"]
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 200e-6])
    ops = dict(trace.device_ops())
    assert ops["sm90_xmma_gemm_f32f32"] == pytest.approx(300e-6)
    assert "before the window" not in ops


def ctx(trace=None, **extra):
    base = dict(
        trace=trace, window={"steps": 10, "window_s": 0.5,
                             "dispatch_ms": 1.25},
        prep_ms=[100.0, 300.0], flops_per_step=4.945e12,
        aggregation_bytes_per_step=3.35e9, aggregation_flops_per_step=1e9,
        peak=harness.card_peaks("NVIDIA H100 80GB HBM3").get)
    base.update(extra)
    return SimpleNamespace(**base)


def test_readers_on_synthetic_windows():
    read = harness.load_reader
    trace = synthetic_trace()
    assert read("step_dispatch_ms")(ctx()) == 1.25
    assert read("batch_prep_ms")(ctx()) == 200.0
    # 10 steps of 4.945 TFLOP in 0.5 s against 989 TFLOP/s: 10%.
    assert read("train_mfu")(ctx()) == pytest.approx(10.0)
    assert read("train_mfu")(ctx(peak=harness.card_peaks("cpu").get)) is None
    # 300 us of gemm over 2 steps.
    assert read("gemm_device_ms")(ctx(trace)) == pytest.approx(0.15)
    # The bound: 3.35e9 B at 3.35 TB/s is 1 ms a step, against 150 us of
    # row owners over 2 steps (0.075 ms a step).
    assert read("agg_roofline")(ctx(trace)) == pytest.approx(
        100.0 * 1.0 / 0.075)
    assert read("device_idle_pct")(ctx(trace)) == pytest.approx(50.0)
    for name in ("gemm_device_ms", "agg_roofline", "device_idle_pct"):
        assert read(name)(ctx(None)) is None
    bare = Trace(steps=2, window=(0.0, 10.0), device=[])
    assert read("agg_roofline")(ctx(bare)) is None
    assert read("gemm_device_ms")(ctx(bare)) is None


def test_percentile_and_end_to_end():
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == \
        pytest.approx(4.8)
    window = {"graphs": 300, "window_s": 2.0, "gaps_ms": [1.0] * 19 + [9.0]}
    assert harness.end_to_end_value("train_graphs_per_s", window, 3.0) == 150
    assert harness.end_to_end_value("train_step_p95_ms", window, 3.0) == \
        pytest.approx(1.4)
    assert harness.end_to_end_value("setup_s", window, 3.0) == 3.0


def test_judge_keeps_the_result_json_when_a_number_is_not_finite():
    from portbench.check import judge

    limits = {"grad_gap": 1e-3, "first_loss_gap": 1e-6}
    table, correct = judge({"grad_gap": float("nan"),
                            "first_loss_gap": 0.0, "loss_gap": 1.0}, limits)
    assert not correct
    assert json.loads(json.dumps(table, allow_nan=False)) == {
        "first_loss_gap": {"value": 0.0, "limit": 1e-6},
        "grad_gap": {"value": "nan", "limit": 1e-3}}
    assert judge({"grad_gap": 1e-4, "first_loss_gap": 2e-6},
                 limits)[1] is False
    assert judge({"grad_gap": 1e-4, "first_loss_gap": 1e-6},
                 limits)[1] is True


def _readings(grads, changes, losses=(1.0, 1.0, 1.0)):
    return {"losses": list(losses),
            "grads": {k: torch.tensor(v) for k, v in grads.items()},
            "changes": {k: torch.tensor(v) for k, v in changes.items()}}


def test_check_holds_a_small_leaf_to_its_own_norm():
    from portbench.check import compare

    # Three leaves of gradient norm 1 and one at 5% of the median whose
    # gradient points the other way: the norms agree, the difference
    # reads 2 over the leaf's own norm.
    grads = {"a": [1.0, 0.0], "b": [0.0, 1.0], "c": [0.6, 0.8],
             "small": [0.05, 0.0]}
    wrong = dict(grads, small=[-0.05, 0.0])
    numbers = compare(_readings(wrong, grads), _readings(grads, grads))
    assert numbers["grad_gap"] == 0.0
    assert numbers["grad_diff"] == pytest.approx(2.0)
    assert numbers["change_diff"] == 0.0


def test_check_leaves_out_a_leaf_of_round_off_gradient():
    from portbench.check import compare

    # A leaf whose gradient is 1e-4 of the median's: its change is left
    # out of the change numbers, and of the gradient's difference.
    grads = {"a": [1.0], "b": [2.0], "c": [3.0], "tiny": [2e-4]}
    changes = {"a": [1e-3], "b": [1e-3], "c": [1e-3], "tiny": [1e-3]}
    got = _readings(dict(grads, tiny=[-2e-4]), dict(changes, tiny=[-1e-3]))
    numbers = compare(got, _readings(grads, changes))
    assert numbers["grad_diff"] == 0.0
    assert numbers["change_gap"] == numbers["change_diff"] == 0.0
    # The gradient's norm gap still counts it, against the median leaf.
    assert numbers["grad_gap"] == 0.0


def test_check_reads_an_update_of_the_wrong_sign():
    from portbench.check import compare

    grads = {"a": [1.0, -1.0], "b": [0.5, 0.5]}
    changes = {"a": [-1e-3, 1e-3], "b": [-1e-3, -1e-3]}
    flipped = {k: [-x for x in v] for k, v in changes.items()}
    numbers = compare(_readings(grads, flipped), _readings(grads, changes))
    assert numbers["change_gap"] == 0.0
    assert numbers["change_diff"] == pytest.approx(2.0)
