"""The readers of a window traced with the program's spans (``spans.py``)
on a synthetic trace: one step, its kernels with the host times of their
launches, and the host spans, in microseconds."""
import types

import pytest

from portbench import spans
from portbench.trace import Trace

KERNELS = [   # name, start, end, launch
    ("k_fwd", 0, 10, -1), ("k_dense", 10, 20, 9),
    ("row_owner_kernel", 30, 40, 26), ("k_other", 40, 45, 27),
    ("k_bw", 45, 50, 44),
    ("adam", 60, 70, 53), ("adam2", 65, 72, 54),
    ("tanh", 90, 95, 85), ("x", 100, 101, None),
]
HOST = [
    ("step", -5, 80), ("step.forward", -4, 21), ("gnn.layer", -3, 19),
    ("gnn.messages", -2, 8), ("step.backward", 21, 51),
    ("gnn.messages.backward", 25, 43), ("step.optimizer", 52, 75),
]


@pytest.fixture
def window():
    kernels = [spans.Kernel(*k) for k in KERNELS]
    return spans.SpanTrace(
        Trace(steps=1, window=(0.0, 101.0),
              device=[(k.name, k.start, k.end) for k in kernels]),
        kernels, [spans.HostSpan(n, s, e, {}) for n, s, e in HOST])


def test_optimizer_and_message_device_ms(window):
    # adam and adam2 overlap: their union, 60-72, counts once.
    assert spans.optimizer_device_ms(window) == pytest.approx(0.012)
    # k_fwd, row_owner_kernel and k_other: 10 + 10 + 5 us.
    assert spans.message_device_ms(window) == pytest.approx(0.025)


def test_a_window_without_the_spans_reads_nothing(window):
    window.spans = [s for s in window.spans if s.name == "step"]
    assert spans.optimizer_device_ms(window) is None
    assert spans.message_device_ms(window) is None


def test_device_by_span_names_the_innermost_span_at_the_launch(window):
    """k_dense was launched after gnn.messages closed, inside gnn.layer;
    tanh after the step; x's launch is unknown."""
    assert dict(spans.device_by_span(window)) == pytest.approx({
        "gnn.messages": 10e-6, "gnn.layer": 10e-6,
        "gnn.messages.backward": 15e-6, "step.backward": 5e-6,
        "step.optimizer": 17e-6, spans.OUTSIDE: 6e-6})


def test_kernels_by_span(window):
    assert spans.kernels_by_span(window, spans_count=2) == pytest.approx({
        "step.optimizer": [("adam", 0.010), ("adam2", 0.007)],
        "gnn.messages.backward": [("row_owner_kernel", 0.010),
                                  ("k_other", 0.005)]})


def test_idle_gaps_by_span_name_what_the_host_was_doing(window):
    assert spans.idle_gaps_by_span(window) == pytest.approx([
        ("step.optimizer", "before tanh", 18e-6),
        ("step.forward", "before row_owner_kernel", 10e-6),
        ("step.backward", "before adam", 10e-6),
        (spans.OUTSIDE, "before x", 5e-6)])


def test_clock_checks(window):
    assert spans.launch_lead_us(window) == 1
    assert spans.clock_skew_us(window) == {
        "gnn.layer": -3, "gnn.messages": -2, "gnn.messages.backward": -5,
        "step": -5, "step.backward": -9, "step.forward": -4,
        "step.optimizer": -8}
    assert spans.first_kernel_after_open_us(window, "step.optimizer") \
        == [8]
    window.kernels[5].launch = 61      # adam launched after it started
    assert spans.launch_lead_us(window) == -1


def test_coverage_and_the_backward_outside_the_messages(window):
    assert spans.coverage(window, "row_owner_kernel", spans.MESSAGES) == 1
    assert spans.coverage(window, "k_bw", spans.MESSAGES) == 0
    assert spans.coverage(window, "index_add", spans.MESSAGES) is None
    share, rest = spans.outside_share(window, "step.backward",
                                      ("gnn.messages.backward",))
    assert share == pytest.approx(0.25)
    assert rest == pytest.approx([("k_bw", 5e-6)])


def test_batch_plan_ms():
    records = [types.SimpleNamespace(name=n, start_ns=s, end_ns=e)
               for n, s, e in (("data.pack", 0, 5_000_000),
                               ("data.plan", 5_000_000, 8_000_000),
                               ("data.plan", 9_000_000, 14_000_000))]
    assert spans.batch_plan_ms(records) == pytest.approx(4.0)
    assert spans.batch_plan_ms(records[:1]) is None
