"""One cell's set-up and windows with the program's spans read, printed as
one JSON line on standard output:

    python3 portbench/span_window.py --workload <name> --seed <n> \
        --seconds <s>

from the root of a checkout, on a machine with an NVIDIA card. Set-up runs
with the program's tracing on (``batch_plan_ms``, and the host ms of
``data.pack`` and ``data.move``); then, with it off, the measured window
of ``--seconds`` and the 16 steps traced with the device alone that the
benchmark's readers read (``trace.py``); then, with it on, 16 more traced
steps (``spans.span_window``). The line holds both traced windows' host
and device ms a step (what tracing costs), the readings of ``spans.py``
on the second window, and the counter registry's counts a step there
(kernel launches, compact forms built).
"""
import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "portbench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / "build" / "portbench" / "triton"))
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "portbench" / "pycache")
sys.path[0] = str(ROOT)


def _mean_ms(records, name):
    times = [(r.end_ns - r.start_ns) / 1e6 for r in records
             if r.name == name]
    return statistics.fmean(times) if times else None


def _gap(st, start, end, ended):
    """Where a gap lies (ms from the window's start, the steps opened on
    the host by then) and the host's CUDA API calls during it."""
    from portbench import spans

    calls = spans.calls_in(st, start, end)
    return {"ms": (end - start) / 1e3,
            "at_ms": (start - st.trace.window[0]) / 1e3,
            "steps_opened": sum(s.name == "step" and s.start <= start
                                for s in st.spans),
            "ended": ended[:60],
            "calls_us": dict(sorted(calls.items(),
                                    key=lambda kv: -kv[1])[:5])}


def _leads(st):
    """How many kernels start before their launch, and the three that
    start earliest before it: (name, us, ms from the window's start)."""
    early = sorted((k for k in st.kernels
                    if k.launch is not None and k.start < k.launch),
                   key=lambda k: k.start - k.launch)
    return {"negative": len(early), "of": len(st.kernels),
            "worst": [(k.name[:50], k.start - k.launch,
                       (k.start - st.trace.window[0]) / 1e3)
                      for k in early[:3]]}


def _after_first_step(st):
    """``st`` without the window's first step: its spans and the kernels
    launched before the second ``step`` opened."""
    from portbench import spans

    starts = sorted(s.start for s in st.spans if s.name == "step")
    cut = starts[1]
    return spans.SpanTrace(st.trace,
                           [k for k in st.kernels
                            if k.launch is not None and k.launch >= cut],
                           [s for s in st.spans if s.start >= cut], st.calls)


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import spans
    from portbench.harness import (
        TRACED_STEPS,
        Session,
        load_cell,
        measured_window,
        power_limit,
    )
    from portbench.trace import traced_window
    from tf2_gnn_tpu_torch.utils import tracing

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_window.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)

    tracing.drain()
    with tracing.enabled():
        session = Session(cell, args.seed, device)
    setup = tracing.drain()
    setup_s = time.perf_counter() - T0
    window = measured_window(session, args.seconds)

    host_s = []

    def run() -> int:
        """The traced steps, as ``harness.traced`` runs them; their host
        seconds (dispatch, without the closing synchronise) kept."""
        start = time.perf_counter()
        for _ in range(TRACED_STEPS):
            session.step(session.steps_done)
            session.steps_done += 1
        host_s.append(time.perf_counter() - start)
        return TRACED_STEPS

    first = traced_window(run, device)
    tracing.reset()
    second = spans.span_window(run, device)
    first_host_ms, second_host_ms = (s * 1e3 / TRACED_STEPS for s in host_s)
    steps = second.trace.steps
    later = _after_first_step(second)
    per_step = {k: v / steps for k, v in tracing.counters().items() if v}
    step_ms = [s.end - s.start for s in second.spans if s.name == "step"]
    fused = cell.config["task_params"].get("use_pair_spmm", False)
    aggregation = "row_owner_kernel" if fused else "indexFunc"
    backward_outside, backward_rest = spans.outside_share(
        second, "step.backward", ("gnn.messages.backward",))
    result = {
        "workload": args.workload, "seed": args.seed,
        "card": power_limit(), "setup_s": setup_s,
        "graphs_per_s": window["graphs"] / window["window_s"],
        "batch_plan_ms": spans.batch_plan_ms(setup),
        "batch_pack_ms": _mean_ms(setup, "data.pack"),
        "batch_move_ms": _mean_ms(setup, "data.move"),
        "batch_prep_ms": statistics.fmean(session.prep_ms),
        "first": {"host_ms": first_host_ms,
                  "window_ms": first.window_s * 1e3 / first.steps,
                  "busy_ms": first.busy_s * 1e3 / first.steps,
                  "idle_pct": 100 * (1 - first.busy_s / first.window_s)},
        "second": {"host_ms": second_host_ms,
                   "window_ms": second.trace.window_s * 1e3 / steps,
                   "busy_ms": second.trace.busy_s * 1e3 / steps,
                   "idle_pct": 100 * (1 - second.trace.busy_s
                                      / second.trace.window_s),
                   "step_span_ms": statistics.fmean(step_ms) / 1e3},
        "optimizer_device_ms": spans.optimizer_device_ms(second),
        "message_device_ms": spans.message_device_ms(second),
        "message_coverage": spans.coverage(second, aggregation,
                                           spans.MESSAGES),
        "backward_outside_share": backward_outside,
        "backward_outside_kernels": backward_rest,
        "launch_known_share": (sum(k.launch is not None
                                   for k in second.kernels)
                               / len(second.kernels)),
        "launch_lead_us": spans.launch_lead_us(second),
        "launch_leads": _leads(second),
        "clock_skew_us": spans.clock_skew_us(second),
        "after_first_step": {
            "launch_lead_us": spans.launch_lead_us(later),
            "clock_skew_us": spans.clock_skew_us(later)},
        "kernels_by_span": spans.kernels_by_span(second),
        "optimizer_first_kernel_after_open_us":
            spans.first_kernel_after_open_us(second, "step.optimizer"),
        "counters_per_step": per_step,
        "host_spans": len(second.spans),
        "spans_without_parent": sorted({s.name for s in second.spans
                                        if s.parent is None}),
        "device_by_span": spans.device_by_span(second),
        "idle_gaps_by_span": spans.idle_gaps_by_span(second),
        "longest_gaps": [_gap(second, *gap)
                         for gap in spans.idle_gaps(second)[:3]],
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
