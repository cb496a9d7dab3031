"""One run of one benchmark cell: set-up, the measured window, the traced
window (``--trace 1``), the check against the plain reference, the result.

A cell (``BENCHMARK.json``'s ``workloads`` entry) joins a configuration
(``portbench/configs/<config>.json``) and a traffic file
(``portbench/traffic/<traffic>.json``); its limits are
``portbench/limits/<cell>.json``, its reference
``portbench/reference/<config["reference"]>.py`` and each per-layer metric
a reader ``portbench/metrics/<metric>.py``, all found by name.

Set-up draws the traffic from the seed, has the port's data layer pack,
pad, plan and move every batch, makes the weights on the device, builds
the training state and runs its first steps through ``make_train_step``'s
step: the first three are read for the check (losses, the first gradient
from the optimizer's state, each leaf's change after three steps), the
rest warm every batch up. The window then dispatches steps back to back,
cycling over the batches, and records a CUDA event after each; it ends
with a synchronise after the first step dispatched past ``--seconds``.
Once it has closed and the peak memory is read, the program is freed and
the reference runs the first three steps again.
"""
import dataclasses
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tf2_gnn_tpu")
CHECKED_STEPS = 3
TRACED_STEPS = 16
WEIGHTS_STREAM = 1 << 20
DROPOUT_STREAM = WEIGHTS_STREAM + 1


def forbidden_modules(names) -> List[str]:
    """The module names whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN`` as a whole."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def reference(self):
        return importlib.import_module(
            f"portbench.reference.{self.config['reference']}")


def _applies(entry: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    from .check import load_limits

    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in manifest["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(entries)}")
    entry = entries[workload]
    bench = root / "portbench"
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=json.loads((bench / "configs" / f"{entry['config']}.json")
                          .read_text()),
        traffic=json.loads((bench / "traffic" / f"{entry['traffic']}.json")
                           .read_text()),
        limits=load_limits(bench, workload),
        end_to_end=[m for m in manifest["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"]
                   if _applies(m, workload)])


def load_reader(name: str, bench: Path = BENCH_DIR) -> Callable:
    from portbench import load_module

    return load_module(bench / "metrics" / f"{name}.py",
                       f"portbench_metric_{name.replace('.', '_')}").read


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """The system under test after set-up, and what set-up read."""

    def __init__(self, cell: Cell, seed: int, device):
        from . import system
        from .generator import derive_seed, generate

        self.cell, self.device = cell, device
        marks = [("start", time.perf_counter())]
        self.draws = generate(cell.traffic, seed)
        marks.append(("draws", time.perf_counter()))
        self.batches, self.prep_ms = system.prepare_batches(
            cell.config, self.draws, device)
        marks.append(("batches", time.perf_counter()))
        shapes = system.parameter_shapes(cell.config, self.draws)
        self.weights = system.initial_weights(
            shapes, derive_seed(seed, WEIGHTS_STREAM, bits=63), device)
        self.dropout_seed = derive_seed(seed, DROPOUT_STREAM, bits=63)
        self.state, self.train_step = system.build_training(
            cell.config, self.draws, self.weights, self.dropout_seed, device)
        self.graphs_per_step = [d.num_graphs for d in self.draws]
        marks.append(("model", time.perf_counter()))
        losses, grads = [], None
        for k in range(CHECKED_STEPS):
            metrics = self.step(k)
            losses.append(metrics["loss"])
            if k == 0:
                grads = system.first_gradients(self.state)
                _sync(device)
                marks.append(("first step", time.perf_counter()))
        changes = system.changes(self.state, self.weights)
        for k in range(CHECKED_STEPS, len(self.batches)):
            self.step(k)
        _sync(device)
        marks.append(("warm-up", time.perf_counter()))
        self.phases = {name: round(b - a, 4) for (_, a), (name, b)
                       in zip(marks, marks[1:])}
        self.readings = {"losses": [float(x) for x in losses],
                         "grads": grads, "changes": changes}
        self.steps_done = len(self.batches)

    def step(self, k: int):
        batch, labels = self.batches[k % len(self.batches)]
        self.state, metrics = self.train_step(self.state, batch, labels)
        return metrics

    def free(self) -> None:
        """Drop the program's state; the draws and weights stay."""
        self.state = self.train_step = self.batches = None
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()


def measured_window(session: Session, seconds: float) -> Dict[str, Any]:
    """Steps back to back for ``seconds``: the steps, the window's seconds
    (first dispatch to the synchronise after the last step), the gaps
    between consecutive step completions (CUDA events; host clock on the
    CPU), the mean host ms of a ``train_step`` call and the losses."""
    import torch

    device = session.device
    cuda = device.type == "cuda"
    events, losses, dispatch = [], [], 0.0
    _sync(device)
    if cuda:
        start_event = torch.cuda.Event(enable_timing=True)
        start_event.record()
    host_marks = []
    collections = [g["collections"] for g in gc.get_stats()]
    start = time.perf_counter()
    k = session.steps_done
    while True:
        t = time.perf_counter()
        metrics = session.step(k)
        dispatch += time.perf_counter() - t
        losses.append(metrics["loss"])
        if cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append(event)
        else:
            host_marks.append(time.perf_counter())
        k += 1
        if time.perf_counter() - start >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - start
    steps = k - session.steps_done
    if cuda:
        marks = [start_event] + events
        gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks = [start] + host_marks
        gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    graphs = sum(session.graphs_per_step[i % len(session.graphs_per_step)]
                 for i in range(session.steps_done, k))
    session.steps_done = k
    collections = [g["collections"] - c
                   for g, c in zip(gc.get_stats(), collections)]
    loss_values = torch.stack(losses).float().cpu()
    return {"steps": steps, "graphs": graphs, "window_s": window_s,
            "gaps_ms": gaps, "dispatch_ms": dispatch / steps * 1e3,
            "losses": loss_values, "gc": collections}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linearly interpolated between ranks."""
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def end_to_end_value(name: str, window: Dict[str, Any], setup_s: float):
    if name == "train_graphs_per_s":
        return window["graphs"] / window["window_s"]
    if name == "train_step_p95_ms":
        return percentile(window["gaps_ms"], 95.0)
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r} in this harness")


def traced(session: Session):
    from .trace import traced_window

    def run() -> int:
        for _ in range(TRACED_STEPS):
            session.step(session.steps_done)
            session.steps_done += 1
        return TRACED_STEPS

    return traced_window(run, session.device)


def device_description(device) -> Dict[str, Any]:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_peaks(kind: str) -> Dict[str, float]:
    """``peaks.json``'s rates for the card named ``kind`` (empty where the
    table has none)."""
    for name, peaks in json.loads((BENCH_DIR / "peaks.json")
                                  .read_text()).items():
        if name in kind:
            return peaks
    return {}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"


def drift(gaps: List[float]) -> str:
    """Median step gap of the window's first and last tenth."""
    tenth = max(len(gaps) // 10, 1)
    return (f"first tenth {statistics.median(gaps[:tenth]):.4f} ms, last "
            f"tenth {statistics.median(gaps[-tenth:]):.4f} ms "
            f"({len(gaps)} steps)")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, log: Callable[[str], None]) -> Dict[str, Any]:
    """One run; returns the result object (``check`` last)."""
    import torch

    from .check import compare, judge

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    session = Session(cell, seed, device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: {started - t0:.3f} s to the session, "
        f"then s by phase {session.phases}; batch prep ms "
        f"{[round(x, 2) for x in session.prep_ms]}")
    window = measured_window(session, seconds)
    gaps = window["gaps_ms"]
    log(f"window {window['steps']} steps in {window['window_s']:.4f} s; "
        f"step gaps {drift(gaps)}; gap ms p50/p90/p95/p99/max "
        + "/".join(f"{percentile(gaps, q):.3f}" for q in (50, 90, 95, 99,
                                                           100))
        + f"; gc collections {window['gc']}; window loss mean "
        f"{float(window['losses'].mean()):.6f}")
    trace_data = traced(session) if trace else None
    device_info = device_description(device)
    session.free()

    reference = cell.reference
    ref_readings = reference.train_readings(
        cell.config, session.draws[:CHECKED_STEPS], session.weights,
        session.dropout_seed, device)
    numbers = compare(session.readings, ref_readings)
    check, correct = judge(numbers, cell.limits)
    nonfinite = int((~torch.isfinite(window["losses"])).sum())

    if trace:
        ctx = SimpleNamespace(
            cell=cell, window=window, prep_ms=session.prep_ms,
            trace=trace_data,
            flops_per_step=statistics.fmean(
                reference.model_flops(cell.config, d) for d in session.draws),
            aggregation_bytes_per_step=statistics.fmean(
                reference.aggregation_bytes(cell.config, d)
                for d in session.draws),
            aggregation_flops_per_step=statistics.fmean(
                reference.aggregation_flops(cell.config, d)
                for d in session.draws),
            peak=card_peaks(device_info["kind"]).get)
        metrics = {}
        for entry in cell.per_layer:
            value = load_reader(entry["name"])(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        device_info["busy_s"] = trace_data.busy_s
        device_info["window_s"] = trace_data.window_s
        traced_ms = trace_data.window_s * 1e3 / trace_data.steps
        log(f"traced window {trace_data.steps} steps, {traced_ms:.4f} ms a "
            f"step against the measured window's "
            f"{window['window_s'] * 1e3 / window['steps']:.4f}")
        breakdown = {"device_ops": [list(x) for x in trace_data.device_ops()],
                     "idle_gaps": [list(x) for x in trace_data.idle_gaps()]}
    else:
        metrics = {m["name"]: {"value": end_to_end_value(m["name"], window,
                                                         setup_s),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
        breakdown = None
    if device.type == "cuda":
        log(f"card: {power_limit()}")
    log("losses: program " + json.dumps(session.readings["losses"])
        + " reference " + json.dumps(ref_readings["losses"]))
    result = {"correct": correct, "attempted": window["steps"],
              "failed": nonfinite, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result


def emit(result: Dict[str, Any], log: Callable[[str], None]) -> int:
    """Print the result as the last line of standard output, after the
    compared numbers on standard error; print nothing and return 3 where a
    module of JAX or the JAX package is loaded."""
    leaked = forbidden_modules(sys.modules)
    if leaked:
        log("modules of JAX or the JAX package are loaded: "
            + ", ".join(leaked))
        return 3
    for name, entry in result["check"].items():
        log(f"check {name} {entry['value']!r} limit {entry['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None
         ) -> int:
    import argparse

    import torch

    t0 = time.perf_counter() if t0 is None else t0
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    cell = load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"cuda available: {torch.cuda.is_available()}, cards: "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t0, log)
    return emit(result, log)
