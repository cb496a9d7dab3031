"""A traced window of training steps under ``torch.profiler`` and what the
per-layer readers take from it: device intervals by kernel name, the
window's span, the union of device activity, and the longest idle gaps,
each named by the device operation that ended it (the operation the
host was launching while the device waited).

All times are the profiler's microseconds.
"""
import dataclasses
from typing import Callable, List, Tuple

WINDOW_LABEL = "portbench.window"


@dataclasses.dataclass
class Trace:
    steps: int
    window: Tuple[float, float]                # us
    device: List[Tuple[str, float, float]]     # (name, start, end) us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def clipped(self):
        lo, hi = self.window
        for name, start, end in self.device:
            start, end = max(start, lo), min(end, hi)
            if end > start:
                yield name, start, end

    def busy_intervals(self) -> List[Tuple[float, float, str]]:
        """The union of device activity inside the window, merged: (start,
        end, the name of the operation that opened the interval)."""
        spans = sorted((s, e, n) for n, s, e in self.clipped())
        merged: List[list] = []
        for start, end, name in spans:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end, name])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e, _ in self.busy_intervals()) / 1e6

    def device_ms_per_step(self, matches: Callable[[str], bool]) -> float:
        """Device ms a step in the kernels whose names ``matches`` (summed
        durations, overlaps counted once per kernel)."""
        total = sum(e - s for n, s, e in self.clipped() if matches(n))
        return total / 1e3 / self.steps

    def idle_gaps(self, count: int = 10) -> List[Tuple[str, float]]:
        """The ``count`` longest idle gaps of the device inside the window,
        each named by the device operation that ended it."""
        lo, hi = self.window
        gaps, cursor = [], lo
        for start, end, name in self.busy_intervals():
            if start > cursor:
                gaps.append((f"before {name[:100]}", start - cursor))
            cursor = max(cursor, end)
        if hi > cursor:
            gaps.append(("end of the window", hi - cursor))
        gaps.sort(key=lambda g: -g[1])
        return [(name, us / 1e6) for name, us in gaps[:count]]

    def device_ops(self, count: int = 10) -> List[Tuple[str, float]]:
        totals = {}
        for name, start, end in self.clipped():
            key = name[:120]
            totals[key] = totals.get(key, 0.0) + (end - start) / 1e6
        return sorted(totals.items(), key=lambda kv: -kv[1])[:count]


def traced_window(run_steps: Callable[[], int], device) -> Trace:
    """Profile ``run_steps`` (which runs the steps and returns how many)
    with the device's activity alone: recording the host's operations too
    slows a host-paced step by a half. The window runs from its first
    device operation to the end of its last."""
    if device.type != "cuda":
        # No device to trace: the window's host time, nothing on a device.
        import time

        start = time.perf_counter()
        steps = run_steps()
        return Trace(steps=steps,
                     window=(0.0, (time.perf_counter() - start) * 1e6),
                     device=[])
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_LABEL):
            steps = run_steps()
            torch.cuda.synchronize(device)
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not (getattr(e, "is_user_annotation", False)
                       or e.name == WINDOW_LABEL)]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    window = (min(s for _, s, _ in events), max(e for _, _, e in events))
    return Trace(steps=steps, window=window, device=events)
