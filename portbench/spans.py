"""A traced window with the program's own spans on, and what it shows.

The program (``tf2_gnn_tpu_torch/utils/tracing.py``) records its spans on
the profiler's clock. A profile of the device alone records each kernel
and, on the host, the CUDA runtime call that launched it (the two share a
correlation id), but no range of a ``record_function``. ``span_window``
profiles steps with the program's tracing on and returns the kernels, each
with the host time of its launch, and the program's host spans, all in the
profiler's microseconds. A kernel belongs to every span open on the host
when it was launched, and its owner is the innermost of them (of the spans
open then, the one opened last, whatever its thread: autograd's backward
thread opens its spans while the step's thread waits in
``step.backward``). The functions below read it:

* ``optimizer_device_ms`` and ``message_device_ms``: device ms a step of
  the kernels launched inside ``step.optimizer``, and inside
  ``gnn.messages`` or ``gnn.messages.backward`` (their union, so
  overlapping kernels count once);
* ``device_by_span``: device seconds by owner;
* ``idle_gaps_by_span``: the longest idle gaps of the device, each named by
  the innermost span open on the host when the device went idle
  (``OUTSIDE`` where none was) and by the operation that ended it;
* ``launch_lead_us``, ``clock_skew_us``, ``first_kernel_after_open_us``,
  ``coverage`` and ``outside_share``: the checks that the host spans and
  the device share one clock, that the message spans hold the
  aggregation kernels, and what of ``step.backward`` lies outside
  ``gnn.messages.backward``;
* ``batch_plan_ms``: mean host ms a batch spends in ``data.plan``.
"""
import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .trace import WINDOW_LABEL, Trace

OUTSIDE = "outside the program"
OPTIMIZER = ("step.optimizer",)
MESSAGES = ("gnn.messages", "gnn.messages.backward")


@dataclasses.dataclass
class HostSpan:
    name: str
    start: float        # us on the profiler's axis
    end: float
    attrs: Dict
    parent: Optional[int] = None    # the enclosing span's ``id``
    id: Optional[int] = None


@dataclasses.dataclass
class Kernel:
    name: str
    start: float        # us
    end: float
    launch: Optional[float]   # host us of its launch; None where unknown


@dataclasses.dataclass
class SpanTrace:
    trace: Trace                  # the kernels, for busy and idle time
    kernels: List[Kernel]         # inside the window
    spans: List[HostSpan]         # the program's host spans
    calls: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)     # the host's CUDA API calls, us


def _merge(intervals) -> List[Tuple[float, float]]:
    merged: List[list] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def _union_us(intervals) -> float:
    return sum(e - s for s, e in _merge(intervals))


class _OpenSpans:
    """The innermost host span open at a time: of the spans open then, the
    one opened last."""

    def __init__(self, spans: Sequence[HostSpan]):
        self.spans = sorted(spans, key=lambda s: s.start)
        self.starts = [s.start for s in self.spans]

    def innermost(self, t: float) -> Optional[HostSpan]:
        for s in reversed(self.spans[:bisect.bisect_right(self.starts, t)]):
            if t < s.end:
                return s
        return None


def _launched_in(st: SpanTrace, names: Sequence[str]) -> List[Kernel]:
    """The kernels launched while a span named in ``names`` was open."""
    inside = _merge((s.start, s.end) for s in st.spans if s.name in names)
    starts = [lo for lo, _ in inside]
    out = []
    for k in st.kernels:
        if k.launch is None:
            continue
        i = bisect.bisect_right(starts, k.launch) - 1
        if i >= 0 and k.launch < inside[i][1]:
            out.append(k)
    return out


def device_ms_in(st: SpanTrace, names: Sequence[str]) -> float:
    """Device ms a step of the kernels launched inside the spans
    ``names`` (the union of their intervals)."""
    kernels = _launched_in(st, names)
    return _union_us((k.start, k.end) for k in kernels) / 1e3 / st.trace.steps


def optimizer_device_ms(st: SpanTrace) -> Optional[float]:
    ms = device_ms_in(st, OPTIMIZER)
    return ms if ms > 0 else None


def message_device_ms(st: SpanTrace) -> Optional[float]:
    ms = device_ms_in(st, MESSAGES)
    return ms if ms > 0 else None


def device_by_span(st: SpanTrace, count: int = 10
                   ) -> List[Tuple[str, float]]:
    """Device seconds of the window's kernels by owner (the innermost span
    open at the launch), the ``count`` largest."""
    open_spans = _OpenSpans(st.spans)
    totals: Dict[str, float] = {}
    for k in st.kernels:
        owner = None if k.launch is None else open_spans.innermost(k.launch)
        key = OUTSIDE if owner is None else owner.name
        totals[key] = totals.get(key, 0.0) + (k.end - k.start) / 1e6
    return sorted(totals.items(), key=lambda kv: -kv[1])[:count]


def kernels_by_span(st: SpanTrace, spans_count: int = 6,
                    kernels_count: int = 4
                    ) -> Dict[str, List[Tuple[str, float]]]:
    """Device ms a step of the largest kernels (by name) of each of the
    ``spans_count`` largest owners."""
    open_spans = _OpenSpans(st.spans)
    table: Dict[str, Dict[str, float]] = {}
    for k in st.kernels:
        owner = None if k.launch is None else open_spans.innermost(k.launch)
        names = table.setdefault(OUTSIDE if owner is None else owner.name,
                                 {})
        names[k.name[:110]] = (names.get(k.name[:110], 0.0)
                               + (k.end - k.start) / 1e3 / st.trace.steps)
    ranked = sorted(table.items(), key=lambda kv: -sum(kv[1].values()))
    return {owner: sorted(names.items(), key=lambda kv: -kv[1])
            [:kernels_count]
            for owner, names in ranked[:spans_count]}


def idle_gaps(st: SpanTrace) -> List[Tuple[float, float, str]]:
    """The device's idle gaps in the window, longest first: (start us, end
    us, the device operation that ended it)."""
    lo, hi = st.trace.window
    gaps, cursor = [], lo
    for start, end, name in st.trace.busy_intervals():
        if start > cursor:
            gaps.append((cursor, start, f"before {name[:100]}"))
        cursor = max(cursor, end)
    if hi > cursor:
        gaps.append((cursor, hi, "end of the window"))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def idle_gaps_by_span(st: SpanTrace, count: int = 10
                      ) -> List[Tuple[str, str, float]]:
    """The ``count`` longest idle gaps of the device in the window: (the
    innermost host span open when the device went idle, the device
    operation that ended the gap, seconds)."""
    open_spans = _OpenSpans(st.spans)
    out = []
    for start, end, ended in idle_gaps(st)[:count]:
        owner = open_spans.innermost(start)
        out.append((OUTSIDE if owner is None else owner.name, ended,
                    (end - start) / 1e6))
    return out


def calls_in(st: SpanTrace, lo: float, hi: float) -> Dict[str, float]:
    """Host us by CUDA API call name of the calls that overlap [lo, hi]."""
    out: Dict[str, float] = {}
    for name, start, end in st.calls:
        if start < hi and end > lo:
            out[name] = out.get(name, 0.0) + (end - start)
    return out


def launch_lead_us(st: SpanTrace) -> Optional[float]:
    """The least time from a kernel's launch on the host to its start on
    the device (negative: a kernel started before its launch, so the two
    clocks disagree by at least that much)."""
    leads = [k.start - k.launch for k in st.kernels if k.launch is not None]
    return min(leads) if leads else None


def _first_kernels(st: SpanTrace, name: str):
    """For each span ``name`` that launched a kernel: (the span, the start
    of the first kernel launched inside it)."""
    kernels = sorted((k for k in st.kernels if k.launch is not None),
                     key=lambda k: k.launch)
    launches = [k.launch for k in kernels]
    out = []
    for span in st.spans:
        if span.name != name:
            continue
        lo = bisect.bisect_left(launches, span.start)
        hi = bisect.bisect_left(launches, span.end)
        if hi > lo:
            out.append((span, min(k.start for k in kernels[lo:hi])))
    return out


def clock_skew_us(st: SpanTrace) -> Dict[str, float]:
    """By span name, the most by which a span's device range (from the
    start of the first kernel launched inside it) starts before the span
    opened on the host; negative where every range starts after."""
    out = {}
    for name in sorted({s.name for s in st.spans}):
        pairs = _first_kernels(st, name)
        if pairs:
            out[name] = max(span.start - first for span, first in pairs)
    return out


def first_kernel_after_open_us(st: SpanTrace, name: str) -> List[float]:
    """For each span ``name``, us from its opening on the host to the start
    of the first kernel launched inside it."""
    return [first - span.start for span, first in _first_kernels(st, name)]


def coverage(st: SpanTrace, kernel: str,
             names: Sequence[str]) -> Optional[float]:
    """The share of the device time of the kernels whose name holds
    ``kernel`` that were launched inside the spans ``names``; None where
    no such kernel ran."""
    total = sum(k.end - k.start for k in st.kernels if kernel in k.name)
    inside = sum(k.end - k.start for k in _launched_in(st, names)
                 if kernel in k.name)
    return inside / total if total else None


def outside_share(st: SpanTrace, outer: str, inner: Sequence[str],
                  count: int = 5):
    """(the share of the device time of the kernels launched inside
    ``outer`` that were launched outside every span ``inner``, the
    ``count`` largest of those kernels by name with their seconds)."""
    in_outer = _launched_in(st, (outer,))
    in_inner = {id(k) for k in _launched_in(st, inner)}
    total = sum(k.end - k.start for k in in_outer)
    if not total:
        return None, []
    names: Dict[str, float] = {}
    for k in in_outer:
        if id(k) not in in_inner:
            key = k.name[:80]
            names[key] = names.get(key, 0.0) + (k.end - k.start) / 1e6
    top = sorted(names.items(), key=lambda kv: -kv[1])
    return sum(v for _, v in top) * 1e6 / total, top[:count]


def batch_plan_ms(records) -> Optional[float]:
    """Mean host ms a batch spends inside ``data.plan``, over the batches
    that ``records`` (``tracing.drain()``'s) planned."""
    plans = [r for r in records if r.name == "data.plan"]
    if not plans:
        return None
    return sum(r.end_ns - r.start_ns for r in plans) / len(plans) / 1e6


def span_window(run_steps: Callable[[], int], device) -> SpanTrace:
    """Profile ``run_steps`` (which runs the steps and returns how many)
    with the device's activity alone and the program's tracing on: the
    kernels with their launches, and the program's host spans, on the
    profiler's axis."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tf2_gnn_tpu_torch.utils import tracing

    torch.cuda.synchronize(device)
    tracing.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_LABEL), tracing.enabled():
            steps = run_steps()
            torch.cuda.synchronize(device)
    records = tracing.drain()
    results = prof.profiler.kineto_results
    origin = results.trace_start_ns()
    launch_ns, device, calls = {}, [], []
    for e in results.events():
        if (getattr(e, "is_user_annotation", lambda: False)()
                or e.name() == WINDOW_LABEL):
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
            continue
        # With the device's activity alone, a CUDA API call; a launch's
        # lazy module loading shares its correlation id and starts later.
        calls.append(e)
        cid = e.correlation_id()
        launch_ns[cid] = min(launch_ns.get(cid, e.start_ns()), e.start_ns())
    if not device:
        raise RuntimeError("the profiler recorded no device activity")

    def us(ns):
        return (ns - origin) / 1e3

    def launch(e):
        ns = launch_ns.get(e.correlation_id(),
                           launch_ns.get(e.linked_correlation_id()))
        return None if ns is None else us(ns)

    kernels = [Kernel(e.name(), us(e.start_ns()), us(e.end_ns()), launch(e))
               for e in device]
    window = (min(k.start for k in kernels), max(k.end for k in kernels))
    spans = [HostSpan(r.name, us(r.start_ns), us(r.end_ns), dict(r.attrs),
                      r.parent, r.id)
             for r in records]
    return SpanTrace(
        Trace(steps=steps, window=window,
              device=[(k.name, k.start, k.end) for k in kernels]),
        kernels, spans,
        [(e.name(), us(e.start_ns()), us(e.end_ns())) for e in calls])
