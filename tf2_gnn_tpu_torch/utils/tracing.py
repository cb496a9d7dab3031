"""The port's spans and counters, on the profiler's clock.

**Spans.** ``span(name, **attrs)`` is a context manager around one piece
of the port's work (a train step, its optimizer update, a GNN layer, the
planning of a batch). ``begin`` opens one that a later call closes with
its ``close()`` (the backward brackets of ``backward_bracket``). Tracing
is off by default: ``span`` and ``begin`` then return one shared no-op
after a single flag check, read no clock and open no profiler range.
``enabled()`` (or ``set_enabled``) switches it on. While on, each span

* takes its host times from ``time.time_ns()``, the clock the profiler's
  event times are on (Kineto's ``start_ns()`` is Unix-epoch nanoseconds;
  ``torch.profiler.profile(...).profiler.kineto_results.trace_start_ns()``
  is the trace's origin on it), so host spans and device kernels share
  one axis;
* opens ``torch.profiler.record_function(name)``, which gives it a range
  in a profile that records the host's activity (``--profile-dir``'s),
  and there a device range over the kernels it launched. A profile of
  the device alone has no such ranges, but it records the CUDA API call
  that launched each kernel, on the same clock, so a reader places each
  kernel in the spans open at its launch (``portbench/spans.py``);
* records its parent (the innermost span open on its thread; a span that
  autograd's backward thread opens with nothing open there takes the
  innermost span of the thread that runs the step), its thread, and the
  step id of the ``step`` span open at the time.

The records (``SpanRecord``) are kept in memory, at most ``MAX_SPANS``
(later ones are dropped and counted under ``span.dropped``), and read
with ``drain()``.

**Counters.** One registry: ``count(name, n)`` adds to a counter of its
own (``compact.build.<plan>.<direction>``, a plan's compact form built;
``typed_linear.shared_input``, a forward of ``TypedLinear``'s all-types
form, which writes the [L, V, H] tables without transposed copies;
``pair_tables.rows_computed`` and ``pair_tables.rows_full``, at every
pair-joint layer's forward the table rows its products computed (only
those its plan reads, or all) and the ``L * v_src`` rows of the full
tables; ``rgat.route.<route>``, an RGAT layer's forward by the route it took;
``segment.sum.ordered``, a segment sum over a ``SegmentOrder``, as the
unfused path's sums over edges run, and ``segment.sum.scatter``, one by
``index_add_``; ``segment.order.build``, an order built, once a batch and
edge array in steady state), and
the kernel modules' launch counts, the native planners' counts and
the collectives' counts are read from the stores their modules keep
(``STORES``: ``launch.*``, ``planned.*``, ``collective.<name>.calls`` /
``.bytes``). ``counters()`` is a snapshot of all of them, ``reset()``
sets every one to 0.
"""
import collections
import contextlib
import dataclasses
import importlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

MAX_SPANS = 1 << 18

# The counter stores the registry reads: (namespace, module, attribute).
# Each module keeps its store bound to the same object; the registry
# reads and zeroes it in place.
STORES = (
    ("launch", "tf2_gnn_tpu_torch.ops.pair_spmm", "LAUNCHES"),
    ("launch", "tf2_gnn_tpu_torch.ops.pair_attention", "LAUNCHES"),
    ("launch", "tf2_gnn_tpu_torch.ops.pair_edge_mlp", "LAUNCHES"),
    ("launch", "tf2_gnn_tpu_torch.ops.sorted_spmm", "LAUNCHES"),
    ("launch", "tf2_gnn_tpu_torch.ops.probes", "LAUNCHES"),
    ("planned", "tf2_gnn_tpu_torch.native", "PLANNED"),
    ("collective", "tf2_gnn_tpu_torch.parallel.collectives", "COUNTS"),
)

_on = False
_COUNTS: "collections.Counter[str]" = collections.Counter()
_records: List["SpanRecord"] = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
# The open ``step`` span and the span stack of the thread that runs it.
_step_span: Optional["_Span"] = None
_step_stack: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    id: int
    name: str
    start_ns: int              # time.time_ns(), the profiler's clock
    end_ns: int
    parent: Optional[int]      # the enclosing span's id
    thread: int                # threading.get_ident()
    step: Optional[int]        # the open ``step`` span's step id
    attrs: Dict[str, Any]


class _NoSpan:
    """What ``span`` and ``begin`` return while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass

    def close(self) -> None:
        pass


_OFF = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("id", "name", "attrs", "start_ns", "parent", "step",
                 "_stack", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def open(self) -> "_Span":
        global _step_span, _step_stack
        stack = _stack()
        outer = stack[-1] if stack else None
        if (outer is None and _step_stack
                and torch._C._current_autograd_node() is not None):
            # Autograd's own thread, working for the open step.
            outer = _step_stack[-1]
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        if self.name == "step":
            self.step = self.attrs.get("step")
            _step_span, _step_stack = self, stack
        else:
            self.step = None if outer is None else outer.step
        self._stack = stack
        stack.append(self)
        self.start_ns = time.time_ns()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def close(self) -> None:
        global _step_span, _step_stack
        self._range.__exit__(None, None, None)
        end_ns = time.time_ns()
        stack = self._stack
        # Normally the top; a bracket closed by a hook may sit lower.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        if _step_span is self:
            _step_span = _step_stack = None
        record = SpanRecord(self.id, self.name, self.start_ns, end_ns,
                            self.parent, threading.get_ident(), self.step,
                            self.attrs)
        with _lock:
            if len(_records) < MAX_SPANS:
                _records.append(record)
            else:
                _COUNTS["span.dropped"] += 1

    def note(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def span(name: str, **attrs):
    """A context manager recording ``name`` around its body while tracing
    is on; the shared no-op while it is off."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def begin(name: str, **attrs):
    """An open span that the caller ends with ``close()``; the shared
    no-op while tracing is off."""
    if not _on:
        return _OFF
    return _Span(name, attrs).open()


def backward_bracket(output: torch.Tensor, inputs: torch.Tensor,
                     name: str, **attrs) -> None:
    """Record ``name`` over the backward of the work from ``inputs`` to
    ``output``: it opens when ``output``'s gradient arrives and closes
    once ``inputs``' gradient is whole. The hooks return nothing, so no
    gradient changes. Does nothing while tracing is off or where either
    tensor takes no gradient."""
    if not (_on and output.requires_grad and inputs.requires_grad):
        return
    opened = []

    def open_hook(grad):
        opened.append(begin(name, **attrs))

    def close_hook(grad):
        while opened:
            opened.pop().close()

    output.register_hook(open_hook)
    inputs.register_hook(close_hook)


def is_enabled() -> bool:
    return _on


def set_enabled(on: bool) -> bool:
    """Switch tracing on or off; returns the previous setting."""
    global _on
    previous, _on = _on, bool(on)
    return previous


@contextlib.contextmanager
def enabled(on: bool = True):
    """Tracing switched to ``on`` for the body, then back."""
    previous = set_enabled(on)
    try:
        yield
    finally:
        set_enabled(previous)


def drain() -> List[SpanRecord]:
    """The recorded spans, in the order they closed; the store is left
    empty."""
    global _records
    with _lock:
        records, _records = _records, []
    return records


# ---------------------------------------------------------------------------
# Counters

def count(name: str, n: int = 1) -> None:
    with _lock:
        _COUNTS[name] += n


def _stores():
    for namespace, module, attribute in STORES:
        yield namespace, getattr(importlib.import_module(module), attribute)


def _flatten(prefix: str, store, out: Dict[str, int]) -> None:
    for key, value in store.items():
        if isinstance(value, dict):
            _flatten(f"{prefix}.{key}", value, out)
        else:
            out[f"{prefix}.{key}"] = value


def counters(namespace: Optional[str] = None) -> Dict[str, int]:
    """A snapshot of every counter by its dotted name; with ``namespace``
    (``"launch"``, ``"compact.build"``, ...) those under it, by the rest of
    the name."""
    out: Dict[str, int] = {}
    for prefix, store in _stores():
        _flatten(prefix, store, out)
    out.update(_COUNTS)
    if namespace is None:
        return out
    head = namespace + "."
    return {k[len(head):]: v for k, v in out.items() if k.startswith(head)}


def _zero(store) -> None:
    for key, value in store.items():
        if isinstance(value, dict):
            _zero(value)
        else:
            store[key] = 0


def reset() -> None:
    """Every counter to 0."""
    for _, store in _stores():
        _zero(store)
    _COUNTS.clear()
