"""Host spans of the benchmark's own code, and the reduction of a
``torch.profiler`` trace to what the per-layer metrics read.

A span is opened around each call into the program (``Spans``). In a traced
run it is also a ``record_function`` range named ``bench/<name>``, so that
the trace holds it beside the device's operations; in an untraced run a
span costs nothing.

``reduce`` keeps the device operations (kernels, copies, sets) that ran
inside the ``bench/window`` range, each with the names of the host
operations that launched it (the runtime call that shares its correlation
id, and that call's parents), and the spans.
"""

import contextlib
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "bench/"
WINDOW = "window"


class Spans:
    """``record_function`` ranges named ``bench/<name>`` while ``traced``,
    nothing otherwise."""

    def __init__(self, traced: bool):
        self.traced = traced

    def __call__(self, name: str):
        return torch.profiler.record_function(PREFIX + name) if self.traced else contextlib.nullcontext()


class Op(NamedTuple):
    name: str
    start: float            # us, the trace's clock
    end: float
    launched_by: FrozenSet[str]


class Span(NamedTuple):
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    ops: List[Op]
    spans: List[Span]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals, clipped to the window."""
        out: List[List[float]] = []
        for op in sorted(self.ops, key=lambda o: o.start):
            a, b = max(op.start, self.window[0]), min(op.end, self.window[1])
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def span_ms(self, name: str) -> Optional[float]:
        """Mean length in ms of the spans ``name`` inside the window, None
        without any."""
        d = [s.end - s.start for s in self.spans
             if s.name == name and s.start >= self.window[0] and s.end <= self.window[1]]
        return sum(d) / len(d) / 1e3 if d else None

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """(label, seconds) of every stretch of the window with no operation
        on the device. The label is the innermost span that holds the
        stretch's middle, else the span that overlaps it most, else
        "outside spans"."""
        edges = [self.window[0]]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(self.window[1])
        spans = sorted((s for s in self.spans if s.name != WINDOW), key=lambda s: s.end - s.start)
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = next((s.name for s in spans if s.start <= mid <= s.end), None)
            if label is None:
                best, label = 0.0, "outside spans"
                for s in spans:
                    overlap = min(b, s.end) - max(a, s.start)
                    if overlap > best:
                        best, label = overlap, s.name
            gaps.append((label, (b - a) / 1e6))
        return gaps

    def breakdown(self, n: int = 10) -> Dict:
        """The ``n`` device operations that took most time, by name, and the
        ``n`` longest idle gaps with their labels."""
        by_name: Dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + (op.end - op.start) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:n]
        return {"device_ops": [[name[:160], s] for name, s in top], "idle_gaps": [[lbl, s] for lbl, s in gaps]}


def profiler():
    """A profiler of the host and the CUDA device."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def reduce(prof) -> Trace:
    """The window's device operations and the spans, from a finished
    ``torch.profiler.profile``. A device event shares its id (the CUPTI
    correlation) with the host's CUDA runtime call that launched it, whose
    parents in the profiler's tree are the host ops above it."""
    from torch.autograd import DeviceType
    events = prof.events()
    runtime, spans = {}, []
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name.startswith("cu"):
                runtime[e.id] = e
            elif e.name.startswith(PREFIX):
                spans.append(Span(e.name[len(PREFIX):], e.time_range.start, e.time_range.end))
    windows = [s for s in spans if s.name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no bench/window range")
    window = (windows[0].start, windows[0].end)
    ops = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith(PREFIX) or getattr(e, "is_user_annotation", False):
            continue
        if e.time_range.end <= window[0] or e.time_range.start >= window[1]:
            continue
        names, parent = set(), runtime.get(e.id)
        while parent is not None:
            names.add(parent.name)
            parent = parent.cpu_parent
        ops.append(Op(e.name, e.time_range.start, e.time_range.end, frozenset(names)))
    return Trace(ops, spans, window)


class Context(NamedTuple):
    """What a per-layer metric's reader reads: the trace, the counts of the
    traced window (``steps``, ``ticks``, ``streams``) and the configuration's
    frozen work counts."""
    trace: Trace
    counts: Dict
    work: Dict
