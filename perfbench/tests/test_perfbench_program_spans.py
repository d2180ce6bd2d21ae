"""The program's own ranges (``oww/<name>``, ``openwakeword_tpu_torch.tracing``)
in a trace, on the CPU: ``trace.reduce`` counts none of their device-side
mirrors as an operation, so every reader that was there reads the same with
them as without, and the readers of the program's ranges find the
operations launched inside them; ``tools/span_times.py`` tables the
program's ranges of a profile and of a small traced run."""

import importlib.util
import json
import pathlib
import sys
from typing import NamedTuple, Optional

import pytest
import torch
from torch.autograd import DeviceType

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import spec, trace  # noqa: E402
from perfbench.tests.test_perfbench_spec import small  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = {"cnn_device_ms.stream", "addon_device_ms.stream"}
EARLIER = [m["name"] for m in BENCH["per_layer"] if m["name"] not in PROGRAM]


class Range(NamedTuple):
    start: float
    end: float


class Event:
    """What ``trace.reduce`` reads of a ``torch.profiler`` event."""

    def __init__(self, name, start, end, parent=None, device=DeviceType.CPU, id=0, thread=1, annotation=False):
        self.name, self.time_range, self.cpu_parent = name, Range(start, end), parent
        self.device_type, self.id, self.thread, self.is_user_annotation = device, id, thread, annotation


class Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _events(program: bool):
    """Two steps of a bench span around the engine, each launching a conv and
    a suppressor multiply, a gather on the main thread and a fetch on a
    second one; with ``program``, the program's ranges between the bench
    span and the aten ops, and their device-side mirrors."""
    out = [Event("bench/window", 0.0, 1000.0)]
    for k, t in enumerate((100.0, 500.0)):
        issue = Event("bench/step_issue", t, t + 300)
        step = Event("oww/engine.step", t + 5, t + 295, issue) if program else issue
        cnn = Event("oww/engine.cnn", t + 10, t + 100, step) if program else step
        ns = Event("oww/engine.ns", t + 110, t + 200, step) if program else step
        conv = Event("aten::convolution", t + 20, t + 90, cnn)
        mul = Event("aten::mul", t + 120, t + 190, ns)
        out += [issue, conv, mul, Event("cudaLaunchKernel", t + 30, t + 35, conv, id=10 + k),
                Event("cudaLaunchKernel", t + 130, t + 135, mul, id=20 + k),
                Event("conv_kernel", t + 100, t + 160, device=DeviceType.CUDA, id=10 + k),
                Event("elementwise_kernel", t + 160, t + 190, device=DeviceType.CUDA, id=20 + k)]
        if program:
            out += [step, cnn, ns]
            out += [Event(e.name, e.time_range.start + 80, e.time_range.end + 80, device=DeviceType.CUDA,
                          id=100 + k, annotation=True) for e in (step, cnn, ns)]
    gather = Event("bench/score_gather", 850.0, 950.0)
    scores = Event("oww/engine.scores", 855.0, 945.0, gather) if program else gather
    out += [gather, Event("cudaMemcpyAsync", 860.0, 870.0, scores, id=30),
            Event("Memcpy DtoH", 870.0, 880.0, device=DeviceType.CUDA, id=30)]
    if program:
        out += [scores, Event("oww/serve.fetch", 860.0, 900.0, thread=2),
                Event("oww/serve.extract", 900.0, 910.0, thread=2)]
    return out


def _ctx(program: bool):
    work = json.loads((ROOT / "perfbench" / "configs" / "oww6_vad_ns.json").read_text())["work"]
    return trace.Context(trace.reduce(Profile(_events(program))), {"steps": 2, "ticks": 2, "streams": 4096}, work)


def _read(name: str, ctx) -> Optional[float]:
    return spec.module("metrics", name).read(ctx)


def test_program_ranges_leave_every_earlier_reader_as_it_was():
    with_ranges, without = _ctx(True), _ctx(False)
    assert [op.name for op in with_ranges.trace.ops] == [op.name for op in without.trace.ops]
    assert len(with_ranges.trace.ops) == 5
    assert with_ranges.trace.spans == without.trace.spans
    assert with_ranges.trace.breakdown() == without.trace.breakdown()
    for name in EARLIER:
        assert _read(name, with_ranges) == _read(name, without), name


def test_launched_by_holds_the_program_ranges():
    ops = {op.name: op.launched_by for op in _ctx(True).trace.ops}
    assert {"oww/engine.cnn", "oww/engine.step", "bench/step_issue", "aten::convolution"} <= ops["conv_kernel"]
    assert "oww/engine.ns" in ops["elementwise_kernel"] and "oww/engine.cnn" not in ops["elementwise_kernel"]
    assert "oww/engine.scores" in ops["Memcpy DtoH"]


@pytest.mark.parametrize("name, us", [("cnn_device_ms.stream", 60.0), ("addon_device_ms.stream", 30.0)])
def test_program_range_readers(name, us):
    assert _read(name, _ctx(True)) == pytest.approx(2 * us / 1e3 / 2)
    assert _read(name, _ctx(False)) is None


def test_program_range_readers_are_listed_for_the_stream_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert entries["cnn_device_ms.stream"]["workloads"] == ["oww6.stream", "oww6_vad_ns.stream"]
    assert entries["addon_device_ms.stream"]["workloads"] == ["oww6_vad_ns.stream"]
    for name in PROGRAM:
        assert entries[name]["moves"] == "frames_per_s" and entries[name]["source"] == "device_trace"


def _span_times():
    loader = importlib.util.spec_from_file_location("span_times", ROOT / "tools" / "span_times.py")
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module


def test_span_times_tables_a_synthetic_profile():
    out = _span_times().tables(Profile(_events(True)), {"ticks": 2, "streams": 4096})
    ranges = out["ranges"]
    assert out["ticks"] == 2 and out["window_ms_per"] == pytest.approx(0.5)
    step, cnn, ns = ranges["oww/engine.step"], ranges["oww/engine.cnn"], ranges["oww/engine.ns"]
    assert step["count"] == cnn["count"] == ns["count"] == 2
    assert step["host_ms"] == pytest.approx(0.29) and cnn["host_ms"] == pytest.approx(0.09)
    assert step["device_ms"] == pytest.approx(0.09)
    assert cnn["ops"] == {"conv_kernel": pytest.approx(0.06)} and cnn["device_ms"] == pytest.approx(0.06)
    assert ns["ops"] == {"elementwise_kernel": pytest.approx(0.03)}
    assert ranges["oww/engine.scores"]["device_ms"] == pytest.approx(0.005)
    assert step["threads"] == ranges["oww/engine.scores"]["threads"] == ["main"]
    assert ranges["oww/serve.fetch"]["threads"] == ranges["oww/serve.extract"]["threads"] == ["other"]
    assert ranges["oww/serve.fetch"]["device_ms"] == 0.0
    # the gap between the second step's last op and the fetch is the
    # program's step; the harness alone labels it by its own span
    gaps = {label: s for label, s in out["idle_gaps"]}
    assert gaps["oww/engine.step"] == pytest.approx(180e-6) and gaps["oww/engine.scores"] == pytest.approx(120e-6)
    assert ["step_issue", pytest.approx(180e-6)] in trace.reduce(Profile(_events(True))).breakdown()["idle_gaps"]


def test_span_times_reads_a_small_run_on_the_cpu():
    """The tool's profiler and its hold on the profile reach the run through
    ``perfbench.trace``'s names, and are taken out again."""
    before = trace.profiler, trace.reduce, trace.Context
    out = _span_times().report(small(spec.load("oww6.serve")), 2 ** 31 + 91, torch.device("cpu"))
    assert (trace.profiler, trace.reduce, trace.Context) == before
    assert out["result"]["correct"], out["result"]["checks"]
    ranges, ticks = out["ranges"], out["ticks"]
    assert ticks > 0
    for name in ("oww/serve.dispatch", "oww/engine.packets", "oww/engine.step"):
        assert ranges[name]["count"] == ticks and ranges[name]["threads"] == ["main"], name
    for name in ("oww/serve.fetch", "oww/serve.extract"):
        assert 0 < ranges[name]["count"] <= ticks and ranges[name]["threads"] == ["other"], name
