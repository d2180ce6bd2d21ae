"""What the harness finds by name, its frozen counts, its trace arithmetic,
and what it refuses to run with, on the CPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run, spec, trace, workcount  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"stream": {"streams": 4, "check_streams": 3, "segment_frames": 10, "segments": 2, "trace_segments": 2},
         "serve": {"streams": 4, "check_streams": 4, "warm_ticks": 3, "trace_ticks": 6, "bank_ticks": 5}}


def small(cell):
    cell.workload["params"].update(SMALL[cell.traffic["driver"]])
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_its_driver_and_readers(name):
    cell = spec.load(name)
    assert cell.chips == 1
    assert spec.module("drivers", cell.traffic["driver"]).run
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    for m in cell.per_layer:
        assert spec.module("metrics", m["name"]).read
        assert m["moves"] in [e["name"] for e in cell.end_to_end]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_frozen_work_counts(config):
    c = json.loads((ROOT / "perfbench" / "configs" / f"{config}.json").read_text())
    assert c["work"] == workcount.counts(c)


def test_work_counts_match_the_earlier_figures():
    """8.08 GFLOP of mel, 45.98 GFLOP of CNN step, 343.70 of prime at 4096
    streams (PERF.md's kernel table)."""
    assert round(workcount.mel()["flops"] * 4096 / 1e9, 2) == 8.08
    assert round(workcount.cnn()["step_flops"] * 4096 / 1e9, 2) == 45.98
    assert round(workcount.cnn()["window_flops"] * 4096 / 1e9, 2) == 343.70


def test_an_added_cell_is_found_without_edits(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [{"name": "oww6.stream_tiny", "config": "oww6", "traffic": "stream",
                                                "chips": 1, "why": "a cell added as data"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell_file = json.loads((ROOT / "perfbench" / "workloads" / "oww6.stream.json").read_text())
    cell_file["params"].update(SMALL["stream"])
    (tmp_path / "perfbench" / "workloads" / "oww6.stream_tiny.json").write_text(json.dumps(cell_file))
    cell = spec.load("oww6.stream_tiny", root=tmp_path, here=tmp_path / "perfbench")
    assert cell.params["streams"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]     # frames_per_s lists its cells by name
    result = run.execute(cell, 2 ** 31 + 5, 0.3, False, torch.device("cpu"))
    assert result["correct"] and result["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_small_run_on_the_cpu_is_correct(name, traced):
    result = run.execute(small(spec.load(name)), 2 ** 31 + 77, 0.5, traced, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert list(result)[-2:] == ["checks", "info"]       # "info" goes to stderr; "checks" prints last
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in spec.load(name).end_to_end}


def test_forbidden_modules_are_compared_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "openwakeword_tpu_torch_fake", object())
    assert "openwakeword_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "openwakeword_tpu.fake", object())
    assert "openwakeword_tpu" in run.loaded_forbidden()


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import perfbench.run, perfbench.check, perfbench.system; "
            "from perfbench import spec\n"
            "for k in ('stream', 'serve'): spec.module('drivers', k)\n"
            "import openwakeword_tpu_torch.parallel\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'openwakeword_tpu'}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import perfbench.reference.pipeline, perfbench.check, "
            "perfbench.workcount; print(sorted(m for m in sys.modules if m.split('.')[0].startswith('openwakeword')))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "oww6.stream", "--seed", str(2 ** 31 + 3),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_trace_arithmetic():
    ops = [trace.Op("k", 0.0, 10.0, frozenset({"aten::convolution"})), trace.Op("k", 5.0, 20.0, frozenset()),
           trace.Op("melspec_frames_mma_kernel<3>", 40.0, 50.0, frozenset()), trace.Op("x", 90.0, 120.0, frozenset())]
    spans = [trace.Span("window", 0.0, 100.0), trace.Span("outer", 0.0, 100.0), trace.Span("feed", 21.0, 39.0)]
    t = trace.Trace(ops, spans, (0.0, 100.0))
    assert t.busy() == [(0.0, 20.0), (40.0, 50.0), (90.0, 100.0)]
    assert t.busy_s() == pytest.approx(40e-6) and t.idle_pct() == pytest.approx(60.0)
    assert t.idle_gaps() == [("feed", pytest.approx(20e-6)), ("outer", pytest.approx(40e-6))]
    ctx = trace.Context(t, {"steps": 2, "streams": 4096}, json.loads(
        (ROOT / "perfbench" / "configs" / "oww6.json").read_text())["work"])
    assert spec.module("metrics", "conv_ms.stream").read(ctx) == pytest.approx(10 / 1e3 / 2)
    least = workcount.mel_launch_least_seconds(ctx.work, 4096)
    assert spec.module("metrics", "mel_roofline_pct.stream").read(ctx) == pytest.approx(100 * least / 10e-6)
    assert spec.module("metrics", "ops_per_step.stream").read(ctx) == 2.0
    empty = trace.Context(trace.Trace([], spans, (0.0, 100.0)), ctx.counts, ctx.work)
    for name in ("conv_ms.stream", "mel_roofline_pct.stream", "ops_per_step.stream", "step_mfu.stream",
                 "device_idle_pct.stream", "tick_device_ms.serve"):
        assert spec.module("metrics", name).read(empty) is None
