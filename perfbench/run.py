"""Benchmark of openwakeword_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run builds the cell's system from the seed,
warms up every shape the cell uses (set-up), measures for ``--seconds``
(``--trace 1``: a shorter window under ``torch.profiler``, for the per-layer
metrics), compares a sample of what the timed path produced with the plain
reference in ``perfbench/reference``, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``breakdown``) and, last, ``checks``:
each number compared beside its limit, which also end standard error.

``--control 1`` runs the configuration's ``control_precision`` in place of
its own (the check's control; not part of a run). ``--set key=value``
overrides a parameter of the cell (a JSON value), for sweeps.

Exits non-zero and prints no result without a CUDA device, with fewer
devices than the cell asks for, or when ``jax`` or the JAX package was
loaded.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time


def _process_start() -> float:
    """The process's start on the ``time.time`` clock (from /proc; the
    moment of this import where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


START = _process_start()
ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openwakeword_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``openwakeword_tpu_torch`` is not ``openwakeword_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What a driver reads and reports to: the cell, the seed, the window's
    length, whether it is traced, the device, the spans."""

    def __init__(self, cell, seed: int, seconds: float, traced: bool, control: bool, device, spans):
        self.cell, self.seed, self.seconds, self.traced, self.control = cell, seed, seconds, traced, control
        self.device, self.spans = device, spans
        self.setup_s = None
        self.marks = []

    def mark(self, name: str):
        """Notes the end of a stage of set-up, for the run's log."""
        self.marks.append((name, time.time() - START))

    def setup_done(self):
        """Marks the end of set-up: the first timed operation comes next."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()
        self.setup_s = time.time() - START

    def card_state(self) -> str:
        """The card's SM clock, power draw and temperature, read once the
        window has closed, for the run's log."""
        return smi(self.device, "clocks.sm,power.draw,temperature.gpu") if self.device.type == "cuda" else "not read"


def smi(device, query: str) -> str:
    """``nvidia-smi``'s reading of ``query`` for the card, or "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader", "-i",
                              str(device.index or 0)], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def card(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "power_limit": smi(device, "power.limit")}


def execute(cell, seed: int, seconds: float, traced: bool, device, control: bool = False) -> dict:
    """One run of ``cell`` on ``device``: the result line's fields, before
    printing. The tests call it on the CPU."""
    import torch
    from perfbench import check, spec, system, trace
    spans = trace.Spans(traced)
    r = Run(cell, seed, seconds, traced, control, device, spans)
    driver = spec.module("drivers", cell.traffic["driver"])
    out = driver.run(r)
    w = system.weights(cell.config, seed)
    with torch.no_grad():
        checks, seen = check.compare(out["histories"], out["labels"], system.reference_args(cell.config, w),
                                     cell.workload["limits"], device)
    checks["failed"] = {"value": out["failed"], "limit": 0}
    dev = card(device)
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    result = {"correct": check.passed(checks), "attempted": int(out["attempted"]), "failed": int(out["failed"])}
    if traced:
        t = out["trace"]
        ctx = trace.Context(t, out["counts"], cell.config["work"])
        metrics = {}
        for m in cell.per_layer:
            value = spec.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = t.busy_s(), t.window_s
        result["breakdown"] = t.breakdown()
    else:
        values = dict(out["end_to_end"], setup_s=r.setup_s)
        metrics = {m["name"]: {"value": _finite(values[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    result.update(metrics=metrics, device=dev, checks=checks)
    stages = ", ".join(f"{name} {t:.2f}" for name, t in r.marks)
    result["info"] = (f"{out['info']}; set-up s since the start: {stages}; compared {seen['steps']} steps, "
                      f"gate ambiguous {seen['gate_ambiguous']}")
    return result


def _finite(v: float) -> float:
    """A metric as printed: a value that never came (infinitely late) as 1e12."""
    return float(v) if v == v and abs(v) != float("inf") else 1e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import spec
    cell = spec.load(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        cell.workload.setdefault("params", {})[key] = json.loads(value)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    dev = card(device)
    print(f"perfbench: {args.workload} seed {args.seed} on {dev['kind']} x {torch.cuda.device_count()}, "
          f"power limit {dev.get('power_limit')}, torch {torch.__version__} CUDA {torch.version.cuda}",
          file=sys.stderr)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), device, bool(args.control))
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"perfbench: the run loaded {forbidden}", file=sys.stderr)
        return 3
    print(result.pop("info"), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
