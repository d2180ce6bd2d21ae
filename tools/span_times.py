"""Where a benchmark cell's time goes, by the program's own spans.

    python3 tools/span_times.py --workload oww6.serve --seed 7

Makes one traced run of the cell (``perfbench/run.py --trace 1``) of this
checkout under a profiler that records every thread, the server's fetcher
thread too, and prints one JSON line: the run's own result, the window's
time per step or tick, and for each ``oww/<name>`` range of the program
(``openwakeword_tpu_torch.tracing``) inside the window its count, threads,
host ms and the device ms of the operations launched inside it per step or
tick (with the operations that took most of it), and the window's longest
idle gaps labelled by the innermost range, the program's or the
benchmark's, that holds them. Needs a CUDA device.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from perfbench import run, spec, trace  # noqa: E402

PROGRAM = "oww/"


def tables(prof, counts) -> dict:
    """The program's ranges in a finished profile of a traced run, per step
    or tick of ``counts`` (the run's counts of its window)."""
    from torch.autograd import DeviceType
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    main = next(e.thread for e in cpu if e.name == trace.PREFIX + trace.WINDOW)
    t = trace.reduce(prof)
    unit = "steps" if "steps" in counts else "ticks"
    per = counts[unit]
    lo, hi = t.window
    ranges = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in cpu
              if e.name.startswith(PROGRAM) and e.time_range.start >= lo and e.time_range.end <= hi]
    table = {}
    for name, a, b, thread in ranges:
        row = table.setdefault(name, {"count": 0, "host_ms": 0.0, "device_ms": 0.0, "threads": set(), "ops": {}})
        row["count"] += 1
        row["host_ms"] += (b - a) / 1e3 / per
        row["threads"].add("main" if thread == main else "other")
    for op in t.ops:
        for name in op.launched_by:
            if name in table:
                ms = (op.end - op.start) / 1e3 / per
                table[name]["device_ms"] += ms
                table[name]["ops"][op.name[:80]] = table[name]["ops"].get(op.name[:80], 0.0) + ms
    for row in table.values():
        row["threads"] = sorted(row["threads"])
        row["ops"] = dict(sorted(row["ops"].items(), key=lambda kv: -kv[1])[:5])
    labelled = trace.Trace(t.ops, t.spans + [trace.Span(n, a, b) for n, a, b, _ in ranges], t.window)
    return {unit: per, "window_ms_per": t.window_s * 1e3 / per, "ranges": dict(sorted(table.items())),
            "idle_gaps": labelled.breakdown()["idle_gaps"]}


def report(cell, seed: int, device) -> dict:
    """One traced run of ``cell`` on ``device`` under a profiler of every
    thread, and its ``tables``. For the length of the run it puts its own
    profiler into ``perfbench.trace`` and keeps the profile and the window's
    counts that ``perfbench.run`` hands to the trace's reduction and to the
    readers' context."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    kept = {}
    profiler, reduce, context = trace.profiler, trace.reduce, trace.Context

    def every_thread():
        return profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))

    def keep(prof):
        kept["prof"] = prof
        return reduce(prof)

    def counted(t, counts, work):
        kept["counts"] = counts
        return context(t, counts, work)

    trace.profiler, trace.reduce, trace.Context = every_thread, keep, counted
    try:
        result = run.execute(cell, seed, 0.0, True, device)
    finally:
        trace.profiler, trace.reduce, trace.Context = profiler, reduce, context
    return {"workload": cell.name, "seed": seed, "result": result, **tables(kept["prof"], kept["counts"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("span_times: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(report(spec.load(args.workload), args.seed, torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
