"""Find what belongs to a cell by name: ``BENCHMARK.json`` at the root of the
checkout, then the files of the benchmark's own folders.

* ``configs/<config>.json``: the engine's settings, the heads' shapes,
  the frozen work counts;
* ``traffic/<traffic>.json``: the driver that plays the mix and its
  parameters;
* ``workloads/<cell>.json``: the sizes of the cell, the sample the
  comparison reads and the limits it holds the outputs to;
* ``drivers/<driver>.py`` (``run``, ``outputs``) and
  ``metrics/<metric>.py`` (``read``): code found by name.

A cell, a configuration, a traffic mix or a per-layer metric is added by
adding its files and its entries in ``BENCHMARK.json``; nothing here names
any of them.
"""

import importlib.util
import json
import pathlib
from typing import Dict, List, NamedTuple

HERE = pathlib.Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict           # configs/<config>.json
    traffic: Dict          # traffic/<traffic>.json
    workload: Dict         # workloads/<cell>.json
    end_to_end: List[Dict]   # the BENCHMARK.json metrics this cell reports
    per_layer: List[Dict]

    @property
    def params(self) -> Dict:
        """The traffic's parameters with the cell's own on top."""
        return {**self.traffic.get("params", {}), **self.workload.get("params", {})}


def _json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    """A metric with ``workloads`` is the listed cells'; a per-layer one
    without is every cell's that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load(name: str, root: pathlib.Path = HERE.parent, here: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` in ``root``; KeyError if
    it has none."""
    bench = _json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}; it has {sorted(entries)}")
    entry = entries[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(entry["chips"]), _json(here / "configs" / f"{entry['config']}.json"),
                _json(here / "traffic" / f"{entry['traffic']}.json"), _json(here / "workloads" / f"{name}.json"),
                e2e, per_layer)


def module(kind: str, name: str, here: pathlib.Path = HERE):
    """The module ``<kind>/<name>.py`` of the benchmark's folder, loaded by
    its path (names may hold dots)."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
