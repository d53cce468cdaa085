"""Finds a cell's parts by name, from ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, traffic kind,
cell or per-layer metric sits in a file of its own, named after it:

* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/traffic/<traffic>.json``: a mix's parameters, whose ``kind``
  names ``benchmark/kinds/<kind>.py``, the generator that reads them;
* ``benchmark/cells/<workload>.json``: the cell's engine settings and the
  limits of its correctness check;
* ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric, a
  function ``read(ctx)`` that returns a number, or None where it finds
  nothing to read.

A later change adds a configuration, a mix, a kind, a cell or a metric by
adding its files and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

FOLDER = "benchmark"


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    settings: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def kind(self):
        """The traffic kind's module (its ``Source``)."""
        kind = self.traffic["kind"]
        return _load_module(self.root / FOLDER / "kinds" / f"{kind}.py",
                            f"benchmark_kind_{kind}")

    def reader(self, metric: str):
        mod = _load_module(self.root / FOLDER / "metrics" / f"{metric}.py",
                           "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))
        return mod.read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[entry["config"]]
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((root / FOLDER / "traffic" / f"{entry['traffic']}.json").read_text())
    settings = json.loads((root / FOLDER / "cells" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(workload, entry, config, traffic, settings, e2e, per_layer, root)


def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default), or None for no values."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

