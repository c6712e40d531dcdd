"""What a cell is made of, found by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration
and traffic mix, and the metrics.  Each of those sits in a file of its
own under this folder:

  configs/<config>.json    the deployment: grid, physics, steps, source
  traffic/<traffic>.json   the solver the runs use, the input bank, the
                           loop, and the control's lower-precision solver
  cells/<cell>.json        the limits of the correctness comparison, with
                           the readings they were set from
  metrics/<metric>.py      a reader: `read(ctx)` returns the metric's
                           value, or None where it finds nothing to read

so that a cell, a configuration, a traffic mix or a metric is added by
adding files and entries, with no edit to a file that is already here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One entry of `workloads`, with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def metrics(self, trace: bool) -> list:
        """The metrics this cell reports: its end-to-end metrics, or with
        `trace` its per-layer ones."""
        return self.per_layer if trace else self.end_to_end


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: pathlib.Path = ROOT,
              bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, its files read from
    `bench_dir`.  Raises KeyError for a cell the file does not name."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has "
                       f"{', '.join(sorted(cells))})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[entry["config"]]["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    limits = _load_json(bench_dir / "cells" / f"{name}.json")
    return Cell(name, entry["chips"], config, traffic, limits,
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name))


def reader(metric: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The `read(ctx)` function of metrics/<metric>.py."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"mgbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_data(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    """A data file under the folder, such as metrics/kernel_layers.json."""
    return _load_json(bench_dir / name)
