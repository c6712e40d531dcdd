"""A stand-in benchmark at a size the CPU holds, added the way a later
change adds a cell: new files and new entries only."""

import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = "tiny"
CELLS = {"tiny-delta": "delta-fixed", "tiny-adaptive": "adaptive-f64"}
# at n=64 and 10 steps the delta path reads up to ~3e-8, the f64 path
# ~2e-13 and the float32 control ~5e-7 (CPU): a limit between them
LIMIT = 1.5e-7


def make(tmp: pathlib.Path, n: int = 64, steps: int = 10) -> pathlib.Path:
    """A copy of the benchmark under `tmp`, with a configuration "tiny"
    and a cell of it under each traffic mix; returns the copy's root."""
    shutil.copytree(BENCH, tmp / "mgbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads(
        (BENCH / "configs" / "advdiff-n1024.json").read_text())
    config.update(name=TINY, n=n, num_steps=steps)
    (tmp / "mgbench" / "configs" / f"{TINY}.json").write_text(
        json.dumps(config))
    bench["configs"].append({
        "name": TINY, "source": "stand-in", "reduced": ["n", "num_steps"],
        "file": f"mgbench/configs/{TINY}.json", "why": "a CPU stand-in"})
    for cell, mix in CELLS.items():
        bench["workloads"].append({"name": cell, "config": TINY,
                                   "traffic": mix, "chips": 1,
                                   "why": "a CPU stand-in"})
        (tmp / "mgbench" / "cells" / f"{cell}.json").write_text(
            json.dumps({"uT_rel_gap": {"limit": LIMIT}}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
