"""Cells, configurations, traffic mixes and metrics are found by name, and
a stand-in added as new files and entries runs with no other edit."""

import json

import pytest
import standin

from mgbench import harness, spec


def test_every_cell_loads_by_name():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["n"] > 0 and cell.traffic["solver"]
        assert cell.limits["uT_rel_gap"]["limit"] > 0
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "dof_rate"} <= names
        assert cell.per_layer


def test_every_metric_has_a_reader():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_unknown_cell_raises():
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("no-such-cell")


def test_metric_lists_follow_workloads_keys():
    cell = spec.load_cell("advdiff-n4096-delta")
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert "run_ms_p95" not in names and "cycles_per_step" not in names
    cell = spec.load_cell("advdiff-n1024-adaptive-f64")
    names = {m["name"] for m in cell.per_layer}
    assert {"run_ms_p95", "cycles_per_step", "loop_tests_per_step"} <= names


@pytest.mark.parametrize("cell", sorted(standin.CELLS))
def test_standin_cell_added_by_files_runs(tmp_path, cell):
    root = standin.make(tmp_path)
    result = harness.run_cell(cell, 2**31 + 7, 0.3, False, device="cpu",
                              root=root, bench_dir=root / "mgbench")
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"dof_rate", "setup_s"}
    assert list(result)[-1] == "checks"
    gap = result["checks"]["uT_rel_gap"]
    assert gap["value"] <= gap["limit"]


def test_standin_metric_added_by_file(tmp_path):
    root = standin.make(tmp_path)
    (root / "mgbench" / "metrics" / "runs_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.walls))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "runs_done", "unit": "runs",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-delta"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = harness.run_cell("tiny-delta", 5, 0.2, False, device="cpu",
                              root=root, bench_dir=root / "mgbench")
    assert result["metrics"]["runs_done"]["value"] == result["attempted"]
