"""The control (the program's own lower-precision path, and the reference
in float32) reads far above the program: on the CPU at a stand-in's size,
and on the card at each cell's own size against the cell's limit."""

import json

import pytest
import standin
import torch

from mgbench import control, spec


@pytest.mark.parametrize("cell", sorted(standin.CELLS))
def test_control_reads_far_above_the_program(tmp_path, cell):
    root = standin.make(tmp_path)
    c = spec.load_cell(cell, root, root / "mgbench")
    (row,) = control.readings(c, [2**31 + 99], device="cpu")
    assert row["control"] > 3 * row["program"]
    assert row["reference_f32"] > 3 * row["program"]
    assert row["program"] <= standin.LIMIT < row["control"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [
    w["name"] for w in json.loads(
        (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_the_cell_limit_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size")
    c = spec.load_cell(cell)
    limit = c.limits["uT_rel_gap"]["limit"]
    for row in control.readings(c, [2**31 + 1, 2**31 + 2, 2**31 + 3],
                                kinds=("program", "control")):
        assert row["program"] <= limit < row["control"], row
