"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a stand-in's size.  The faults a cell on one card can have: a step that
returns its state unchanged, and an answer altered where it is produced
(no batch to halve, no exchange between cards)."""

import pytest
import standin
import torch

from mgbench import harness
from hpcclassmultigridproject_tpu_torch.mg import cycle, delta


def _unchanged_state(monkeypatch):
    """Every cycle returns its iterate unchanged (zero from zero), so every
    step returns the state it was given."""

    def still(levels, u, rhs, cfg, lvl=0, want_final_residual=False,
              u_is_zero=False, shardings=None):
        u = torch.zeros_like(rhs) if u is None or u_is_zero else u
        return (u, rhs.clone()) if want_final_residual else u

    monkeypatch.setattr(delta, "mg_cycle", still)
    monkeypatch.setattr(cycle, "mg_cycle", still)
    return None


def _altered_answer(monkeypatch):
    """uT altered at one node, by 1e-4 of its largest value, where the run
    produces it."""

    def patch(runner):
        run = runner.model.run

        def altered(u0, warn=True):
            uT, stats = run(u0, warn=warn)
            uT = uT.clone()
            n = uT.shape[0] - 1
            uT[n // 2, n // 3] += 1e-4 * float(uT.abs().max())
            return uT, stats

        runner.model.run = altered

    return patch


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_answer"])
@pytest.mark.parametrize("cell", sorted(standin.CELLS))
def test_fault_makes_the_run_not_correct(tmp_path, monkeypatch, cell, fault):
    root = standin.make(tmp_path)
    patch = {"unchanged_state": _unchanged_state,
             "altered_answer": _altered_answer}[fault](monkeypatch)
    result = harness.run_cell(cell, 2**32 + 11, 0.2, False, device="cpu",
                              root=root, bench_dir=root / "mgbench",
                              patch=patch)
    assert result["correct"] is False
    gap = result["checks"]["uT_rel_gap"]
    assert gap["value"] > gap["limit"]
    if fault == "unchanged_state":
        assert result["failed"] == result["attempted"]
