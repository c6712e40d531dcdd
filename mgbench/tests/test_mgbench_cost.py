"""The frozen cost model equals the program's utils/profiling.py at three
shapes, and a run's least time follows its cycles."""

import pytest
import torch

from mgbench.reference import cost
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.utils import profiling


def _levels(n):
    model = AdvectionDiffusion(
        ProblemConfig(n=n), SolverConfig(coarse_mode="dense"), device="cpu")
    return model.levels, model.solver


@pytest.mark.parametrize("n", [64, 128, 256])
def test_frozen_model_matches_the_program(n):
    levels, solver = _levels(n)
    for itemsize in (4, 8):
        for level in levels:
            for kw in ({}, {"read_u": False, "want_residual": True,
                            "res_dec": True},
                       {"corr": True, "want_residual": True}):
                assert cost.smooth_cost(level, itemsize, 3, **kw) == \
                    profiling.smooth_cost(level, itemsize, 3, **kw)
            assert cost.open_cost(level, itemsize) == \
                profiling.open_cost(level, itemsize)
            for phase in ("smooth", "residual", "rhs", "restrict",
                          "prolong", "norm", "coarse"):
                assert cost._bytes_model(phase, level, itemsize, 3) == \
                    profiling._bytes_model(phase, level, itemsize, 3)
                assert cost._flops_model(phase, level, 3) == \
                    profiling._flops_model(phase, level, 3)
        for ascent in (False, True):
            assert cost.tower_cost(levels, 1, itemsize, 3, ascent) == \
                profiling.tower_cost(levels, 1, itemsize, 3, ascent)
        assert cost.bound_ms(1e9, 1e12, itemsize) == \
            profiling.bound_ms(1e9, 1e12, itemsize)
    assert cost._phase_counts(solver, len(levels)) == \
        profiling._phase_counts(solver, len(levels))
    assert cost.num_levels(n, {}) == len(levels)


def test_least_time_follows_cycles_and_is_bandwidth_bound():
    solver = {"dtype": "float64", "coarse_mode": "gs", "niter": 3}
    one = cost.run_work(1024, 100, solver, [1] * 100)
    two = cost.run_work(1024, 100, solver, [2] * 100)
    assert two.nbytes > 1.5 * one.nbytes
    assert one.least_seconds() == pytest.approx(
        one.nbytes / cost.HBM_BYTES_PER_S)


def test_delta_work_counts_the_f64_certificates():
    solver = {"delta_form": True, "coarse_mode": "dense", "niter": 3,
              "certify_every": 10}
    with_certs = cost.run_work(256, 100, solver, [1] * 100)
    without = cost.run_work(256, 100, dict(solver, certify_every=0),
                            [1] * 100)
    assert with_certs.flops[8] > without.flops[8] > 0
    assert with_certs.nbytes > without.nbytes


def test_grid_is_the_logical_one():
    g = cost.Grid(1024)
    assert g.padded == (1025, 1025) and cost._points(g) == 1023**2
    assert torch.float64.itemsize == 8
