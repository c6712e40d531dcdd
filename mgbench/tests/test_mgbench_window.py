"""The end-to-end readers over a window: the rate counts all the work and
all the time, and the 95th percentile is the tail of every run."""

import types

import pytest

from mgbench import spec


def _ctx(walls, passed=None, n=1025, steps=100):
    passed = [True] * len(walls) if passed is None else passed
    win = types.SimpleNamespace(walls=walls, passed=passed,
                                seconds=sum(walls), cycles=[])
    return types.SimpleNamespace(window=win, n=n, steps=steps,
                                 dof_steps=(n - 1) ** 2 * steps)


def test_rate_counts_a_stall_and_only_certified_runs():
    walls = [0.025] * 99 + [1.0]            # one run stalls for a second
    ctx = _ctx(walls)
    rate = spec.reader("dof_rate")(ctx)
    assert rate == pytest.approx(100 * 1024**2 * 100 / 3.475 / 1e9)
    ctx = _ctx(walls, passed=[True] * 98 + [False, True])
    assert spec.reader("dof_rate")(ctx) == pytest.approx(rate * 99 / 100)


def test_p95_is_the_tail_of_every_run():
    walls = [0.025] * 190 + [0.2] * 10      # the 5% slowest
    p95 = spec.reader("run_ms_p95")(_ctx(walls))
    assert p95 == pytest.approx(25.0)        # rank 190 of 200
    walls = [0.025] * 189 + [0.2] * 11
    assert spec.reader("run_ms_p95")(_ctx(walls)) == pytest.approx(200.0)


def test_p95_of_a_few_runs_is_the_slowest():
    assert spec.reader("run_ms_p95")(_ctx([0.1, 0.3, 0.2])) == \
        pytest.approx(300.0)
