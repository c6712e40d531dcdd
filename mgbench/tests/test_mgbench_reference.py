"""The plain reference against the native oracle's committed field."""

import math
import pathlib

import numpy as np
import pytest
import torch

from mgbench.reference import cn

GOLDEN = pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden"


def test_reference_n256_matches_the_golden_field():
    n = 256
    u0 = cn.gaussian(n, 0.2, 0.4, 100.0)
    uT = cn.cn_run(u0, n, -4e-4, (1.0 / n) / 10.0, 100)
    want = np.load(GOLDEN / "uT_n256.npy")
    np.testing.assert_allclose(uT.numpy(), want, atol=1e-12)
    assert float(uT[128, 128]) == pytest.approx(4.802e-5, abs=5e-9)


def test_float32_reference_is_farther():
    n = 64
    u0 = cn.gaussian(n, 0.3, 0.6, 100.0)
    ref = cn.cn_run(u0, n, -4e-4, (1.0 / n) / 10.0, 20)
    low = cn.cn_run(u0, n, -4e-4, (1.0 / n) / 10.0, 20,
                    dtype=torch.float32)
    gap = float((low.double() - ref).abs().max() / ref.abs().max())
    assert 1e-8 < gap < 1e-5


def test_operator_is_diagonally_dominant_at_the_cells():
    for n in (1024, 4096):
        op = cn.CNOperator(n, -4e-4, (1.0 / n) / 10.0)
        assert 0.0 < op.rho < 0.3
        assert op.diag_a == pytest.approx(1 + 4 * (0.05 * n) * 4e-4)
    assert not math.isnan(op.rho)
