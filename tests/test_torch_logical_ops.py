"""PyTorch port: the logical-shape operations (`ops.stencil`,
`ops.smoothers`, `ops.transfer`, exported from `ops`) against the JAX
package's and the native C++ oracle, from seeded numpy float64 inputs on
the CPU.

Against the JAX function: within atol 1e-14, and to the bit where
tests/test_padded.py holds the padded forms to the bit (injection) and
wherever both compute the same operations in the same order; the norm
within rel 1e-14 (a reduction, whose order differs).  Against the native
oracle or dense math: tests/test_ops.py's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu.core.problem import (
    cn_coefficients as j_coefficients,
)
from hpcclassmultigridproject_tpu.ops import smoothers as j_smoothers
from hpcclassmultigridproject_tpu.ops import stencil as j_stencil
from hpcclassmultigridproject_tpu.ops import transfer as j_transfer
from hpcclassmultigridproject_tpu_torch import native, ops
from hpcclassmultigridproject_tpu_torch.core.problem import cn_coefficients

N = 16
H = 1.0 / N
DT = H / 10
NU = -4e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rand_fields(seed, n=N):
    """u (zero ring), rhs (zero ring), v1, v2: float64 numpy."""
    rng = np.random.default_rng(seed)
    shape = (n + 1, n + 1)
    u, rhs = rng.standard_normal(shape), rng.standard_normal(shape)
    for a in (u, rhs):
        a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
    return u, rhs, rng.standard_normal(shape), rng.standard_normal(shape)


def _coefs(v1, v2):
    """The port's and the JAX package's coefficients of the same fields."""
    return (cn_coefficients(torch.from_numpy(v1), torch.from_numpy(v2), DT,
                            NU, H),
            j_coefficients(jnp.asarray(v1), jnp.asarray(v2), DT, NU, H))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, bitwise):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_ops_exports_the_jax_names():
    import hpcclassmultigridproject_tpu.ops as j_ops

    assert set(j_ops.__all__) <= set(ops.__all__)
    assert set(ops.__all__) - set(j_ops.__all__) == {"checkerboard"}
    for name in ops.__all__:
        assert getattr(ops, name) is not None


def test_top_level_exports_the_jax_names():
    import hpcclassmultigridproject_tpu as j_pkg
    import hpcclassmultigridproject_tpu_torch as t_pkg
    from hpcclassmultigridproject_tpu_torch.mg.cycle import mg_solve

    assert set(j_pkg.__all__) <= set(t_pkg.__all__)
    assert t_pkg.mg_solve is mg_solve


@pytest.mark.parametrize("op", ["neighbor_sum", "apply_A", "apply_B",
                                "compute_rhs"])
def test_stencil_op_matches_jax(op):
    u, _, v1, v2 = _rand_fields(1)
    tc, jc = _coefs(v1, v2)
    got = getattr(ops, op)(tc, _t(u))
    want = getattr(j_stencil, op)(jc, jnp.asarray(u))
    _close(got, want, bitwise=False)
    if op != "neighbor_sum":
        g = got.numpy()
        assert not g[0].any() and not g[-1].any()
        assert not g[:, 0].any() and not g[:, -1].any()


def test_residual_matches_jax():
    u, rhs, v1, v2 = _rand_fields(2)
    tc, jc = _coefs(v1, v2)
    _close(ops.residual(tc, _t(u), _t(rhs)),
           j_stencil.residual(jc, jnp.asarray(u), jnp.asarray(rhs)),
           bitwise=False)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interior_norm_matches_jax(dtype):
    res = np.random.default_rng(3).standard_normal((N + 1, N + 1))
    res = res.astype(dtype)
    got = ops.interior_norm(_t(res))
    want = j_stencil.interior_norm(jnp.asarray(res))
    assert got.dtype == (torch.float64 if dtype == np.float64
                         else torch.float32)
    assert float(got) == pytest.approx(float(want), rel=1e-14 if
                                       dtype == np.float64 else 1e-6)


@pytest.mark.parametrize("shape,parity", [((15, 15), 0), ((15, 15), 1),
                                          ((6, 9), 0), ((6, 9), 1)])
def test_checkerboard_matches_jax(shape, parity):
    got = ops.checkerboard(shape, parity)
    want = np.asarray(j_smoothers.checkerboard(shape, parity))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    f = ops.checkerboard(shape, parity, dtype=torch.float64)
    np.testing.assert_array_equal(
        f.numpy(), np.asarray(j_smoothers.checkerboard(shape, parity,
                                                       dtype=jnp.float64)))


@pytest.mark.parametrize("sweeps", [1, 3])
def test_rb_gauss_seidel_matches_jax(sweeps):
    u, rhs, v1, v2 = _rand_fields(4)
    tc, jc = _coefs(v1, v2)
    got, want = _t(u), jnp.asarray(u)
    for _ in range(sweeps):
        got = ops.rb_gauss_seidel(tc, got, _t(rhs))
        want = j_smoothers.rb_gauss_seidel(jc, want, jnp.asarray(rhs))
    _close(got, want, bitwise=False)


@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_weighted_jacobi_matches_jax(omega):
    u, rhs, v1, v2 = _rand_fields(5)
    tc, jc = _coefs(v1, v2)
    _close(ops.weighted_jacobi(tc, _t(u), _t(rhs), omega),
           j_smoothers.weighted_jacobi(jc, jnp.asarray(u), jnp.asarray(rhs),
                                       omega), bitwise=False)


@pytest.mark.parametrize("nf", [8, 10, 16])
def test_restrictions_match_jax(nf):
    fine = np.random.default_rng(6).standard_normal((nf + 1, nf + 1))
    _close(ops.restrict_inject(_t(fine)),
           j_transfer.restrict_inject(jnp.asarray(fine)), bitwise=True)
    _close(ops.restrict_full_weighting(_t(fine)),
           j_transfer.restrict_full_weighting(jnp.asarray(fine)),
           bitwise=False)


@pytest.mark.parametrize("nc", [5, 8])
def test_prolong_matches_jax(nc):
    coarse = np.random.default_rng(7).standard_normal((nc + 1, nc + 1))
    _close(ops.prolong_bilinear(_t(coarse)),
           j_transfer.prolong_bilinear(jnp.asarray(coarse)), bitwise=False)


def test_float64_ops_are_the_jax_ops_to_the_bit():
    """Each op but the norm does the JAX package's operations in its order:
    in float64 the results agree to the bit."""
    u, rhs, v1, v2 = _rand_fields(8)
    tc, jc = _coefs(v1, v2)
    ju, jr = jnp.asarray(u), jnp.asarray(rhs)
    pairs = [
        (ops.apply_A(tc, _t(u)), j_stencil.apply_A(jc, ju)),
        (ops.compute_rhs(tc, _t(u)), j_stencil.compute_rhs(jc, ju)),
        (ops.residual(tc, _t(u), _t(rhs)), j_stencil.residual(jc, ju, jr)),
        (ops.rb_gauss_seidel(tc, _t(u), _t(rhs)),
         j_smoothers.rb_gauss_seidel(jc, ju, jr)),
        (ops.weighted_jacobi(tc, _t(u), _t(rhs), 0.8),
         j_smoothers.weighted_jacobi(jc, ju, jr, 0.8)),
        (ops.restrict_full_weighting(_t(u)),
         j_transfer.restrict_full_weighting(ju)),
        (ops.prolong_bilinear(_t(u)), j_transfer.prolong_bilinear(ju)),
    ]
    for got, want in pairs:
        _close(got, want, bitwise=True)


# --- against the native oracle (tests/test_ops.py's tolerances) ------------


def test_compute_rhs_matches_native():
    u, _, v1, v2 = _rand_fields(9)
    tc, _ = _coefs(v1, v2)
    got = ops.compute_rhs(tc, _t(u)).numpy()
    want = native.compute_rhs(u, v1, v2, H, DT, NU)
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1], rtol=1e-13)
    assert np.all(got[0] == 0) and np.all(got[:, 0] == 0)


def test_residual_matches_native():
    u, rhs, v1, v2 = _rand_fields(10)
    tc, _ = _coefs(v1, v2)
    got = ops.residual(tc, _t(u), _t(rhs)).numpy()
    want = native.residual(u, rhs, v1, v2, H, DT, NU)
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1], rtol=1e-12)


def test_norm_matches_native():
    res = np.random.default_rng(11).standard_normal((N + 1, N + 1))
    assert float(ops.interior_norm(_t(res))) == pytest.approx(
        native.norm(res), rel=1e-13)


def test_rb_gauss_seidel_matches_native():
    u, rhs, v1, v2 = _rand_fields(12)
    tc, _ = _coefs(v1, v2)
    got = _t(u)
    for _ in range(3):
        got = ops.rb_gauss_seidel(tc, got, _t(rhs))
    want = native.gs_sweep(u, rhs, v1, v2, H, DT, NU, nsweeps=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


def test_apply_A_matches_dense_matrix():
    """A·u against the interior matrix of the same coefficients, built
    row by row in numpy."""
    u, _, v1, v2 = _rand_fields(13)
    tc, _ = _coefs(v1, v2)
    m = N - 1
    A = np.zeros((m * m, m * m))
    bands = {k: getattr(tc, k).numpy() for k in ("aa", "bb", "cc", "dd")}
    for r in range(m):
        for c in range(m):
            row = r * m + c
            A[row, row] = tc.diag_a
            for k, (dr, dc) in (("cc", (-1, 0)), ("dd", (1, 0)),
                                ("aa", (0, -1)), ("bb", (0, 1))):
                rr, cc = r + dr, c + dc
                if 0 <= rr < m and 0 <= cc < m:
                    A[row, rr * m + cc] = bands[k][r, c]
    got = ops.apply_A(tc, _t(u)).numpy()[1:-1, 1:-1].ravel()
    np.testing.assert_allclose(got, A @ u[1:-1, 1:-1].ravel(), rtol=1e-12)


def test_jacobi_fixed_point_is_solution():
    u, _, v1, v2 = _rand_fields(14)
    tc, _ = _coefs(v1, v2)
    rhs = ops.apply_A(tc, _t(u))
    out = ops.weighted_jacobi(tc, _t(u), rhs, 1.0)
    np.testing.assert_allclose(out.numpy(), u, atol=1e-12)


def test_prolong_matches_native():
    coarse = np.random.default_rng(15).standard_normal((6, 6))
    np.testing.assert_allclose(ops.prolong_bilinear(_t(coarse)).numpy(),
                               native.prolong(coarse), rtol=1e-15)


def test_restrict_inject_matches_native():
    fine = np.random.default_rng(16).standard_normal((11, 11))
    np.testing.assert_allclose(ops.restrict_inject(_t(fine)).numpy(),
                               native.restrict(fine), rtol=0)


def test_restrict_prolong_roundtrip():
    coarse = np.random.default_rng(17).standard_normal((6, 6))
    back = ops.restrict_inject(ops.prolong_bilinear(_t(coarse)))
    np.testing.assert_allclose(back.numpy(), coarse, rtol=0)


def test_restrict_full_weighting_oracle():
    nf = 8
    fine = np.random.default_rng(18).standard_normal((nf + 1, nf + 1))
    got = ops.restrict_full_weighting(_t(fine)).numpy()
    want = fine[::2, ::2].copy()
    for i in range(1, nf // 2):
        for j in range(1, nf // 2):
            fi, fj = 2 * i, 2 * j
            want[i, j] = (
                4 * fine[fi, fj]
                + 2 * (fine[fi - 1, fj] + fine[fi + 1, fj]
                       + fine[fi, fj - 1] + fine[fi, fj + 1])
                + fine[fi - 1, fj - 1] + fine[fi - 1, fj + 1]
                + fine[fi + 1, fj - 1] + fine[fi + 1, fj + 1]) / 16.0
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_full_weighting_preserves_constants():
    got = ops.restrict_full_weighting(torch.ones((17, 17), dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), 1.0)


def test_ops_leave_their_inputs_unchanged():
    u, rhs, v1, v2 = _rand_fields(19)
    tc, _ = _coefs(v1, v2)
    tu, tr = _t(u.copy()), _t(rhs.copy())
    ops.rb_gauss_seidel(tc, tu, tr)
    ops.weighted_jacobi(tc, tu, tr, 0.8)
    ops.restrict_full_weighting(tu)
    ops.restrict_inject(tu)[0, 0] = 7.0
    np.testing.assert_array_equal(tu.numpy(), u)
    np.testing.assert_array_equal(tr.numpy(), rhs)
