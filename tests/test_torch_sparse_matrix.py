"""PyTorch port: the explicit-matrix path (sparse/matrix.py) against the
port's stencil ops and the JAX package's BCOO product (CPU, x64), the
counterpart of tests/test_sparse_matrix.py, at its bound: atol 1e-13 in
float64.

The JAX test's level holds stored bands; its twin here is the five-band
level of the same bands (`stored_coefficients`).  The port's own
rediscretized levels are from_v levels, whose bands the matrix forms as
the host build stores them: one more case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu.mg.levels import build_hierarchy as j_build
from hpcclassmultigridproject_tpu.sparse import matrix as j_matrix
from hpcclassmultigridproject_tpu.sparse.galerkin import (
    galerkin_coarse_level as j_galerkin,
)
from hpcclassmultigridproject_tpu_torch.core.layout import (
    interior_mask,
    padded_shape,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    _np_pad_field,
    banded_level,
    build_hierarchy,
    stored_coefficients,
)
from hpcclassmultigridproject_tpu_torch.ops import padded as pops
from hpcclassmultigridproject_tpu_torch.sparse.galerkin import (
    galerkin_coarse_level,
)
from hpcclassmultigridproject_tpu_torch.sparse.matrix import (
    level_to_bcoo,
    level_to_bcsr,
    spmv_apply,
    spmv_residual,
)

N = 32
DT, NU = (1.0 / N) / 10, -4e-4
ATOL = 1e-13


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _velocities(seed):
    return np.random.default_rng(seed).standard_normal((2, N + 1, N + 1))


def _levels(seed):
    """(the port's five-band level, the JAX level) of one seeded velocity
    field, float64: the same bands."""
    v1, v2 = _velocities(seed)
    coef = stored_coefficients(_np_pad_field(v1), _np_pad_field(v2), N,
                               1.0 / N, DT, NU, torch.float64)
    jl = j_build(jnp.asarray(v1), jnp.asarray(v2), DT, NU, 1,
                 dtype=jnp.float64)[0]
    tl = banded_level(coef, n=N, h=1.0 / N, dt=DT, nu=NU, diag_a=jl.diag_a,
                      diag_b=jl.diag_b, dtype=torch.float64, device="cpu")
    return tl, jl


def _field(seed, n=N):
    x = np.random.default_rng(seed).standard_normal(padded_shape(n))
    return torch.from_numpy(x) * interior_mask(n, padded_shape(n),
                                               dtype=torch.float64,
                                               device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("assemble", [level_to_bcoo, level_to_bcsr])
def test_apply_equals_stencil_and_jax(assemble):
    """BCOO and CSR apply (tests/test_sparse_matrix.py's first two)."""
    tl, jl = _levels(5)
    mat = assemble(tl)
    assert mat.layout == (torch.sparse_coo if assemble is level_to_bcoo
                          else torch.sparse_csr)
    assert mat.shape == ((N - 1) ** 2, (N - 1) ** 2)
    u = _field(6)
    got = spmv_apply(mat, tl, u)
    _close(got, pops.apply_A(tl, u))
    _close(got, j_matrix.spmv_apply(j_matrix.level_to_bcoo(jl), jl,
                                    jnp.asarray(u.numpy())))


def test_spmv_residual_equals_stencil_and_jax():
    tl, jl = _levels(7)
    mat = level_to_bcoo(tl)
    u, rhs = _field(8), _field(9)
    got = spmv_residual(mat, tl, u, rhs)
    _close(got, pops.residual(tl, u, rhs))
    _close(got, j_matrix.spmv_residual(
        j_matrix.level_to_bcoo(jl), jl, jnp.asarray(u.numpy()),
        jnp.asarray(rhs.numpy())))


def test_bcoo_of_galerkin_9pt_level():
    """A Galerkin nine-band level (full weighting): corners and a varying
    diagonal."""
    tl, jl = _levels(10)
    coarse = galerkin_coarse_level(tl, "full")
    jcoarse = j_galerkin(jl, "full", jl.v1, jl.v2)
    assert coarse.form == "nine"
    mat = level_to_bcoo(coarse)
    assert mat._nnz() == j_matrix.level_to_bcoo(jcoarse).nse
    u = _field(11, N // 2)
    got = spmv_apply(mat, coarse, u)
    _close(got, pops.apply_A(coarse, u))
    _close(got, j_matrix.spmv_apply(j_matrix.level_to_bcoo(jcoarse), jcoarse,
                                    jnp.asarray(u.numpy())))


@pytest.mark.parametrize("assemble", [level_to_bcoo, level_to_bcsr])
def test_matrix_of_a_from_v_level(assemble):
    """The port's rediscretized (from_v) level: the matrix holds the bands
    the host build stores, so it is the JAX level's matrix, and its
    product equals the from_v stencil."""
    v1, v2 = _velocities(12)
    (level,) = build_hierarchy(v1, v2, DT, NU, 1, dtype=torch.float64,
                               device="cpu")
    assert level.form == "from_v"
    jl = j_build(jnp.asarray(v1), jnp.asarray(v2), DT, NU, 1,
                 dtype=jnp.float64)[0]
    mat = assemble(level)
    assert mat.dtype == torch.float64
    want = j_matrix.level_to_bcoo(jl).todense()
    np.testing.assert_array_equal(mat.to_dense().numpy(), np.asarray(want))
    u = _field(13)
    _close(spmv_apply(mat, level, u), pops.apply_A(level, u))


def test_matrix_dtype_and_blocks():
    """The default dtype is the level's (a from_v float32 level's v1); a
    rank's block of a level is refused."""
    import dataclasses

    v1, v2 = _velocities(14)
    (level,) = build_hierarchy(v1, v2, DT, NU, 1, dtype=torch.float32,
                               device="cpu")
    assert level_to_bcoo(level).dtype == torch.float32
    assert level_to_bcsr(level, torch.float64).dtype == torch.float64
    with pytest.raises(ValueError, match="whole level"):
        level_to_bcoo(dataclasses.replace(level, row_off=8))
