"""PyTorch port: the plain level operations (ops/padded.py) and the delta
stepper's building blocks (mg/delta.py) against the JAX package, in f64 at
atol 1e-12 (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu.core.layout import padded_shape
from hpcclassmultigridproject_tpu.mg import delta as jdelta
from hpcclassmultigridproject_tpu.mg.levels import build_fine_level as j_fine
from hpcclassmultigridproject_tpu.ops import padded as jops
from hpcclassmultigridproject_tpu_torch import interop
from hpcclassmultigridproject_tpu_torch.mg import delta as tdelta
from hpcclassmultigridproject_tpu_torch.ops import padded as tops

ATOL = 1e-12


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _levels(n, jdtype=jnp.float64, seed=3):
    """A JAX fine level on random velocities and the port's copy of it."""
    v = np.random.default_rng(seed).standard_normal((2, n + 1, n + 1))
    jl = j_fine(jnp.asarray(v[0]), jnp.asarray(v[1]), 0.1 / n, -4e-4,
                dtype=jdtype)
    d = {k: getattr(jl, k) for k in ("n", "h", "dt", "nu", "diag_a", "diag_b")}
    d.update(v1=np.asarray(jl.v1), v2=np.asarray(jl.v2))
    return jl, interop.level_from_numpy(d, device="cpu")


def _field(rng, n, dtype=np.float64, scale=1.0):
    """Random padded field, zero outside the open interior."""
    x = np.zeros(padded_shape(n))
    x[1:n, 1:n] = scale * rng.standard_normal((n - 1, n - 1))
    return x.astype(dtype)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("n", [16, 64])
def test_stencil_ops_match(n):
    rng = np.random.default_rng(n)
    jl, tl = _levels(n)
    u, rhs = _field(rng, n), _field(rng, n)
    ju, jr = jnp.asarray(u), jnp.asarray(rhs)
    tu, tr = torch.from_numpy(u), torch.from_numpy(rhs)
    for a, b in zip(jops._coefs_from_v(jl), tops.coefs_from_v(tl)):
        _close(b, a)
    _close(tops.neighbor_sum_from_v(tl, tu), jops.neighbor_sum_from_v(jl, ju))
    _close(tops.residual_from_v(tl, tu, tr), jops.residual_from_v(jl, ju, jr))
    _close(tops.rb_gauss_seidel(tl, tu, tr), jops.rb_gauss_seidel(jl, ju, jr))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interior_norm_matches(dtype):
    x = _field(np.random.default_rng(4), 64, dtype)
    want = float(jops.interior_norm(jnp.asarray(x)))
    got = tops.interior_norm(torch.from_numpy(x))
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.float64)
    assert abs(float(got) - want) <= (1e-6 if dtype == np.float32 else ATOL) * want


@pytest.mark.parametrize("n", [16, 64, 128])
def test_transfers_match(n):
    """Injection (full and from the row-decimated residual) and bilinear
    prolongation, including the crop/pad at the padded edges."""
    rng = np.random.default_rng(n + 1)
    fine = _field(rng, n)
    coarse_shape = padded_shape(n // 2)
    want = jops.restrict_inject(jnp.asarray(fine), coarse_shape)
    _close(tops.restrict_inject(torch.from_numpy(fine), coarse_shape), want, 0)
    dec = torch.from_numpy(fine[::2].copy())
    _close(tops.restrict_inject_rows_decimated(dec, coarse_shape), want, 0)
    coarse = _field(rng, n // 2)
    _close(tops.prolong_bilinear(torch.from_numpy(coarse), fine.shape),
           jops.prolong_bilinear(jnp.asarray(coarse), fine.shape), 0)


@pytest.mark.parametrize("n", [16, 64])
def test_delta_blocks_match(n):
    """delta_rhs (with and without the lo part), the TwoSum accumulator and
    the hi/lo split."""
    rng = np.random.default_rng(n + 2)
    jl, tl = _levels(n)
    hi, lo = _field(rng, n), _field(rng, n, scale=1e-9)
    jh, jlo = jnp.asarray(hi), jnp.asarray(lo)
    th, tlo = torch.from_numpy(hi), torch.from_numpy(lo)
    _close(tdelta.delta_rhs(tl, th), jdelta.delta_rhs(jl, jh))
    _close(tdelta.delta_rhs(tl, th, tlo), jdelta.delta_rhs(jl, jh, jlo))
    want_hi, want_lo = jdelta._split_hi_lo(jh, jnp.float32)
    got_hi, got_lo = tdelta._split_hi_lo(th, torch.float32)
    _close(got_hi, want_hi, 0)
    _close(got_lo, want_lo, 0)


def test_twosum_accumulate_is_bitwise_f32():
    rng = np.random.default_rng(8)
    hi, lo, d = (_field(rng, 64, np.float32, s) for s in (1.0, 1e-8, 1e-2))
    want = jdelta._accumulate(jnp.asarray(hi), jnp.asarray(lo),
                              jnp.asarray(d), jnp.float64)
    got = tdelta._accumulate(*(torch.from_numpy(x) for x in (hi, lo, d)))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # renormalized: |lo| within half an ulp of hi
    h2, l2 = (x.numpy() for x in got)
    assert (np.abs(l2) <= 0.5 * np.spacing(np.abs(h2))).all()
