"""PyTorch port: the plain versions of K5 (five-band smoother) and K6
(nine-band smoother) against the JAX package's Pallas kernel
(`ops/pallas/smoother.py::fused_rb_sweeps`) in interpret mode (CPU).  The
CUDA kernels themselves are held to these plain versions on the card by
chip_smoke.py.

K5 runs on a Poisson level, K6 on a real Galerkin R·A·P level, in every
flag set of their paths, at nsweeps 1 and 3, and in f64 at 14 (past one
launch of the port's block).  Tolerances: f64 atol 1e-13
(tests/test_pallas.py); f32 atol 5e-7·max|x| (the few-ulp cross-program
contract), with x the output field, or for a residual the rhs whose
cancellation it is.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpcclassmultigridproject_tpu.ops.pallas.smoother as psm
from hpcclassmultigridproject_tpu.core.problem import rotating_velocity
from hpcclassmultigridproject_tpu.mg.levels import build_hierarchy as j_build
from hpcclassmultigridproject_tpu.models.poisson import (
    poisson_level as j_poisson_level,
)
from hpcclassmultigridproject_tpu_torch import interop
from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother

_STATIC = ("n", "h", "dt", "nu", "diag_a", "diag_b")
_FIELDS = ("aa", "bb", "cc", "dd", "ne", "nw", "se", "sw", "diag")
N = 32


@pytest.fixture(autouse=True)
def _interpret_and_threads():
    old_interpret, old_threads = psm.INTERPRET, torch.get_num_threads()
    psm.INTERPRET = True
    torch.set_num_threads(2)
    yield
    psm.INTERPRET = old_interpret
    torch.set_num_threads(old_threads)


def _port_level(level):
    """The port's copy of a JAX banded level, through interop."""
    d = {k: getattr(level, k) for k in _STATIC}
    d.update({k: None if getattr(level, k) is None
              else np.asarray(getattr(level, k)) for k in _FIELDS})
    return interop.level_from_numpy(d, device="cpu")


@functools.cache
def _levels(kind, jdtype):
    """(JAX level, port level): a Poisson level at n=N, or the Galerkin
    level at n=N below a CN level at 2N (tests/test_pallas.py's)."""
    if kind == "poisson":
        jl = j_poisson_level(N, 1.0 / N, jdtype)
    else:
        v1, v2 = rotating_velocity(2 * N, dtype=jdtype)
        jl = j_build(v1, v2, (0.5 / N) / 10, -4e-4, 2, dtype=jdtype,
                     coarse_operator="galerkin", restriction="full")[1]
    return jl, _port_level(jl)


def _field(rng, shape, n, jdtype, scale=1.0):
    x = np.zeros(shape)
    x[1:n, 1:n] = scale * rng.standard_normal((n - 1, n - 1))
    return x.astype(np.dtype(jdtype))


def _close(got, want, jdtype, scale):
    atol = 1e-13 if jdtype == jnp.float64 else 5e-7 * scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


FLAGS = {
    "zero_init_res": dict(want_residual=True, zero_init=True),
    "zero_init_res_dec": dict(want_residual=True, zero_init=True,
                              residual_rows_decimated=True),
    "corr": dict(corr=True),
    "u_res": dict(want_residual=True),
}


@pytest.mark.parametrize("jdtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nsweeps", [1, 3])
@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("kind,form", [("poisson", "five"),
                                       ("galerkin", "nine")])
def test_banded_smoother_plain_matches_pallas(kind, form, flags, nsweeps,
                                              jdtype):
    jl, tl = _levels(kind, jdtype)
    assert tl.form == form and tl.v1 is None
    rng = np.random.default_rng(nsweeps)
    shape = jl.padded
    u, rhs, corr = (_field(rng, shape, jl.n, jdtype, s)
                    for s in (1.0, 1.0, 1e-2))
    kw = dict(FLAGS[flags])
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("corr", False):
        jkw["corr"], tkw["corr"] = jnp.asarray(corr), torch.from_numpy(corr)
    want = psm.fused_rb_sweeps(jl, jnp.asarray(u), jnp.asarray(rhs), nsweeps,
                               **jkw)
    got = smoother.fused_rb_sweeps(tl, torch.from_numpy(u),
                                   torch.from_numpy(rhs), nsweeps, **tkw)
    _close(got[0], want[0], jdtype, np.abs(np.asarray(want[0])).max())
    if kw.get("want_residual"):
        assert got[1].shape == want[1].shape
        _close(got[1], want[1], jdtype,
               max(np.abs(rhs).max(), np.abs(np.asarray(want[1])).max()))
    else:
        assert got[1] is None


def test_banded_smoother_counts_no_launch_on_cpu():
    _, tl = _levels("galerkin", jnp.float32)
    rhs = torch.zeros(tl.padded)
    cuda.reset_launches()
    smoother.fused_rb_sweeps(tl, None, rhs, 3, True, zero_init=True)
    assert all(v == 0 for v in cuda.LAUNCHES.values())


@pytest.mark.parametrize("kind,form", [("poisson", "five"),
                                       ("galerkin", "nine")])
def test_banded_smoother_plain_matches_pallas_at_14_sweeps(kind, form):
    """nsweeps 14, past the 13 one launch of the port's block takes (the
    wrapper chains K5 and K6 there, as K2): the Pallas kernel runs it in one
    call, and the port's plain version, which the chain equals, matches it
    in f64 from u + corr with the residual."""
    jl, tl = _levels(kind, jnp.float64)
    assert tl.form == form
    rng = np.random.default_rng(14)
    u, rhs, corr = (_field(rng, jl.padded, jl.n, jnp.float64, s)
                    for s in (1.0, 1.0, 1e-2))
    want = psm.fused_rb_sweeps(jl, jnp.asarray(u), jnp.asarray(rhs), 14,
                               want_residual=True, corr=jnp.asarray(corr))
    got = smoother.fused_rb_sweeps(tl, torch.from_numpy(u),
                                   torch.from_numpy(rhs), 14, True,
                                   corr=torch.from_numpy(corr))
    _close(got[0], want[0], jnp.float64, None)
    _close(got[1], want[1], jnp.float64, None)
