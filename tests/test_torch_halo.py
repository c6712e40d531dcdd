"""PyTorch port: the explicit halo smoothing of a 2-D block
(parallel/halo.py), the counterpart of tests/test_halo.py.

The ranks are spawned processes over gloo on the CPU (W=2: a 1x2 mesh,
columns split; W=4: 2x2, both axes split), each smoothing its block of
the same fields, made from one numpy seed; rank 0 hands back the
gathered results.  This module imports jax only inside the tests, so the
spawned ranks import torch and numpy alone.

Bounds: the port's single-device `rb_gauss_seidel` / `residual` to the
bit (every expression keeps their order), the JAX package's
`pops.rb_gauss_seidel` at atol 1e-14 in float64, the norm (ranks' sums
added in rank order) within rel 1e-14 of the single-device norm, and the
overlapped sweep equal to the plain one to the bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu_torch.core.layout import pad_field
from hpcclassmultigridproject_tpu_torch.mg.levels import build_fine_level
from hpcclassmultigridproject_tpu_torch.models.poisson import (
    build_poisson_hierarchy,
)
from hpcclassmultigridproject_tpu_torch.ops import padded as P
from hpcclassmultigridproject_tpu_torch.parallel import (
    Mesh,
    fetch,
    launch_local,
    level_shardings_for_ns,
    make_global,
    make_mesh,
    smooth_distributed,
)

N = 64
SEED = 21
# name: (nsweeps, want_residual, overlap)
RUNS = {
    "sweeps": (3, False, False),
    "sweeps overlapped": (3, False, True),
    "residual": (1, True, False),
    "residual overlapped": (1, True, True),
}


def _fields(n=N, seed=SEED):
    """(v1, v2, u, rhs) as numpy float64, u and rhs zero on the boundary
    ring: tests/test_halo.py's `_setup`."""
    rng = np.random.default_rng(seed)
    shape = (n + 1, n + 1)
    v1, v2 = rng.standard_normal(shape), rng.standard_normal(shape)
    u, rhs = rng.standard_normal(shape), rng.standard_normal(shape)
    for x in (u, rhs):
        x[0, :] = x[-1, :] = x[:, 0] = x[:, -1] = 0.0
    return v1, v2, u, rhs


def _port(form="from_v"):
    """The port's level (from_v, or the five-band Poisson level 0) and the
    padded u, rhs, float64 on the CPU."""
    v1, v2, u, rhs = _fields()
    if form == "from_v":
        level = build_fine_level(v1, v2, (1.0 / N) / 10, -4e-4,
                                 dtype=torch.float64, device="cpu")
    else:
        level = build_poisson_hierarchy(N, 1, dtype=torch.float64,
                                        device="cpu")[0]
    as_t = lambda x: pad_field(torch.from_numpy(x))
    return level, as_t(u), as_t(rhs)


def rank_halo():
    """One rank: every run of RUNS on its block of the from_v level, and
    the plain sweeps on the five-band one; the results gathered whole."""
    torch.set_num_threads(1)
    mesh = make_mesh()
    out = {}
    for form in ("from_v", "five"):
        level, u, rhs = _port(form)
        (part,) = level_shardings_for_ns([N], mesh, 1, "2d")
        ub, rb = make_global(u, part), make_global(rhs, part)
        runs = RUNS if form == "from_v" else {"sweeps": RUNS["sweeps"]}
        for name, (nsweeps, want_residual, overlap) in runs.items():
            got = smooth_distributed(mesh, level, ub, rb, nsweeps,
                                     want_residual, overlap)
            if want_residual:
                u1, res, norm = got
                out[form, name] = (fetch(u1, part).numpy(),
                                   fetch(res, part).numpy(), float(norm))
            else:
                out[form, name] = (fetch(got, part).numpy(),)
    return out


@pytest.fixture(scope="module")
def spawned():
    """{world: {(form, run): results}} from one spawn per world size."""
    return {w: launch_local(rank_halo, w) for w in (2, 4)}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.cache
def _single(form, nsweeps, want_residual):
    """The port's single-device sweeps (and residual, norm)."""
    level, u, rhs = _port(form)
    for _ in range(nsweeps):
        u = P.rb_gauss_seidel(level, u, rhs)
    if not want_residual:
        return (u.numpy(),)
    res = P.residual(level, u, rhs)
    return u.numpy(), res.numpy(), float(P.interior_norm(res))


@functools.cache
def _jax(nsweeps, want_residual):
    """The JAX package's single-device `pops` on the same fields."""
    import jax.numpy as jnp

    from hpcclassmultigridproject_tpu.core.layout import pad_field as j_pad
    from hpcclassmultigridproject_tpu.mg.levels import (
        build_fine_level as j_fine,
    )
    from hpcclassmultigridproject_tpu.ops import padded as pops

    v1, v2, u, rhs = _fields()
    level = j_fine(jnp.asarray(v1), jnp.asarray(v2), (1.0 / N) / 10, -4e-4,
                   dtype=jnp.float64)
    u, rhs = j_pad(jnp.asarray(u)), j_pad(jnp.asarray(rhs))
    for _ in range(nsweeps):
        u = pops.rb_gauss_seidel(level, u, rhs)
    if not want_residual:
        return (np.asarray(u),)
    res = pops.residual(level, u, rhs)
    return np.asarray(u), np.asarray(res), float(pops.interior_norm(res))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_halo_sweeps_match_single_device(spawned, world, overlap):
    """Three sweeps: bitwise the port's single-device sweeps, within
    1e-14 of the JAX package's."""
    (u,) = spawned[world]["from_v",
                          "sweeps overlapped" if overlap else "sweeps"]
    (want,) = _single("from_v", 3, False)
    assert np.array_equal(u, want), np.abs(u - want).max()
    np.testing.assert_allclose(u, _jax(3, False)[0], rtol=0, atol=1e-14)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_halo_residual_and_norm_match(spawned, world, overlap):
    """One sweep and the residual: u and the residual bitwise the port's
    single-device ones and within 1e-14 of the JAX package's; the norm,
    the same on every rank, within rel 1e-14."""
    u, res, norm = spawned[world][
        "from_v", "residual overlapped" if overlap else "residual"]
    want_u, want_r, want_n = _single("from_v", 1, True)
    assert np.array_equal(u, want_u) and np.array_equal(res, want_r)
    ju, jr, jn = _jax(1, True)
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-14)
    np.testing.assert_allclose(res, jr, rtol=0, atol=1e-14)
    assert norm == pytest.approx(want_n, rel=1e-14)
    assert norm == pytest.approx(jn, rel=1e-14)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_overlapped_sweep_equals_plain(spawned, world):
    got = spawned[world]
    assert np.array_equal(got["from_v", "sweeps overlapped"][0],
                          got["from_v", "sweeps"][0])
    for a, b in zip(got["from_v", "residual overlapped"],
                    got["from_v", "residual"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_five_band_level_matches(spawned, world):
    """A stored five-band (Poisson) level: bitwise the single-device
    sweeps."""
    (u,) = spawned[world]["five", "sweeps"]
    assert np.array_equal(u, _single("five", 3, False)[0])


def test_halo_on_one_rank_equals_single_device():
    """One rank, no process group: the whole field is the block, every
    halo line zero, and both sweeps equal the single-device ones."""
    level, u, rhs = _port()
    want_u, want_r, want_n = _single("from_v", 1, True)
    for overlap in (False, True):
        got_u, got_r, got_n = smooth_distributed(Mesh(1), level, u, rhs, 1,
                                                 True, overlap)
        assert torch.equal(got_u, torch.from_numpy(want_u))
        assert torch.equal(got_r, torch.from_numpy(want_r))
        assert float(got_n) == want_n


def test_halo_rejects_9pt():
    """Nine-band levels raise, as in the JAX package."""
    level, u, rhs = _port()
    c = P.coefs(level)
    nine = dataclasses.replace(level, v1=None, v2=None, aa=c.aa, bb=c.bb,
                               cc=c.cc, dd=c.dd, ne=c.aa, nw=c.aa, se=c.aa,
                               sw=c.aa, diag=torch.ones_like(c.aa))
    with pytest.raises(NotImplementedError, match="5-point levels only"):
        smooth_distributed(Mesh(1), nine, u, rhs)
