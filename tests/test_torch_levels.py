"""PyTorch port: the level hierarchy and the interop layer against the JAX
package's host build (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.mg.levels import build_fine_level as j_fine
from hpcclassmultigridproject_tpu.mg.levels import build_hierarchy as j_build
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch import interop
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    build_fine_level,
    build_hierarchy,
)
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
_STATIC = ("n", "h", "dt", "nu", "diag_a", "diag_b")


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _level_dict(level):
    """The JAX level's fields as numpy arrays and numbers."""
    d = {k: getattr(level, k) for k in _STATIC}
    d["v1"], d["v2"] = np.asarray(level.v1), np.asarray(level.v2)
    d["a_inv"] = None if level.a_inv is None else np.asarray(level.a_inv)
    return d


def _velocities(n, seed, jdtype):
    v = np.random.default_rng(seed).standard_normal((2, n + 1, n + 1))
    return v.astype(np.dtype(jdtype))


@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("n,num_levels", [(64, 3), (128, 4)])
def test_hierarchy_matches_jax_build(jdtype, n, num_levels):
    """v1/v2 bitwise on every level; the coarsest dense inverse bitwise in
    f32 (same rounding of the coefficients before the f64 inversion) and
    to 1e-12 in f64."""
    v1, v2 = _velocities(n, 5, jdtype)
    dt, nu = 0.1 / n, -4e-4
    jl = j_build(jnp.asarray(v1), jnp.asarray(v2), dt, nu, num_levels,
                 dtype=jdtype, coarse_mode="dense")
    tl = build_hierarchy(v1, v2, dt, nu, num_levels, dtype=_DTYPES[jdtype],
                         device="cpu", coarse_mode="dense")
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        assert b.v1.dtype == _DTYPES[jdtype]
        np.testing.assert_array_equal(b.v1.numpy(), np.asarray(a.v1))
        np.testing.assert_array_equal(b.v2.numpy(), np.asarray(a.v2))
        assert b.padded == a.padded
        for k in _STATIC:
            assert getattr(b, k) == getattr(a, k), k
    assert all(l.a_inv is None for l in tl[:-1])
    want = np.asarray(jl[-1].a_inv)
    if jdtype == jnp.float32:
        np.testing.assert_array_equal(tl[-1].a_inv.numpy(), want)
    else:
        np.testing.assert_allclose(tl[-1].a_inv.numpy(), want, rtol=0,
                                   atol=1e-12)


def test_fine_level_is_slim_and_matches():
    v1, v2 = _velocities(64, 9, jnp.float64)
    jl = j_fine(jnp.asarray(v1), jnp.asarray(v2), 1 / 640, -4e-4,
                dtype=jnp.float64)
    tl = build_fine_level(v1, v2, 1 / 640, -4e-4, dtype=torch.float64,
                          device="cpu")
    np.testing.assert_array_equal(tl.v1.numpy(), np.asarray(jl.v1))
    np.testing.assert_array_equal(tl.v2.numpy(), np.asarray(jl.v2))
    assert tl.a_inv is None and tl.form == "from_v" and tl.aa is None
    for k in _STATIC:
        assert getattr(tl, k) == getattr(jl, k), k


def _delta_cfgs(**kw):
    base = dict(tol=1e-6, cycle_mode="fixed", num_cycles=1,
                coarse_mode="dense", delta_form=True, num_levels=3, **kw)
    return (JSolver(dtype=jnp.float32, refine_dtype=jnp.float64, **base),
            SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                         **base))


def test_model_builds_the_jax_models_state():
    """AdvectionDiffusion builds the same levels, fine operator and u0 as
    the JAX model (the velocity cast to f32 before the host build
    included)."""
    jc, tc = _delta_cfgs()
    jm = JModel(JProblem(n=64, num_steps=1), jc)
    tm = AdvectionDiffusion(ProblemConfig(n=64, num_steps=1), tc,
                            device="cpu")
    for a, b in zip(jm.levels, tm.levels):
        np.testing.assert_array_equal(b.v1.numpy(), np.asarray(a.v1))
        np.testing.assert_array_equal(b.v2.numpy(), np.asarray(a.v2))
    np.testing.assert_array_equal(tm.levels[-1].a_inv.numpy(),
                                  np.asarray(jm.levels[-1].a_inv))
    np.testing.assert_array_equal(tm.fine_hi.v1.numpy(),
                                  np.asarray(jm.fine_hi.v1))
    np.testing.assert_array_equal(tm.u0.numpy(), np.asarray(jm.u0))
    assert tm.num_levels == jm.num_levels


def test_interop_round_trips_jax_state():
    jc, _ = _delta_cfgs()
    jm = JModel(JProblem(n=64, num_steps=1), jc)
    dicts = [_level_dict(l) for l in jm.levels]
    hi_dict = _level_dict(jm.fine_hi)
    levels, fine_hi, u0 = interop.levels_from_numpy(
        dicts, hi_dict, np.asarray(jm.u0), device="cpu", dtype=torch.float32)
    for d, level in zip(dicts + [hi_dict], levels + (fine_hi,)):
        np.testing.assert_array_equal(level.v1.numpy(), d["v1"])
        np.testing.assert_array_equal(level.v2.numpy(), d["v2"])
        assert str(level.v1.dtype) == f"torch.{d['v1'].dtype}"
        if d["a_inv"] is None:
            assert level.a_inv is None
        else:
            np.testing.assert_array_equal(level.a_inv.numpy(), d["a_inv"])
        assert {k: getattr(level, k) for k in _STATIC} == {
            k: d[k] for k in _STATIC}
    assert u0.dtype == torch.float64
    np.testing.assert_array_equal(u0.numpy(), np.asarray(jm.u0))


def test_hierarchy_too_deep_raises():
    v1, v2 = _velocities(8, 1, jnp.float64)
    with pytest.raises(ValueError, match="too deep"):
        build_hierarchy(v1, v2, 0.01, -4e-4, 4, dtype=torch.float64,
                        device="cpu")


def test_interop_carries_galerkin_bands():
    """A JAX Galerkin hierarchy crosses interop: the fine level as from_v,
    the coarse levels nine-band with their bands, diagonal and dense
    inverse bitwise, no velocities; and equals the port's own build."""
    jc, tc = _delta_cfgs(coarse_operator="galerkin")
    jm = JModel(JProblem(n=64, num_steps=1), jc)
    tm = AdvectionDiffusion(ProblemConfig(n=64, num_steps=1), tc,
                            device="cpu")
    names = ("aa", "bb", "cc", "dd", "ne", "nw", "se", "sw", "diag")
    dicts = [_level_dict(jm.levels[0])]
    for l in jm.levels[1:]:
        d = _level_dict(l)
        d.update({k: np.asarray(getattr(l, k)) for k in names})
        dicts.append(d)
    levels, fine_hi, _ = interop.levels_from_numpy(
        dicts, None, np.asarray(jm.u0), device="cpu", dtype=torch.float32)
    assert fine_hi is None
    assert [l.form for l in levels] == ["from_v", "nine", "nine"]
    for d, got, own in zip(dicts[1:], levels[1:], tm.levels[1:]):
        assert got.v1 is None and got.v2 is None
        for k in names:
            np.testing.assert_array_equal(getattr(got, k).numpy(), d[k])
            np.testing.assert_array_equal(getattr(own, k).numpy(), d[k])
    np.testing.assert_array_equal(levels[-1].a_inv.numpy(), dicts[-1]["a_inv"])
    np.testing.assert_array_equal(tm.levels[-1].a_inv.numpy(),
                                  dicts[-1]["a_inv"])
