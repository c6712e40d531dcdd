"""PyTorch port: the Poisson model family (models/poisson.py) against the JAX
package's on the CPU: multigrid (adaptive, fixed and FMG) and the GS
iteration in f64, with equal cycle and sweep counts, and the float32
default that stalls without converging in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.models import Poisson as JPoisson
from hpcclassmultigridproject_tpu_torch import SolverConfig, interop
from hpcclassmultigridproject_tpu_torch.models import Poisson

_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
_STATIC = ("n", "h", "dt", "nu", "diag_a", "diag_b")


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _models(n, f=None, **kw):
    jdtype = kw.pop("dtype", jnp.float64)
    j = JPoisson(n=n, f=None if f is None else f[0],
                 solver=JSolver(dtype=jdtype, **kw))
    t = Poisson(n=n, f=None if f is None else f[1],
                solver=SolverConfig(dtype=_DTYPES[jdtype], **kw),
                device="cpu")
    return j, t


_F64 = dict(tol=1e-10, restriction="full", coarse_mode="dense")


@pytest.mark.parametrize("n,kw", [
    (32, dict(_F64, num_levels=2)),
    (64, dict(_F64)),
    (64, dict(_F64, cycle_shape=2, num_levels=3)),
    (64, dict(_F64, cycle_mode="fixed", num_cycles=5, num_levels=3)),
    (64, dict(_F64, cycle_mode="fmg", num_cycles=2, num_levels=3)),
])
def test_mg_matches_jax_f64(n, kw):
    jm, tm = _models(n, **kw)
    np.testing.assert_array_equal(tm.rhs.numpy(), np.asarray(jm.rhs))
    ju, jst = jm.solve()
    tu, tst = tm.solve()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-12)
    assert int(tst["cycles"]) == int(jst["cycles"])
    assert bool(tst["converged"]) == bool(jst["converged"])
    assert float(tst["rel_residual"]) == pytest.approx(
        float(jst["rel_residual"]), rel=1e-3)


def test_manufactured_rhs_matches_jax():
    """f takes the node coordinates: the same f in each framework."""
    jf = lambda x, y: 2 * np.pi ** 2 * jnp.sin(np.pi * x) * jnp.sin(np.pi * y)
    tf = lambda x, y: (2 * np.pi ** 2 * torch.sin(np.pi * x)
                       * torch.sin(np.pi * y))
    jm, tm = _models(32, f=(jf, tf), **_F64, num_levels=2)
    np.testing.assert_allclose(tm.rhs.numpy(), np.asarray(jm.rhs), rtol=0,
                               atol=1e-12)
    ju, _ = jm.solve()
    tu, _ = tm.solve()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-12)


def test_gs_matches_jax_f64():
    jm, tm = _models(32, **_F64, num_levels=2)
    ju, jst = jm.solve("gs", check_every=50)
    tu, tst = tm.solve("gs", check_every=50)
    assert int(tst["iters"]) == int(jst["iters"])
    assert float(tst["rel_residual"]) <= 1e-10
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-12)


def test_f32_default_does_not_converge_like_jax():
    """Poisson's default solver in float32 stalls at max_cycles in both
    packages (the f32 residual floor of the Laplacian lies above tol)."""
    jm = JPoisson(n=32)
    tm = Poisson(n=32, device="cpu")
    assert tm.solver == Poisson.DEFAULT_SOLVER
    assert [l.form for l in tm.levels] == ["five"]
    ju, jst = jm.solve()
    tu, tst = tm.solve()
    assert int(jst["cycles"]) == int(tst["cycles"]) == 50
    assert not bool(jst["converged"]) and not bool(tst["converged"])
    assert tu.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=5e-7 * float(np.abs(ju).max()))


def test_poisson_levels_store_only_bands_and_cross_interop():
    """Levels are five-band with no velocity fields; a JAX Poisson level
    crosses interop with its bands bitwise, and the port drops its zero
    velocities."""
    jm, tm = _models(64, **_F64, num_levels=3)
    for jl, tl in zip(jm.levels, tm.levels):
        assert tl.form == "five" and tl.v1 is None and tl.v2 is None
        d = {k: getattr(jl, k) for k in _STATIC}
        d.update({k: np.asarray(getattr(jl, k)) for k in
                  ("aa", "bb", "cc", "dd", "v1", "v2")})
        if jl.a_inv is not None:
            d["a_inv"] = np.asarray(jl.a_inv)
        got = interop.level_from_numpy(d, device="cpu")
        assert got.form == "five" and got.v1 is None
        for k in ("aa", "bb", "cc", "dd"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), d[k])
            np.testing.assert_array_equal(getattr(tl, k).numpy(), d[k])
        assert {k: getattr(tl, k) for k in _STATIC} == {
            k: d[k] for k in _STATIC}
    np.testing.assert_allclose(tm.levels[-1].a_inv.numpy(),
                               np.asarray(jm.levels[-1].a_inv), rtol=0,
                               atol=1e-12)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Poisson(n=16, device="cuda")
