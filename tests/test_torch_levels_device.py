"""PyTorch port: the on-device model build (core/problem.py's generators,
mg/levels.py::build_hierarchy_device and build_fine_level_device) and the
model born row-partitioned, against the port's host build and the JAX
package's device build (CPU, x64), the counterpart of
tests/test_levels_device.py.

Tolerances are the JAX package's (tests/test_levels_device.py): sin, cos
and exp of torch and of numpy may differ by an ulp, so the builds agree to
the ulp, not to the bit: float32 fields rtol 1e-6 / atol 1e-7, float64
fields rtol 1e-14 / atol 1e-15, u0 rtol 1e-13 / atol 1e-300 (exp amplifies
an argument's ulp by up to |σ·r²| ≈ 70), the dense inverse rtol 1e-5 /
atol 1e-6, and a device-built model's uT rtol 1e-5 / atol 1e-10 after 5
delta steps.  A row window is held to the whole build at the same
tolerances: on the CPU torch's vectorised sin may round an element in a
loop's tail differently (on the card each element goes through one device
function, and chip_smoke.py asks for the bits).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu.core import problem as j_problem
from hpcclassmultigridproject_tpu.mg import levels as j_levels
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.core import problem
from hpcclassmultigridproject_tpu_torch.core.layout import pad_field, padded_shape
from hpcclassmultigridproject_tpu_torch.mg import levels
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.models import advection_diffusion
from hpcclassmultigridproject_tpu_torch.models.advection_diffusion import (
    use_device_build,
)
from hpcclassmultigridproject_tpu_torch.parallel import (
    Mesh,
    make_global,
    shard_hierarchy,
    shard_level_data,
)

N, DT, NU = 64, 0.1 / 64, -4e-4
TOL = {torch.float32: dict(rtol=1e-6, atol=1e-7),
       torch.float64: dict(rtol=1e-14, atol=1e-15)}
U0_TOL = dict(rtol=1e-13, atol=1e-300)
A_INV_TOL = dict(rtol=1e-5, atol=1e-6)
_JDTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
_DELTA = dict(tol=1e-6, cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
              delta_form=True, num_levels=3)
_STATIC = ("n", "h", "dt", "nu", "diag_a", "diag_b")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tol)


def _delta(**kw):
    return SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                        **_DELTA, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_hierarchy_matches_host_and_jax(dtype):
    """n=64, 3 levels, dense coarse: every level's (v1, v2) and the dense
    inverse against the port's host build and JAX's device build."""
    v1, v2 = problem.rotating_velocity(N, dtype=dtype, device="cpu")
    host = levels.build_hierarchy(v1, v2, DT, NU, 3, dtype=dtype,
                                  device="cpu", coarse_mode="dense")
    dev = levels.build_hierarchy_device(N, np.pi, np.pi, DT, NU, 3,
                                        dtype=dtype, device="cpu",
                                        coarse_mode="dense")
    jax_dev = j_levels.build_hierarchy_device(
        N, np.pi, np.pi, DT, NU, 3, dtype=_JDTYPE[dtype], coarse_mode="dense")
    assert len(dev) == len(host) == len(jax_dev) == 3
    for lh, ld, lj in zip(host, dev, jax_dev):
        assert ld.form == "from_v" and ld.row_off == 0
        assert ld.v1.dtype == dtype and ld.padded == lh.padded
        for k in _STATIC:
            assert getattr(ld, k) == getattr(lh, k) == getattr(lj, k), k
        for f in ("v1", "v2"):
            _close(getattr(ld, f), getattr(lh, f), TOL[dtype], f"n={ld.n} {f}")
            _close(getattr(ld, f), getattr(lj, f), TOL[dtype], f"n={ld.n} {f}")
    assert all(level.a_inv is None for level in dev[:-1])
    assert dev[-1].a_inv.dtype == dtype
    _close(dev[-1].a_inv, host[-1].a_inv, A_INV_TOL)
    _close(dev[-1].a_inv, jax_dev[-1].a_inv, A_INV_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_fine_level_and_u0_match_host_and_jax(dtype):
    """The slim fine level and the padded u0 against their host twins and
    JAX's device build."""
    v1, v2 = problem.rotating_velocity(N, dtype=dtype, device="cpu")
    host = levels.build_fine_level(v1, v2, DT, NU, dtype=dtype, device="cpu")
    dev = levels.build_fine_level_device(N, np.pi, np.pi, DT, NU,
                                         dtype=dtype, device="cpu")
    jax_dev = j_levels.build_fine_level_device(
        N, np.pi, np.pi, DT, NU, dtype=_JDTYPE[dtype],
        store_coefficients=False)
    assert dev.form == "from_v" and dev.a_inv is None and dev.row_off == 0
    for k in _STATIC:
        assert getattr(dev, k) == getattr(host, k) == getattr(jax_dev, k), k
    for f in ("v1", "v2"):
        _close(getattr(dev, f), getattr(host, f), TOL[dtype], f)
        _close(getattr(dev, f), getattr(jax_dev, f), TOL[dtype], f)
    u0_host = pad_field(problem.gaussian_u0(N, dtype=dtype, device="cpu"))
    u0_dev = problem.gaussian_u0_padded_device(N, dtype=dtype, device="cpu")
    u0_jax = j_problem.gaussian_u0_padded_device(N, dtype=_JDTYPE[dtype])
    assert u0_dev.dtype == dtype and u0_dev.shape == u0_host.shape
    tol = U0_TOL if dtype == torch.float64 else TOL[dtype]
    _close(u0_dev, u0_host, tol)
    _close(u0_dev, u0_jax, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cn_coefficients_match_jax(dtype):
    """cn_coefficients and cn_coefficients_padded on seeded velocities, in
    the velocities' dtype, against the JAX package's."""
    n, h = 16, 1.0 / 16
    rng = np.random.default_rng(11)
    v = rng.standard_normal((2, n + 1, n + 1)).astype(np.dtype(str(dtype)[6:]))
    vp = [np.pad(x, ((0, padded_shape(n)[0] - n - 1),
                     (0, padded_shape(n)[1] - n - 1))) for x in v]
    got = problem.cn_coefficients(*map(torch.from_numpy, v), DT, NU, h)
    want = j_problem.cn_coefficients(*map(jnp.asarray, v), DT, NU, h)
    got_p = problem.cn_coefficients_padded(*map(torch.from_numpy, vp), n, DT,
                                           NU, h)
    want_p = j_problem.cn_coefficients_padded(*map(jnp.asarray, vp), n, DT,
                                              NU, h)
    for g, w in ((got, want), (got_p, want_p)):
        assert (g.diag_a, g.diag_b) == (w.diag_a, w.diag_b)
        for k in ("aa", "bb", "cc", "dd"):
            assert getattr(g, k).shape == getattr(w, k).shape
            _close(getattr(g, k), getattr(w, k), TOL[dtype], k)
    assert float(got_p.aa[0].abs().max()) == 0.0  # boundary row masked


def test_row_window_takes_any_rows():
    """A window from below row 0 to past the padded rows: rows outside the
    logical grid are 0, the others the whole build's rows."""
    shape = padded_shape(N)
    rows = (-5, shape[0] + 7)
    whole = problem.rotating_velocity_trace(N, np.pi, np.pi, shape,
                                            dtype=torch.float64, device="cpu")
    part = problem.rotating_velocity_trace(N, np.pi, np.pi, shape,
                                           dtype=torch.float64, device="cpu",
                                           rows=rows)
    u0_whole = problem.gaussian_u0_padded_device(N, dtype=torch.float64,
                                                 device="cpu")
    u0_part = problem.gaussian_u0_padded_device(N, dtype=torch.float64,
                                                device="cpu", rows=rows)
    for got, want in zip((*part, u0_part), (*whole, u0_whole)):
        assert got.shape == (shape[0] + 12, shape[1])
        # rows -5 .. -1, where sin(kx·x) is not 0: only the mask zeroes them
        assert float(got[:5].abs().max()) == 0.0
        assert float(got[5 + N + 1:].abs().max()) == 0.0  # rows past n
        _close(got[5:5 + shape[0]], want, TOL[torch.float64])
    lone = problem.rotating_velocity_trace(N, np.pi, np.pi, shape,
                                           dtype=torch.float64, device="cpu",
                                           rows=(N - 1, N + 2))
    assert float(lone[1][:2].abs().max()) > 0 and float(
        lone[1][2].abs().max()) == 0.0


@pytest.mark.parametrize("rank", range(4))
def test_born_partitioned_rows_equal_the_cut_whole_build(rank):
    """Every rank of a hand-built Mesh(world=4, rank=k) at n=128,
    min_local 16: each level, fine_hi and u0 equal shard_level_data /
    make_global of the whole device build, row_off included."""
    p = ProblemConfig(n=128, num_steps=1)
    s = _delta(device_build=True)
    whole = AdvectionDiffusion(p, s, device="cpu")
    mesh = Mesh(4, rank)
    born = AdvectionDiffusion(p, s, device="cpu", mesh=mesh, min_local=16)
    cut, shardings = shard_hierarchy(whole.levels, mesh, 16, "rows",
                                     nsweeps=s.niter)
    assert born.shardings == shardings and born.mesh == mesh
    assert [q is not None for q in shardings] == [True, True, False]
    for got, want in zip(born.levels, cut):
        assert got.row_off == want.row_off and got.padded == want.padded
        for f in ("v1", "v2"):
            _close(getattr(got, f), getattr(want, f), TOL[torch.float32], f)
    _close(born.levels[-1].a_inv, whole.levels[-1].a_inv, A_INV_TOL)
    hi = shard_level_data(whole.fine_hi, shardings[0])
    assert born.fine_hi.row_off == hi.row_off
    for f in ("v1", "v2"):
        _close(getattr(born.fine_hi, f), getattr(hi, f), TOL[torch.float64])
    _close(born.u0, make_global(whole.u0, shardings[0]), U0_TOL)


def test_born_partitioned_build_never_calls_the_host_build(monkeypatch):
    """The host constructors poisoned: each rank's partitioned levels hold
    its local + 2·halo rows, fine_hi too, u0 its local rows, and the
    replicated levels are whole; no rank holds a whole level 0."""
    def boom(*a, **k):
        raise AssertionError("host build called in the device build")

    for module, names in (
            (problem, ("_node_coords", "rotating_velocity", "gaussian_u0")),
            (levels, ("_np_pad_field", "build_hierarchy")),
            (advection_diffusion, ("rotating_velocity", "gaussian_u0",
                                   "build_hierarchy", "build_fine_level"))):
        for name in names:
            monkeypatch.setattr(module, name, boom)
    p = ProblemConfig(n=128, num_steps=1)
    for rank in (0, 3):
        m = AdvectionDiffusion(p, _delta(), device="cpu", mesh=Mesh(4, rank),
                               min_local=16)
        for level, part in zip(m.levels, m.shardings):
            rows = level.padded[0]
            if part is None:
                assert rows == padded_shape(level.n)[0] and not level.row_off
            else:
                assert rows == part.local + 2 * part.halo < padded_shape(
                    level.n)[0]
        part = m.shardings[0]
        assert m.fine_hi.padded[0] == part.local + 2 * part.halo
        assert m.u0.shape == part.shape
    whole = AdvectionDiffusion(p, _delta(device_build=True), device="cpu")
    assert whole.levels[0].padded == padded_shape(128)


def test_device_built_model_runs_like_host_and_jax():
    """n=64, 5 delta steps: the device-built model against the host-built
    one and JAX's device-built one (rtol 1e-5 / atol 1e-10: the operators
    differ at the ulp of sin/cos), final certificate <= 1e-6."""
    from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
    from hpcclassmultigridproject_tpu import SolverConfig as JSolver
    from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel

    p = ProblemConfig(n=N, num_steps=5)
    dev = AdvectionDiffusion(p, _delta(device_build=True), device="cpu")
    host = AdvectionDiffusion(p, _delta(device_build=False), device="cpu")
    jm = JModel(JProblem(n=N, num_steps=5),
                JSolver(dtype=jnp.float32, refine_dtype=jnp.float64,
                        device_build=True, **_DELTA))
    uT_d, st_d = dev.run(warn=False)
    uT_h, _ = host.run(warn=False)
    uT_j, _ = jm.run(warn=False)
    _close(uT_d, uT_h, dict(rtol=1e-5, atol=1e-10))
    _close(uT_d, uT_j, dict(rtol=1e-5, atol=1e-10))
    assert float(st_d["final_rel_residual_hi"]) <= 1e-6
    assert bool((st_d["rel_residual"] <= 1e-6).all())


@pytest.mark.parametrize("n,kw,device,notice", [
    (4096, {}, True, True),                         # auto: the device, said
    (2048, {}, False, False),                       # auto: the host
    (4096, dict(coarse_operator="galerkin"), False, False),
    (4096, dict(device_build=False), False, False),
    (64, dict(device_build=True), True, False),
])
def test_build_choice_and_its_one_notice(n, kw, device, notice):
    """The JAX package's auto rule (the device from n=4096 with
    rediscretized levels), with one warning naming n where auto picks the
    device, which the JAX package does silently."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        assert use_device_build(ProblemConfig(n=n), SolverConfig(**kw)) is device
    said = [str(w.message) for w in got]
    assert len(said) == int(notice)
    if notice:
        assert f"n={n}" in said[0] and "device" in said[0]


@pytest.mark.parametrize("case", ["galerkin", "mesh_host_build", "layout_2d"])
def test_device_build_refusals(case):
    """Galerkin levels on the device and a mesh with the host build forced
    raise ValueError, as in the JAX package, in the 2-D layout too; an
    unknown layout raises ValueError."""
    p = ProblemConfig(n=64, num_steps=1)
    if case == "galerkin":
        with pytest.raises(ValueError, match="rediscretize"):
            AdvectionDiffusion(p, _delta(device_build=True,
                                         coarse_operator="galerkin"),
                               device="cpu")
        with pytest.raises(ValueError, match="rediscretize"):
            levels.build_hierarchy_device(N, np.pi, np.pi, DT, NU, 3,
                                          dtype=torch.float32, device="cpu",
                                          coarse_operator="galerkin")
    elif case == "mesh_host_build":
        with pytest.raises(ValueError, match="device build"):
            AdvectionDiffusion(p, _delta(device_build=False), device="cpu",
                               mesh=Mesh(2))
    else:
        with pytest.raises(ValueError, match="device build"):
            AdvectionDiffusion(p, _delta(device_build=False), device="cpu",
                               mesh=Mesh(2), layout="2d")
        with pytest.raises(ValueError, match="unknown layout"):
            AdvectionDiffusion(p, _delta(), device="cpu", mesh=Mesh(2),
                               layout="cols")


def test_born_partitioned_run_refuses_another_partitioning():
    """distributed_run of a model born row-partitioned refuses a mesh,
    min_local or layout other than the model's, before any collective
    (the JAX package ignores layout and min_local there)."""
    from hpcclassmultigridproject_tpu_torch.parallel import distributed_run

    m = AdvectionDiffusion(ProblemConfig(n=64, num_steps=1), _delta(),
                           device="cpu", mesh=Mesh(2, 1), min_local=16)
    for kw in (dict(mesh=Mesh(4, 1)), dict(mesh=Mesh(2, 0)),
               dict(min_local=64), dict(min_local=8), dict(layout="2d")):
        with pytest.raises(ValueError, match="row-partitioned"):
            distributed_run(m, **kw)
    # its own partitioning passes the checks and reaches the first
    # collective, which a hand-built view of two ranks cannot run
    with pytest.raises((RuntimeError, ValueError), match="process group"):
        distributed_run(m, Mesh(2, 1), min_local=16, layout="rows")
