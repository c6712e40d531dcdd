"""PyTorch port: the general single-device cycle (mg/cycle.py) against the
JAX package's on the CPU, in f64 at atol 1e-12: V- and W-cycles,
injection and full weighting, dense and GS coarse solves; the adaptive,
fixed and FMG solvers with equal cycle counts; and the two gates that keep
the fused fast paths (the coarse tower, the row-decimated residual) to the
configurations they are exact for.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.core.problem import rotating_velocity
from hpcclassmultigridproject_tpu.mg import cycle as j_cycle
from hpcclassmultigridproject_tpu.mg.levels import build_hierarchy as j_build
from hpcclassmultigridproject_tpu_torch import SolverConfig
from hpcclassmultigridproject_tpu_torch.mg import cycle
from hpcclassmultigridproject_tpu_torch.mg.levels import build_hierarchy

N = 64
_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _setup(jdtype=jnp.float64, n=N, num_levels=3, **kw):
    """JAX and port hierarchies and configs on the reference velocities."""
    v1, v2 = rotating_velocity(n, dtype=jdtype)
    jcfg = JSolver(dtype=jdtype, num_levels=num_levels, **kw)
    tcfg = SolverConfig(dtype=_DTYPES[jdtype], num_levels=num_levels, **kw)
    build_kw = {k: v for k, v in kw.items()
                if k in ("coarse_mode", "coarse_operator", "restriction")}
    jl = j_build(v1, v2, 0.1 / n, -4e-4, num_levels, dtype=jdtype, **build_kw)
    tl = build_hierarchy(np.asarray(v1), np.asarray(v2), 0.1 / n, -4e-4,
                         num_levels, dtype=_DTYPES[jdtype], device="cpu",
                         **build_kw)
    return jl, tl, jcfg, tcfg


def _fields(shape, n, seed, count):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        x = np.zeros(shape)
        x[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
        out.append(x)
    return out


def _close(got, want, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize(
    "shape,restriction,coarse_mode",
    list(itertools.product((1, 2), ("inject", "full"), ("dense", "gs"))))
def test_mg_cycle_matches_jax(shape, restriction, coarse_mode):
    jl, tl, jcfg, tcfg = _setup(cycle_shape=shape, restriction=restriction,
                                coarse_mode=coarse_mode)
    u, rhs = _fields(jl[0].padded, N, shape, 2)
    ju, jr = j_cycle.mg_cycle(jl, jnp.asarray(u), jnp.asarray(rhs), jcfg,
                              want_final_residual=True)
    tu, tr = cycle.mg_cycle(tl, torch.from_numpy(u), torch.from_numpy(rhs),
                            tcfg, want_final_residual=True)
    _close(tu, ju)
    _close(tr, jr)
    # from a zero iterate, without the final residual
    ju0 = j_cycle.mg_cycle(jl, jnp.zeros_like(jnp.asarray(rhs)),
                           jnp.asarray(rhs), jcfg, u_is_zero=True)
    tu0 = cycle.mg_cycle(tl, None, torch.from_numpy(rhs), tcfg,
                         u_is_zero=True)
    _close(tu0, ju0)


@pytest.mark.parametrize("solver,kw", [
    ("mg_solve", dict(tol=1e-12)),
    ("mg_solve", dict(tol=1e-12, cycle_shape=2, restriction="full",
                      coarse_mode="dense")),
    ("mg_solve_fixed", dict(cycle_mode="fixed", num_cycles=2)),
    ("fmg_solve", dict(cycle_mode="fmg", num_cycles=1, coarse_mode="dense")),
    ("fmg_solve", dict(cycle_mode="fmg", num_cycles=2, restriction="full")),
])
def test_solvers_match_jax(solver, kw):
    """Same iterate, relative residual and cycle count; the adaptive
    solver's host loop stops where the JAX while_loop does."""
    jl, tl, jcfg, tcfg = _setup(**kw)
    u, rhs = _fields(jl[0].padded, N, 9, 2)
    ju, jst = getattr(j_cycle, solver)(jl, jnp.asarray(u), jnp.asarray(rhs),
                                       jcfg)
    tu, tst = getattr(cycle, solver)(tl, torch.from_numpy(u),
                                     torch.from_numpy(rhs), tcfg)
    _close(tu, ju)
    assert int(tst["cycles"]) == int(jst["cycles"])
    assert tst["cycles"].dtype == torch.int32
    assert float(tst["rel_residual"]) == pytest.approx(
        float(jst["rel_residual"]), rel=1e-6, abs=1e-15)
    assert bool(tst["converged"]) == bool(jst["converged"])


def test_mg_solve_stops_at_max_cycles_like_jax():
    """A tolerance below reach: both run max_cycles and report not
    converged."""
    jl, tl, jcfg, tcfg = _setup(jnp.float32, tol=1e-12, max_cycles=4,
                                coarse_mode="dense")
    u, rhs = _fields(jl[0].padded, N, 4, 2)
    u, rhs = u.astype(np.float32), rhs.astype(np.float32)
    _, jst = j_cycle.mg_solve(jl, jnp.asarray(u), jnp.asarray(rhs), jcfg)
    _, tst = cycle.mg_solve(tl, torch.from_numpy(u), torch.from_numpy(rhs),
                            tcfg)
    assert int(tst["cycles"]) == int(jst["cycles"]) == 4
    assert not bool(tst["converged"]) and not bool(jst["converged"])


def test_coarse_solve_gs_matches_jax():
    jl, tl, jcfg, tcfg = _setup(coarse_mode="gs")
    bottom_j, bottom_t = jl[-1], tl[-1]
    (rhs,) = _fields(bottom_j.padded, bottom_j.n, 2, 1)
    rhs *= 1e-3
    smoother = j_cycle._get_smoother(jcfg)
    ju = j_cycle.coarse_solve_gs(bottom_j, jnp.zeros_like(jnp.asarray(rhs)),
                                 jnp.asarray(rhs), jcfg, smoother)
    tu = cycle.coarse_solve_gs(bottom_t, None, torch.from_numpy(rhs), tcfg)
    _close(tu, ju)


# Configurations each of which one tower gate of the JAX package refuses.
OFF_TOWER = {
    "full_weighting": dict(restriction="full"),
    "w_cycle": dict(cycle_shape=2),
    "gs_coarse": dict(coarse_mode="gs"),
    "galerkin": dict(coarse_operator="galerkin"),
}


@pytest.mark.parametrize("name", sorted(OFF_TOWER))
def test_tower_gate_refuses_off_tower_configs(name, monkeypatch):
    """In float32 with a zero iterate below the finest level, a full-
    weighting, W-cycle, GS-coarse or Galerkin configuration must never enter
    tower_vcycle, which runs a V-cycle of injection to a dense solve on
    from_v levels; the cycle matches the JAX package's per-level one."""
    kw = dict(dict(coarse_mode="dense"), **OFF_TOWER[name])
    jl, tl, jcfg, tcfg = _setup(jnp.float32, **kw)
    assert not cycle._tower_eligible(tcfg, tl, 1, True)

    def refuse(*args, **kwargs):
        raise AssertionError("tower_vcycle entered")

    monkeypatch.setattr(cycle, "tower_vcycle", refuse)
    (rhs,) = _fields(jl[0].padded, N, 6, 1)
    rhs = rhs.astype(np.float32)
    ju = j_cycle.mg_cycle(jl, jnp.zeros_like(jnp.asarray(rhs)),
                          jnp.asarray(rhs), jcfg, u_is_zero=True)
    tu = cycle.mg_cycle(tl, None, torch.from_numpy(rhs), tcfg,
                        u_is_zero=True)
    _close(tu, ju, atol=5e-7 * float(np.abs(np.asarray(ju)).max()))


def test_tower_gate_takes_the_v_inject_dense_config():
    """The control: the main path's configuration does take the tower from
    level 1, and not from level 0, with an iterate, or in float64."""
    _, tl, _, tcfg = _setup(jnp.float32, coarse_mode="dense")
    assert cycle._tower_eligible(tcfg, tl, 1, True)
    assert not cycle._tower_eligible(tcfg, tl, 0, True)
    assert not cycle._tower_eligible(tcfg, tl, 1, False)
    _, tl64, _, tcfg64 = _setup(jnp.float64, coarse_mode="dense")
    assert not cycle._tower_eligible(tcfg64, tl64, 1, True)


@pytest.mark.parametrize("restriction", ["inject", "full"])
def test_row_decimated_residual_only_under_injection(restriction,
                                                     monkeypatch):
    """The pre-smooth emits the row-decimated residual only for injection;
    full weighting restricts the full residual."""
    jl, tl, jcfg, tcfg = _setup(restriction=restriction, coarse_mode="dense")
    calls = []
    real = cycle.fused_rb_sweeps

    def record(*args, **kwargs):
        calls.append(kwargs.get("residual_rows_decimated", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(cycle, "fused_rb_sweeps", record)
    u, rhs = _fields(jl[0].padded, N, 8, 2)
    ju = j_cycle.mg_cycle(jl, jnp.asarray(u), jnp.asarray(rhs), jcfg)
    tu = cycle.mg_cycle(tl, torch.from_numpy(u), torch.from_numpy(rhs), tcfg)
    _close(tu, ju)
    # two levels above the coarsest, a pre- and a post-smooth each
    assert len(calls) == 4
    assert any(calls) == (restriction == "inject")
