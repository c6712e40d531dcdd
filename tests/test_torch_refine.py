"""PyTorch port: the non-delta steppers (mg/timestepper.py, mg/refine.py)
on the CPU, against the JAX package and the native C++ oracle.

- refined adaptive, fixed and FMG runs against the JAX package: uT at atol
  1e-8 in float32 (tests/test_torch_delta.py), the same cycle counts, every
  certificate <= 1e-6;
- `timestepper_refined_fused` against per-step `refined_solve`, as
  tests/test_refine.py holds the JAX pair;
- the plain float64 steppers (adaptive V and W, GS coarse solve) against
  the native oracle over 100 steps at atol 1e-12 (tests/test_golden.py);
- the canonical float32 drive SolverConfig(tol=1e-5) at n=64: center
  5.708e-5 within 1e-8, one cycle per step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu import native
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestep
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _port(n, steps, **kw):
    kw = {k: _DTYPES.get(v, v) for k, v in kw.items()}
    return AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                              SolverConfig(**kw), device="cpu")


_REFINED = dict(dtype=jnp.float32, refine_dtype=jnp.float64, tol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(_REFINED),
    dict(_REFINED, cycle_mode="fixed", num_cycles=1, coarse_mode="dense"),
    dict(_REFINED, cycle_mode="fixed", num_cycles=2, restriction="full",
         coarse_operator="galerkin", coarse_mode="dense"),
    dict(_REFINED, cycle_mode="fmg", num_cycles=1, coarse_mode="dense"),
    dict(_REFINED, cycle_shape=2),
], ids=["adaptive", "fixed", "fixed_galerkin", "fmg", "adaptive_w"])
def test_refined_runs_match_jax(kw):
    n, steps = 64, 5
    jm = JModel(JProblem(n=n, num_steps=steps), JSolver(**kw))
    tm = _port(n, steps, **kw)
    assert tm.fine_hi is not None and tm.u0.dtype == torch.float64
    juT, jst = jm.run(warn=False)
    tuT, tst = tm.run(warn=False)
    assert tuT.dtype == torch.float64
    np.testing.assert_allclose(tuT.numpy(), np.asarray(juT), rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(tst["cycles"].numpy(),
                                  np.asarray(jst["cycles"]))
    assert set(tst) == set(jst)
    assert (tst["rel_residual"].numpy() <= 1e-6).all()
    assert tst["converged"].numpy().all()


def test_fused_stepper_matches_per_step_refined():
    """timestepper_refined_fused (the fixed refined run) gives the iterates
    and certificates of one `timestep` (refined_solve) call per step."""
    tm = _port(64, 8, **_REFINED, cycle_mode="fixed", num_cycles=1,
               coarse_mode="dense")
    uT_fused, s_fused = tm.run(warn=False)
    u, rels = tm.u0, []
    for _ in range(8):
        u, s = timestep(tm.levels, u, tm.solver, tm.fine_hi)
        rels.append(float(s["rel_residual"]))
    np.testing.assert_allclose(uT_fused.numpy(), tm.crop(u).numpy(), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(s_fused["rel_residual"].numpy(), rels,
                               rtol=1e-5)
    assert s_fused["converged"].numpy().all()


@pytest.mark.parametrize("shape", [1, 2])
def test_f64_adaptive_matches_native_oracle(default_problem, shape):
    """The reference configuration (adaptive, GS coarse solve, injection)
    in float64, V- and W-cycles, 100 steps, against the native C++ oracle:
    uT at atol 1e-12 and the same cycle count every step."""
    tm = _port(64, 100, dtype=jnp.float64, num_levels=2, cycle_shape=shape)
    uT, stats = tm.run()
    u0, v1, v2 = default_problem(64)
    want, cycles = native.run(u0, v1, v2, nu=-4e-4, dt=(1 / 64) / 10,
                              nsteps=100, num_levels=2, shape=shape)
    np.testing.assert_allclose(uT.numpy(), want, rtol=0, atol=1e-12)
    if shape == 1:
        np.testing.assert_array_equal(stats["cycles"].numpy(), cycles)


def test_canonical_f32_drive_n64():
    """The verify skill's canonical drive: SolverConfig(tol=1e-5) at n=64
    (float32, adaptive, GS coarse solve) gives the reference center value in
    one cycle per step."""
    tm = _port(64, 100, tol=1e-5)
    uT, stats = tm.run()
    assert tm.center_value(uT) == pytest.approx(5.708e-5, abs=1e-8)
    assert int(stats["cycles"].max()) == 1
    assert stats["converged"].numpy().all()


def test_non_delta_run_has_no_high_dtype_state():
    """Without refine_dtype the model keeps no high-precision operator and
    runs in the working dtype, as the JAX model does."""
    tm = _port(32, 2, dtype=jnp.float64, cycle_mode="fixed", num_cycles=1,
               coarse_mode="dense")
    assert tm.fine_hi is None and tm.u0.dtype == torch.float64
    jm = JModel(JProblem(n=32, num_steps=2),
                JSolver(dtype=jnp.float64, cycle_mode="fixed", num_cycles=1,
                        coarse_mode="dense"))
    juT, _ = jm.run(warn=False)
    tuT, _ = tm.run(warn=False)
    np.testing.assert_allclose(tuT.numpy(), np.asarray(juT), rtol=0,
                               atol=1e-12)
