"""PyTorch port: the whole slice (AdvectionDiffusion → timestepper →
timestepper_delta → mg_cycle → the kernels' plain versions) against the JAX
package's delta-form runs on the CPU, with backend="jnp" and with
backend="pallas" in interpret mode (tower eligible).

n=64, 3 levels, 5 steps, certify_every=2.  f64 working dtype: uT at atol
1e-12.  f32 working dtype: uT at atol 1e-8, every certificate <= 1e-6, the
final f64 certificate within 20% of the JAX run's (tests/test_tower.py),
and the same rel_residual_hi_steps cadence.
"""

import dataclasses
import functools
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpcclassmultigridproject_tpu.mg.cycle as j_cycle
import hpcclassmultigridproject_tpu.ops.pallas.smoother as psm
from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.mg.cycle import mg_cycle
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

GOLDEN = pathlib.Path(__file__).parent / "golden"
_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
_RUN = dict(tol=1e-6, cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
            delta_form=True)


@pytest.fixture(autouse=True)
def _interpret_and_threads():
    old_interpret, old_threads = psm.INTERPRET, torch.get_num_threads()
    psm.INTERPRET = True
    torch.set_num_threads(2)
    yield
    psm.INTERPRET = old_interpret
    torch.set_num_threads(old_threads)


def _models(jdtype, backend="jnp", n=64, steps=5, **kw):
    kw = dict(_RUN, num_levels=3, certify_every=2, **kw)
    jm = JModel(JProblem(n=n, num_steps=steps),
                JSolver(dtype=jdtype, refine_dtype=jnp.float64,
                        backend=backend, **kw))
    tm = AdvectionDiffusion(
        ProblemConfig(n=n, num_steps=steps),
        SolverConfig(dtype=_DTYPES[jdtype], refine_dtype=torch.float64, **kw),
        device="cpu")
    return jm, tm


@functools.cache
def _port_run(jdtype):
    """The port's run does not depend on the JAX backend: run it once."""
    return _models(jdtype)[1].run(warn=False)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_slice_matches_jax_f64(backend):
    jm, _ = _models(jnp.float64, backend)
    juT, jst = jm.run(warn=False)
    tuT, tst = _port_run(jnp.float64)
    np.testing.assert_allclose(tuT.numpy(), np.asarray(juT), rtol=0,
                               atol=1e-12)
    assert float(tst["final_rel_residual_hi"]) == pytest.approx(
        float(jst["final_rel_residual_hi"]), rel=1e-3)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_slice_matches_jax_f32(backend):
    jm, _ = _models(jnp.float32, backend)
    juT, jst = jm.run(warn=False)
    tuT, tst = _port_run(jnp.float32)
    assert tuT.dtype == torch.float64 and tuple(tuT.shape) == (65, 65)
    np.testing.assert_allclose(tuT.numpy(), np.asarray(juT), rtol=0,
                               atol=1e-8)
    rel = tst["rel_residual"].numpy()
    hi = tst["rel_residual_hi_steps"].numpy()
    final = float(tst["final_rel_residual_hi"])
    assert (rel <= 1e-6).all() and (hi <= 1e-6).all() and final <= 1e-6
    jfinal = float(jst["final_rel_residual_hi"])
    assert abs(final - jfinal) <= 0.2 * max(final, jfinal)
    np.testing.assert_array_equal(hi < 0,
                                  np.asarray(jst["rel_residual_hi_steps"]) < 0)
    np.testing.assert_array_equal(tst["certified"].numpy(),
                                  np.asarray(jst["certified"]))
    np.testing.assert_array_equal(tst["converged"].numpy(),
                                  np.asarray(jst["converged"]))


def test_stats_keys_and_types_match():
    jm, _ = _models(jnp.float32, steps=3)
    _, jst = jm.run(warn=False)
    _, tst = _models(jnp.float32, steps=3)[1].run(warn=False)
    assert set(tst) == set(jst)
    for k, v in tst.items():
        assert v.shape == np.asarray(jst[k]).shape, k
        assert str(v.dtype).split(".")[-1] == str(np.asarray(jst[k]).dtype), k
    np.testing.assert_array_equal(tst["cycles"].numpy(),
                                  np.asarray(jst["cycles"]))


def test_step_matches_jax_step():
    jm, tm = _models(jnp.float32, steps=1)
    ju, jst = jm.step(jm.u0)
    tu, tst = tm.step(tm.u0)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-8)
    assert set(tst) == set(jst)
    assert tst["rel_residual"].ndim == 0 and float(tst["rel_residual"]) <= 1e-6
    assert tm.center_value(tm.crop(tu)) == pytest.approx(
        jm.center_value(jm.crop(ju)), abs=1e-9)


def test_one_cycle_matches_jax_f64():
    """One V-cycle from a zero iterate at the finest level, with the final
    residual, against JAX mg_cycle."""
    jm, tm = _models(jnp.float64, "jnp")
    rng = np.random.default_rng(5)
    rhs = np.zeros(jm.levels[0].padded)
    rhs[1:64, 1:64] = rng.standard_normal((63, 63))
    ju, jr = j_cycle.mg_cycle(jm.levels, jnp.zeros_like(jnp.asarray(rhs)),
                              jnp.asarray(rhs), jm.solver,
                              want_final_residual=True, u_is_zero=True)
    tu, tr = mg_cycle(tm.levels, None, torch.from_numpy(rhs), tm.solver,
                      want_final_residual=True, u_is_zero=True)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)


def test_run_warns_like_jax_on_a_missed_tolerance():
    """tol below what one f32 cycle reaches: the port warns (steps missed,
    no margin, failed certificate), as the JAX model does."""
    _, tm = _models(jnp.float32, steps=2, tol=1e-9)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        tm.run()
    text = " ".join(str(w.message) for w in got)
    assert "did not converge at step 0" in text
    assert "no safety margin" in text
    assert "rigorous certificate FAILED at step 1" in text


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdvectionDiffusion(ProblemConfig(n=16),
                           SolverConfig(refine_dtype=torch.float64, **_RUN),
                           device="cuda")


def test_mesh_runs_and_matches():
    """A mesh builds the model born partitioned, in the rows layout and in
    the 2-D one: rank 1 of two holds its rows (and halo) of level 0, or
    in the 2-D layout its column window (col_off), and its fields match
    the whole device build's cut to the same window (the born-run bound of
    tests/test_torch_parallel.py: a window may round sin apart on the
    CPU)."""
    from hpcclassmultigridproject_tpu_torch.parallel import (
        Mesh,
        make_global,
        shard_level_data,
    )

    cfg = SolverConfig(refine_dtype=torch.float64, num_levels=2, **_RUN)
    model = AdvectionDiffusion(ProblemConfig(n=64), cfg, device="cpu",
                               mesh=Mesh(2, 1), min_local=16)
    part = model.shardings[0]
    assert model.levels[0].padded[0] == part.local + 2 * part.halo
    assert model.levels[0].row_off == part.start - part.halo
    whole = AdvectionDiffusion(ProblemConfig(n=64), dataclasses.replace(
        cfg, device_build=True), device="cpu")
    grid = AdvectionDiffusion(ProblemConfig(n=64), cfg, device="cpu",
                              mesh=Mesh(2, 1), min_local=16, layout="2d")
    part = grid.shardings[0]
    level = grid.levels[0]
    assert (level.row_off, level.col_off) == (-1, part.col_start - 1) == (
        -1, 63)
    assert level.padded == (part.local + 2, part.local_cols + 2)
    for got, want in ((level, shard_level_data(whole.levels[0], part)),
                      (grid.fine_hi, shard_level_data(whole.fine_hi, part))):
        assert (got.row_off, got.col_off, got.padded) == (
            want.row_off, want.col_off, want.padded)
        for f in ("v1", "v2"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=2e-6, atol=1e-11)
    np.testing.assert_allclose(grid.u0, make_global(whole.u0, part),
                               rtol=2e-6, atol=1e-11)


@pytest.mark.slow
def test_delta_form_n256_matches_golden():
    """The bench configuration at n=256 against the committed golden field,
    at the bounds of tests/test_golden.py."""
    tm = AdvectionDiffusion(
        ProblemConfig(n=256),
        SolverConfig(dtype=torch.float32, refine_dtype=torch.float64, **_RUN),
        device="cpu")
    uT, stats = tm.run(warn=False)
    want = np.load(GOLDEN / "uT_n256.npy")
    np.testing.assert_allclose(uT.numpy(), want, atol=5e-7)
    assert float(uT[128, 128]) == pytest.approx(4.802e-5, abs=1e-8)
    assert float(stats["final_rel_residual_hi"]) <= 1e-6
