"""PyTorch port: configuration, padded layout and problem fields against the
JAX package (CPU; the port's counterparts of config.py, core/layout.py and
core/problem.py)."""

import dataclasses
import itertools
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpcclassmultigridproject_tpu.config as jcfg
import hpcclassmultigridproject_tpu.core.layout as jlay
import hpcclassmultigridproject_tpu.core.problem as jprob
import hpcclassmultigridproject_tpu_torch.config as tcfg
import hpcclassmultigridproject_tpu_torch.core.layout as tlay
import hpcclassmultigridproject_tpu_torch.core.problem as tprob

_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
_DELTA = dict(refine_dtype=jnp.float64, cycle_mode="fixed",
              coarse_mode="dense", delta_form=True)


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _port_kwargs(kw):
    return {k: _DTYPES.get(v, v) for k, v in kw.items()}


def test_problem_config_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.ProblemConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.ProblemConfig)]
    assert jf == tf
    for n, dt in ((64, None), (1024, 3e-5)):
        j, t = jcfg.ProblemConfig(n=n, dt=dt), tcfg.ProblemConfig(n=n, dt=dt)
        assert (j.dx, j.dt_) == (t.dx, t.dt_)


def test_solver_config_fields_match():
    jf = dataclasses.fields(jcfg.SolverConfig)
    tf = dataclasses.fields(tcfg.SolverConfig)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert _DTYPES.get(a.default, a.default) == b.default, a.name


@pytest.mark.parametrize("kw", [
    dict(cycle_mode="bogus"),
    dict(smoother="sor"),
    dict(backend="cuda"),
    dict(delta_form=True),
    dict(delta_form=True, refine_dtype=jnp.float64),
    dict(_DELTA, num_cycles=0),
])
def test_solver_config_validation_matches(kw):
    """Both packages refuse the same malformed configurations."""
    with pytest.raises(ValueError):
        jcfg.SolverConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.SolverConfig(**_port_kwargs(kw))


@pytest.mark.parametrize("kw", [
    dict(device_build=True),
])
def test_off_slice_configs_runs_and_matches(kw):
    """Valid JAX configurations the port once refused now run.  The device
    build's configuration is accepted, and the 2-D layout of a model born
    partitioned builds rank 0's window of rows and columns, equal to the
    whole device build's level and u0 cut to it (the born-run bound of
    tests/test_torch_parallel.py)."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import (
        GridBlocks,
        Mesh,
        make_global,
        shard_level_data,
    )

    jcfg.SolverConfig(**kw)
    cfg = tcfg.SolverConfig(**_port_kwargs(kw))
    assert cfg.device_build is True
    born = AdvectionDiffusion(ProblemConfig(n=64), cfg, device="cpu",
                              mesh=Mesh(2), layout="2d", min_local=16)
    whole = AdvectionDiffusion(ProblemConfig(n=64), cfg, device="cpu")
    part = born.shardings[0]
    assert isinstance(part, GridBlocks) and born.layout == "2d"
    want = shard_level_data(whole.levels[0], part)
    got = born.levels[0]
    assert (got.row_off, got.col_off, got.padded) == (
        want.row_off, want.col_off, want.padded) == (-1, -1, (74, 66))
    for f in ("v1", "v2"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=2e-6, atol=1e-11)
    np.testing.assert_allclose(born.u0, make_global(whole.u0, part),
                               rtol=2e-6, atol=1e-11)


@pytest.mark.parametrize("kw", [
    dict(),                                     # adaptive, not delta
    dict(_DELTA, delta_form=False, refine_dtype=None),
    dict(_DELTA, cycle_shape=2),
    dict(_DELTA, restriction="full"),
    dict(_DELTA, coarse_mode="gs"),
    dict(_DELTA, coarse_operator="galerkin"),
    dict(cycle_mode="fmg", refine_dtype=jnp.float64),
    dict(device_build=False),
    dict(_DELTA, sharded_overlap=True),
    dict(smoother="jacobi"),
    dict(smoother="chebyshev"),
    dict(_DELTA, smoother="jacobi"),
    dict(_DELTA, smoother="chebyshev"),
])
def test_single_device_configs_are_accepted(kw):
    """Every single-device configuration the JAX package takes, the port
    takes too, with the same field values (and the overlap
    schedule of the distributed run)."""
    j = jcfg.SolverConfig(**kw)
    t = tcfg.SolverConfig(**_port_kwargs(kw))
    for f in dataclasses.fields(j):
        assert _DTYPES.get(getattr(j, f.name), getattr(j, f.name)) == \
            getattr(t, f.name), f.name


def test_certify_every_without_delta_warns_like_jax():
    kw = dict(cycle_mode="fixed", certify_every=10)
    with pytest.warns(UserWarning, match="only honored by the delta"):
        jcfg.SolverConfig(**kw)
    with pytest.warns(UserWarning, match="only honored by the delta"):
        tcfg.SolverConfig(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tcfg.SolverConfig(**_port_kwargs(_DELTA), certify_every=10)


def test_resolved_num_cycles_matches_over_grid():
    for n, nu, niter, tol in itertools.product(
            (256, 1024, 4096, 8192, 16384), (-4e-4, -1e-3),
            (1, 2, 3), (1e-6, 1e-8)):
        h = 1.0 / n
        kw = dict(_DELTA, niter=niter, tol=tol, num_cycles=None)
        j = jcfg.SolverConfig(**kw).resolved_num_cycles(h / 10, nu, h)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = tcfg.SolverConfig(**_port_kwargs(kw)).resolved_num_cycles(
                h / 10, nu, h)
        assert j == t, (n, nu, niter, tol)


def test_resolved_num_cycles_warns_only_at_cap():
    cfg = tcfg.SolverConfig(**_port_kwargs(_DELTA), num_cycles=None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cfg.resolved_num_cycles(1e-4, -4e-4, 1.0 / 1024) == 1
    with pytest.warns(UserWarning, match="capped at 6"):
        assert cfg.resolved_num_cycles(1.0 / 655360, -4e-4,
                                       1.0 / 65536) == 6


def test_resolved_num_levels_matches():
    for n, levels in itertools.product((2, 16, 64, 1024, 16384), (None, 1, 3)):
        j = jcfg.SolverConfig(**_DELTA, num_levels=levels)
        t = tcfg.SolverConfig(**_port_kwargs(_DELTA), num_levels=levels)
        assert j.resolved_num_levels(n) == t.resolved_num_levels(n)


@pytest.mark.parametrize("n", [2, 16, 63, 64, 127, 1024])
def test_padded_shape_matches(n):
    assert jlay.padded_shape(n) == tlay.padded_shape(n)


def test_pad_crop_shift_masks_match():
    rng = np.random.default_rng(11)
    n = 40
    u = rng.standard_normal((n + 1, n + 1))
    jp = np.asarray(jlay.pad_field(jnp.asarray(u)))
    tp = tlay.pad_field(torch.from_numpy(u))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tlay.crop_field(tp, n).numpy(), u)
    for di, dj in itertools.product((-1, 0, 1), repeat=2):
        np.testing.assert_array_equal(
            tlay.shift(tp, di, dj).numpy(),
            np.asarray(jlay.shift(jnp.asarray(jp), di, dj)))
    shape = jp.shape
    np.testing.assert_array_equal(
        tlay.interior_mask(n, shape, device="cpu").numpy(),
        np.asarray(jlay.interior_mask(n, shape)))
    for parity in (0, 1):
        np.testing.assert_array_equal(
            tlay.color_mask(shape, parity, device="cpu").numpy(),
            np.asarray(jlay.color_mask(shape, parity)))


@pytest.mark.parametrize("n", [16, 64])
def test_problem_fields_match_f64(n):
    ju0 = np.asarray(jprob.gaussian_u0(n, 0.3, 0.6, 80.0, dtype=jnp.float64))
    tu0 = tprob.gaussian_u0(n, 0.3, 0.6, 80.0, dtype=torch.float64,
                            device="cpu")
    np.testing.assert_allclose(tu0.numpy(), ju0, rtol=0, atol=1e-14)
    jv = jprob.rotating_velocity(n, math.pi, 2.0, dtype=jnp.float64)
    tv = tprob.rotating_velocity(n, math.pi, 2.0, dtype=torch.float64,
                                 device="cpu")
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-14)
