"""PyTorch port: K8, the whole-step opening, on the CPU.

- `fused_open_presmooth` (its plain version on CPU tensors) against the
  JAX package's `ops/pallas/delta_step.py::fused_open_presmooth` in
  interpret mode, in both residual modes, at the tolerances of
  tests/test_pallas.py::test_fused_open_presmooth_matches_separate_kernels
  (f64: hi/lo exact, rhs 1e-15, u1 rtol 1e-13 atol 1e-14, r0 1e-13; f32:
  the few-ulp contract 5e-7·max|x| of tests/test_torch_kernels_plain.py);
- the delta run with `_FUSE_OPEN_SMOOTH` on against the JAX run with its
  flag on (backend "pallas", interpret mode): n=64, 3 levels, 8 steps,
  certify_every=3, uT within 1e-12 (f64) and 1e-8 (f32, the bound of
  tests/test_torch_delta.py), every certificate <= 1e-6;
- the port with the flag on against the port with it off;
- the gate: configurations it refuses run the flag-off path.

The CUDA kernel itself is held to the plain version on the card by
chip_smoke.py, and its window schedule on the CPU by
tests/test_torch_smooth_tiles.py; here the C entry points' arities are
held to the ctypes tables.
"""

import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpcclassmultigridproject_tpu.mg.delta as j_delta
import hpcclassmultigridproject_tpu.ops.pallas.smoother as psm
from hpcclassmultigridproject_tpu import ProblemConfig as JProblem
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.core.problem import rotating_velocity
from hpcclassmultigridproject_tpu.mg.levels import build_hierarchy as j_build
from hpcclassmultigridproject_tpu.models import AdvectionDiffusion as JModel
from hpcclassmultigridproject_tpu.ops.pallas import delta_step as j_k1
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch import interop
from hpcclassmultigridproject_tpu_torch.mg import delta as t_delta
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build, delta_step

_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
_STATIC = ("n", "h", "dt", "nu", "diag_a", "diag_b")
_RUN = dict(tol=1e-6, cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
            delta_form=True, num_levels=3, certify_every=3)
N, STEPS = 64, 8


@pytest.fixture(autouse=True)
def _interpret_and_threads():
    old_interpret, old_threads = psm.INTERPRET, torch.get_num_threads()
    psm.INTERPRET = True
    torch.set_num_threads(2)
    yield
    psm.INTERPRET = old_interpret
    torch.set_num_threads(old_threads)


@functools.cache
def _fine_levels(jdtype):
    """The JAX package's fine CN level at n=N and the port's copy."""
    v1, v2 = rotating_velocity(N, dtype=jdtype)
    jl = j_build(v1, v2, 0.1 / N, -4e-4, 2, dtype=jdtype)[0]
    d = {k: getattr(jl, k) for k in _STATIC}
    d.update(v1=np.asarray(jl.v1), v2=np.asarray(jl.v2), a_inv=None)
    return jl, interop.level_from_numpy(d, device="cpu")


def _field(rng, shape, jdtype, scale):
    x = np.zeros(shape)
    x[1:N, 1:N] = scale * rng.standard_normal((N - 1, N - 1))
    return x.astype(np.dtype(jdtype))


@pytest.mark.parametrize("dec", [False, True])
@pytest.mark.parametrize("jdtype", [jnp.float64, jnp.float32])
def test_open_presmooth_plain_matches_jax(jdtype, dec):
    jl, tl = _fine_levels(jdtype)
    rng = np.random.default_rng(11)
    hi, lo, d = (_field(rng, jl.padded, jdtype, s) for s in (1.0, 1e-8, 1e-2))
    want = j_k1.fused_open_presmooth(jl, *map(jnp.asarray, (hi, lo, d)), 3,
                                     residual_rows_decimated=dec)
    got = delta_step.fused_open_presmooth(tl, *map(torch.from_numpy,
                                                   (hi, lo, d)), 3,
                                          residual_rows_decimated=dec)
    assert got[4].shape == (jl.padded[0] // 2 if dec else jl.padded[0],
                            jl.padded[1])
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    if jdtype == jnp.float64:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-15)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-13, atol=1e-14)
        np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-13)
    else:
        # the residual cancels against rhs_δ: its rounding is of rhs_δ's size
        scales = [np.abs(w).max() for w in want[:4]] + [np.abs(want[2]).max()]
        for g, w, s in zip(got, want, scales):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-7 * s)


@pytest.mark.parametrize("dec", [False, True])
def test_open_presmooth_equals_the_opening_then_the_pre_smooth(dec):
    """The plain version is K1's plain version followed by K2's from zero,
    as the kernel must be to the bit."""
    _, tl = _fine_levels(jnp.float64)
    rng = np.random.default_rng(3)
    hi, lo, d = (torch.from_numpy(_field(rng, tl.padded, jnp.float64, s))
                 for s in (1.0, 1e-8, 1e-2))
    got = delta_step.fused_open_presmooth(tl, hi, lo, d, 3,
                                          residual_rows_decimated=dec)
    hi2, lo2, rhs = delta_step.fused_accumulate_open(tl, hi, lo, d)
    from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import (
        fused_rb_sweeps,
    )

    u1, r0 = fused_rb_sweeps(tl, None, rhs, 3, True, zero_init=True,
                             residual_rows_decimated=dec)
    for g, w in zip(got, (hi2, lo2, rhs, u1, r0)):
        assert torch.equal(g, w)


def _port_model(tdtype, steps=STEPS, **kw):
    return AdvectionDiffusion(
        ProblemConfig(n=N, num_steps=steps),
        SolverConfig(dtype=tdtype, refine_dtype=torch.float64,
                     **dict(_RUN, **kw)), device="cpu")


def _port_run(monkeypatch, tdtype, fused: bool, **kw):
    monkeypatch.setattr(t_delta, "_FUSE_OPEN_SMOOTH", fused)
    return _port_model(tdtype, **kw).run(warn=False)


@pytest.mark.parametrize("jdtype,atol", [(jnp.float64, 1e-12),
                                         (jnp.float32, 1e-8)])
def test_fused_run_matches_jax_fused_run(monkeypatch, jdtype, atol):
    monkeypatch.setattr(j_delta, "_FUSE_OPEN_SMOOTH", True)
    jm = JModel(JProblem(n=N, num_steps=STEPS),
                JSolver(dtype=jdtype, refine_dtype=jnp.float64,
                        backend="pallas", **_RUN))
    juT, jst = jm.run(warn=False)
    calls = []
    real = t_delta.fused_open_presmooth
    monkeypatch.setattr(t_delta, "fused_open_presmooth",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tuT, tst = _port_run(monkeypatch, _DTYPES[jdtype], True)
    assert len(calls) == STEPS
    np.testing.assert_allclose(tuT.numpy(), np.asarray(juT), rtol=0,
                               atol=atol)
    rel = tst["rel_residual"].numpy()
    hi = tst["rel_residual_hi_steps"].numpy()
    assert (rel <= 1e-6).all() and float(tst["final_rel_residual_hi"]) <= 1e-6
    assert (hi[hi >= 0] <= 1e-6).all() and (hi >= 0).sum() == STEPS // 3
    np.testing.assert_array_equal(hi < 0,
                                  np.asarray(jst["rel_residual_hi_steps"]) < 0)
    np.testing.assert_array_equal(tst["certified"].numpy(),
                                  np.asarray(jst["certified"]))


def test_fused_run_equals_unfused_run(monkeypatch):
    uT_off, st_off = _port_run(monkeypatch, torch.float64, False)
    uT_on, st_on = _port_run(monkeypatch, torch.float64, True)
    np.testing.assert_allclose(uT_on.numpy(), uT_off.numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(st_on["rel_residual"].numpy(),
                               st_off["rel_residual"].numpy(), rtol=1e-10,
                               atol=1e-12)
    assert set(st_on) == set(st_off)


@pytest.mark.parametrize("kw", [
    dict(num_cycles=2),
    dict(restriction="full"),
    dict(cycle_shape=2),
    dict(smoother="chebyshev"),
    dict(num_levels=1),
])
def test_gate_refuses_off_path_configs(monkeypatch, kw):
    """With the flag on and K8 patched to raise, each configuration off
    the whole-step opening's path runs, and equals its flag-off run."""
    want, _ = _port_run(monkeypatch, torch.float64, False, steps=3, **kw)

    def refuse(*a, **k):
        raise AssertionError("the gate let an off-path configuration in")

    monkeypatch.setattr(t_delta, "fused_open_presmooth", refuse)
    got, _ = _port_run(monkeypatch, torch.float64, True, steps=3, **kw)
    assert torch.equal(got, want)


def test_open_presmooth_refuses_a_banded_level():
    from hpcclassmultigridproject_tpu_torch.models.poisson import (
        poisson_level,
    )

    level = poisson_level(16, 1 / 16, dtype=torch.float64, device="cpu")
    x = torch.zeros(level.padded, dtype=torch.float64)
    with pytest.raises(ValueError, match="whole from_v level"):
        delta_step.fused_open_presmooth(level, x, x, x, 3)


def test_cpu_open_presmooth_counts_no_launch():
    _, tl = _fine_levels(jnp.float32)
    cuda.reset_launches()
    x = torch.zeros(tl.padded)
    delta_step.fused_open_presmooth(tl, x, x, x, 3, True)
    assert cuda.LAUNCHES["open_presmooth"] == 0


def _c_entries():
    """{name: argument count} of every extern "C" entry point in csrc/,
    with the float32/float64 entries of a macro expanded by suffix."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text().replace("\\\n", " ")
        for name, params in re.findall(r'extern "C" \w+\*? ([\w#]+)\(([^)]*)\)',
                                       text, flags=re.S):
            if name == "mg_error_string":
                continue
            count = len([p for p in params.split(",") if p.strip()])
            if name.endswith("_##SUFFIX"):
                for suffix in ("f32", "f64"):
                    found[f"{name[:-len('_##SUFFIX')]}_{suffix}"] = count
            else:
                found[name] = count
    return found


def test_c_entry_points_match_the_ctypes_tables():
    """nvcc does not run here: hold each C entry point's arity, in the
    sources, to the argument types ctypes will set on it."""
    want = {f"{base}_{s}": len(args) for base, args in _build._SIGNATURES.items()
            for s in ("f32", "f64")}
    want.update({k: len(v) for k, v in _build._F32_SIGNATURES.items()})
    want.update({k: len(v) for k, v in _build._LOOP_SIGNATURES.items()})
    want.update({k: len(v) for k, v in _build._PEER_SIGNATURES.items()})
    assert _c_entries() == want


def test_k1_and_k8_share_the_opening():
    """K1 (mg::delta_open_at) and K8 (the from_v block's FV_OPEN variant)
    fold with the one TwoSum (`accumulate`) and form the rhs with the one
    pair of functions (`dform` of hi' and of lo', then `delta_rhs`) of
    common.cuh, so their rhs agree to the bit; K2-K7 (smoother.cu,
    tower.cu) instantiate no opening."""
    source = (_build.CSRC / "delta_step.cu").read_text()
    common = (_build.CSRC / "common.cuh").read_text()
    assert "mg::delta_open_at(" in source
    assert "mg::smooth_from_v<T, ACCESS, mg::FV_OPEN>(" in source

    def body(signature):
        start = common.index(signature)
        return common[start:common.index("\n}\n", start)]

    assert common.count("const T bv = t - h;") == 1  # one TwoSum
    assert common.count("(up - x) + (dn - x)") == 1  # one lap
    assert common.count("-(two_rnu * lap)") == 1  # one rhs
    assert "return accumulate(hi[g], lo[g], d[g]);" in body(
        "Pair<T> accumulate_at(")
    open_at = body("Opened<T> delta_open_at(")
    assert "accumulate_at(" in open_at and "delta_rhs(dform(" in open_at
    assert "return dform(" in body("DForm<T> fv_dform(")
    block = body("__device__ void smooth_from_v(")
    assert "accumulate(c0[j].rhs, c0[j].cc, c0[j].dd)" in block
    assert "h0[j] = fv_dform(" in block and "h1[j] = fv_dform(" in block
    assert "delta_rhs(h0[j], fv_dform(" in block
    assert "delta_rhs(h1[j], fv_dform(" in block
    assert "delta_open_at(" not in block
    smoother_cu = (_build.CSRC / "smoother.cu").read_text()
    tower_cu = (_build.CSRC / "tower.cu").read_text()
    assert "smooth_from_v<" in smoother_cu and "smooth_from_v<" in tower_cu
    for text in (smoother_cu, tower_cu):
        assert "FV_OPEN" not in text and "delta_open_at" not in text
        assert "smooth_tile" not in text
    assert pathlib.Path(_build.CSRC / "probe.cu").is_file()
