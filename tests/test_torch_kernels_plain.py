"""PyTorch port: the plain versions of the four kernels (K1 opening, K2
smoother, K3/K4 tower) against the JAX package's Pallas kernels in
interpret mode (CPU).  The CUDA kernels themselves are held to these plain
versions on the card by chip_smoke.py.

Tolerances: f64 atol 1e-13 (tests/test_pallas.py); f32 atol 5e-7·max|x|
(tests/test_tower.py, the few-ulp cross-program contract), with x the
output field, or for a residual the rhs whose cancellation it is.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpcclassmultigridproject_tpu.ops.pallas.smoother as psm
from hpcclassmultigridproject_tpu import SolverConfig as JSolver
from hpcclassmultigridproject_tpu.mg.levels import build_hierarchy as j_build
from hpcclassmultigridproject_tpu.ops.pallas import delta_step as j_k1
from hpcclassmultigridproject_tpu.ops.pallas import tower as j_tower
from hpcclassmultigridproject_tpu_torch import SolverConfig, interop
from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import (
    _build,
    delta_step,
    smoother,
    tower,
)
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    residual_from_v,
    restrict_inject,
)

_DTYPES = {jnp.float32: torch.float32, jnp.float64: torch.float64}
_STATIC = ("n", "h", "dt", "nu", "diag_a", "diag_b")


@pytest.fixture(autouse=True)
def _interpret_and_threads():
    old_interpret, old_threads = psm.INTERPRET, torch.get_num_threads()
    psm.INTERPRET = True
    torch.set_num_threads(2)
    yield
    psm.INTERPRET = old_interpret
    torch.set_num_threads(old_threads)


def _hierarchies(n, jdtype):
    """The JAX package's 3-level hierarchy on the reference velocities, and
    the port's copy through interop."""
    from hpcclassmultigridproject_tpu.core.problem import rotating_velocity

    v1, v2 = rotating_velocity(n, dtype=jdtype)
    jl = j_build(v1, v2, 0.1 / n, -4e-4, 3, dtype=jdtype, coarse_mode="dense")
    dicts = []
    for l in jl:
        d = {k: getattr(l, k) for k in _STATIC}
        d.update(v1=np.asarray(l.v1), v2=np.asarray(l.v2),
                 a_inv=None if l.a_inv is None else np.asarray(l.a_inv))
        dicts.append(d)
    tl = tuple(interop.level_from_numpy(d, device="cpu") for d in dicts)
    return jl, tl


def _field(rng, shape, n, jdtype, scale=1.0):
    x = np.zeros(shape)
    x[1:n, 1:n] = scale * rng.standard_normal((n - 1, n - 1))
    return x.astype(np.dtype(jdtype))


def _close(got, want, jdtype, scale=None):
    """f32 atol is relative to `scale`, by default the expected field's
    max-abs."""
    want = np.asarray(want)
    if scale is None:
        scale = np.abs(want).max()
    atol = 1e-13 if jdtype == jnp.float64 else 5e-7 * scale
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


CASES = [(n, dt) for n in (64, 128) for dt in (jnp.float32, jnp.float64)]


@pytest.mark.parametrize("n,jdtype", CASES)
def test_k1_delta_open_plain_matches_pallas(n, jdtype):
    jl, tl = _hierarchies(n, jdtype)
    rng = np.random.default_rng(n)
    shape = jl[0].padded
    hi, lo, d = (_field(rng, shape, n, jdtype, s) for s in (1.0, 1e-8, 1e-2))
    want = j_k1.fused_accumulate_open(jl[0], *map(jnp.asarray, (hi, lo, d)))
    got = delta_step.fused_accumulate_open(
        tl[0], *map(torch.from_numpy, (hi, lo, d)))
    for g, w in zip(got, want):
        _close(g, w, jdtype)


K2_FLAGS = {
    "pre": dict(want_residual=True, zero_init=True,
                residual_rows_decimated=True),
    "post": dict(want_residual=True, corr=True),
    "plain": dict(want_residual=True),
    "no_residual": dict(want_residual=False),
}


@pytest.mark.parametrize("flags", sorted(K2_FLAGS))
@pytest.mark.parametrize("n,jdtype", CASES)
def test_k2_smoother_plain_matches_pallas(n, jdtype, flags):
    jl, tl = _hierarchies(n, jdtype)
    rng = np.random.default_rng(n + 1)
    shape = jl[0].padded
    u, rhs, corr = (_field(rng, shape, n, jdtype, s) for s in (1.0, 1.0, 1e-2))
    kw = dict(K2_FLAGS[flags])
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("corr", False):
        jkw["corr"], tkw["corr"] = jnp.asarray(corr), torch.from_numpy(corr)
    want = psm.fused_rb_sweeps(jl[0], jnp.asarray(u), jnp.asarray(rhs), 3,
                               **jkw)
    got = smoother.fused_rb_sweeps(tl[0], torch.from_numpy(u),
                                   torch.from_numpy(rhs), 3, **tkw)
    _close(got[0], want[0], jdtype)
    if kw["want_residual"]:
        # the residual cancels against rhs: its rounding is of rhs's size
        assert got[1].shape == want[1].shape
        _close(got[1], want[1], jdtype, scale=np.abs(rhs).max())
    else:
        assert got[1] is None


@pytest.mark.parametrize("n,jdtype", CASES)
def test_k3_k4_tower_plain_matches_pallas(n, jdtype):
    """The whole tower V-cycle from level 1 (descent, dense coarse solve,
    ascent) on a random rhs, as tests/test_tower.py drives it."""
    jl, tl = _hierarchies(n, jdtype)
    rng = np.random.default_rng(7)
    rhs = _field(rng, jl[1].padded, jl[1].n, jdtype)
    jcfg = JSolver(dtype=jdtype, refine_dtype=jnp.float64, cycle_mode="fixed",
                   num_cycles=1, coarse_mode="dense", delta_form=True,
                   backend="pallas", num_levels=3)
    tcfg = SolverConfig(dtype=_DTYPES[jdtype], refine_dtype=torch.float64,
                        cycle_mode="fixed", num_cycles=1, coarse_mode="dense",
                        delta_form=True, num_levels=3)
    want = j_tower.tower_vcycle(jl, 1, jnp.asarray(rhs), jcfg)
    got = tower.tower_vcycle(tl, 1, torch.from_numpy(rhs), tcfg)
    _close(got, want, jdtype)
    # the descent's coarse rhs is the injected residual of its last level
    u_mids, rhs_mids, bottom = tower.tower_descend(
        tl, 1, torch.from_numpy(rhs), 3)
    res = residual_from_v(tl[1], u_mids[0], rhs_mids[0])
    assert torch.equal(bottom, restrict_inject(res, tl[2].padded))


def test_plain_route_on_cpu_counts_no_launches():
    _, tl = _hierarchies(64, jnp.float32)
    cuda.reset_launches()
    rhs = torch.zeros(tl[0].padded)
    smoother.fused_rb_sweeps(tl[0], None, rhs, 3, True, zero_init=True)
    assert all(v == 0 for v in cuda.LAUNCHES.values())


def test_wrappers_refuse_bad_inputs():
    _, tl = _hierarchies(64, jnp.float32)
    rhs = torch.zeros(tl[0].padded)
    with pytest.raises(ValueError, match="several devices"):
        cuda.use_kernel(rhs, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="no kernel route"):
        cuda.use_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="exclusive"):
        smoother.fused_rb_sweeps(tl[0], rhs, rhs, 3, zero_init=True, corr=rhs)
    with pytest.raises(ValueError, match="expected"):
        cuda.check_inputs(tl[0].padded, torch.float32, rhs=rhs[:8])
    with pytest.raises(ValueError, match="contiguous"):
        cuda.check_inputs((1152, 1032), torch.float32, rhs=torch.zeros(
            1032, 1152).t())
    with pytest.raises(ValueError, match="float32 or float64"):
        cuda.check_inputs((2, 2), torch.float16, x=torch.zeros(2, 2))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: a missing compiler is an error."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_cpu_run_never_loads_the_kernel_library():
    """Importing the port and running it on the CPU neither imports jax nor
    builds or loads the CUDA library."""
    code = (
        "import sys, torch\n"
        "import hpcclassmultigridproject_tpu_torch as p\n"
        "from hpcclassmultigridproject_tpu_torch import interop\n"
        "from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion\n"
        "from hpcclassmultigridproject_tpu_torch.ops.cuda import _build\n"
        "cfg = p.SolverConfig(refine_dtype=torch.float64, cycle_mode='fixed',"
        " num_cycles=1, coarse_mode='dense', delta_form=True, num_levels=2)\n"
        "m = AdvectionDiffusion(p.ProblemConfig(n=16, num_steps=2), cfg,"
        " device='cpu')\n"
        "uT, st = m.run()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert _build.library.cache_info().currsize == 0, 'library loaded'\n"
        "print('ok', float(st['final_rel_residual_hi']))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=root, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
