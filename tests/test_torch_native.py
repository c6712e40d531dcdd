"""PyTorch port: its own native C++ oracle (`native/`), against the JAX
package's.

The port's `native/mgref.cpp` is the JAX package's byte for byte, its
bindings have the same functions and signatures and give the same numbers
to the bit, the library builds into the package's `_build/` (never next to
the source), importing it loads neither jax nor the JAX package, and the
port's float64 adaptive run at n=64 matches the port's `native.run` at
atol 1e-12 (tests/test_golden.py), V- and W-cycles.
"""

import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu import native as j_native
from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch import native
from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

ROOT = pathlib.Path(__file__).resolve().parents[1]
BINDINGS = ("build", "lib", "run", "compute_rhs", "residual", "norm",
            "gs_sweep", "prolong", "restrict")
N = 16
H = 1.0 / N
DT = H / 10
NU = -4e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _fields(seed):
    rng = np.random.default_rng(seed)
    u, rhs, v1, v2 = rng.standard_normal((4, N + 1, N + 1))
    for a in (u, rhs):
        a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
    return u, rhs, v1, v2


def test_source_is_the_jax_packages_byte_for_byte():
    port = ROOT / "hpcclassmultigridproject_tpu_torch" / "native" / "mgref.cpp"
    jax_src = ROOT / "hpcclassmultigridproject_tpu" / "native" / "mgref.cpp"
    assert port.read_bytes() == jax_src.read_bytes()


def test_builds_into_the_package_build_directory():
    lib_path = native.build()
    build_dir = ROOT / "hpcclassmultigridproject_tpu_torch" / "_build"
    assert lib_path.parent == build_dir and lib_path.is_file()
    assert lib_path.name.startswith("libmgref-")
    assert not list((build_dir.parent / "native").glob("*.so"))
    assert native.build() == lib_path  # reused, not rebuilt
    assert native.lib().adr_norm is not None


def test_bindings_have_the_jax_signatures():
    for name in BINDINGS:
        assert (inspect.signature(getattr(native, name))
                == inspect.signature(getattr(j_native, name))), name


def test_bindings_equal_the_jax_packages_to_the_bit():
    u, rhs, v1, v2 = _fields(0)
    pairs = [
        (native.compute_rhs(u, v1, v2, H, DT, NU),
         j_native.compute_rhs(u, v1, v2, H, DT, NU)),
        (native.residual(u, rhs, v1, v2, H, DT, NU),
         j_native.residual(u, rhs, v1, v2, H, DT, NU)),
        (native.gs_sweep(u, rhs, v1, v2, H, DT, NU, nsweeps=3),
         j_native.gs_sweep(u, rhs, v1, v2, H, DT, NU, nsweeps=3)),
        (native.prolong(u[:9, :9]), j_native.prolong(u[:9, :9])),
        (native.restrict(u), j_native.restrict(u)),
        (np.float64(native.norm(rhs)), np.float64(j_native.norm(rhs))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [1, 2])
def test_run_equals_the_jax_packages_to_the_bit(default_problem, shape):
    u0, v1, v2 = default_problem(32)
    kw = dict(nu=-4e-4, dt=(1 / 32) / 10, nsteps=10, num_levels=2,
              shape=shape)
    got, got_cycles = native.run(u0, v1, v2, **kw)
    want, want_cycles = j_native.run(u0, v1, v2, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_cycles, want_cycles)


def test_gs_sweep_leaves_its_input_unchanged():
    u, rhs, v1, v2 = _fields(1)
    before = u.copy()
    native.gs_sweep(u, rhs, v1, v2, H, DT, NU)
    np.testing.assert_array_equal(u, before)


@pytest.mark.parametrize("shape", [1, 2])
def test_f64_adaptive_run_matches_the_port_oracle(default_problem, shape):
    """The reference configuration (float64, adaptive, GS coarse solve,
    injection) at n=64, 2 levels, 100 steps: atol 1e-12 and, for the
    V-cycle, the same cycles a step (tests/test_golden.py)."""
    model = AdvectionDiffusion(
        ProblemConfig(n=64),
        SolverConfig(dtype=torch.float64, num_levels=2, cycle_shape=shape),
        device="cpu")
    uT, stats = model.run()
    u0, v1, v2 = default_problem(64)
    want, cycles = native.run(u0, v1, v2, nu=-4e-4, dt=(1 / 64) / 10,
                              nsteps=100, num_levels=2, shape=shape)
    np.testing.assert_allclose(uT.numpy(), want, rtol=0, atol=1e-12)
    if shape == 1:
        np.testing.assert_array_equal(stats["cycles"].numpy(), cycles)


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "from hpcclassmultigridproject_tpu_torch import native\n"
            "native.build()\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'hpcclassmultigridproject_tpu' "
            "or m.startswith('hpcclassmultigridproject_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
