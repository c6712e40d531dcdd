"""ctypes bindings for the native host oracle (libmgref), the port's own
copy of the JAX package's `native/`: `mgref.cpp` is that package's source
byte for byte, and these bindings have its functions and signatures.

The library is the serial double-precision C++ implementation the solver
is validated against.  It is built with g++ at first use, never at import,
into the package's `_build/` (under a name that carries a hash of the
source, the flags and the host's CPU, which `-march=native` compiles for),
never next to the source.  Every function takes and
returns numpy arrays; nothing here imports torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "mgref.cpp"
BUILD_DIR = _DIR.parent / "_build"
# the JAX package's flags (its native/__init__.py::build)
GXX_FLAGS = ("-O2", "-march=native", "-shared", "-fPIC")

_I, _D = ctypes.c_int, ctypes.c_double
_PD, _PI = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
# the C entry points' argument types (mgref.cpp's extern "C" block)
_SIGNATURES = {
    "adr_run": [_I, _I, _D, _D, _I, _D, _I, _I, _I, _D, _I] + [_PD] * 4
               + [_PI],
    "adr_compute_rhs": [_I, _D, _D, _D] + [_PD] * 4,
    "adr_residual": [_I, _D, _D, _D] + [_PD] * 5,
    "adr_norm": [_I, _PD],
    "adr_gs_sweep": [_I, _D, _D, _D] + [_PD] * 4 + [_I],
    "adr_prolong": [_I, _PD, _PD],
    "adr_restrict": [_I, _PD, _PD],
}

_lib = None


def _host_cpu() -> bytes:
    """The CPU `-march=native` compiles for: its model and flags where
    /proc/cpuinfo has them, else the machine's architecture."""
    try:
        info = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.machine().encode()
    lines = {line for line in info.splitlines()
             if line.startswith(("model name", "flags"))}
    return "\n".join(sorted(lines)).encode() or platform.machine().encode()


def build(force: bool = False) -> pathlib.Path:
    """Compile libmgref unless a build of the same source and flags for
    this CPU exists (or `force`); returns the library's path.  The build goes to a
    process-private file first, so concurrent builds never load a partial
    library."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _host_cpu()
                            + _SRC.read_bytes())
    lib_path = BUILD_DIR / f"libmgref-{digest.hexdigest()[:16]}.so"
    if lib_path.is_file() and not force:
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                   check=True)
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The built library, with every entry point's argument types set."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(_lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib.adr_norm.restype = ctypes.c_double
    return _lib


def _arr(a):
    """`a` as a contiguous float64 array, kept by the caller while the
    library reads it, and its pointer."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, _out(a)


def _out(a):
    return a.ctypes.data_as(_PD)


def run(
    u0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    nu: float,
    dt: float,
    nsteps: int,
    num_levels: int,
    tol: float = 1e-6,
    max_cycles: int = 50,
    niter: int = 3,
    shape: int = 1,
    coarse_tol: float = 1e-5,
    coarse_maxiter: int = 1000,
):
    """Full oracle run (adaptive V/W-cycles, GS coarse solve, injection);
    returns (uT, cycles_per_step)."""
    n = u0.shape[0] - 1
    u0, p_u0 = _arr(u0)
    v1, p_v1 = _arr(v1)
    v2, p_v2 = _arr(v2)
    uT = np.zeros_like(u0)
    cycles = np.zeros(nsteps, dtype=np.int32)
    lib().adr_run(n, num_levels, nu, dt, nsteps, tol, max_cycles, niter,
                  shape, coarse_tol, coarse_maxiter, p_u0, p_v1, p_v2,
                  _out(uT), cycles.ctypes.data_as(_PI))
    return uT, cycles


def compute_rhs(u, v1, v2, h, dt, nu):
    n = u.shape[0] - 1
    u, p_u = _arr(u)
    v1, p_v1 = _arr(v1)
    v2, p_v2 = _arr(v2)
    out = np.zeros_like(u)
    lib().adr_compute_rhs(n, h, dt, nu, p_v1, p_v2, p_u, _out(out))
    return out


def residual(u, rhs, v1, v2, h, dt, nu):
    n = u.shape[0] - 1
    u, p_u = _arr(u)
    rhs, p_rhs = _arr(rhs)
    v1, p_v1 = _arr(v1)
    v2, p_v2 = _arr(v2)
    out = np.zeros_like(u)
    lib().adr_residual(n, h, dt, nu, p_v1, p_v2, p_u, p_rhs, _out(out))
    return out


def norm(res):
    n = res.shape[0] - 1
    res, p_res = _arr(res)
    return lib().adr_norm(n, p_res)


def gs_sweep(u, rhs, v1, v2, h, dt, nu, nsweeps: int = 1):
    n = u.shape[0] - 1
    u = np.ascontiguousarray(u, dtype=np.float64).copy()
    rhs, p_rhs = _arr(rhs)
    v1, p_v1 = _arr(v1)
    v2, p_v2 = _arr(v2)
    lib().adr_gs_sweep(n, h, dt, nu, p_v1, p_v2, _out(u), p_rhs, nsweeps)
    return u


def prolong(coarse):
    nc = coarse.shape[0] - 1
    coarse, p_c = _arr(coarse)
    fine = np.zeros((2 * nc + 1, 2 * nc + 1))
    lib().adr_prolong(nc, p_c, _out(fine))
    return fine


def restrict(fine):
    nf = fine.shape[0] - 1
    fine, p_f = _arr(fine)
    coarse = np.zeros((nf // 2 + 1, nf // 2 + 1))
    lib().adr_restrict(nf, p_f, _out(coarse))
    return coarse
