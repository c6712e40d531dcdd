"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` of the package is compiled by its own nvcc, all started
together, and the objects linked into one shared library with a plain C
interface, for sm_90a (Hopper).  The
library's name carries a hash of the sources and flags, so a build is
reused until they change.  The build runs at the first launch, never at
import.  A missing nvcc or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PACKAGE = pathlib.Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

# -fmad=false: no a*b+c contraction, so a kernel matches its plain
# PyTorch version on the card to the bit or near it.  Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SMOOTH_ARGS = [_P] * 7 + [_I] * 5 + [_D] * 5 + [_I, _P]
# the tower's per-level pointers, shapes and constants as three arrays, the
# level count, nsweeps, scratch, the (blocks/SM, SMs, grid) out-array, stream
_TOWER_ARGS = [_P] * 3 + [_I] * 2 + [_P] * 3
# entry points built for float32 (_f32) and float64 (_f64)
_SIGNATURES = {
    "mg_delta_open": [_P] * 8 + [_I] * 3 + [_D] * 2 + [_P],
    "mg_open_smooth": [_P] * 10 + [_I] * 4 + [_D] * 7 + [_I, _P],
    "mg_smooth": _SMOOTH_ARGS,
    "mg_smooth5": [_P] * 9 + [_I] * 3 + [_D] * 2 + [_I, _P],
    "mg_smooth9": [_P] * 14 + [_I] * 3 + [_I, _P],
    "mg_tower_descend": _TOWER_ARGS,
    "mg_tower_ascend": _TOWER_ARGS,
}
# float32-only entry points, named without a suffix (csrc/probe.cu)
_F32_SIGNATURES = {
    "mg_probe_stride2_rows": [_P, _P, _I, _I, _P],
    "mg_probe_interleave_rows": [_P, _P, _I, _I, _P],
    "mg_probe_flatten": [_P, _P, _I, _P],
    "mg_probe_dot": [_P] * 3 + [_I] * 3 + [_P],
}
# the while node's entry points (csrc/loop.cu), of no dtype: the
# conditional handle is an unsigned long long
_U64 = ctypes.c_ulonglong
_LOOP_SIGNATURES = {
    "mg_while_set": [_U64, _P, _P, _I, _P, _P, _D, _I, _P, _P],
    "mg_while_handle": [_P, _P],
    "mg_while_begin": [_P, _U64, _P, _P],
    "mg_while_end": [_P],
}
# the peer transport's entry points (csrc/peer.cu), of no dtype: a kernel
# takes its arguments as one packed array (peer.cuh's ExchangeArgs,
# GatherArgs, ReduceArgs) and the stream
_PEER_SIGNATURES = {
    "mg_peer_exchange": [_P, _P],
    "mg_peer_gather": [_P, _P],
    "mg_peer_reduce": [_P, _P],
    "mg_peer_alloc": [_I, _U64, _P, _P, _P, _P],
    "mg_peer_handle": [_P, _P],
    "mg_peer_open": [_P, _I, _I, _P],
    "mg_peer_close": [_P, _P, _I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the port's "
        "CUDA kernels cannot be built")


def build() -> pathlib.Path:
    """Compile every csrc/*.cu, one nvcc a source, all started together,
    and link the objects into one library, unless a build of the same
    sources and flags exists; returns the library's path.  The compilers'
    output (register and shared-memory use per kernel) is kept beside the
    library as `.log`."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    lib = BUILD_DIR / f"libmgkernels-{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix=f"{lib.stem}.",
                                         dir=BUILD_DIR))
    try:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objects = [work / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [_nvcc(), *compile_flags, "-c", "-I", str(CSRC), "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for src, obj in zip(sources, objects)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            out, err = proc.communicate()
            logs.append(out + err)
            if proc.returncode != 0:
                failed.append(f"{src.name}: exit code {proc.returncode}:\n"
                              f"{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = work / lib.name
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link, exit code "
                               f"{link.returncode}:\n{link.stderr}")
        lib.with_suffix(".log").write_text(
            "".join(logs) + link.stdout + link.stderr)
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with argument types set on every entry."""
    lib = ctypes.CDLL(str(build()))
    names = {f"{base}_{suffix}": argtypes
             for base, argtypes in _SIGNATURES.items()
             for suffix in ("f32", "f64")}
    for name, argtypes in {**names, **_F32_SIGNATURES, **_LOOP_SIGNATURES,
                           **_PEER_SIGNATURES}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mg_error_string.argtypes = [ctypes.c_int]
    lib.mg_error_string.restype = ctypes.c_char_p
    return lib


def entry(base: str, dtype_itemsize: int | None = None):
    """The C entry point `base` for float32 (4) or float64 (8), or an
    entry point without a suffix (no itemsize)."""
    if dtype_itemsize is None:
        return getattr(library(), base)
    return getattr(library(), f"{base}_{'f32' if dtype_itemsize == 4 else 'f64'}")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().mg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
