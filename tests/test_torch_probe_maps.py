"""PyTorch port: P's two index maps, stride2_rows and interleave_rows
(`ops/cuda/probe.py`, `csrc/probe.cu::map_kernel`), on the CPU.

The wrappers give x[::2, :] (ceil(R/2) rows, odd R included) and
stack([x, x + 1], 1).reshape(2R, C) (R = 0 included); with the kernel
route forced, they allocate those shapes and launch nothing for an empty
output.

The kernel source itself runs here too: g++ builds `csrc/probe.cu` against
a small stand-in for the CUDA runtime (`SHIM`), with each `<<<...>>>`
launch turned into a call that runs the grid's blocks and threads one at a
time on the host.  The wrappers then launch `launch_map` and `map_kernel`
on CPU tensors, and their results are held to the plain versions bit for
bit: for the float4 item, the float item (odd columns, a view one float
off), odd and single rows, and past the launch limit of 65535 block rows.
Run thread by thread on a watched output, every output value must be
stored exactly once, by the real launch geometry and by one with the
limit lowered to one block row (each thread then takes every 8th row).
chip_smoke.py holds the kernel to the plain versions on the card.
"""

import ctypes
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build, probe

MAPS = ["stride2_rows", "interleave_rows"]

# Enough of the CUDA runtime for g++ to build probe.cu and run its kernels
# on the host.  `mg_host_launch` runs every thread of the grid in turn.
# With a watch set, each thread runs alone on the watched output, first
# filled with a sentinel; each value it changed counts one store.
SHIM = r"""
#pragma once
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
typedef void* cudaStream_t;
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
inline void __syncthreads() {}
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
inline int cudaGetLastError() { return 0; }

constexpr uint32_t MG_SENTINEL = 0x7fc0deadu;
inline uint32_t* mg_watch_out = nullptr;
inline long mg_watch_n = 0;
inline int* mg_watch_count = nullptr;
inline uint32_t* mg_watch_value = nullptr;
// the last launch: grid x, y, z, block x, y, z, bytes of the first
// argument's item
inline long mg_last[7];

extern "C" void mg_shim_watch(float* out, long n, int* count, float* value) {
  mg_watch_out = reinterpret_cast<uint32_t*>(out);
  mg_watch_n = n;
  mg_watch_count = count;
  mg_watch_value = reinterpret_cast<uint32_t*>(value);
}

extern "C" void mg_shim_last(long* out) { std::copy(mg_last, mg_last + 7, out); }

template <class First, class... P, class... A>
void mg_host_launch(dim3 grid, dim3 block, size_t, cudaStream_t,
                    void (*kernel)(First, P...), A... args) {
  gridDim = grid;
  blockDim = block;
  const long last[7] = {grid.x, grid.y, grid.z, block.x, block.y, block.z,
                        sizeof(std::remove_pointer_t<First>)};
  std::copy(last, last + 7, mg_last);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx)
        for (unsigned tz = 0; tz < block.z; ++tz)
          for (unsigned ty = 0; ty < block.y; ++ty)
            for (unsigned tx = 0; tx < block.x; ++tx) {
              blockIdx = dim3(bx, by, bz);
              threadIdx = dim3(tx, ty, tz);
              if (mg_watch_out)
                std::fill(mg_watch_out, mg_watch_out + mg_watch_n,
                          MG_SENTINEL);
              kernel(args...);
              if (mg_watch_out)
                for (long i = 0; i < mg_watch_n; ++i)
                  if (mg_watch_out[i] != MG_SENTINEL) {
                    ++mg_watch_count[i];
                    mg_watch_value[i] = mg_watch_out[i];
                  }
            }
}
"""

LAUNCH_LIMIT = "constexpr int MAP_MAX_GRID_Y = 65535;"


def _build_host(directory, source: str) -> ctypes.CDLL:
    """probe.cu's `source` built by g++ against SHIM, each `kernel<<<grid,
    block, smem, stream>>>(args)` made `mg_host_launch(grid, block, smem,
    stream, kernel, args)`."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel source for the host"
    (directory / "cuda_runtime.h").write_text(SHIM)
    host = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(",
                  r"mg_host_launch(\2, \1, ", source, flags=re.S)
    assert "<<<" not in host and host.count("mg_host_launch(") == 5
    src, lib = directory / "probe_host.cpp", directory / "libprobe_host.so"
    src.write_text(host)
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-Wno-unknown-pragmas", "-shared",
                    "-fPIC", "-I", str(directory), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    for name, argtypes in _build._F32_SIGNATURES.items():
        getattr(cdll, name).argtypes = argtypes
        getattr(cdll, name).restype = ctypes.c_int
    cdll.mg_shim_watch.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                   ctypes.c_void_p, ctypes.c_void_p]
    cdll.mg_shim_watch.restype = None
    cdll.mg_shim_last.argtypes = [ctypes.c_void_p]
    cdll.mg_shim_last.restype = None
    return cdll


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{"limit": probe.cu as it is, "grid_y_1": with MAP_MAX_GRID_Y = 1},
    built for the host."""
    source = (_build.CSRC / "probe.cu").read_text()
    assert source.count(LAUNCH_LIMIT) == 1
    libs = {}
    for name, text in (("limit", source),
                       ("grid_y_1", source.replace(
                           LAUNCH_LIMIT, "constexpr int MAP_MAX_GRID_Y = 1;"))):
        libs[name] = _build_host(tmp_path_factory.mktemp(name), text)
    return libs


@pytest.fixture
def kernel_route(monkeypatch, host_libs):
    """The wrappers launch the host build of probe.cu on CPU tensors."""
    lib = host_libs["limit"]
    monkeypatch.setattr(cuda, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "entry", lambda name: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


def _last(lib) -> dict:
    got = (ctypes.c_long * 7)()
    lib.mg_shim_last(got)
    return dict(grid=tuple(got[:3]), block=tuple(got[3:6]), item=got[6])


def _input(rows: int, cols: int, offset: int, seed: int = 7) -> torch.Tensor:
    """x ~ N(0, 1) of (rows, cols), `offset` floats past an aligned buffer
    (torch's own CPU allocations are 64-byte aligned)."""
    base = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        rows * cols + offset).astype(np.float32)).clone()
    return base[offset:].view(rows, cols)


def _walk_rows(name: str, rows: int) -> int:
    return rows if name == "interleave_rows" else (rows + 1) // 2


# (rows, cols, x's offset in floats): (64, 256) is the probe's shape;
# (1032, 1152) the main path's fine level
_SHAPES = {"probe": (64, 256, 0), "odd": (65, 257, 0), "one_row": (1, 256, 0),
           "three_rows": (3, 256, 0), "one_by_four": (1, 4, 0),
           "three_by_five": (3, 5, 0), "two_by_three": (2, 3, 0),
           "misaligned": (64, 256, 1), "fine_level": (1032, 1152, 0)}
_WATCHED = ["probe", "odd", "one_by_four", "three_by_five", "two_by_three",
            "misaligned"]


@pytest.mark.parametrize("case", list(_SHAPES))
@pytest.mark.parametrize("name", MAPS)
def test_map_kernel_matches_plain(kernel_route, name, case):
    """The kernel source, launched by its wrapper, equals the plain version
    bit for bit; the float4 item runs where C % 4 == 0 and x is 16-byte
    aligned, else the float item; one launch a call."""
    rows, cols, offset = _SHAPES[case]
    x = _input(rows, cols, offset)
    cuda.reset_launches()
    got = getattr(probe, name)(x)
    assert cuda.LAUNCHES[f"probe_{name}"] == 1
    want = getattr(probe, f"{name}_plain")(x)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    launch = _last(kernel_route)
    assert launch["item"] == (16 if cols % 4 == 0 and offset % 4 == 0 else 4)
    assert launch["block"] == (32, 8, 1)
    assert launch["grid"][1] == -(-_walk_rows(name, rows) // 8)


@pytest.mark.parametrize("name", MAPS)
def test_map_kernel_takes_rows_past_the_launch_limit(kernel_route, name):
    """Past 65535 block rows of 8 the grid stops at the limit and a thread
    takes a row again, gridDim.y x 8 further on."""
    walk = 8 * 65535 + 3
    rows = walk if name == "interleave_rows" else 2 * walk - 1
    x = _input(rows, 4, 0)
    got = getattr(probe, name)(x)
    want = getattr(probe, f"{name}_plain")(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert _last(kernel_route)["grid"] == (1, 65535, 1)


@pytest.mark.parametrize("grid", ["limit", "grid_y_1"])
@pytest.mark.parametrize("case", _WATCHED)
@pytest.mark.parametrize("name", MAPS)
def test_map_kernel_writes_every_output_once(host_libs, name, case, grid):
    """Thread by thread, every output value is stored exactly once, from
    the right input, and nothing is stored past either end of the output;
    at one block row (grid_y_1) each thread takes every 8th row."""
    lib = host_libs[grid]
    rows, cols, offset = _SHAPES[case]
    x = _input(rows, cols, offset)
    want = getattr(probe, f"{name}_plain")(x)
    guard = 16
    buf = torch.full((want.numel() + 2 * guard,), -3.0)
    out = buf[guard:guard + want.numel()]
    count = torch.zeros(want.numel(), dtype=torch.int32)
    value = torch.full((want.numel(),), float("nan"))
    lib.mg_shim_watch(out.data_ptr(), out.numel(), count.data_ptr(),
                      value.data_ptr())
    try:
        err = getattr(lib, f"mg_probe_{name}")(x.data_ptr(), out.data_ptr(),
                                               rows, cols, None)
    finally:
        lib.mg_shim_watch(None, 0, None, None)
    assert err == 0
    np.testing.assert_array_equal(count.numpy(), 1)
    assert torch.equal(value.view(torch.int32),
                       want.reshape(-1).view(torch.int32))
    assert torch.all(buf[:guard] == -3.0) and torch.all(buf[-guard:] == -3.0)
    if grid == "grid_y_1":
        assert _last(lib)["grid"][1] == 1


def test_map_launchers_call_no_library_copy():
    """The two launchers launch map_kernel and copy nothing themselves."""
    source = (_build.CSRC / "probe.cu").read_text()
    assert "cudaMemcpy" not in source
    for entry in ("mg_probe_stride2_rows", "mg_probe_interleave_rows"):
        body = source[source.index(f'extern "C" int {entry}'):]
        assert "launch_map<" in body[:body.index("}")]


@pytest.mark.parametrize("rows", [1, 3, 65])
def test_stride2_rows_takes_odd_rows(rows):
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, 256)).astype(np.float32))
    got = probe.stride2_rows(x)
    assert got.shape == ((rows + 1) // 2, 256)
    np.testing.assert_array_equal(got.numpy(), x.numpy()[::2, :])


@pytest.mark.parametrize("rows", [0, 1])
def test_interleave_rows_takes_zero_and_one_row(rows):
    x = np.random.default_rng(rows).standard_normal((rows, 256)).astype(
        np.float32)
    got = probe.interleave_rows(torch.from_numpy(x))
    assert got.shape == (2 * rows, 256)
    np.testing.assert_array_equal(
        got.numpy(), np.stack([x, x + np.float32(1.0)], 1).reshape(2 * rows,
                                                                   256))


@pytest.mark.parametrize("shape", [(0, 256), (1, 256), (3, 256), (65, 257),
                                   (64, 0)])
@pytest.mark.parametrize("name", MAPS)
def test_map_wrappers_allocate_the_plain_shape(monkeypatch, name, shape):
    """With the kernel route forced, each wrapper allocates the plain
    version's shape (odd rows: ceil(R/2)), passes x's rows and columns,
    and launches nothing when the output is empty."""
    calls = []

    def launch(entry, counter, out, x_ptr, out_ptr, rows, cols):
        calls.append((entry, counter, rows, cols))
        return out

    monkeypatch.setattr(cuda, "use_kernel", lambda *t: True)
    monkeypatch.setattr(probe, "_launch", launch)
    x = torch.zeros(shape)
    kern, plain = getattr(probe, name), getattr(probe, f"{name}_plain")
    out = kern(x)
    assert out.shape == plain(x).shape and out.dtype == torch.float32
    want = [(f"mg_probe_{name}", f"probe_{name}", *shape)]
    assert calls == (want if out.numel() else [])
