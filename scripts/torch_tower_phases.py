"""Where the time of K3 and K4 (the coarse tower, one cooperative launch a
half) goes on one card: its level phases against its grid barriers.

    python3 scripts/torch_tower_phases.py

Prints one JSON line, float32, the card's time per call
(`utils.timing.device_ms`, 200 calls):

- `k3_ms` / `k4_ms` by start level s = 1 .. 4 of the n=1024 hierarchy: the
  tower over 4, 3, 2 and 1 levels (512 .. 64 onto the dense 32), so each
  step of s adds one level phase and one grid barrier;
- `k2_ms` by level: K2 (zero_init, residual) on that level alone, one
  launch of the same block over the same tiles;
- `barrier_us`: one `cooperative_groups` grid barrier at the tower's grid
  (`tower_grid`: blocks per SM, SMs, blocks of 512 threads), from a
  cooperative kernel that does nothing but 1000 of them, built here with
  nvcc;
- the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BARRIERS = 1000
_BARRIER_SRC = r"""
#include <cooperative_groups.h>
__global__ void __launch_bounds__(512, 1) spin(int n) {
  __shared__ float window[4488];  // the from_v block's 17,952 bytes
  window[threadIdx.x] = 0.f;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
  if (window[threadIdx.x] != 0.f) window[0] = 1.f;
}
extern "C" int barriers(int blocks, int n, cudaStream_t stream) {
  void* args[] = {&n};
  return cudaLaunchCooperativeKernel((const void*)spin, dim3(blocks),
                                     dim3(512), args, 0, stream);
}
"""


def _barrier_kernel(tmp: pathlib.Path):
    from hpcclassmultigridproject_tpu_torch.ops.cuda import _build

    src, lib = tmp / "barrier.cu", tmp / "libbarrier.so"
    src.write_text(_BARRIER_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).barriers
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke
    from hpcclassmultigridproject_tpu_torch.mg.cycle import coarse_solve_dense
    from hpcclassmultigridproject_tpu_torch.mg.levels import build_hierarchy
    from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother, tower
    from hpcclassmultigridproject_tpu_torch.utils.timing import device_ms

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: nothing measured")
    dev, n, dt = torch.device("cuda", 0), 1024, torch.float32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    vel = np.random.default_rng(7).standard_normal((2, n + 1, n + 1))
    levels = build_hierarchy(
        vel[0], vel[1], 0.1 / n, -4e-4,
        chip_smoke.delta_config().resolved_num_levels(n), dtype=dt,
        device=dev, coarse_mode="dense")
    rng = np.random.default_rng(2024)
    out = {"card": smi, "k3_ms": {}, "k4_ms": {}, "k2_ms": {}}
    for s in range(1, len(levels) - 1):
        rhs = chip_smoke._field(rng, levels[s].padded, levels[s].n, dt, dev)
        u_mids, rhs_mids, bottom = tower.tower_descend_plain(levels, s, rhs, 3)
        v = coarse_solve_dense(levels[-1], bottom)
        key = f"s={s} (n={levels[s].n}, {len(levels) - 1 - s} levels)"
        out["k3_ms"][key] = device_ms(
            lambda: tower.tower_descend(levels, s, rhs, 3), 200)
        out["k4_ms"][key] = device_ms(
            lambda: tower.tower_ascend(levels, s, v, u_mids, rhs_mids, 3),
            200)
        if s == 1:  # the main path's call: (blocks/SM, SMs, blocks)
            out["tower_grid"] = list(tower.GRID["descent", dt])
        out["k2_ms"][f"n={levels[s].n}"] = device_ms(
            lambda: smoother.fused_rb_sweeps(levels[s], None, rhs, 3, True,
                                             zero_init=True), 200)
    blocks = out["tower_grid"][2]
    with tempfile.TemporaryDirectory() as tmp:
        fn = _barrier_kernel(pathlib.Path(tmp))
        stream = torch.cuda.current_stream(dev).cuda_stream
        ms = {}
        for count in (0, BARRIERS):
            def launch():
                if fn(blocks, count, stream) != 0:
                    raise RuntimeError("the barrier kernel's launch failed")
            ms[count] = device_ms(launch, 20)
    out["barrier_us"] = (ms[BARRIERS] - ms[0]) / BARRIERS * 1e3
    out["empty_cooperative_launch_us"] = ms[0] * 1e3
    print(json.dumps(out))


if __name__ == "__main__":
    main()
