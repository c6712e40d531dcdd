"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for the
H100; the kernels are built for sm_90a).

    python3 chip_smoke.py

Run from the repository root.  Phases, each printing its results and each
raising on failure:

1. device: the card's name, the device count, and nvidia-smi's name and
   power limit;
2. build: nvcc builds every kernel of the port from csrc/, and ptxas'
   registers, shared memory and spills of each entry are printed; the
   tower's kernels must read nothing through the read-only path (no
   LDG...CONSTANT in their SASS, by cuobjdump);
3. kernels: each kernel (K1 opening, K2 smoother in both flag sets of the
   main path, K3/K4 tower, K5 five-band and K6 nine-band smoothers on
   every smoothed level of their paths in the four flag sets of those
   paths, K7 on every shape the distributed path's two schedules launch
   at W=4, K8 whole-step opening in both residual modes) against its plain
   PyTorch version on the card, at the paths' shapes, in float32 (within 4
   ulp of the field's max-abs) and float64 (within 1e-13), with kernel and
   plain times and the bound of the byte and operation model
   (utils/profiling.py); K2 also in all six of its flag sets on every
   level of the n=1024 hierarchy and at nsweeps 1 on the gsbench level
   (2056x2176), with misaligned arrays and at nsweeps 20, K7 in all four
   of its on its 40 shapes, K5 and K6 with misaligned arrays and at
   nsweeps 14 (a chain of two launches), K6 at nsweeps 4, each
   bit-identical to its plain version; K3 and K4 (one cooperative launch
   each) bit-identical from level 1 and level 3 of n=1024 and level 1 of
   n=256 at nsweeps 1, 3 and 14, each called 20 times with every result
   equal to the first, with the grid each launch chose; the four K7 blocks
   of level 0, stitched, against K2 on the whole field; K8 bit for bit
   against its plain version and against K1 then K2 at nsweeps 3 and 14
   (K8 then a K2 link), in both residual modes, from aligned and from
   misaligned arrays; then K5's and K6's time, bound and launches at each
   level of a run of their paths;
4. main path: the n=1024, 100-step delta-form run through
   AdvectionDiffusion, with every certificate <= 1e-6, the center value,
   the launch count of every kernel, and the same run through the plain
   versions on the card;
5. golden: the n=256 delta-form run against tests/golden/uT_n256.npy;
6. galerkin: the main path with Galerkin coarse levels (K1, K2, K6);
7. poisson: Poisson(n=1024) in float64 to tol 1e-10 and in its float32
   default, which stalls at 50 cycles as the JAX package's does (K5);
8. refined: n=1024, 100 refined fixed-cycle steps, not in delta form (K2,
   K3, K4);
9. distributed: parallel.distributed_run of the main path over W=4 spawned
   ranks on the one card, over gloo with the halos staged through host
   memory (NCCL takes one rank per GPU), in the plain and the overlap
   schedule (K7, K3, K4) and once through the plain versions: every
   certificate, the center value, uT against phase 4's, and each
   schedule's launch counts; then one NCCL rank, whose 10-step
   distributed_run must equal a 10-step single-device run;
10. open-smooth: the main path with mg.delta._FUSE_OPEN_SMOOTH on (K8,
    K2 post-smooth, K3, K4; no K1): launch counts, certificates, the
    center, uT equal to phase 4's to the bit, and both paths' walls in
    turns;
11. cli: the port's CLI in subprocesses: the main configuration's `run`,
    the same checkpointed (its chunks' stats stitched: converged, every
    certificate <= 1e-6), `gsbench` at n=2048 with both backends, and
    `profile` of the main configuration;
12. probe: P's six kernels (ops/cuda/probe.py) against the JAX probe
    script's checks and bit for bit against their plain versions; the
    product kernel on dense operands (the three probe shapes, an unaligned
    one, two staging passes) bit for bit against its fixed order repeated
    in PyTorch and within k 2^-24 (|a| @ |b|) of the float64 product;
    flatten into a buffer of its own (no alias of x); stride2_rows and
    interleave_rows bit for bit against their plain versions at odd rows,
    one and three rows, a misaligned view, the main path's fine level
    (1032, 1152) and n=8192's (8200, 8320), launching nothing for an empty
    input, and timed at the probe's shape and the two real ones beside
    their bounds; with the library call's time beside each (torch.matmul
    for the products, a copy for flatten);
13. device build: (a) the main configuration built on the device
    (device_build=True) beside the host build: both builds' seconds,
    every level, the dense inverse, fine_hi and u0 against the host-built
    model's at the JAX package's tolerances, the 100-step run certified,
    its launch counts equal to phase 4's and its uT within rtol 1e-5 /
    atol 1e-10 of phase 4's; (b) n=16384 on the one card with
    device_build=None, which must pick the device and say so: build
    seconds, peak MiB after the build and after the run, 10 steps with
    certify_every=10 at the auto cycle count (and each smaller count, to
    find the smallest that certifies), every certificate, the wall, and
    levels 0, fine_hi and u0 on 24 seeded and edge rows against numpy
    float64; (d) the explicit matrix (sparse/matrix.py): CSR SpMV on the
    card (cuSPARSE) against the stencil at n=1024 level 0 in float64 and
    on a Galerkin level (atol 1e-13), with both times.

14. 2-D layout and scaling: W=4 gloo ranks on cuda:0 (not a scaling
    figure).  (a) the main path at n=1024 through distributed_run in the
    2-D layout over a 2x2 mesh, min_local 64 (levels 1024..128 in 2-D
    blocks, K3/K4 from 64), plain and with sharded_overlap (halo.py's
    overlapped sweep): MAIN_STEPS steps unless a timed warm-up says a run
    would pass GRID_MAX_RUN_S, then fewer (printed, and compared with a
    single-device run of as many); uT within 1e-9 of the single-device
    run, every certificate, plain and overlap equal to the bit, each
    rank's K3/K4 counts, walls, peak MiB and collectives a step; (b) at
    n=256, 5 steps, min_local 16, in both layouts: FMG plain and refined,
    Jacobi, Chebyshev, Galerkin (nine-band levels partitioned) and the
    main configuration, each within 1e-9 of its single-device run on the
    card (bitwise printed) and certified, and the main one born
    2-D-partitioned equal to the whole build's run to the bit; (c)
    `smooth_distributed` on the n=1024 level 0, plain and overlapped,
    equal to K2 on the whole level to the bit, with its wall and the ms
    of one exchange; (d) `cli scaling` in subprocesses: strong over 1, 2,
    4 ranks at n=1024 in the rows and the 2-D layout, weak at n=512 and
    1024, each line's keys, devices, n and mesh, and center_uT within
    1e-9 of a single-device run.
15. routes and oracle: (a) the main path of phase 4 once with each of
    the JAX package's switches off (mg.cycle._FUSE_CORR, _USE_TOWER,
    _RESTRICT_DEC, mg.delta._FUSE_OPEN: the unfused forms) and once with
    backend="jnp" (the plain versions on the card), beside the default
    route: each uT equal to phase 4's to the bit, every certificate
    <= 1e-6, every kernel's launch count exact (no K1-K8 under "jnp"),
    and each route's wall in turns (median of 6), device busy, idle
    share, launch calls and peak MiB; (b) the float64 adaptive reference
    configuration (GS coarse solve, injection; K2 in float64) against the
    port's own native C++ oracle (native/, built with g++) at n=64, 2
    levels, 100 steps, V- and W-cycles, within 1e-12 and with the
    V-cycle's cycles a step equal, and at n=256 against
    tests/golden/uT_n256.npy within 1e-12, center within 5e-9 of
    4.802e-5, at most one cycle a step; (c) the logical-shape operations
    (ops) on the card against the oracle in float64 at
    tests/test_ops.py's tolerances.

16. multi-gpu: the partitioned run over four cards, one NCCL rank a card
    (`launch_local(..., backend="nccl", device="cuda")`: rank r on
    cuda:r, halos and norms on the device).  On fewer than four cards one
    line says it was not run, with the device count, and nothing else
    runs.  On four it prints nvidia-smi's index, name and power limit of
    each card and `nvidia-smi topo -m`, then: (a) the main path at
    n=1024, 100 steps, min_local 64, through distributed_run in the rows
    layout (K7, plain and overlapped schedule) and the 2-D layout (plain
    and overlapped sweep), built whole and born partitioned: uT within
    1e-9 of phase 4's (bitwise printed), every certificate, every rank's
    launch counts exact (K7 6 a step plain, 18 overlapped; K3/K4 one a
    step), every rank posting the same collectives (counted a step),
    rank 0's wall (built whole: median of 5 after a warm-up; born: one
    run), peak MiB per rank, and the ms of each exchange and all-gather
    at the path's shapes; (b)
    phase 14 (b) over NCCL; (c) n=16384 born partitioned in each layout,
    10 steps at phase 13's cycle count, uT equal to phase 13's one-card
    uT to the bit (SHA-256), and n=32768 born row-partitioned, 10 steps
    at the auto cycle count (if it does not certify, at each larger count
    until one does), every certificate <= 1e-6, build seconds and peak
    MiB per rank; (d) `cli scaling` over NCCL, strong at n=8192 over 1,
    2, 4 ranks and weak at n=4096 and 8192 over 1 and 4, in both layouts,
    at the auto cycle count, each center within 1e-9 of a single-device
    run.
17. compiled (run before phase 16, whose rank 0 takes cuda:0): the
    models' entry points as compiled programs, each captured once as a
    CUDA graph and replayed (utils/graphs.py), against their eager runs
    (`timestepper`, `mg_solve_fixed`, `fmg_solve` called directly).
    (a) the tower alone (two cooperative launches) captured and replayed
    against its eager call to the bit; the main path at n=1024, 100
    steps: 6 replays, each with uT and every stats tensor equal to the
    eager run's (phase 4's uT) to the bit and launch counts equal to
    eager's, the certificates and the center;
    the capture seconds (warm-up, capture, instantiation), the graph's
    node count, walls in turns against eager (median of 6), busy by
    torch.profiler and the graph alone by CUDA events, idle shares, peak
    MiB allocated and reserved; (b) every other captured configuration:
    open-smooth and each switch of phase 15 off, Galerkin (delta form),
    refined fixed, mg_solve_fixed with and without Galerkin levels,
    fmg_solve, Jacobi and Chebyshev (10 steps), backend="jnp", Poisson
    fixed and fmg in float64 and fixed in float32: each replay equal to
    its eager run to the bit with equal launch counts, with the same
    numbers; (c) two runs from different u0 independent, `step` and
    `run_chunk(10)` equal to eager, the checkpointed run (every=10) equal
    to its eager chunks to the bit and within 1e-9 of `run`'s uT, and
    each switch and the backend flipped between calls giving the flipped
    route's eager uT; (d) n=16384, 10 steps at phase 13's cycle count,
    eager and captured, each uT equal to phase 13's to the bit, with peak
    MiB.  It frees its models and graphs and empties the cache at the end.

Phase 9 also builds the main path's model born row-partitioned over its
W=4 ranks (AdvectionDiffusion(mesh=...), min_local=64; phase 13's (c)):
its uT must equal, to the bit, distributed_run of the whole device-built
model in the same spawn, with the certificates and K7 counts of the plain
schedule, and each rank's peak MiB, build through run, lower than the
whole-built model's.

Each path phase (4, 6, 7, 8, 9, 10, 13, 15) resets the launch counts just
before the run it reads, checks every count, and (but 15, whose "jnp"
route is the plain one) runs the same path once more through the plain
versions.  On the card `AdvectionDiffusion.run`, `step` and `run_chunk`
and `Poisson.solve` in fixed and fmg mode replay captured graphs (the
route is part of a graph's key, so the plain run captures its own); a
replay adds the launch counts its capture recorded, and phase 17 holds
each to its eager run.  Phase 14 (a) resets and checks each rank's
counts the same way; its 2-D blocks run plain torch, with no kernel.

The last two lines are a JSON object with the kernels' numbers (launches
on their path, max difference, kernel, plain and bound ms, and the time of
one PyTorch call computing the same function where there is one), then
{"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "hpcclassmultigridproject_tpu_torch"
TPU = "hpcclassmultigridproject_tpu/ops/pallas"
PROBE_TPU = "scripts/mosaic_probe_tpu.py:39"
PROBES = ["stride2_rows", "dot_decimate", "interleave_rows", "flatten",
          "dot_decimate_rows", "dot_prolong_rows"]
KERNELS = [  # (counter, name, source, the TPU kernel's pallas_call)
    ("delta_open", "K1 delta opening", f"{PKG}/csrc/delta_step.cu",
     f"{TPU}/delta_step.py:131"),
    ("smooth", "K2 red-black smoother", f"{PKG}/csrc/smoother.cu",
     f"{TPU}/smoother.py:437"),
    ("tower_descent", "K3 tower descent", f"{PKG}/csrc/tower.cu",
     f"{TPU}/tower.py:326"),
    ("tower_ascent", "K4 tower ascent", f"{PKG}/csrc/tower.cu",
     f"{TPU}/tower.py:349"),
    ("smooth5", "K5 five-band smoother", f"{PKG}/csrc/smoother.cu",
     f"{TPU}/smoother.py:437"),
    ("smooth9", "K6 nine-band smoother", f"{PKG}/csrc/smoother.cu",
     f"{TPU}/smoother.py:437"),
    ("smooth_rows", "K7 row-offset smoother", f"{PKG}/csrc/smoother.cu",
     f"{TPU}/smoother.py:437"),
    ("open_presmooth", "K8 whole-step opening", f"{PKG}/csrc/delta_step.cu",
     f"{TPU}/delta_step.py:329"),
] + [(f"probe_{p}", f"P {p}", f"{PKG}/csrc/probe.cu", PROBE_TPU)
     for p in PROBES]
MAIN_N, MAIN_STEPS = 1024, 100
CENTER_1024 = 4.60419316843316e-5  # delta form at n=1024 (BENCH_r05.json)
# the JAX package's values on the CPU under x64, at n=1024
CENTER_GALERKIN = 4.604193168566387e-05   # delta form, Galerkin levels
CENTER_REFINED = 4.604193170120696e-05    # refined, fixed, one cycle
CENTER_POISSON = 0.07367129792055582      # u[512, 512], f64, tol 1e-10
TOL = 1e-6
DIST_WORLD, DIST_MIN_LOCAL, NCCL_STEPS = 4, 64, 10
# phase 13: n=16384 on one card, built on the device (auto), 10 steps
BIG_N, BIG_STEPS, BIG_ROWS = 16384, 10, 18
# the JAX package's bounds of the device build against the host build
# (tests/test_levels_device.py)
BUILD_TOL = {torch.float32: (1e-6, 1e-7), torch.float64: (1e-14, 1e-15)}
U0_TOL, A_INV_TOL, RUN_TOL = (1e-13, 1e-300), (1e-5, 1e-6), (1e-5, 1e-10)
TOWER_SWEEPS, TOWER_REPEATS = (1, 3, 14), 20  # 14: a chain of two links
K8_SWEEPS = (3, 14)  # 14: K8 of 13 sweeps, then a K2 link
# the host calls that launch a kernel or a captured graph, as
# torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaLaunchCooperativeKernelExC", "cuLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")
GSBENCH_N, GSBENCH_SWEEPS = 2048, 500  # the reference's GS microbenchmark
# K2's flag sets (the C entry's ZERO_INIT / ADD_CORR / u starts, WANT_RES,
# RES_ROWS_DEC): pre- and post-smooth of the main path first, gsbench's last
FROM_V_FLAG_SETS = {
    "zero_init, res_rows_dec": dict(zero_init=True, want_residual=True,
                                    residual_rows_decimated=True),
    "corr, residual": dict(corr="corr", want_residual=True),
    "zero_init, residual": dict(zero_init=True, want_residual=True),
    "corr": dict(corr="corr"),
    "u, residual": dict(want_residual=True),
    "u": {},
}
# K7's: the distributed path's two first (timed), then without the residual
K7_FLAG_SETS = {
    "zero_init, residual": dict(zero_init=True, want_residual=True),
    "u, residual": dict(want_residual=True),
    "zero_init": dict(zero_init=True),
    "u": {},
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def delta_config(**kw):
    from hpcclassmultigridproject_tpu_torch import SolverConfig

    return SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                        tol=TOL, cycle_mode="fixed", num_cycles=1,
                        coarse_mode="dense", delta_form=True, **kw)


def time_ms(fn, reps: int) -> float:
    """Mean time per call of `fn` in ms as the host issues them: CUDA events
    around `reps` calls after one warm-up call (where a call's host cost
    exceeds its kernels, this reads the host cost)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {name}; device_count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    return name


def phase_build() -> None:
    from hpcclassmultigridproject_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if any(k in line for k in ("Compiling entry", "spill", "Used")):
            print(f"[build]   {line.strip()}")
    loads = _constant_loads(lib)
    if loads is None:
        print("[build] cuobjdump not found: SASS not read")
        return
    for name, count in sorted(loads.items()):
        if "descend_kernel" in name or "ascend_kernel" in name:
            print(f"[build] SASS {name}: {count} LDG...CONSTANT")
            require(count == 0, f"{name} reads through the read-only path, "
                    "which does not see an earlier level phase's writes")


def _constant_loads(lib) -> dict | None:
    """{kernel: count of read-only-path global loads (LDG...CONSTANT)} in
    the library's SASS, or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            kernel = found.group(1)
            counts[kernel] = 0
        elif kernel and re.search(r"LDG\.E[.\w]*CONSTANT", line):
            counts[kernel] += 1
    return counts


def _field(rng, shape, n, dtype, device, scale=1.0):
    """Random field, zero outside the open interior [1:n, 1:n]."""
    x = np.zeros(shape)
    x[1:n, 1:n] = scale * rng.standard_normal((n - 1, n - 1))
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _flatten(result):
    """The tensors of a kernel's result: a tensor, or tuples and lists of
    them (None entries dropped)."""
    if isinstance(result, (tuple, list)):
        return [t for x in result for t in _flatten(x)]
    return [] if result is None else [result]


def _compare(name, got, want, dtype):
    """Max-abs difference of the kernel's outputs from the plain version's,
    each within 1e-13 (float64) or 4 ulp of its field's max-abs (float32);
    returns (max difference, loosest bound, bit-identical)."""
    err, bound, exact = 0.0, 0.0, True
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape, f"{name}[{i}]: shape {g.shape} vs {w.shape}")
        require(bool(torch.isfinite(g).all()), f"{name}[{i}]: non-finite")
        e = (g - w).abs().max().item()
        b = 1e-13 if dtype == torch.float64 else 4.0 * float(
            np.spacing(np.float32(w.abs().max().item())))
        require(e <= b, f"{name}[{i}]: max|kernel - plain| {e:.3g} > {b:.3g}")
        err, bound = max(err, e), max(bound, b)
        exact = exact and torch.equal(g, w)
    return err, bound, exact


# K5's and K6's flag sets: the four of their paths
BAND_FLAG_SETS = {
    "zero_init, residual": dict(want_residual=True, zero_init=True),
    "zero_init, res_rows_dec": dict(want_residual=True, zero_init=True,
                                    residual_rows_decimated=True),
    "corr": dict(corr="corr"),
    "u, residual": dict(want_residual=True),
}
# the smoothed levels of the Poisson path (K5) and the nine-band levels of
# the Galerkin path (K6) at n=1024, and the f32 Poisson default's cycles
POISSON_LEVELS, GALERKIN_LEVELS = range(5), range(1, 5)
POISSON_F32_CYCLES = 50


def _path_flags(tag: str, lvl: int) -> tuple[str, str]:
    """The flag sets K5 (`smooth5`) or K6 (`smooth9`) runs at level lvl of
    its path, each once a cycle or step (mg/cycle.py::mg_cycle): Poisson
    pre-smooths level 0 from u and a coarser level from zero with the full
    residual, the Galerkin delta path from zero with the residual's even
    rows; both post-smooth with the correction."""
    if tag == "smooth9":
        return ("zero_init, res_rows_dec", "corr")
    return ("u, residual" if lvl == 0 else "zero_init, residual", "corr")


def _band_cases(tag, levels, f, lvls):
    """K5 (`smooth5`) or K6 (`smooth9`) on levels[lvl] for each lvl of
    `lvls` in every flag set of BAND_FLAG_SETS, nsweeps 3: {name: (kernel,
    plain version, shape, (bytes, flops))}.  `f(scale, lvl)` makes a field
    of level lvl's shape."""
    from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother
    from hpcclassmultigridproject_tpu_torch.utils import profiling

    cases = {}
    for lvl in lvls:
        level = levels[lvl]
        u, corr, rhs = f(1.0, lvl), f(1e-2, lvl), f(1.0, lvl)
        for name, kw in BAND_FLAG_SETS.items():
            kw = {k: corr if v == "corr" else v for k, v in kw.items()}
            cases[f"{tag} (level {lvl}, {name})"] = (
                lambda level=level, u=u, rhs=rhs, kw=kw:
                    smoother.fused_rb_sweeps(level, u, rhs, 3, **kw),
                lambda level=level, u=u, rhs=rhs, kw=kw:
                    smoother.fused_rb_sweeps_plain(level, u, rhs, 3, **kw),
                level.padded,
                profiling.smooth_cost(
                    level, rhs.element_size(), 3,
                    read_u=not kw.get("zero_init", False), corr="corr" in kw,
                    want_residual=kw.get("want_residual", False),
                    res_dec=kw.get("residual_rows_decimated", False)))
    return cases


def _one_off(x):
    """x in a buffer that starts one value before it: no row of it is
    aligned to a pair of values."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def _band_checks(poisson, galerkin, f):
    """K5 and K6 past their paths' calls: on their 72x128 level with
    arrays one value off alignment (the block's FV_SINGLES instance) and at
    nsweeps 14 (a chain of two launches), and K6 at nsweeps 4 on 520x640
    (one launch; its float64 window refused that before the from_v
    block): {name: (kernel, plain version, shape)}, all from u + corr with
    the full residual."""
    from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother

    cases = {}
    for tag, levels in (("smooth5", poisson), ("smooth9", galerkin)):
        runs = [(4, 3, "arrays one value off alignment", True),
                (4, 14, "nsweeps 14, two launches", False)]
        if tag == "smooth9":
            runs.append((1, 4, "nsweeps 4", False))
        for lvl, ns, what, off in runs:
            level = levels[lvl]
            u, corr, rhs = f(1.0, lvl), f(1e-2, lvl), f(1.0, lvl)
            if off:
                u, corr, rhs = _one_off(u), _one_off(corr), _one_off(rhs)
            name = f"{tag} check (corr, residual, {what}) at {level.padded}"
            cases[name] = (
                lambda level=level, ns=ns, u=u, rhs=rhs, corr=corr:
                    smoother.fused_rb_sweeps(level, u, rhs, ns, True,
                                             corr=corr),
                lambda level=level, ns=ns, u=u, rhs=rhs, corr=corr:
                    smoother.fused_rb_sweeps_plain(level, u, rhs, ns, True,
                                                   corr=corr),
                level.padded)
    return cases


def _rank_views(levels, world: int, rank: int):
    """Rank `rank`'s view of the distributed path's levels (W ranks,
    min_local 64): (cut levels, partitions), with no process group."""
    from hpcclassmultigridproject_tpu_torch.parallel import Mesh
    from hpcclassmultigridproject_tpu_torch.parallel.sharding import (
        shard_hierarchy,
    )

    return shard_hierarchy(levels, Mesh(world=world, rank=rank),
                           DIST_MIN_LOCAL)


def _ext_rows(x, part):
    """Rows [start − h, stop + h) of the whole field x, zero past it: the
    extended block the deep-halo exchange gives a rank."""
    import torch.nn.functional as F

    h = part.halo
    full = F.pad(x, (0, 0, h, part.span - x.shape[0] + h))
    return full[part.start:part.stop + 2 * h].contiguous()


def _smooth_rows_cases(levels, f):
    """K7 on the W=4 blocks: level 0 at the first, a middle and the last
    rank, levels 1 and 2 at a middle rank, each in the two flag sets of
    the distributed path, on every shape its two schedules launch: the
    extended block (plain schedule), and the raw block and the two 3h-row
    edge slabs (overlap schedule)."""
    from hpcclassmultigridproject_tpu_torch.mg.levels import level_rows
    from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother
    from hpcclassmultigridproject_tpu_torch.utils import profiling

    cases = {}
    picks = [(0, 0), (0, 1), (0, DIST_WORLD - 1), (1, 1), (2, 1)]
    for lvl, rank in picks:
        cut, parts = _rank_views(levels, DIST_WORLD, rank)
        level, part = cut[lvl], parts[lvl]
        h, start, stop, local = part.halo, part.start, part.stop, part.local
        u = _ext_rows(f(lvl=lvl), part)
        rhs = _ext_rows(f(lvl=lvl), part)
        # (schedule's block, global rows [a, b)); ext row 0 is start − h
        blocks = [("extended", start - h, stop + h),
                  ("overlap raw", start, stop),
                  ("overlap top slab", start - h, start + 2 * h),
                  ("overlap bottom slab", stop - 2 * h, stop + h)]
        for what, a, b in blocks:
            lv = level if what == "extended" else level_rows(level, a, b)
            uu, rr = (x[a - start + h:b - start + h].contiguous()
                      for x in (u, rhs))
            assert lv.padded[0] == b - a and (b - a) in (local + 2 * h,
                                                         local, 3 * h)
            for flags, kw in K7_FLAG_SETS.items():
                cases[f"smooth_rows ({what}, level {lvl}, rank {rank}, "
                      f"row_off {lv.row_off}, {flags})"] = (
                    lambda lv=lv, uu=uu, rr=rr, kw=kw:
                        smoother.fused_rb_sweeps_rows(lv, uu, rr, 3, **kw),
                    lambda lv=lv, uu=uu, rr=rr, kw=kw:
                        smoother.fused_rb_sweeps_plain(lv, uu, rr, 3, **kw),
                    lv.padded,
                    profiling.smooth_cost(
                        lv, uu.element_size(), 3,
                        read_u=not kw.get("zero_init", False),
                        want_residual=kw.get("want_residual", False)))
    return cases


def _from_v_checks(levels, f, gs_level, g):
    """K2 against its plain version in every flag set (FROM_V_FLAG_SETS) on
    each level of the main path's hierarchy at nsweeps 3, and on the
    gsbench level (n=2048) at nsweeps 1; then on the 72x128 level with its
    arrays one value off a pair's alignment (the block's FV_SINGLES
    instance), and at nsweeps 20 (a chain of two launches): {name:
    (kernel, plain version, shape)}.  `g(scale)` makes a field of the
    gsbench level."""
    from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother

    cases = {}
    shapes = [(lv, 3, lambda s, i=i: f(s, i)) for i, lv in enumerate(levels)]
    for level, ns, field in shapes + [(gs_level, 1, g)]:
        u, corr, rhs = field(1.0), field(1e-2), field(1.0)
        for flags, kw in FROM_V_FLAG_SETS.items():
            kw = {k: corr if v == "corr" else v for k, v in kw.items()}
            cases[f"smooth check ({flags}, nsweeps {ns}) at "
                  f"{level.padded}"] = (
                lambda level=level, ns=ns, u=u, rhs=rhs, kw=kw:
                    smoother.fused_rb_sweeps(level, u, rhs, ns, **kw),
                lambda level=level, ns=ns, u=u, rhs=rhs, kw=kw:
                    smoother.fused_rb_sweeps_plain(level, u, rhs, ns, **kw),
                level.padded)

    lvl = len(levels) - 2
    level = levels[lvl]
    u, corr, rhs = f(1.0, lvl), f(1e-2, lvl), f(1.0, lvl)
    for name, ns, args in (
            ("arrays one value off alignment", 3,
             (_one_off(u), _one_off(rhs), dict(corr=_one_off(corr)))),
            ("nsweeps 20, two launches", 20, (u, rhs, dict(corr=corr)))):
        uu, rr, kw = args
        cases[f"smooth check (corr, residual, {name}) at {level.padded}"] = (
            lambda ns=ns, uu=uu, rr=rr, kw=kw: smoother.fused_rb_sweeps(
                level, uu, rr, ns, True, **kw),
            lambda ns=ns, uu=uu, rr=rr, kw=kw: smoother.fused_rb_sweeps_plain(
                level, uu, rr, ns, True, **kw),
            level.padded)
    return cases


def _tower_checks(hierarchies, field):
    """K3 and K4 against their plain versions from each (levels, s) of
    `hierarchies` at every nsweeps of TOWER_SWEEPS; the ascent from the
    coarse solution of the plain descent: {name: (kernel, plain version,
    shape)}.  `field(levels, lvl)` makes an rhs of levels[lvl]."""
    from hpcclassmultigridproject_tpu_torch.mg.cycle import coarse_solve_dense
    from hpcclassmultigridproject_tpu_torch.ops.cuda import tower

    cases = {}
    for levels, s in hierarchies:
        rhs = field(levels, s)
        for ns in TOWER_SWEEPS:
            u_mids, rhs_mids, bottom = tower.tower_descend_plain(levels, s,
                                                                 rhs, ns)
            v = coarse_solve_dense(levels[-1], bottom)
            at = f"(n={levels[0].n}, s={s}, nsweeps {ns}) at {levels[s].padded}"
            args = (s, rhs, ns)
            cases[f"tower_descent check {at}"] = (
                lambda levels=levels, args=args: tower.tower_descend(
                    levels, *args),
                lambda levels=levels, args=args: tower.tower_descend_plain(
                    levels, *args),
                levels[s].padded)
            args = (s, v, u_mids, rhs_mids, ns)
            cases[f"tower_ascent check {at}"] = (
                lambda levels=levels, args=args: tower.tower_ascend(
                    levels, *args),
                lambda levels=levels, args=args: tower.tower_ascend_plain(
                    levels, *args),
                levels[s].padded)
    return cases


def _stitched_rows(levels, u, rhs, dtype):
    """The W K7 blocks of level 0 (halos cut from the whole field, as the
    exchange delivers them) stitched, against K2 on the whole field."""
    from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother
    from hpcclassmultigridproject_tpu_torch.parallel.rows_halo import (
        Exchange,
        smooth_block,
    )

    outs = []
    for rank in range(DIST_WORLD):
        cut, parts = _rank_views(levels, DIST_WORLD, rank)
        part, h = parts[0], parts[0].halo
        ext = [_ext_rows(x, part) for x in (u, rhs)]
        blocks = [x[h:h + part.local] for x in ext]
        halos = Exchange.given([(x[:h], x[h + part.local:]) for x in ext])
        outs.append(smooth_block(cut[0], part, blocks, halos, 3, True))
    rows = levels[0].padded[0]
    got = [torch.cat([o[i] for o in outs]) for i in (0, 1)]
    want = smoother.fused_rb_sweeps(levels[0], u, rhs, 3, True)
    torch.cuda.synchronize()
    err, bound, exact = _compare("smooth_rows stitched",
                                 [g[:rows] for g in got], want, dtype)
    past = max(float(g[rows:].abs().max()) for g in got)
    require(past == 0.0, "stitched K7 blocks: rows past the array not 0")
    print(f"[kernels] smooth_rows stitched: {DIST_WORLD} blocks of level 0 "
          f"{str(dtype)[6:]} against K2 on the whole {levels[0].padded} "
          f"field: max|K7 - K2| {err:.3g} (bound {bound:.3g}), "
          f"bit-identical {exact}")


def _k8_checks(fine, hi, lo, d, dtype) -> int:
    """K8 against its plain version and against K1 followed by K2 from zero
    (both on the card) at each nsweeps of K8_SWEEPS, in both residual
    modes, from aligned arrays (the block's FV_PAIRED instance) and from
    arrays one value off a pair's alignment (FV_SINGLES): the same
    expressions in the same order, so each must be bit-identical.  Returns
    the number of cases."""
    from hpcclassmultigridproject_tpu_torch.ops.cuda import (
        delta_step,
        smoother,
    )

    cases = 0
    for ns in K8_SWEEPS:
        for dec in (True, False):
            mode = "res_rows_dec" if dec else "full residual"
            for what, args in (("aligned", (hi, lo, d)),
                               ("one value off alignment",
                                tuple(_one_off(x) for x in (hi, lo, d)))):
                got = delta_step.fused_open_presmooth(fine, *args, ns, dec)
                plain = delta_step.fused_open_presmooth_plain(fine, *args, ns,
                                                              dec)
                hi2, lo2, rhs = delta_step.fused_accumulate_open(fine, *args)
                u1, r0 = smoother.fused_rb_sweeps(
                    fine, None, rhs, ns, True, zero_init=True,
                    residual_rows_decimated=dec)
                torch.cuda.synchronize()
                at = f"{mode}, nsweeps {ns}, {what}"
                for against, want in (("plain", plain),
                                      ("K1, K2", (hi2, lo2, rhs, u1, r0))):
                    err, bound, exact = _compare(f"K8 vs {against} ({at})",
                                                 got, want, dtype)
                    print(f"[kernels] open_presmooth ({at}) "
                          f"{str(dtype)[6:]} against {against} on the card:"
                          f" max|K8 - {against}| {err:.3g} (bound "
                          f"{bound:.3g}), bit-identical {exact}")
                    require(exact, f"K8 ({at}) not bit-identical to "
                            f"{against}")
                cases += 1
    return cases


def _band_levels(out: dict, levels) -> None:
    """K5's and K6's float32 time, bound and launches at each level of a
    run of their paths (Poisson f32, 50 cycles; Galerkin, 100 steps): the
    level's pre- and post-smooth, each launched once a cycle or step."""
    for tag, label, lvls, runs in (
            ("smooth5", "K5, Poisson f32", POISSON_LEVELS, POISSON_F32_CYCLES),
            ("smooth9", "K6, Galerkin", GALERKIN_LEVELS, MAIN_STEPS)):
        for lvl in lvls:
            rows = [out[f"{tag} (level {lvl}, {flags})"]
                    for flags in _path_flags(tag, lvl)]
            ms, bound = (statistics.mean(r[i] for r in rows) for i in (1, 3))
            print(f"[kernels] {label} level {lvl} {levels[lvl].padded}: "
                  f"{2 * runs} launches a run; kernel {ms:.4f} ms (pre "
                  f"{rows[0][1]:.4f}, post {rows[1][1]:.4f}), bound "
                  f"{bound:.4f} ms, plain "
                  f"{statistics.mean(r[2] for r in rows):.4f} ms; launches "
                  f"x (kernel - bound) "
                  f"{2 * runs * (ms - bound):.3f} ms")


def phase_kernels(device, n: int) -> dict:
    """Each kernel against its plain version at its paths' shapes for n,
    in float64 then float32; returns {counter: (max-abs difference, kernel
    ms, plain ms, bound ms, bound_by)} of the float32 run, the main path's
    dtype (a kernel with several flag sets: the largest difference and the
    mean times and bounds).  Kernel and plain ms are the card's time per
    call (`utils.timing.device_ms`)."""
    from hpcclassmultigridproject_tpu_torch.core.problem import (
        rotating_velocity,
    )
    from hpcclassmultigridproject_tpu_torch.mg.cycle import coarse_solve_dense
    from hpcclassmultigridproject_tpu_torch.mg.levels import (
        build_fine_level,
        build_hierarchy,
    )
    from hpcclassmultigridproject_tpu_torch.models.poisson import (
        build_poisson_hierarchy,
    )
    from hpcclassmultigridproject_tpu_torch.ops.cuda import (
        delta_step,
        smoother,
        tower,
    )
    from hpcclassmultigridproject_tpu_torch.utils import profiling
    from hpcclassmultigridproject_tpu_torch.utils.timing import device_ms

    out = {}
    small_n = 256
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(2024)
        vel = np.random.default_rng(7).standard_normal((2, n + 1, n + 1))
        num_levels = delta_config().resolved_num_levels(n)
        levels = build_hierarchy(
            vel[0], vel[1], 0.1 / n, -4e-4, num_levels, dtype=dtype,
            device=device, coarse_mode="dense")
        galerkin = build_hierarchy(
            vel[0], vel[1], 0.1 / n, -4e-4, num_levels, dtype=dtype,
            device=device, coarse_operator="galerkin")
        poisson = build_poisson_hierarchy(n, len(POISSON_LEVELS), dtype=dtype,
                                          device=device)
        fine = levels[0]
        isz = torch.empty((), dtype=dtype).element_size()
        f = lambda scale=1.0, lvl=0: _field(
            rng, levels[lvl].padded, levels[lvl].n, dtype, device, scale)
        hi, lo, d = f(), f(1e-8), f(1e-2)
        u, corr, rhs = f(), f(1e-2), f()
        rhs1 = f(lvl=1)
        u_mids, rhs_mids, bottom = tower.tower_descend_plain(levels, 1, rhs1, 3)
        v = coarse_solve_dense(levels[-1], bottom)
        cases = {  # name: (kernel, plain version, input shape, (bytes, flops))
            "delta_open": (
                lambda: delta_step.fused_accumulate_open(fine, hi, lo, d),
                lambda: delta_step.fused_accumulate_open_plain(fine, hi, lo, d),
                fine.padded, profiling.open_cost(fine, isz)),
            "smooth pre (zero_init, res_rows_dec)": (
                lambda: smoother.fused_rb_sweeps(
                    fine, None, rhs, 3, True, zero_init=True,
                    residual_rows_decimated=True),
                lambda: smoother.fused_rb_sweeps_plain(
                    fine, None, rhs, 3, True, zero_init=True,
                    residual_rows_decimated=True),
                fine.padded,
                profiling.smooth_cost(fine, isz, 3, read_u=False,
                                      want_residual=True, res_dec=True)),
            "smooth post (corr, residual)": (
                lambda: smoother.fused_rb_sweeps(fine, u, rhs, 3, True,
                                                 corr=corr),
                lambda: smoother.fused_rb_sweeps_plain(fine, u, rhs, 3, True,
                                                       corr=corr),
                fine.padded,
                profiling.smooth_cost(fine, isz, 3, corr=True,
                                      want_residual=True)),
            "tower_descent": (
                lambda: tower.tower_descend(levels, 1, rhs1, 3),
                lambda: tower.tower_descend_plain(levels, 1, rhs1, 3),
                levels[1].padded,
                profiling.tower_cost(levels, 1, isz, 3, ascent=False)),
            "tower_ascent": (
                lambda: tower.tower_ascend(levels, 1, v, u_mids, rhs_mids, 3),
                lambda: tower.tower_ascend_plain(levels, 1, v, u_mids,
                                                 rhs_mids, 3),
                levels[1].padded,
                profiling.tower_cost(levels, 1, isz, 3, ascent=True)),
            **{f"open_presmooth ({mode})": (
                lambda dec=dec: delta_step.fused_open_presmooth(
                    fine, hi, lo, d, 3, dec),
                lambda dec=dec: delta_step.fused_open_presmooth_plain(
                    fine, hi, lo, d, 3, dec),
                fine.padded, profiling.open_smooth_cost(fine, isz, 3, dec))
               for mode, dec in (("res_rows_dec", True),
                                 ("full residual", False))},
            **_band_cases("smooth5", poisson, f, POISSON_LEVELS),
            **_band_cases("smooth9", galerkin, f, GALERKIN_LEVELS),
        }
        # K7 timed in the distributed path's flag sets; K2 and K7 checked
        # in all of theirs, and K2 on every level and the gsbench level
        gv1, gv2 = rotating_velocity(GSBENCH_N, dtype=dtype, device="cpu")
        gs_level = build_fine_level(gv1, gv2, (1.0 / GSBENCH_N) / 10, -4e-4,
                                    dtype=dtype, device=device)
        checks = _from_v_checks(levels, f, gs_level, lambda scale: _field(
            rng, gs_level.padded, gs_level.n, dtype, device, scale))
        checks.update(_band_checks(poisson, galerkin, f))
        for name, case in _smooth_rows_cases(levels, f).items():
            if "residual" in name:
                cases[name] = case
            else:
                checks[name] = case[:3]
        small_vel = np.random.default_rng(7).standard_normal(
            (2, small_n + 1, small_n + 1))
        small = build_hierarchy(
            small_vel[0], small_vel[1], 0.1 / small_n, -4e-4,
            delta_config().resolved_num_levels(small_n), dtype=dtype,
            device=device, coarse_mode="dense")
        checks.update(_tower_checks(
            [(levels, 1), (levels, 3), (small, 1)],
            lambda lv, lvl: _field(rng, lv[lvl].padded, lv[lvl].n, dtype,
                                   device)))
        _stitched_rows(levels, u, rhs, dtype)
        k8_cases = _k8_checks(fine, hi, lo, d, dtype)
        exact_from_v, exact_bands, exact_tower = [], [], []
        for name, (kern, plain, shape, *timed) in {**cases, **checks}.items():
            got, want = _flatten(kern()), _flatten(plain())
            torch.cuda.synchronize()
            err, bound, exact = _compare(name, got, want, dtype)
            line = (f"[kernels] {name} {str(dtype)[6:]} at {shape}: "
                    f"max|kernel - plain| {err:.3g} (bound {bound:.3g}), "
                    f"bit-identical {exact}")
            if name.startswith("smooth ") or name.startswith("smooth_rows"):
                require(exact, f"{name}: K2/K7 not bit-identical to the "
                        "plain version")
                exact_from_v.append(exact)
            if name.startswith("open_presmooth"):
                require(exact, f"{name}: K8 not bit-identical to the plain "
                        "version")
            if name.startswith("smooth5") or name.startswith("smooth9"):
                require(exact, f"{name}: K5/K6 not bit-identical to the "
                        "plain version")
                exact_bands.append(exact)
            if name.startswith("tower"):
                half = name.split(" ")[0].split("_")[1]
                line += (f"; grid (blocks/SM, SMs, blocks) "
                         f"{tower.GRID[half, dtype]}")
                require(exact, f"{name}: K3/K4 not bit-identical to the "
                        "plain version")
                # a race across the grid barrier shows as a call that
                # differs from another on the same inputs
                same = all(torch.equal(a, b) for _ in range(TOWER_REPEATS - 1)
                           for a, b in zip(_flatten(kern()), got))
                torch.cuda.synchronize()
                require(same, f"{name}: a repeated call differs")
                exact_tower.append(exact and same)
            if dtype == torch.float32 and timed:
                cost = timed[0]
                ms = device_ms(kern, 200)
                plain_ms = device_ms(plain, 20)
                issued = time_ms(kern, 200)
                bound_ms, bound_by = profiling.bound_ms(*cost, isz)
                line += (f"; kernel {ms:.4f} ms on the card ({issued:.4f} ms "
                         f"as issued), plain {plain_ms:.4f} ms, bound "
                         f"{bound_ms:.4f} ms ({bound_by}: "
                         f"{cost[0] / 1e6:.2f} MB, {cost[1] / 1e6:.1f} "
                         "MFLOP)")
                out[name] = (err, ms, plain_ms, bound_ms, bound_by)
            print(line)
        print(f"[kernels] K2 and K7 ({str(dtype)[6:]}): bit-identical to "
              f"their plain versions in {sum(exact_from_v)} of "
              f"{len(exact_from_v)} cases")
        print(f"[kernels] K5 and K6 ({str(dtype)[6:]}): bit-identical to "
              f"their plain versions in {sum(exact_bands)} of "
              f"{len(exact_bands)} cases")
        print(f"[kernels] K8 ({str(dtype)[6:]}): bit-identical to its "
              f"plain version and to K1 then K2 in {k8_cases} of {k8_cases} "
              f"cases, and to its plain version at the path's call")
        print(f"[kernels] K3 and K4 ({str(dtype)[6:]}): bit-identical to "
              f"their plain versions, and each of {TOWER_REPEATS} calls "
              f"equal to the first, in {sum(exact_tower)} of "
              f"{len(exact_tower)} cases")
    k1, k2_pre = out["delta_open"][1], out["smooth pre (zero_init, "
                                           "res_rows_dec)"][1]
    k8 = out["open_presmooth (res_rows_dec)"][1]
    print(f"[kernels] price of the whole-step opening (float32, at "
          f"{levels[0].padded}): K8 {k8:.4f} ms against K1 + K2 pre-smooth "
          f"{k1:.4f} + {k2_pre:.4f} = {k1 + k2_pre:.4f} ms")
    _band_levels(out, levels)
    merged = {}
    for name, numbers in out.items():
        found = re.match(r"(smooth[59]) \(level (\d+), (.*)\)$", name)
        if found and found.group(3) not in _path_flags(found.group(1),
                                                       int(found.group(2))):
            continue  # K5, K6: their paths' calls alone, each launched
            # once a cycle or step, so the mean is launch-weighted
        merged.setdefault(name.split(" ")[0], []).append(numbers)
    return {key: (max(r[0] for r in rows),
                  statistics.mean(r[1] for r in rows),
                  statistics.mean(r[2] for r in rows),
                  statistics.mean(r[3] for r in rows),
                  rows[0][4])
            for key, rows in merged.items()}


def _drive(tag, run, want: dict, plain_bound: float):
    """Drive one path: a warm-up run, then a run between a reset and a
    read of the launch counts (every count must equal `want`, 0 where it
    names none), three timed runs, a run for peak device memory, and one
    run through the plain versions on the card, whose output may differ by
    at most `plain_bound`.  `run` returns (output tensor, stats).  Returns
    (output, stats, launch counts)."""
    from hpcclassmultigridproject_tpu_torch.ops import cuda

    def timed():
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    timed()  # warm-up
    cuda.reset_launches()
    (out, stats), _ = timed()
    counts = dict(cuda.LAUNCHES)
    want = {k: want.get(k, 0) for k in counts}
    print(f"[{tag}] launches in one run: {counts}")
    require(counts == want, f"{tag}: launch counts {counts}, expected {want}")
    walls = [timed()[1] for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    timed()
    peak = torch.cuda.max_memory_allocated()
    with cuda.plain_route():
        (out_plain, _), plain_wall = timed()
    du = (out - out_plain).abs().max().item()
    print(f"[{tag}] wall per run (median of 3): kernels "
          f"{statistics.median(walls):.4f} s {walls}, plain (one run) "
          f"{plain_wall:.4f} s; peak device memory {peak / 2**20:.1f} MiB")
    print(f"[{tag}] max|output(kernels) - output(plain)| {du:.3g} "
          f"(bound {plain_bound:g})")
    require(du <= plain_bound, f"{tag}: kernel path and plain path differ "
            f"by {du:.3g}")
    return out, stats, counts


def _check_advection(tag, n, steps, uT, stats, center_ref, delta: bool):
    """Shape, finiteness, every certificate <= 1e-6 and the center value
    of an AdvectionDiffusion run of `steps` steps at n."""
    require(tuple(uT.shape) == (n + 1, n + 1), f"{tag}: uT shape")
    require(bool(torch.isfinite(uT).all()), f"{tag}: uT not finite")
    rel = stats["rel_residual"].cpu().numpy()
    line = f"[{tag}] step certificates: {rel.size}, max {rel.max():.3e}"
    require(rel.size == steps and bool((rel <= TOL).all()),
            f"{tag}: a step certificate exceeds 1e-6")
    if delta:
        hi = stats["rel_residual_hi_steps"].cpu().numpy()
        certified = hi[hi >= 0]
        final = float(stats["final_rel_residual_hi"])
        line += (f"; f64 mid-run certificates: {certified.size}, max "
                 f"{certified.max():.3e}; final f64 certificate {final:.3e}")
        require(certified.size == steps // 10
                and bool((certified <= TOL).all()),
                f"{tag}: a mid-run f64 certificate is missing or > 1e-6")
        require(final <= TOL, f"{tag}: final f64 certificate {final:.3e}")
    center = float(uT[n // 2, n // 2])
    print(line)
    print(f"[{tag}] center uT {center!r} (reference {center_ref!r}, |diff| "
          f"{abs(center - center_ref):.3g})")
    require(abs(center - center_ref) <= 1e-9,
            f"{tag}: center value off by > 1e-9")


def phase_galerkin(device, n: int, steps: int):
    """The main path with Galerkin R·A·P coarse levels: K6 smooths levels
    1 to 4, K2 level 0, and no level goes through the tower."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    t0 = time.perf_counter()
    model = AdvectionDiffusion(
        ProblemConfig(n=n, num_steps=steps),
        delta_config(certify_every=10, coarse_operator="galerkin"),
        device=device)
    forms = [level.form for level in model.levels]
    print(f"[galerkin] n={n}, {steps} steps, level forms {forms}, model "
          f"built in {time.perf_counter() - t0:.2f} s")
    require(forms == ["from_v"] + ["nine"] * (len(forms) - 1),
            f"galerkin: level forms {forms}")
    smoothed = len(forms) - 2  # nine-band levels above the dense solve
    uT, stats, counts = _drive(
        "galerkin", lambda: model.run(warn=False),
        {"delta_open": steps, "smooth": 2 * steps,
         "smooth9": 2 * smoothed * steps}, 1e-8)
    _check_advection("galerkin", n, steps, uT, stats, CENTER_GALERKIN,
                     True)
    return counts


def phase_poisson(device, n: int):
    """Poisson(n) in float64 to tol 1e-10 (7 cycles, the center value), and
    in its float32 default, which stalls at 50 cycles without converging,
    as the JAX package's does.  Returns the float32 run's launch counts."""
    from hpcclassmultigridproject_tpu_torch import SolverConfig
    from hpcclassmultigridproject_tpu_torch.models import Poisson

    counts = None
    for dtype, solver in (
            (torch.float64, SolverConfig(dtype=torch.float64, tol=1e-10,
                                         restriction="full",
                                         coarse_mode="dense")),
            (torch.float32, Poisson.DEFAULT_SOLVER)):
        tag = f"poisson {str(dtype)[6:]}"
        model = Poisson(n=n, solver=solver, device=device)
        smoothed = model.num_levels - 1
        cycles_want = 7 if dtype == torch.float64 else solver.max_cycles
        u, stats, got = _drive(
            tag, model.solve, {"smooth5": 2 * smoothed * cycles_want},
            1e-13 if dtype == torch.float64 else 1e-6)
        cycles = int(stats["cycles"])
        rel = float(stats["rel_residual"])
        conv = bool(stats["converged"])
        center = float(u[n // 2, n // 2])
        print(f"[{tag}] cycles {cycles}, rel_residual {rel:.4g}, converged "
              f"{conv}, center u {center!r}")
        require(tuple(u.shape) == (n + 1, n + 1)
                and bool(torch.isfinite(u).all()), f"{tag}: u")
        require(cycles == cycles_want, f"{tag}: {cycles} cycles, expected "
                f"{cycles_want}")
        if dtype == torch.float64:
            require(conv, f"{tag}: did not converge")
            require(abs(center - CENTER_POISSON) <= 1e-11,
                    f"{tag}: center off by {abs(center - CENTER_POISSON):.3g}")
        else:
            counts = got
            require(not conv, f"{tag}: converged, unlike the JAX package")
            print(f"[{tag}] does not converge in float32, as the JAX "
                  "package's float32 default does not")
    return counts


def phase_refined(device, n: int, steps: int):
    """Refined fixed-cycle stepping (not delta form): float64 state and
    residuals, one float32 V-cycle per step through K2 and the tower."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    model = AdvectionDiffusion(
        ProblemConfig(n=n, num_steps=steps),
        SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                     tol=TOL, cycle_mode="fixed", num_cycles=1,
                     coarse_mode="dense"),
        device=device)
    uT, stats, counts = _drive(
        "refined", lambda: model.run(warn=False),
        {"smooth": 2 * steps, "tower_descent": steps,
         "tower_ascent": steps}, 1e-8)
    _check_advection("refined", n, steps, uT, stats, CENTER_REFINED,
                     False)
    return counts


def phase_main_path(device, n: int, steps: int, center_ref: float):
    """The main path through AdvectionDiffusion; returns the launch counts
    of one run and its uT."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    t0 = time.perf_counter()
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                               delta_config(certify_every=10),
                               device=device)
    print(f"[main] n={n}, {steps} steps, {model.num_levels} levels, model "
          f"built in {time.perf_counter() - t0:.2f} s")
    uT, stats, counts = _drive(
        "main", lambda: model.run(warn=False),
        {"delta_open": steps, "smooth": 2 * steps, "tower_descent": steps,
         "tower_ascent": steps}, 1e-8)
    _check_advection("main", n, steps, uT, stats, center_ref, True)
    return counts, uT


def phase_golden(device) -> None:
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    want = np.load(ROOT / "tests" / "golden" / "uT_n256.npy")
    model = AdvectionDiffusion(ProblemConfig(n=256), delta_config(),
                               device=device)
    uT, stats = model.run(warn=False)
    got = uT.cpu().numpy()
    err = float(np.abs(got - want).max())
    center = float(got[128, 128])
    final = float(stats["final_rel_residual_hi"])
    print(f"[golden] n=256: max|uT - golden| {err:.3g} (bound 5e-07), center "
          f"{center!r} (4.802e-05 +- 1e-08), final f64 certificate "
          f"{final:.3e}")
    require(err <= 5e-7, "golden field mismatch")
    require(abs(center - 4.802e-5) <= 1e-8, "golden center mismatch")
    require(final <= TOL, "golden final certificate > 1e-6")


def _dist_rank(n: int, steps: int) -> dict:
    """One rank of the distributed phase (a spawned process on cuda:0): the
    main path through distributed_run in the plain and the overlap
    schedule, each run read between a reset and a read of this rank's
    launch counts, and once through the plain versions.  Rank 0's result
    reaches the parent."""
    import dataclasses

    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops import cuda
    from hpcclassmultigridproject_tpu_torch.parallel import distributed_run

    torch.backends.cuda.matmul.allow_tf32 = False
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                               delta_config(certify_every=10), device="cuda")

    def run(overlap: bool):
        model.solver = dataclasses.replace(model.solver,
                                           sharded_overlap=overlap)
        dist.barrier()
        t0 = time.perf_counter()
        uT, stats = distributed_run(model, min_local=DIST_MIN_LOCAL)
        torch.cuda.synchronize()
        dist.barrier()
        return uT, stats, time.perf_counter() - t0

    run(False)  # warm-up: CUDA context, kernel library, allocator
    out = {}
    for tag, overlap in (("plain", False), ("overlap", True)):
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        uT, stats, wall = run(overlap)
        counts = dict(cuda.LAUNCHES)
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, torch.cuda.max_memory_allocated())
        out[tag] = dict(uT=uT.cpu().numpy(), wall=wall, counts=counts,
                        peaks_mib=[b / 2**20 for b in peaks],
                        stats={k: v.cpu().numpy() for k, v in stats.items()})
    with cuda.plain_route():
        uT, _, wall = run(False)
    out["plain versions"] = dict(uT=uT.cpu().numpy(), wall=wall)
    out["comm_ms"] = _collective_costs(model)
    model = None  # freed before the two builds whose memory is compared
    out["born"] = _born_partitioned_runs(n, steps)
    return out


def _born_partitioned_runs(n: int, steps: int) -> dict:
    """Phase 13 (c), in phase 9's ranks: distributed_run of the main path's
    model built whole on the device, then of the same model born
    row-partitioned (this rank builds its rows only), each read from a
    reset of the launch counts and the peak device memory before its build
    to the end of its run."""
    import gc

    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops import cuda
    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed_run,
        make_mesh,
    )

    problem = ProblemConfig(n=n, num_steps=steps)
    builds = {
        "whole device-built": lambda: AdvectionDiffusion(
            problem, delta_config(certify_every=10, device_build=True),
            device="cuda"),
        "born row-partitioned": lambda: AdvectionDiffusion(
            problem, delta_config(certify_every=10), device="cuda",
            mesh=make_mesh(), min_local=DIST_MIN_LOCAL),
    }
    out = {}
    for tag, build in builds.items():
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cuda.reset_launches()
        t0 = time.perf_counter()
        model = build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        uT, stats = distributed_run(model, min_local=DIST_MIN_LOCAL)
        torch.cuda.synchronize()
        counts = dict(cuda.LAUNCHES)
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks,
                               torch.cuda.max_memory_allocated() - base)
        out[tag] = dict(uT=uT.cpu().numpy(), counts=counts, build_s=build_s,
                        peaks_mib=[b / 2**20 for b in peaks],
                        level0_rows=model.levels[0].padded[0],
                        stats={k: v.cpu().numpy() for k, v in stats.items()})
        model = uT = stats = None
    return out


def _collective_costs(model, reps: int = 100, grid: bool = False) -> dict:
    """Mean ms per call of each collective of the distributed path, with
    no kernel between the calls, at the path's shapes: the deep-halo
    exchange of (u, rhs) at level 0, the one-row exchange, the norm's
    all_sum, and the agglomeration's all-gather into level 3; with `grid`
    also the 2-D layout's four-edge exchange of a level-0 block and its
    one-line extension with corners (two batches)."""
    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch.parallel import (
        blocks,
        distributed,
        halo,
        level_shardings,
        level_shardings_for_ns,
        make_mesh,
        rows_halo,
    )

    mesh = make_mesh()
    parts = level_shardings(model.levels, mesh, DIST_MIN_LOCAL)
    x = torch.ones(parts[0].shape, device="cuda")
    coarse = torch.ones((parts[2].local // 2, model.levels[3].padded[1]),
                        device="cuda")
    calls = {
        "exchange (u, rhs), 8 rows": lambda: rows_halo.exchange([x, x], 8,
                                                                mesh),
        "exchange (u), 1 row": lambda: rows_halo.exchange([x], 1, mesh),
        "all_sum": lambda: distributed.all_sum(x.sum(), mesh),
        "all_gather_rows into level 3": lambda: distributed.all_gather_rows(
            coarse, mesh),
    }
    if grid:
        (part,) = level_shardings_for_ns([model.problem.n], mesh, 1, "2d")
        xg = torch.ones(part.shape, device="cuda")
        calls["2-D exchange, four edges"] = lambda: halo._start_halo(
            xg, mesh).wait()
        calls["2-D extension with corners"] = lambda: blocks.extend([xg],
                                                                    part)
    out = {}
    for name, fn in calls.items():
        fn()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    return out


def _nccl_rank(n: int, steps: int) -> dict:
    """The one NCCL rank: distributed_run (every level replicated at world
    size 1) against a single-device run, and the all-gathers of the
    collectives on device tensors."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed,
        distributed_run,
        make_mesh,
    )

    mesh = make_mesh()
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                               delta_config(certify_every=10), device="cuda")
    uT_dist, _ = distributed_run(model, mesh, min_local=DIST_MIN_LOCAL)
    uT_single, _ = model.run(warn=False)
    x = torch.arange(12.0, device="cuda").reshape(3, 4)
    gathered = distributed.all_gather_rows(x, mesh)
    total = distributed.all_sum(x.sum(), mesh)
    return dict(backend=mesh.backend, world=mesh.world,
                max_diff=float((uT_dist - uT_single).abs().max()),
                collectives_ok=bool(torch.equal(gathered, x)
                                    and float(total) == 66.0))


def phase_distributed(n: int, steps: int, uT_single) -> int:
    """distributed_run of the main path over DIST_WORLD ranks on the one
    card; returns rank 0's K7 launch count of the plain schedule's run."""
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    print(f"[distributed] {DIST_WORLD} ranks on cuda:0 over gloo, halos and "
          "collectives staged through host memory: the machine has one "
          "card, and NCCL takes one rank per GPU.  The walls are not a "
          "scaling figure.")
    t0 = time.perf_counter()
    res = launch_local(_dist_rank, DIST_WORLD, (n, steps), backend="gloo",
                       device="cuda:0")
    print(f"[distributed] spawn, build and four runs per rank: "
          f"{time.perf_counter() - t0:.1f} s")
    single = uT_single.cpu().numpy()
    want = {"plain": {"smooth_rows": 6 * steps},
            "overlap": {"smooth_rows": 18 * steps}}
    comm = res.pop("comm_ms")
    born = res.pop("born")
    print("[distributed] collectives per call, ms (rank 0, mean of 100, "
          "no kernel between them): " + ", ".join(
              f"{k} {v:.4f}" for k, v in comm.items()))
    for tag, got in res.items():
        du = float(np.abs(got["uT"] - single).max())
        line = (f"[distributed] {tag}: wall {got['wall']:.4f} s (rank 0), "
                f"max|uT_dist - uT_single| {du:.3g} (bound 1e-09)")
        if tag in want:
            counts = got["counts"]
            expect = {k: 0 for k in counts}
            expect.update(want[tag], tower_descent=steps,
                          tower_ascent=steps)
            line += (f"; launches per rank {counts}; peak device memory per "
                     f"rank {[round(m, 1) for m in got['peaks_mib']]} MiB")
            print(line)
            require(counts == expect, f"distributed {tag}: launch counts "
                    f"{counts}, expected {expect}")
            stats = {k: torch.from_numpy(v) for k, v in got["stats"].items()}
            _check_advection(f"distributed {tag}", n, steps,
                             torch.from_numpy(got["uT"]), stats, CENTER_1024,
                             True)
        else:
            print(line)
        require(du <= 1e-9, f"distributed {tag}: uT off the single-device "
                f"run by {du:.3g}")
    _check_born_partitioned(born, n, steps, single)
    nccl = launch_local(_nccl_rank, 1, (n, NCCL_STEPS), backend="nccl",
                        device="cuda:0")
    print(f"[distributed] one NCCL rank ({nccl['backend']}, world "
          f"{nccl['world']}): {NCCL_STEPS} steps, max|uT_dist - "
          f"uT_single| {nccl['max_diff']!r} (expected 0); all_gather_rows "
          f"and all_sum on device tensors right: {nccl['collectives_ok']}")
    require(nccl["backend"] == "nccl" and nccl["max_diff"] == 0.0
            and nccl["collectives_ok"], "the one-rank NCCL run")
    return res["plain"]["counts"]["smooth_rows"]


def _check_born_partitioned(born: dict, n: int, steps: int, single) -> None:
    """Phase 13 (c): the born row-partitioned run equal to the whole
    device-built model's distributed run to the bit, both certified, with
    the plain schedule's launch counts, and each rank's peak memory lower
    born row-partitioned."""
    expect = {"smooth_rows": 6 * steps, "tower_descent": steps,
              "tower_ascent": steps}
    rtol, atol = RUN_TOL
    for tag, got in born.items():
        counts = got["counts"]
        du = float(np.abs(got["uT"] - single).max())
        print(f"[distributed] {tag}: built in {got['build_s']:.3f} s (rank "
              f"0), level 0 holds {got['level0_rows']} rows on rank 0; "
              f"launches per rank {counts}; peak device memory per rank, "
              f"build through run, {[round(m, 1) for m in got['peaks_mib']]}"
              f" MiB; max|uT - uT_single(host build)| {du:.3g}")
        require(counts == {k: expect.get(k, 0) for k in counts},
                f"distributed {tag}: launch counts {counts}")
        stats = {k: torch.from_numpy(v) for k, v in got["stats"].items()}
        _check_advection(f"distributed {tag}", n, steps,
                         torch.from_numpy(got["uT"]), stats, CENTER_1024,
                         True)
        require(np.allclose(got["uT"], single, rtol=rtol, atol=atol),
                f"distributed {tag}: uT off the host-built run's")
    whole = born["whole device-built"]
    part = born["born row-partitioned"]
    same = np.array_equal(part["uT"], whole["uT"])
    print(f"[distributed] born row-partitioned uT equal to the whole "
          f"device-built model's to the bit: {same} (max|diff| "
          f"{float(np.abs(part['uT'] - whole['uT']).max())!r})")
    require(same, "born row-partitioned uT differs from the whole build's")
    require(part["level0_rows"] < whole["level0_rows"],
            "born row-partitioned: rank 0 holds the whole level 0")
    require(all(b < w for b, w in zip(part["peaks_mib"],
                                      whole["peaks_mib"])),
            "born row-partitioned: a rank's peak memory is not lower")


def _profiled_run(run) -> tuple[float, float, int, int]:
    """One call of `run` under torch.profiler: (its wall in s, the card's
    busy ms -- the union of the intervals of its kernels, copies and
    memsets --, its kernel launch calls, and how many of those were
    cooperative launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for a, b in spans:
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    launches = sum(e.name in LAUNCH_CALLS for e in events)
    cooperative = sum(e.name in LAUNCH_CALLS and "Cooperative" in e.name
                      for e in events)
    return wall, busy_us / 1e3, launches, cooperative


def phase_open_smooth(device, n: int, steps: int, uT_main):
    """The main path with the whole-step opening on (K8 opens each step,
    K2 post-smooths, the tower below; no K1), then the two paths' walls in
    turns in this process (off, on, on, off, ...) and one profiled run of
    each.  Returns the launch counts of one run."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.mg import delta
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                               delta_config(certify_every=10), device=device)
    old = delta._FUSE_OPEN_SMOOTH
    try:
        delta._FUSE_OPEN_SMOOTH = True
        uT, stats, counts = _drive(
            "open-smooth", lambda: model.run(warn=False),
            {"open_presmooth": steps, "smooth": steps,
             "tower_descent": steps, "tower_ascent": steps}, 1e-8)
        _check_advection("open-smooth", n, steps, uT, stats, CENTER_1024,
                         True)
        du = float((uT - uT_main).abs().max())
        print(f"[open-smooth] max|uT - uT(main path)| {du!r}; equal to the "
              f"bit: {torch.equal(uT, uT_main)}")
        require(torch.equal(uT, uT_main),
                f"open-smooth: uT off the main path's by {du:.3g}")
        walls = {False: [], True: []}
        for fused in (False, True, True, False) * 3:
            delta._FUSE_OPEN_SMOOTH = fused
            t0 = time.perf_counter()
            model.run(warn=False)
            torch.cuda.synchronize()
            walls[fused].append(time.perf_counter() - t0)
        profiled = {}
        for fused in (False, True):
            delta._FUSE_OPEN_SMOOTH = fused
            profiled[fused] = _profiled_run(lambda: model.run(warn=False))
    finally:
        delta._FUSE_OPEN_SMOOTH = old
    for fused, label in ((False, "K1 + K2 opening"), (True, "K8 opening")):
        median = statistics.median(walls[fused])
        wall, busy, launches, cooperative = profiled[fused]
        print(f"[open-smooth] {label}: wall per run in turns {median:.4f} s "
              f"(median of 6, {walls[fused]}); one profiled run {wall:.4f} "
              f"s, the card busy {busy:.2f} ms of it, idle "
              f"{1 - busy / 1e3 / median:.1%} of the median wall, "
              f"{launches} kernel launch calls ({cooperative} cooperative)")
    return counts


def _cli(*argv, timeout=600) -> list[dict]:
    """The port's CLI in a subprocess from the repository root; its JSON
    lines.  A non-zero exit raises."""
    cmd = [sys.executable, "-m", f"{PKG}.cli", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    require(proc.returncode == 0,
            f"cli {' '.join(argv)}: exit {proc.returncode}\n{proc.stderr}")
    print(f"[cli] {' '.join(argv)}: {time.perf_counter() - t0:.1f} s in all")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def phase_cli(n: int, steps: int) -> None:
    """The port's CLI on the card: the main configuration's run (and
    checkpointed), gsbench with both backends, and the profile."""
    from hpcclassmultigridproject_tpu_torch.core.layout import padded_shape
    from hpcclassmultigridproject_tpu_torch.mg.levels import Level
    from hpcclassmultigridproject_tpu_torch.utils import profiling

    main_cfg = ["--n", str(n), "--steps", str(steps), "--delta",
                "--cycle-mode", "fixed", "--num-cycles", "1", "--coarse",
                "dense", "--certify-every", "10"]
    (run,) = _cli("run", *main_cfg, "--reps", "3")
    print(f"[cli] run: {run}")
    require(run["converged"] and abs(run["center_uT"] - CENTER_1024) <= 1e-9,
            f"cli run: {run}")
    with tempfile.TemporaryDirectory() as ck:
        (ckpt,) = _cli("run", *main_cfg, "--checkpoint-dir", ck,
                       "--checkpoint-every", "25")
        kept = sorted(os.listdir(ck))
    print(f"[cli] checkpointed run: {ckpt}; directory {kept}")
    require(abs(ckpt["center_uT"] - CENTER_1024) <= 1e-9
            and ckpt["converged"] and ckpt["max_rel_residual"] <= TOL
            and ckpt["max_cycles"] == run["max_cycles"],
            f"cli checkpointed run (its stitched stats): {ckpt}")
    rows_cols = torch.empty(padded_shape(GSBENCH_N), device="meta")
    gs_level = Level(v1=rows_cols, v2=rows_cols, a_inv=None, n=GSBENCH_N,
                     h=1.0 / GSBENCH_N, dt=0.0, nu=0.0, diag_a=1.0,
                     diag_b=1.0)
    sweep_bound, _ = profiling.bound_ms(
        *profiling.smooth_cost(gs_level, 4, 1), 4)
    for backend, what in (("pallas", "K2, one launch per sweep"),
                          ("jnp", "plain rb_gauss_seidel")):
        (gs,) = _cli("gsbench", "--n", str(GSBENCH_N), "--sweeps",
                     str(GSBENCH_SWEEPS), "--backend", backend)
        print(f"[cli] gsbench --backend {backend} ({what}): "
              f"{gs['gflops']:.2f} GFLOP/s, {gs['stencil_gdof_s']:.3f} "
              f"stencil GDOF/s, {gs['us_per_sweep']:.2f} us per sweep "
              f"(K2's bytes bound a sweep at {sweep_bound * 1e3:.2f} us)")
    prof = _cli("profile", *main_cfg, "--reps", "3")
    for rec in prof[:-1]:
        print(f"[cli] profile: {rec['phase']} level {rec['level']} (n="
              f"{rec['n']}): {rec['best_ms']:.4f} ms, {rec['achieved_gb_s']:.1f}"
              f" GB/s, x{rec['per_step_count']:g} per step")
    summary = prof[-1]
    print(f"[cli] profile: step {summary['step_ms']:.4f} ms, modelled "
          f"{summary['modeled_ms']:.4f} ms; phase share "
          f"{json.dumps(summary['phase_share'])}")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# the product kernel's dense cases beyond probe.DOT_SHAPES: two passes of
# the 16-byte staging (k = 512)
DOT_EXTRA_SHAPES = {"two passes": (64, 512, 128)}


def _probe_dot_dense(probe) -> None:
    """The product kernel on dense seeded operands at the three probe
    shapes, one that no tile divides and one of two staging passes: bit for
    bit against its fixed order repeated in PyTorch
    (`probe.dot_in_kernel_order`), and within k 2^-24 (|a| @ |b|) of the
    float64 product.  Launched after the counted run."""
    for shape, (m, k, n) in {**probe.DOT_SHAPES, **DOT_EXTRA_SHAPES}.items():
        a, b = (torch.from_numpy(v).cuda()
                for v in probe.dense_operands(m, k, n))
        got = probe.dot(a, b, "probe_dot_decimate")
        want = probe.dot_in_kernel_order(a, b)
        torch.cuda.synchronize()
        err = (got.double() - a.double() @ b.double()).abs()
        ratio = float((err / probe.dot_error_bound(a, b)).max())
        print(f"[probe] dot ({m},{k})@({k},{n}) dense: bit-identical to "
              f"its order in torch {_bits_equal(got, want)}, max|err| "
              f"{float(err.max()):.3g}, at most {ratio:.4f} of the bound "
              f"k 2^-24 (|a|@|b|)")
        require(_bits_equal(got, want),
                f"probe dot {shape}: differs from dot_in_kernel_order")
        require(ratio <= 1.0, f"probe dot {shape}: past the float32 bound")


def _probe_flatten_copy(probe) -> None:
    """flatten writes a buffer of its own, bit for bit: at the probe's
    shape, at a count with a scalar tail, and from an unaligned view."""
    x = torch.from_numpy(probe.probe_operands()["x"]).cuda()
    tail = torch.arange(35, dtype=torch.float32, device="cuda").reshape(5, 7)
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    for what, src in (("probe", x), ("tail", tail), ("unaligned", shifted)):
        before = src.clone()
        out = probe.flatten(src)
        library = probe.flatten_plain(src)
        torch.cuda.synchronize()
        require(_bits_equal(out, src.reshape(-1, 1)),
                f"probe flatten ({what}): values differ")
        for o in (out, library):
            require(o.untyped_storage().data_ptr()
                    != src.untyped_storage().data_ptr(),
                    f"probe flatten ({what}): the output aliases x")
        out.fill_(7.0)
        require(_bits_equal(src, before),
                f"probe flatten ({what}): writing the output changed x")
    print("[probe] flatten: bit-identical at the probe's shape, with a "
          "scalar tail and from an unaligned view; the kernel's and the "
          "library call's outputs share no storage with x")


def _probe_maps(probe, cuda) -> None:
    """stride2_rows and interleave_rows bit for bit against their plain
    versions at `probe.MAP_CHECKS`, and no launch for an empty input; then
    each map's device time, its plain version's (the library call) and its
    bound at `probe.MAP_SHAPES`.  Launched after the counted run."""
    from hpcclassmultigridproject_tpu_torch.utils import profiling
    from hpcclassmultigridproject_tpu_torch.utils.timing import device_ms

    maps = ("stride2_rows", "interleave_rows")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (rows, cols), offset in probe.MAP_CHECKS:
        base = torch.randn(rows * cols + offset, generator=gen, device="cuda")
        x = base[offset:].view(rows, cols)
        for name in maps:
            got = getattr(probe, name)(x)
            want = getattr(probe, f"{name}_plain")(x)
            torch.cuda.synchronize()
            require(_bits_equal(got, want),
                    f"probe {name} at ({rows}, {cols}) + {offset}: differs "
                    "from its plain version")
    before = dict(cuda.LAUNCHES)
    for shape in ((0, 256), (5, 0)):
        x = torch.empty(shape, device="cuda")
        for name in maps:
            got = getattr(probe, name)(x)
            require(got.shape == getattr(probe, f"{name}_plain")(x).shape,
                    f"probe {name} at {shape}: shape {tuple(got.shape)}")
    torch.cuda.synchronize()
    require(cuda.LAUNCHES == before, "probe maps: an empty input launched")
    print(f"[probe] stride2_rows, interleave_rows: bit-identical to their "
          f"plain versions at {list(probe.MAP_CHECKS)} (shape, x's "
          f"offset in floats); no launch for (0, 256) or (5, 0)")
    for rows, cols in probe.MAP_SHAPES:
        x = torch.randn((rows, cols), generator=gen, device="cuda")
        for name in maps:
            kern, plain = getattr(probe, name), getattr(probe,
                                                        f"{name}_plain")
            ms = device_ms(lambda: kern(x), 200)
            library = device_ms(lambda: plain(x), 200)
            bound, bound_by = profiling.bound_ms(
                *profiling.probe_cost(name, {"x": x}), 4)
            print(f"[probe] {name} ({rows}, {cols}): kernel {ms:.5f} ms, "
                  f"library call {library:.5f} ms, bound {bound:.5f} ms "
                  f"({bound_by}), the kernel at {bound / ms:.1%} of its "
                  f"bound, library call / kernel {library / ms:.2f}")
        del x


def phase_probe() -> dict:
    """P's six kernels once each between a reset and a read of the launch
    counts, held to the JAX probe script's checks and bit for bit to their
    plain versions (the products: each output one product or one rounding
    of a sum of two exact products, the same in any order); then the
    product kernel on dense operands, flatten's copy and the two index maps
    at more shapes; then timed.
    Returns {counter: (max-abs difference from the expectation, kernel ms,
    plain ms, bound ms, bound_by, library ms, launches)}."""
    from hpcclassmultigridproject_tpu_torch.ops import cuda
    from hpcclassmultigridproject_tpu_torch.ops.cuda import probe
    from hpcclassmultigridproject_tpu_torch.utils import profiling

    cuda.reset_launches()
    checked = probe.run_probes("cuda", reps=0)
    counts = {k: v for k, v in cuda.LAUNCHES.items() if k.startswith("probe_")}
    print(f"[probe] launches in one run: {counts}")
    require(counts == {f"probe_{p}": 1 for p in PROBES},
            f"probe: launch counts {counts}")
    ops = probe.probe_operands()
    _probe_dot_dense(probe)
    _probe_flatten_copy(probe)
    _probe_maps(probe, cuda)
    timed = probe.run_probes("cuda", reps=200)
    out = {}
    for rec, again, name in zip(checked, timed, probe.probes()):
        require(rec["passed"] and again["passed"], f"probe {name}: FAIL")
        require(rec["bit_identical"] and again["bit_identical"],
                f"probe {name}: differs from its plain version")
        bound_ms, bound_by = profiling.bound_ms(
            *profiling.probe_cost(name, ops), 4)
        print(f"[probe] PASS {name}: max|kernel - expected| "
              f"{rec['max_abs_diff']:.3g}, bit-identical to the plain "
              f"version {rec['bit_identical']}; kernel "
              f"{again['kernel_ms']:.4f} ms, plain {again['plain_ms']:.4f} ms"
              f", library call {again['library_ms']:.4f} ms"
              f", bound {bound_ms:.6f} ms ({bound_by})")
        out[f"probe_{name}"] = (rec["max_abs_diff"], again["kernel_ms"],
                                again["plain_ms"], bound_ms, bound_by,
                                again["library_ms"], counts[f"probe_{name}"])
    return out


def _within(got: torch.Tensor, want: torch.Tensor, tol) -> tuple[bool, float]:
    """(|got − want| <= atol + rtol·|want| everywhere, max|got − want|)."""
    rtol, atol = tol
    got, want = got.double(), want.double().to(got.device)
    return (tuple(got.shape) == tuple(want.shape)
            and bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
            float((got - want).abs().max()))


def _check_build(tag: str, dev, host) -> None:
    """A device-built model's levels, dense inverse, fine_hi and u0
    against the host-built model's, at the JAX package's tolerances."""
    pairs = []
    for lvl, (ld, lh) in enumerate(zip(dev.levels, host.levels)):
        tol = BUILD_TOL[ld.v1.dtype]
        pairs += [(f"level {lvl} {f}", getattr(ld, f), getattr(lh, f), tol)
                  for f in ("v1", "v2")]
    pairs.append(("a_inv", dev.levels[-1].a_inv, host.levels[-1].a_inv,
                  A_INV_TOL))
    pairs += [(f"fine_hi {f}", getattr(dev.fine_hi, f),
               getattr(host.fine_hi, f), BUILD_TOL[torch.float64])
              for f in ("v1", "v2")]
    pairs.append(("u0", dev.u0, host.u0, U0_TOL))
    worst = {}
    for what, got, want, tol in pairs:
        ok, err = _within(got, want, tol)
        require(ok, f"{tag}: {what} off the host build by {err:.3g}")
        worst[what] = (err, int((got != want).sum()))
    print(f"[device build] {tag}: every field within the JAX package's "
          "bounds of the host build; max|device - host| (elements not "
          "equal to the bit): " + ", ".join(
              f"{k} {e:.3g} ({d})" for k, (e, d) in worst.items()))


def _np_rows(n: int, rows: np.ndarray, cols: int):
    """Numpy float64 (v1, v2, u0) of the default problem on the given
    global rows of the padded grid, 0 outside the logical grid (u0 also
    on its boundary ring)."""
    h = 1.0 / n
    x = (rows.astype(np.float64) * h)[:, None]
    y = (np.arange(cols, dtype=np.float64) * h)[None, :]
    r, c = rows[:, None], np.arange(cols)[None, :]
    inside = (r <= n) & (c <= n)
    v1 = np.where(inside, -np.pi * np.sin(np.pi * x) * np.cos(np.pi * y), 0.0)
    v2 = np.where(inside, np.pi * np.cos(np.pi * x) * np.sin(np.pi * y), 0.0)
    interior = (r >= 1) & (r <= n - 1) & (c >= 1) & (c <= n - 1)
    u0 = np.where(interior,
                  np.exp(-100.0 * ((x - 0.2) ** 2 + (y - 0.4) ** 2)), 0.0)
    return v1, v2, u0


def _big_rows_check(model, n: int) -> None:
    """Levels 0, fine_hi and u0 of the n=16384 model on BIG_ROWS seeded
    rows and the edge rows against numpy float64 of just those rows."""
    rows_total, cols = model.levels[0].padded
    rng = np.random.default_rng(13)
    rows = np.unique(np.concatenate([
        rng.integers(0, rows_total, BIG_ROWS),
        [0, 1, n - 1, n, n + 1, rows_total - 1]]))
    v1, v2, u0 = _np_rows(n, rows, cols)
    idx = torch.from_numpy(rows).to(model.device)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    checks = [("level 0 v1", model.levels[0].v1, f32(v1),
               BUILD_TOL[torch.float32]),
              ("level 0 v2", model.levels[0].v2, f32(v2),
               BUILD_TOL[torch.float32]),
              ("fine_hi v1", model.fine_hi.v1, torch.from_numpy(v1),
               BUILD_TOL[torch.float64]),
              ("fine_hi v2", model.fine_hi.v2, torch.from_numpy(v2),
               BUILD_TOL[torch.float64]),
              ("u0", model.u0, torch.from_numpy(u0), U0_TOL)]
    errs = []
    for what, field, want, tol in checks:
        ok, err = _within(field[idx], want, tol)
        require(ok, f"device build n={n}: {what} off numpy by {err:.3g} on "
                f"rows {rows.tolist()}")
        errs.append(f"{what} {err:.3g}")
    print(f"[device build] n={n}: {rows.size} rows {rows.tolist()} against "
          f"numpy float64: max|diff| " + ", ".join(errs))


def _big_run(model, cycles: int):
    """One run of the n=16384 model at `cycles` V-cycles a step: (wall s,
    uT, stats, launch counts)."""
    import dataclasses

    from hpcclassmultigridproject_tpu_torch.ops import cuda

    model.solver = dataclasses.replace(model.solver, num_cycles=cycles)
    cuda.reset_launches()
    t0 = time.perf_counter()
    uT, stats = model.run(warn=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, uT, stats, dict(cuda.LAUNCHES)


def _certified(stats) -> tuple[bool, float, float, float]:
    """(every certificate <= 1e-6, max f32 step certificate, max mid-run
    f64 certificate, final f64 certificate)."""
    rel = float(stats["rel_residual"].max())
    hi = stats["rel_residual_hi_steps"]
    mid = float(hi[hi >= 0].max()) if bool((hi >= 0).any()) else 0.0
    final = float(stats["final_rel_residual_hi"])
    return max(rel, mid, final) <= TOL, rel, mid, final


def _phase_big(device) -> tuple[int, dict]:
    """Phase 13 (b): n=16384 on the one card, auto build and auto cycles.
    Returns the cycle count of the last run and its uT's fingerprint, which
    phase 16 holds the four-card runs to."""
    import dataclasses
    import gc
    import warnings

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    problem = ProblemConfig(n=BIG_N, num_steps=BIG_STEPS)
    solver = dataclasses.replace(delta_config(certify_every=10),
                                 num_cycles=None)
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        model = AdvectionDiffusion(problem, solver, device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    notices = [str(w.message) for w in said if "device_build" in str(w.message)]
    built_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"[device build] n={BIG_N}: padded {model.levels[0].padded}, "
          f"{model.num_levels} levels, built in {build_s:.3f} s, peak "
          f"device memory after the build {built_mib:.1f} MiB; the notice: "
          f"{notices}")
    require(len(notices) == 1 and f"n={BIG_N}" in notices[0],
            f"device build n={BIG_N}: auto did not say it picked the device")
    _big_rows_check(model, BIG_N)
    auto = model.solver.num_cycles
    levels_k2 = sum(level.n > 512 for level in model.levels)
    found = None
    for cycles in range(1, 7):
        if cycles > auto and found is not None:
            break
        wall, _, stats, counts = _big_run(model, cycles)
        ok, rel, mid, final = _certified(stats)
        print(f"[device build] n={BIG_N}, {BIG_STEPS} steps, {cycles} "
              f"V-cycles a step{' (auto)' if cycles == auto else ''}: wall "
              f"{wall:.3f} s (the first run at this count), max f32 step "
              f"certificate {rel:.3e}, f64 mid-run {mid:.3e}, final f64 "
              f"{final:.3e}: {'certified' if ok else 'NOT certified'}; "
              f"launches {counts}")
        want = {"delta_open": BIG_STEPS,
                "smooth": 2 * levels_k2 * cycles * BIG_STEPS,
                "tower_descent": cycles * BIG_STEPS,
                "tower_ascent": cycles * BIG_STEPS}
        require(counts == {k: want.get(k, 0) for k in counts},
                f"device build n={BIG_N}: launch counts {counts}, expected "
                f"{want}")
        if ok and found is None:
            found = cycles
    require(found is not None, f"device build n={BIG_N}: no cycle count up "
            "to 6 certifies")
    cycles = auto if found <= auto else found
    wall, uT, stats, _ = _big_run(model, cycles)
    require(tuple(uT.shape) == (BIG_N + 1, BIG_N + 1)
            and bool(torch.isfinite(uT).all()), f"n={BIG_N}: uT")
    ok, rel, mid, final = _certified(stats)
    print(f"[device build] n={BIG_N}: auto cycle count {auto}, the smallest "
          f"that certifies {found}; the run at {cycles}: wall {wall:.3f} s "
          f"(warm), certificates f32 {rel:.3e} / f64 mid-run {mid:.3e} / "
          f"final {final:.3e}; peak device memory after the runs "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; center "
          f"uT {float(uT[BIG_N // 2, BIG_N // 2])!r}")
    require(ok, f"device build n={BIG_N}: the run at {cycles} cycles is not "
            "certified")
    return cycles, _fingerprint(uT)


def _phase_spmv(device, n: int) -> None:
    """Phase 13 (d): the explicit matrix on the card (cuSPARSE CSR) against
    the stencil, at n's level 0 in float64 and on a Galerkin level."""
    from hpcclassmultigridproject_tpu_torch.core.layout import interior_mask
    from hpcclassmultigridproject_tpu_torch.core.problem import (
        rotating_velocity,
    )
    from hpcclassmultigridproject_tpu_torch.mg.levels import build_hierarchy
    from hpcclassmultigridproject_tpu_torch.ops import padded
    from hpcclassmultigridproject_tpu_torch.sparse.galerkin import (
        galerkin_coarse_level,
    )
    from hpcclassmultigridproject_tpu_torch.sparse.matrix import (
        level_to_bcsr,
        spmv_apply,
    )

    v1, v2 = rotating_velocity(n, dtype=torch.float64, device="cpu")
    (fine,) = build_hierarchy(v1, v2, 0.1 / n, -4e-4, 1, dtype=torch.float64,
                              device=device)
    coarse = galerkin_coarse_level(fine, "full")
    gen = torch.Generator(device=device).manual_seed(17)
    for tag, level in (("level 0 (from_v)", fine),
                       ("Galerkin level 1 (nine-band)", coarse)):
        u = torch.randn(level.padded, generator=gen, dtype=torch.float64,
                        device=device) * interior_mask(
            level.n, level.padded, dtype=torch.float64, device=device)
        t0 = time.perf_counter()
        mat = level_to_bcsr(level)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        err = float((spmv_apply(mat, level, u)
                     - padded.apply_A(level, u)).abs().max())
        spmv_ms = time_ms(lambda: spmv_apply(mat, level, u), 50)
        stencil_ms = time_ms(lambda: padded.apply_A(level, u), 50)
        print(f"[device build] spmv, n={level.n} {tag}: CSR {mat.shape[0]} "
              f"rows, {mat.values().numel()} entries, assembled in "
              f"{build_s:.3f} s; max|SpMV - stencil| {err:.3g} (bound "
              f"1e-13); ms per call (time_ms, mean of 50): SpMV "
              f"{spmv_ms:.4f}, stencil apply_A {stencil_ms:.4f}")
        require(err <= 1e-13, f"spmv {tag}: off the stencil by {err:.3g}")


def phase_device_build(device, n: int, steps: int, uT_main,
                       counts_main: dict) -> tuple[int, dict]:
    """13. The device build: (a) the main configuration, (b) n=16384 on
    one card, (d) the explicit matrix; (c) runs in phase 9's ranks.
    Returns (b)'s cycle count and uT fingerprint."""
    import dataclasses

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    problem = ProblemConfig(n=n, num_steps=steps)
    cfg = delta_config(certify_every=10)
    seconds = {}
    for tag, build in (("host", False), ("device", True), ("device again",
                                                             True)):
        t0 = time.perf_counter()
        model = AdvectionDiffusion(
            problem, dataclasses.replace(cfg, device_build=build),
            device=device)
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        if tag == "host":
            host = model
    dev = model
    print(f"[device build] n={n}: model built in seconds (host build, "
          f"device build, device build again): {seconds}")
    _check_build(f"n={n}", dev, host)
    host = None
    uT, stats, counts = _drive("device build", lambda: dev.run(warn=False),
                               counts_main, 1e-8)
    _check_advection("device build", n, steps, uT, stats, CENTER_1024, True)
    ok, err = _within(uT, uT_main, RUN_TOL)
    print(f"[device build] max|uT - uT(main path, host build)| {err:.3g} "
          f"(bound rtol {RUN_TOL[0]:g}, atol {RUN_TOL[1]:g}); equal to the "
          f"bit: {torch.equal(uT, uT_main)}; launch counts equal to phase "
          f"4's: {counts == counts_main}")
    require(ok, f"device build: uT off the main path's by {err:.3g}")
    dev = uT = stats = None
    big = _phase_big(device)
    _phase_spmv(device, n)
    return big


# phase 14: the 2-D layout and scaling, W=4 gloo ranks on the one card
GRID_WORLD, GRID_MIN_LOCAL = 4, 64
# (a): timed warm-up steps, and the longest run that keeps MAIN_STEPS
GRID_WARM_STEPS, GRID_MAX_RUN_S = 10, 120.0
CONFIG_N, CONFIG_STEPS, CONFIG_MIN_LOCAL = 256, 5, 16  # (b)
HALO_SWEEPS, HALO_REPS, EXCHANGE_REPS = 3, 20, 100  # (c)
SCALING_STEPS = 10  # (d)
SCALING_KEYS = ["devices", "n", "mesh", "layout", "seconds", "center_uT",
                "efficiency"]
# phase 15: the routes of the main path, each switch by its module, and
# the float64 reference configuration against the native oracle
ROUTE_SWITCHES = (("cycle", "_FUSE_CORR"), ("cycle", "_USE_TOWER"),
                  ("cycle", "_RESTRICT_DEC"), ("delta", "_FUSE_OPEN"))
ROUTE_ROUNDS = 3  # walls in turns: each route twice a round
ORACLE_N, ORACLE_STEPS, ORACLE_LEVELS = 64, 100, 2  # tests/test_golden.py
GOLDEN_CENTER = 4.802e-5
OPS_N = 16  # tests/test_ops.py's grid


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _count_collectives() -> dict:
    """Count this process's point-to-point batches and all-gathers from
    here on, by wrapping `dist.batch_isend_irecv` and `dist.all_gather`
    (every exchange and collective of parallel/ goes through one of
    them); returns the live counts."""
    import torch.distributed as dist

    counts = {"batch_isend_irecv": 0, "all_gather": 0}
    for name in counts:
        real = getattr(dist, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        setattr(dist, name, counted)
    return counts


def _peaks_mib(base: int = 0) -> list:
    """Every rank's peak device memory since the last reset, in MiB."""
    import torch.distributed as dist

    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() - base)
    return [b / 2**20 for b in peaks]


def _grid_rank(n: int, steps: int) -> dict:
    """Phase 14 (a), one rank on cuda:0: the main path through
    distributed_run in the 2-D layout, plain and with sharded_overlap
    (halo.py's overlapped sweep), each run read between a reset and a read
    of this rank's launch counts, collectives and peak memory.  A timed
    warm-up of GRID_WARM_STEPS steps picks the step count: `steps` if a
    run would take under GRID_MAX_RUN_S, else as many as take about half
    that, a multiple of 10 (rank 0 decides for all)."""
    import dataclasses

    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops import cuda
    from hpcclassmultigridproject_tpu_torch.parallel import distributed_run

    torch.backends.cuda.matmul.allow_tf32 = False
    colls = _count_collectives()
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                               delta_config(certify_every=10), device="cuda")

    def run(overlap: bool, nsteps: int):
        model.solver = dataclasses.replace(model.solver,
                                           sharded_overlap=overlap)
        model.problem = dataclasses.replace(model.problem, num_steps=nsteps)
        dist.barrier()
        t0 = time.perf_counter()
        uT, stats = distributed_run(model, min_local=GRID_MIN_LOCAL,
                                    layout="2d")
        torch.cuda.synchronize()
        dist.barrier()
        return uT, stats, time.perf_counter() - t0

    run(False, 2)  # warm-up: CUDA context, kernel library, allocator
    _, _, warm = run(False, GRID_WARM_STEPS)
    pick = [steps]
    if warm * steps / GRID_WARM_STEPS >= GRID_MAX_RUN_S:
        fit = GRID_MAX_RUN_S / 2 / warm * GRID_WARM_STEPS
        pick = [max(10, int(fit) // 10 * 10)]
    dist.broadcast_object_list(pick, src=0)
    out = {"steps": pick[0], "warm_s": warm}
    for tag, overlap in (("plain", False), ("overlap", True)):
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        for k in colls:
            colls[k] = 0
        uT, stats, wall = run(overlap, pick[0])
        counts, moved = dict(cuda.LAUNCHES), dict(colls)
        out[tag] = dict(uT=uT.cpu().numpy(), wall=wall, counts=counts,
                        collectives=moved, peaks_mib=_peaks_mib(),
                        stats={k: v.cpu().numpy() for k, v in stats.items()})
    return out


def _grid_configs() -> dict:
    """Phase 14 (b): the configurations that run over partitioned levels
    since the 2-D layout (and the main one), by name."""
    from hpcclassmultigridproject_tpu_torch import SolverConfig

    f64 = torch.float64
    return {
        "fmg": SolverConfig(dtype=f64, cycle_mode="fmg", num_cycles=1),
        "fmg refined": SolverConfig(dtype=torch.float32, refine_dtype=f64,
                                    tol=TOL, cycle_mode="fmg", num_cycles=1),
        "jacobi": SolverConfig(dtype=f64, smoother="jacobi",
                               jacobi_omega=0.8),
        "chebyshev": SolverConfig(dtype=f64, smoother="chebyshev"),
        "galerkin": delta_config(certify_every=5,
                                 coarse_operator="galerkin"),
        "main": delta_config(certify_every=5),
    }


def _configs_rank(n: int, steps: int, min_local: int) -> dict:
    """Phase 14 (b), one rank on cuda:0: each configuration through
    distributed_run in both layouts, and the main one born 2-D-partitioned
    against the same run of the whole device-built model."""
    import dataclasses

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed_run,
        make_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    problem = ProblemConfig(n=n, num_steps=steps)
    as_np = lambda uT, stats: (uT.cpu().numpy(), {
        k: v.cpu().numpy() for k, v in stats.items()})
    out = {}
    for name, cfg in _grid_configs().items():
        for layout in ("rows", "2d"):
            model = AdvectionDiffusion(problem, cfg, device="cuda")
            t0 = time.perf_counter()
            uT, stats = distributed_run(model, min_local=min_local,
                                        layout=layout)
            torch.cuda.synchronize()
            out[name, layout] = (*as_np(uT, stats),
                                 time.perf_counter() - t0)
    main = _grid_configs()["main"]
    born = AdvectionDiffusion(problem, main, device="cuda", mesh=make_mesh(),
                              layout="2d", min_local=min_local)
    whole = AdvectionDiffusion(problem, dataclasses.replace(
        main, device_build=True), device="cuda")
    out["born"] = as_np(*distributed_run(born))
    out["whole"] = as_np(*distributed_run(whole, min_local=min_local,
                                          layout="2d"))
    out["born_level0"] = (born.levels[0].padded, born.levels[0].col_off)
    return out


def _halo_rank(n: int) -> dict:
    """Phase 14 (c), one rank on cuda:0: smooth_distributed on this rank's
    2-D block of the main path's level 0 (float32, seeded fields), plain
    and overlapped, gathered; the whole level's K2 (`fused_rb_sweeps`) on
    the same fields; and the ms of one 2-D halo exchange (halo.py's four
    edges) and of one corner-carrying extension (blocks.extend)."""
    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.core.layout import interior_mask
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import (
        fused_rb_sweeps,
    )
    from hpcclassmultigridproject_tpu_torch.parallel import (
        blocks,
        fetch,
        halo,
        level_shardings_for_ns,
        make_global,
        make_mesh,
        smooth_distributed,
    )

    level = AdvectionDiffusion(ProblemConfig(n=n, num_steps=1),
                               delta_config(), device="cuda").levels[0]
    rng = np.random.default_rng(14)
    mask = interior_mask(n, level.padded, dtype=torch.float32,
                         device="cuda")
    u, rhs = (torch.from_numpy(rng.standard_normal(level.padded)).to(
        device="cuda", dtype=torch.float32) * mask for _ in range(2))
    mesh = make_mesh()
    (part,) = level_shardings_for_ns([n], mesh, 1, "2d")
    ub, rb = make_global(u, part), make_global(rhs, part)
    out = {"block": part.shape}
    want = fused_rb_sweeps(level, u, rhs, HALO_SWEEPS, want_residual=True)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            got = fn()
        torch.cuda.synchronize()
        dist.barrier()
        return got, (time.perf_counter() - t0) / reps * 1e3

    for tag, overlap in (("plain", False), ("overlapped", True)):
        (u1, res, norm), ms = timed(lambda: smooth_distributed(
            mesh, level, ub, rb, HALO_SWEEPS, True, overlap), HALO_REPS)
        got = (fetch(u1, part), fetch(res, part))
        out[tag] = dict(ms=ms, equal=[bool(torch.equal(g, w))
                                      for g, w in zip(got, want)],
                        max_diff=max(float((g - w).abs().max())
                                     for g, w in zip(got, want)),
                        norm=float(norm))
    _, out["exchange_ms"] = timed(
        lambda: halo._start_halo(ub, mesh).wait(), EXCHANGE_REPS)
    _, out["extend_ms"] = timed(lambda: blocks.extend([ub], part),
                                EXCHANGE_REPS)
    return out


def _certified_run(tag: str, stats: dict, delta: bool) -> str:
    """Require every step converged (under tol), and under the delta form
    every f64 certificate <= 1e-6; a one-line summary."""
    rel = stats["rel_residual"]
    require(bool(np.all(stats["converged"])) and bool(np.all(rel <= TOL)),
            f"{tag}: a step missed tol (max {rel.max():.3e})")
    line = f"max step certificate {rel.max():.3e}"
    if delta:
        hi = stats["rel_residual_hi_steps"]
        final = float(stats["final_rel_residual_hi"])
        require(bool(np.all(hi[hi >= 0] <= TOL)) and final <= TOL,
                f"{tag}: an f64 certificate exceeds 1e-6")
        line += (f", f64 certificates {int((hi >= 0).sum())} (max "
                 f"{hi[hi >= 0].max():.3e}), final f64 {final:.3e}")
    return line


def _phase_grid_main(n: int, steps: int, uT_single, smi: str) -> None:
    """Phase 14 (a)."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    t0 = time.perf_counter()
    res = launch_local(_grid_rank, GRID_WORLD, (n, steps), backend="gloo",
                       device="cuda:0")
    ran = res["steps"]
    print(f"[grid] (a) main path, n={n}, layout 2d over a 2x2 mesh, "
          f"min_local {GRID_MIN_LOCAL} (levels {n}..{n >> 3} in 2-D blocks, "
          f"{n >> 4} and {n >> 5} replicated): spawn, build and runs "
          f"{time.perf_counter() - t0:.1f} s; warm-up of {GRID_WARM_STEPS} "
          f"steps {res['warm_s']:.3f} s (rank 0); {smi}")
    if ran != steps:
        print(f"[grid] (a) steps cut from {steps} to {ran}: a {steps}-step "
              f"run would take over {GRID_MAX_RUN_S:.0f} s; compared with a "
              f"single-device run of {ran} steps")
        model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=ran),
                                   delta_config(certify_every=10),
                                   device="cuda")
        uT_single = model.run(warn=False)[0]
    single = uT_single.cpu().numpy()
    expect = {"tower_descent": ran, "tower_ascent": ran}
    for tag in ("plain", "overlap"):
        got = res[tag]
        counts = got["counts"]
        du = float(np.abs(got["uT"] - single).max())
        print(f"[grid] (a) {tag}: wall {got['wall']:.4f} s (rank 0, {ran} "
              f"steps; {smi}), max|uT - uT_single| {du!r} (bound 1e-09); "
              f"launches per rank {counts}; collectives on rank 0 "
              f"{got['collectives']} ({got['collectives']['batch_isend_irecv'] / ran:.1f}"
              f" exchanges and {got['collectives']['all_gather'] / ran:.1f} "
              f"all-gathers a step); peak device memory per rank "
              f"{[round(m, 1) for m in got['peaks_mib']]} MiB")
        require(counts == {k: expect.get(k, 0) for k in counts},
                f"grid (a) {tag}: launch counts {counts}")
        require(du <= 1e-9, f"grid (a) {tag}: uT off by {du:.3g}")
        stats = {k: torch.from_numpy(v) for k, v in got["stats"].items()}
        _check_advection(f"grid {tag}", n, ran, torch.from_numpy(got["uT"]),
                         stats, CENTER_1024, True)
    same = np.array_equal(res["plain"]["uT"], res["overlap"]["uT"])
    print(f"[grid] (a) overlapped halo sweeps equal to plain to the bit: "
          f"{same}")
    require(same, "grid (a): the overlapped sweep differs from the plain")


def _phase_grid_configs(smi: str, backend: str = "gloo",
                        device: str = "cuda:0",
                        label: str = "[grid] (b)") -> None:
    """Phase 14 (b), and phase 16 (b) over NCCL with one card a rank."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    t0 = time.perf_counter()
    res = launch_local(_configs_rank, GRID_WORLD,
                       (CONFIG_N, CONFIG_STEPS, CONFIG_MIN_LOCAL),
                       backend=backend, device=device)
    print(f"{label} n={CONFIG_N}, {CONFIG_STEPS} steps, min_local "
          f"{CONFIG_MIN_LOCAL}, W={GRID_WORLD}, both layouts: "
          f"{time.perf_counter() - t0:.1f} s in all, {backend}; {smi}")
    problem = ProblemConfig(n=CONFIG_N, num_steps=CONFIG_STEPS)
    for name, cfg in _grid_configs().items():
        single, _ = AdvectionDiffusion(problem, cfg, device="cuda").run(
            warn=False)
        single = single.cpu().numpy()
        for layout in ("rows", "2d"):
            uT, stats, wall = res[name, layout]
            du = float(np.abs(uT - single).max())
            line = _certified_run(f"{label} {name} {layout}", stats,
                                  cfg.delta_form)
            print(f"{label} {name}, {layout}: wall {wall:.3f} s (rank "
                  f"0), max|uT - uT_single(card)| {du!r} (bound 1e-09, "
                  f"bitwise {du == 0.0}); {line}")
            require(du <= 1e-9, f"{label} {name} {layout}: uT off the "
                    f"single-device run by {du:.3g}")
    born, whole = res["born"], res["whole"]
    same = np.array_equal(born[0], whole[0])
    _certified_run(f"{label} born", born[1], True)
    print(f"{label} main born 2-D-partitioned (rank 0's level 0 "
          f"{res['born_level0'][0]}, col_off {res['born_level0'][1]}) "
          f"equal to the whole device build's 2-D run to the bit: {same}")
    require(same, f"{label}: the born 2-D run differs from the whole one")


def _phase_grid_halo(n: int, smi: str) -> None:
    """Phase 14 (c)."""
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    res = launch_local(_halo_rank, GRID_WORLD, (n,), backend="gloo",
                       device="cuda:0")
    for tag in ("plain", "overlapped"):
        got = res[tag]
        print(f"[grid] (c) smooth_distributed {tag}, n={n} level 0, "
              f"{HALO_SWEEPS} sweeps and the residual, blocks "
              f"{res['block']}: {got['ms']:.3f} ms a call (rank 0, mean "
              f"of {HALO_REPS}; {smi}); (u, residual) equal to K2 on the "
              f"whole level: {got['equal']} (max|diff| {got['max_diff']!r})"
              f"; norm {got['norm']!r}")
        require(all(got["equal"]), f"grid (c) {tag}: differs from K2")
    print(f"[grid] (c) one 2-D halo exchange of a block (four edges): "
          f"{res['exchange_ms']:.4f} ms; one extension with corners (rows, "
          f"then columns): {res['extend_ms']:.4f} ms (rank 0, mean of "
          f"{EXCHANGE_REPS}, gloo staged through the host; {smi})")


def _phase_grid_scaling(smi: str, strong_n: int = MAIN_N,
                        weak_n: int = MAIN_N // 2,
                        weak_layouts=("auto",), cycles: int | None = 1,
                        reps: int = 1, label: str = "[grid] (d)") -> None:
    """Phase 14 (d): `cli scaling` on the card, strong in both layouts and
    weak, each line against a single-device run of its n at `cycles`
    V-cycles a step (None: the auto count); phase 16 (d) runs it over
    NCCL, one card a rank, at its own sizes."""
    import dataclasses

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    flags = ["--steps", str(SCALING_STEPS), "--delta", "--cycle-mode",
             "fixed", "--num-cycles", "auto" if cycles is None else
             str(cycles), "--coarse", "dense", "--certify-every", "10",
             "--reps", str(reps), "--max-devices", str(GRID_WORLD)]
    centers = {}

    def center(n):
        if n not in centers:
            model = AdvectionDiffusion(
                ProblemConfig(n=n, num_steps=SCALING_STEPS),
                dataclasses.replace(delta_config(certify_every=10),
                                    num_cycles=cycles), device="cuda")
            centers[n] = model.center_value(model.run(warn=False)[0])
        return centers[n]

    meshes = {1: {"x": 1, "y": 1}, 2: {"x": 1, "y": 2}, 4: {"x": 2, "y": 2}}
    sweeps = [("strong", layout, strong_n, [(1, strong_n), (2, strong_n),
                                            (4, strong_n)])
              for layout in ("rows", "2d")]
    sweeps += [("weak", layout, weak_n, [(1, weak_n), (4, 2 * weak_n)])
               for layout in weak_layouts]
    for mode, layout, n, want in sweeps:
        lines = _cli("scaling", "--mode", mode, "--layout", layout, "--n",
                     str(n), *flags)
        require([(r["devices"], r["n"]) for r in lines] == want,
                f"cli scaling {mode} {layout}: points {lines}")
        for rec in lines:
            keys = SCALING_KEYS + (["speedup"] if mode == "strong" else [])
            dc = abs(rec["center_uT"] - center(rec["n"]))
            print(f"{label} scaling --mode {mode} --layout {layout}: "
                  f"{rec['devices']} ranks, n={rec['n']}, mesh "
                  f"{rec['mesh']}: {rec['seconds']:.4f} s ({SCALING_STEPS} "
                  f"steps; {smi}), efficiency {rec['efficiency']}, speedup "
                  f"{rec.get('speedup')}; |center_uT - single| {dc:.3g}")
            require(list(rec) == keys, f"cli scaling keys {list(rec)}")
            require(rec["mesh"] == meshes[rec["devices"]]
                    and rec["layout"] == layout,
                    f"cli scaling mesh/layout {rec}")
            require(dc <= 1e-9, f"cli scaling center off by {dc:.3g}")


def phase_grid(n: int, steps: int, uT_single) -> None:
    """Phase 14: the 2-D layout and scaling (module docstring)."""
    smi = _smi()
    print(f"[grid] {GRID_WORLD} ranks share cuda:0 over gloo, halos and "
          "collectives staged through host memory (NCCL takes one rank per "
          "GPU).  The walls are not a scaling figure.")
    _phase_grid_main(n, steps, uT_single, smi)
    _phase_grid_configs(smi)
    _phase_grid_halo(n, smi)
    _phase_grid_scaling(smi)


def _route_counts(steps: int, switch: str | None) -> dict:
    """The launch counts one main-path run must show on a route, from the
    code: K1 a step, K2 before and after level 0, the tower's two halves;
    without the tower K2 before and after each of levels 0-4; without K1
    the opening is plain torch; none under backend "jnp"."""
    if switch == "jnp":
        return {}
    want = {"delta_open": steps, "smooth": 2 * steps,
            "tower_descent": steps, "tower_ascent": steps}
    if switch == "_USE_TOWER":
        want.update(smooth=10 * steps, tower_descent=0, tower_ascent=0)
    if switch == "_FUSE_OPEN":
        want["delta_open"] = 0
    return want


def _route_run(tag: str, run, want: dict) -> dict:
    """Check one route of the main path: a warm-up run, a run between a
    reset and a read of the launch counts (every count must equal
    `want`), a run for peak memory and a profiled run.  Returns the
    counted run's (uT, stats), its launch counts, the peak MiB and the
    MiB held before that run (earlier phases' tensors and the models),
    and the profiled run's (wall, busy ms, launch calls, cooperative
    ones)."""
    from hpcclassmultigridproject_tpu_torch.ops import cuda

    run()
    torch.cuda.synchronize()
    cuda.reset_launches()
    out = run()
    torch.cuda.synchronize()
    counts = dict(cuda.LAUNCHES)
    want = {k: want.get(k, 0) for k in counts}
    require(counts == want, f"{tag}: launch counts {counts}, expected {want}")
    held = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return {"out": out, "counts": {k: v for k, v in counts.items() if v},
            "peak": torch.cuda.max_memory_allocated() / 2**20,
            "held": held, "profiled": _profiled_run(run)}


@contextlib.contextmanager
def _switched_off(module, switch: str | None):
    """The switch `switch` of `module` off for as long as the context
    lasts (no switch: nothing)."""
    if switch is None:
        yield
        return
    old = getattr(module, switch)
    setattr(module, switch, False)
    try:
        yield
    finally:
        setattr(module, switch, old)


def _phase_routes(device, n: int, steps: int, uT_main, smi: str) -> None:
    """Phase 15 (a): the main path on each route, bit for bit phase 4's,
    then every route's wall in turns (forward, then backward, three
    rounds) in this process."""
    import dataclasses

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.mg import cycle, delta
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    modules = {"cycle": cycle, "delta": delta}
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                               delta_config(certify_every=10), device=device)
    jnp_model = AdvectionDiffusion(
        ProblemConfig(n=n, num_steps=steps),
        dataclasses.replace(model.solver, backend="jnp"), device=device)
    routes = [("default", model, None, None)] + [
        (f"{switch} off", model, modules[module], switch)
        for module, switch in ROUTE_SWITCHES] + [
        ('backend="jnp"', jnp_model, None, "jnp")]
    checked = {}
    for tag, m, module, switch in routes:
        run = lambda m=m: m.run(warn=False)
        with _switched_off(module, None if switch == "jnp" else switch):
            checked[tag] = _route_run(tag, run, _route_counts(steps, switch))
        uT, stats = checked[tag].pop("out")
        _check_advection(f"routes {tag}", n, steps, uT, stats, CENTER_1024,
                         True)
        du = float((uT - uT_main).abs().max())
        print(f"[routes] {tag}: max|uT - uT(phase 4)| {du!r}; equal to the "
              f"bit: {torch.equal(uT, uT_main)}")
        require(torch.equal(uT, uT_main),
                f"routes: {tag}: uT off phase 4's by {du:.3g}")
    walls = {tag: [] for tag, *_ in routes}
    for _ in range(ROUTE_ROUNDS):
        for tag, m, module, switch in routes + routes[::-1]:
            with _switched_off(module, None if switch == "jnp" else switch):
                t0 = time.perf_counter()
                m.run(warn=False)
                torch.cuda.synchronize()
                walls[tag].append(time.perf_counter() - t0)
    for tag, *_ in routes:
        c = checked[tag]
        median = statistics.median(walls[tag])
        wall, busy, launches, cooperative = c["profiled"]
        print(f"[routes] {tag} ({smi}): launches {c['counts']}; wall in "
              f"turns {median:.4f} s (median of {len(walls[tag])}, "
              f"{walls[tag]}); one profiled run {wall:.4f} s, the card busy "
              f"{busy:.2f} ms, idle {1 - busy / 1e3 / median:.1%} of the "
              f"median wall, {launches} launch calls ({cooperative} "
              f"cooperative); peak {c['peak']:.1f} MiB, "
              f"{c['peak'] - c['held']:.1f} above the {c['held']:.1f} "
              "held before the run")


def _default_problem(n: int):
    """The default problem's u0, v1, v2 as numpy float64 logical fields,
    from the reference's formulas (tests/conftest.py::default_problem)."""
    idx = np.arange(n + 1) * (1.0 / n)
    x = idx[:, None] * np.ones((1, n + 1))
    y = np.ones((n + 1, 1)) * idx[None, :]
    u0 = np.exp(-100.0 * ((x - 0.2) ** 2 + (y - 0.4) ** 2))
    u0[0, :] = u0[-1, :] = u0[:, 0] = u0[:, -1] = 0.0
    v1 = -np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)
    v2 = np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)
    return u0, v1, v2


def _phase_oracle(device) -> None:
    """Phase 15 (b): the float64 adaptive reference configuration on the
    card against the native oracle (n=64, V and W) and the golden field
    (n=256), K2 launched in float64 two blocks a level a cycle pass."""
    from hpcclassmultigridproject_tpu_torch import (
        ProblemConfig,
        SolverConfig,
        native,
    )
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    native.build()
    print(f"[oracle] native library {native.build().name} built with g++ "
          f"{' '.join(native.GXX_FLAGS)} in {time.perf_counter() - t0:.2f} s")
    n = ORACLE_N
    u0, v1, v2 = _default_problem(n)
    for shape in (1, 2):
        model = AdvectionDiffusion(
            ProblemConfig(n=n, num_steps=ORACLE_STEPS),
            SolverConfig(dtype=torch.float64, num_levels=ORACLE_LEVELS,
                         cycle_shape=shape), device=device)
        cuda.reset_launches()
        t0 = time.perf_counter()
        uT, stats = model.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda.LAUNCHES)
        cycles = stats["cycles"].cpu().numpy()
        t0 = time.perf_counter()
        want, want_cycles = native.run(u0, v1, v2, nu=-4e-4,
                                       dt=(1 / n) / 10, nsteps=ORACLE_STEPS,
                                       num_levels=ORACLE_LEVELS, shape=shape)
        oracle_s = time.perf_counter() - t0
        err = float(np.abs(uT.cpu().numpy() - want).max())
        name = "V" if shape == 1 else "W"
        print(f"[oracle] n={n} {name}-cycle, float64, {ORACLE_STEPS} steps: "
              f"max|uT - native| {err:.3g} (bound 1e-12); cycles a step "
              f"{sorted(set(cycles.tolist()))} (native "
              f"{sorted(set(want_cycles.tolist()))}); K2 launches "
              f"{counts['smooth']}; card {wall:.3f} s, native "
              f"{oracle_s:.3f} s")
        require(err <= 1e-12, f"oracle: n={n} {name}-cycle off by {err:.3g}")
        if shape == 1:
            require(np.array_equal(cycles, want_cycles),
                    "oracle: V-cycle cycles a step differ from native")
        want_counts = {k: 0 for k in counts}
        want_counts["smooth"] = 2 * shape * int(cycles.sum())
        require(counts == want_counts,
                f"oracle: launch counts {counts}, expected {want_counts}")
    golden = np.load(ROOT / "tests" / "golden" / "uT_n256.npy")
    model = AdvectionDiffusion(ProblemConfig(n=256),
                               SolverConfig(dtype=torch.float64),
                               device=device)
    cuda.reset_launches()
    uT, stats = model.run()
    counts = dict(cuda.LAUNCHES)
    got = uT.cpu().numpy()
    err = float(np.abs(got - golden).max())
    center = float(got[128, 128])
    cycles = stats["cycles"].cpu().numpy()
    print(f"[oracle] n=256 float64 adaptive, {model.num_levels} levels: "
          f"max|uT - golden| {err:.3g} (bound 1e-12), center {center!r} "
          f"({GOLDEN_CENTER} +- 5e-9), max cycles a step {cycles.max()}, "
          f"K2 launches {counts['smooth']}")
    require(err <= 1e-12, f"oracle: n=256 off the golden field by {err:.3g}")
    require(abs(center - GOLDEN_CENTER) <= 5e-9, "oracle: n=256 center")
    require(int(cycles.max()) <= 1, "oracle: n=256 took > 1 cycle a step")
    want_counts = {k: 0 for k in counts}
    want_counts["smooth"] = 2 * (model.num_levels - 1) * int(cycles.sum())
    require(counts == want_counts,
            f"oracle: launch counts {counts}, expected {want_counts}")


def _phase_logical_ops(device) -> None:
    """Phase 15 (c): the logical-shape operations on the card in float64
    against the native oracle, at tests/test_ops.py's grid and
    tolerances."""
    from hpcclassmultigridproject_tpu_torch import native, ops
    from hpcclassmultigridproject_tpu_torch.core.problem import (
        cn_coefficients,
    )

    n, h = OPS_N, 1.0 / OPS_N
    dt, nu = h / 10, -4e-4
    rng = np.random.default_rng(0)
    u, rhs, v1, v2 = rng.standard_normal((4, n + 1, n + 1))
    for a in (u, rhs):
        a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = 0.0
    dev = lambda a: torch.from_numpy(a).to(device)
    coef = cn_coefficients(dev(v1), dev(v2), dt, nu, h)
    require(coef.aa.device.type == "cuda", "ops: coefficients off the card")
    gs = dev(u)
    for _ in range(3):
        gs = ops.rb_gauss_seidel(coef, gs, dev(rhs))
    coarse = rng.standard_normal((6, 6))
    fine = rng.standard_normal((11, 11))
    cases = [  # (name, got, want, rtol, atol, interior only)
        ("compute_rhs", ops.compute_rhs(coef, dev(u)),
         native.compute_rhs(u, v1, v2, h, dt, nu), 1e-13, 0.0, True),
        ("residual", ops.residual(coef, dev(u), dev(rhs)),
         native.residual(u, rhs, v1, v2, h, dt, nu), 1e-12, 0.0, True),
        ("norm", ops.interior_norm(dev(rhs)), np.float64(native.norm(rhs)),
         1e-13, 0.0, False),
        ("gs_sweep (3)", gs, native.gs_sweep(u, rhs, v1, v2, h, dt, nu,
                                             nsweeps=3), 0.0, 1e-13, False),
        ("prolong", ops.prolong_bilinear(dev(coarse)),
         native.prolong(coarse), 1e-15, 0.0, False),
        ("restrict", ops.restrict_inject(dev(fine)), native.restrict(fine),
         0.0, 0.0, False),
    ]
    for name, got, want, rtol, atol, interior in cases:
        require(got.device.type == "cuda", f"ops: {name} off the card")
        got = got.cpu().numpy()
        if interior:
            got, want = got[1:-1, 1:-1], want[1:-1, 1:-1]
        err = float(np.abs(got - want).max())
        ok = bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))
        print(f"[ops] {name} on the card against native, n={n}: max abs "
              f"diff {err:.3g} (rtol {rtol:g}, atol {atol:g})")
        require(ok, f"ops: {name} off the native oracle")


def phase_routes_oracle(device, n: int, steps: int, uT_main) -> None:
    """Phase 15: the routes of the main path, then the oracle."""
    smi = _smi()
    _phase_routes(device, n, steps, uT_main, smi)
    _phase_oracle(device)
    _phase_logical_ops(device)


# phase 16: the partitioned run over four cards, one NCCL rank a card
MULTI_WORLD, MULTI_REPS = 4, 5  # (a): timed runs a case, after a warm-up
HUGE_N, HUGE_MAX_CYCLES = 32768, 12  # (c): a grid no single card holds
STRONG_N, WEAK_N, MULTI_SCALING_REPS = 8192, 4096, 3  # (d)
FINGERPRINT_STRIDE = 64


def _fingerprint(uT: torch.Tensor) -> dict:
    """A large uT in small: the SHA-256 of its bytes (equal digests, equal
    bits), its shape and dtype, its center and every FINGERPRINT_STRIDE-th
    node of each axis (the size of a difference)."""
    host = uT.contiguous().cpu().numpy()
    n = host.shape[0] - 1
    return {"sha256": hashlib.sha256(host.data).hexdigest(),
            "shape": host.shape, "dtype": str(host.dtype),
            "center": float(host[n // 2, n // 2]),
            "sample": host[::FINGERPRINT_STRIDE,
                           ::FINGERPRINT_STRIDE].copy()}


def _all_ranks(value) -> list:
    """`value` of every rank, in rank order, on every rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _multi_main_rank(n: int, steps: int) -> dict:
    """Phase 16 (a), one NCCL rank on its own card: the main path through
    distributed_run in both layouts, built whole and born partitioned, in
    the plain and the overlapped schedule.  Each case runs a warm-up, then
    MULTI_REPS timed runs built whole and one born; the first timed run
    is read between a reset and a read of this rank's launch counts and
    collectives, which every rank reports.  Then the ms of each
    collective at the path's shapes."""
    import dataclasses

    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops import cuda
    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed_run,
        make_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"cards": _all_ranks(torch.cuda.current_device()),
           "backend": dist.get_backend()}
    colls = _count_collectives()
    mesh = make_mesh()
    problem = ProblemConfig(n=n, num_steps=steps)
    cfg = delta_config(certify_every=10)
    for layout in ("rows", "2d"):
        for build in ("whole", "born"):
            if build == "whole":
                model = AdvectionDiffusion(problem, cfg, device="cuda")
                kw = dict(min_local=DIST_MIN_LOCAL, layout=layout)
            else:
                model = AdvectionDiffusion(problem, cfg, device="cuda",
                                           mesh=mesh, layout=layout,
                                           min_local=DIST_MIN_LOCAL)
                kw = {}
            for overlap in (False, True):
                model.solver = dataclasses.replace(model.solver,
                                                   sharded_overlap=overlap)
                case = out[layout, build, overlap] = {"walls": []}
                timed = MULTI_REPS if build == "whole" else 1
                for rep in range(timed + 1):
                    torch.cuda.reset_peak_memory_stats()
                    cuda.reset_launches()
                    for k in colls:
                        colls[k] = 0
                    dist.barrier()
                    t0 = time.perf_counter()
                    uT, stats = distributed_run(model, **kw)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    if rep == 1:
                        case["counts"] = _all_ranks(dict(cuda.LAUNCHES))
                        case["collectives"] = _all_ranks(dict(colls))
                    if rep:
                        case["walls"].append(wall)
                case.update(uT=uT.cpu().numpy(), peaks_mib=_peaks_mib(),
                            stats={k: v.cpu().numpy()
                                   for k, v in stats.items()})
            if layout == "rows" and build == "whole":
                out["comm_ms"] = _collective_costs(model, grid=True)
            model = None
    return out


def _phase_multi_main(n: int, steps: int, uT_single, smi: str) -> None:
    """Phase 16 (a)."""
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    t0 = time.perf_counter()
    res = launch_local(_multi_main_rank, MULTI_WORLD, (n, steps),
                       backend="nccl", device="cuda")
    cards, backend = res.pop("cards"), res.pop("backend")
    comm = res.pop("comm_ms")
    print(f"[multi-gpu] (a) main path, n={n}, {steps} steps, min_local "
          f"{DIST_MIN_LOCAL}, {MULTI_WORLD} ranks over {backend}, rank r "
          f"on cuda:{cards}: spawn, builds and runs "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    require(backend == "nccl" and cards == list(range(MULTI_WORLD)),
            f"multi-gpu (a): backend {backend}, cards {cards}")
    print(f"[multi-gpu] (a) collectives per call over {backend}, ms (rank 0, "
          f"mean of 100, no kernel between them; {smi}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in comm.items()))
    single = uT_single.cpu().numpy()
    for (layout, build, overlap), got in res.items():
        tag = f"{layout}, {build}, {'overlap' if overlap else 'plain'}"
        du = float(np.abs(got["uT"] - single).max())
        expect = {"tower_descent": steps, "tower_ascent": steps}
        if layout == "rows":
            expect["smooth_rows"] = (18 if overlap else 6) * steps
        colls = got["collectives"]
        per_step = {k: v / steps for k, v in colls[0].items()}
        walls = got["walls"]
        print(f"[multi-gpu] (a) {tag}: wall {statistics.median(walls):.4f} s "
              f"(rank 0, median of {len(walls)}: {walls}; {smi}); "
              f"max|uT - uT_single| {du!r} (bound 1e-09, bitwise "
              f"{du == 0.0}); launches per rank (rank 0) {got['counts'][0]};"
              f" collectives a step per rank {per_step}; peak device "
              f"memory per rank {[round(m, 1) for m in got['peaks_mib']]} "
              "MiB")
        for rank, counts in enumerate(got["counts"]):
            require(counts == {k: expect.get(k, 0) for k in counts},
                    f"multi-gpu (a) {tag}: rank {rank}'s launch counts "
                    f"{counts}, expected {expect}")
        require(all(c == colls[0] for c in colls),
                f"multi-gpu (a) {tag}: the ranks posted different "
                f"collectives {colls}")
        require(du <= 1e-9, f"multi-gpu (a) {tag}: uT off the "
                f"single-device run by {du:.3g}")
        stats = {k: torch.from_numpy(v) for k, v in got["stats"].items()}
        _check_advection(f"multi-gpu (a) {tag}", n, steps,
                         torch.from_numpy(got["uT"]), stats, CENTER_1024,
                         True)
    for layout in ("rows", "2d"):
        for overlap in (False, True):
            whole, born = (res[layout, b, overlap] for b in ("whole", "born"))
            du = float(np.abs(whole["uT"] - born["uT"]).max())
            print(f"[multi-gpu] (a) {layout}, "
                  f"{'overlap' if overlap else 'plain'}: born (built on "
                  f"the device) against whole (host build): max|uT diff| "
                  f"{du!r}; the same collectives: "
                  f"{whole['collectives'] == born['collectives']}")


def _multi_scale_rank(big_n: int, big_cycles: int, huge_n: int) -> dict:
    """Phase 16 (c), one NCCL rank on its own card: n=big_n born
    partitioned in each layout at big_cycles V-cycles a step (rank 0
    fingerprints uT), then n=huge_n born row-partitioned at the auto
    cycle count and, if that does not certify, at each larger count up
    to HUGE_MAX_CYCLES until one does.  Build seconds, walls, stats and
    every rank's peak device memory, reset before each build."""
    import dataclasses
    import gc
    import warnings

    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed_run,
        make_mesh,
    )

    mesh = make_mesh()

    def build(n, cycles, layout):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        solver = dataclasses.replace(delta_config(certify_every=10),
                                     num_cycles=cycles)
        dist.barrier()
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            model = AdvectionDiffusion(
                ProblemConfig(n=n, num_steps=BIG_STEPS), solver,
                device="cuda", mesh=mesh, layout=layout)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        return model, dict(build_s=build_s, built_mib=_peaks_mib(),
                           level0=model.levels[0].padded,
                           notices=[str(w.message) for w in said])

    def run(model, cycles):
        model.solver = dataclasses.replace(model.solver, num_cycles=cycles)
        dist.barrier()
        t0 = time.perf_counter()
        uT, stats = distributed_run(model)
        torch.cuda.synchronize()
        return uT, dict(cycles=cycles, wall=time.perf_counter() - t0,
                        stats={k: v.cpu().numpy()
                               for k, v in stats.items()})

    out = {}
    for layout in ("rows", "2d"):
        model, got = build(big_n, big_cycles, layout)
        uT, ran = run(model, big_cycles)
        got.update(ran, peaks_mib=_peaks_mib())
        got["fingerprint"] = _fingerprint(uT) if mesh.rank == 0 else None
        out[big_n, layout] = got
        model = uT = None
    model, got = build(huge_n, None, "rows")
    got["auto"] = model.solver.num_cycles
    got["runs"] = []
    for cycles in [got["auto"], *range(got["auto"] + 1,
                                       HUGE_MAX_CYCLES + 1)]:
        uT = None
        uT, ran = run(model, cycles)
        got["runs"].append(ran)
        if _certified(ran["stats"])[0]:
            break
    got.update(peaks_mib=_peaks_mib(), shape=tuple(uT.shape),
               finite=bool(torch.isfinite(uT).all()),
               center=float(uT[huge_n // 2, huge_n // 2]))
    out[huge_n] = got
    return out


def _phase_multi_scale(big: tuple[int, dict], smi: str) -> None:
    """Phase 16 (c)."""
    from hpcclassmultigridproject_tpu_torch.parallel import launch_local

    big_cycles, want = big
    t0 = time.perf_counter()
    res = launch_local(_multi_scale_rank, MULTI_WORLD,
                       (BIG_N, big_cycles, HUGE_N), backend="nccl",
                       device="cuda")
    print(f"[multi-gpu] (c) n={BIG_N} and n={HUGE_N} born partitioned over "
          f"{MULTI_WORLD} cards, {BIG_STEPS} steps: spawn, builds and runs "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    for layout in ("rows", "2d"):
        got = res[BIG_N, layout]
        fp = got["fingerprint"]
        same = (fp["sha256"] == want["sha256"] and fp["shape"] == want[
            "shape"] and fp["dtype"] == want["dtype"])
        dsample = float(np.abs(fp["sample"] - want["sample"]).max())
        ok, rel, mid, final = _certified(got["stats"])
        print(f"[multi-gpu] (c) n={BIG_N}, {layout}, {big_cycles} V-cycles "
              f"a step: built in {got['build_s']:.3f} s (rank 0's level 0 "
              f"{got['level0']}), wall {got['wall']:.3f} s (rank 0, the "
              f"first run; {smi}); certificates f32 {rel:.3e} / f64 "
              f"mid-run {mid:.3e} / final {final:.3e}; uT equal to phase "
              f"13's one-card run to the bit (SHA-256 of {fp['shape']} "
              f"{fp['dtype']}): {same}; max|diff| on every "
              f"{FINGERPRINT_STRIDE}th node {dsample!r}; center "
              f"{fp['center']!r}; peak device memory per rank, after the "
              f"build {[round(m, 1) for m in got['built_mib']]} MiB, "
              f"build through run {[round(m, 1) for m in got['peaks_mib']]}"
              f" MiB")
        require(ok, f"multi-gpu (c) n={BIG_N} {layout}: not certified")
        require(same, f"multi-gpu (c) n={BIG_N} {layout}: uT differs from "
                "phase 13's one-card run")
    got = res[HUGE_N]
    print(f"[multi-gpu] (c) n={HUGE_N} born row-partitioned: built in "
          f"{got['build_s']:.3f} s (rank 0), rank 0's level 0 "
          f"{got['level0']}; peak device memory per rank after the build "
          f"{[round(m, 1) for m in got['built_mib']]} MiB; auto cycle count "
          f"{got['auto']}; the notices: {got['notices']}")
    for ran in got["runs"]:
        ok, rel, mid, final = _certified(ran["stats"])
        auto = " (auto)" if ran["cycles"] == got["auto"] else ""
        print(f"[multi-gpu] (c) n={HUGE_N}, {BIG_STEPS} steps, "
              f"{ran['cycles']} V-cycles a step{auto}: wall "
              f"{ran['wall']:.3f} s (rank 0, the first run at this count; "
              f"{smi}), certificates f32 {rel:.3e} / f64 mid-run "
              f"{mid:.3e} / final {final:.3e}: "
              f"{'certified' if ok else 'NOT certified'}")
    last = got["runs"][-1]
    ok = _certified(last["stats"])[0]
    if last["cycles"] != got["auto"]:
        print(f"[multi-gpu] (c) n={HUGE_N}: the auto count {got['auto']} "
              f"does not certify; the fewest cycles above it that do: "
              f"{last['cycles'] if ok else 'none up to ' + str(HUGE_MAX_CYCLES)}")
    print(f"[multi-gpu] (c) n={HUGE_N}: uT {got['shape']}, finite "
          f"{got['finite']}, center {got['center']!r}; peak device memory "
          f"per rank, build through the runs and the gather of uT "
          f"{[round(m, 1) for m in got['peaks_mib']]} MiB ({smi})")
    require(got["shape"] == (HUGE_N + 1, HUGE_N + 1) and got["finite"],
            f"multi-gpu (c) n={HUGE_N}: uT")
    require(ok, f"multi-gpu (c) n={HUGE_N}: no cycle count up to "
            f"{HUGE_MAX_CYCLES} certifies")


def phase_multi_gpu(n: int, steps: int, uT_single, big) -> None:
    """Phase 16: the partitioned run over MULTI_WORLD cards, one NCCL rank
    a card (module docstring); on fewer cards one line says it was not
    run.  `big` is phase 13's (cycle count, uT fingerprint) at n=16384."""
    import gc

    count = torch.cuda.device_count()
    if count < MULTI_WORLD:
        print(f"[multi-gpu] not run: it takes {MULTI_WORLD} cards, one NCCL "
              f"rank a card, and torch.cuda.device_count() is {count}")
        return
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    for line in cards:
        print(f"[multi-gpu] card {line}")
    for line in (topo.stdout + topo.stderr).rstrip().splitlines():
        print(f"[multi-gpu] topo {line}")
    smi = "; ".join(cards)
    gc.collect()
    torch.cuda.empty_cache()  # this process's cache on cuda:0 is rank 0's
    _phase_multi_main(n, steps, uT_single, smi)
    _phase_grid_configs(smi, backend="nccl", device="cuda",
                        label="[multi-gpu] (b)")
    gc.collect()
    torch.cuda.empty_cache()
    _phase_multi_scale(big, smi)
    _phase_grid_scaling(smi, strong_n=STRONG_N, weak_n=WEAK_N,
                        weak_layouts=("rows", "2d"), cycles=None,
                        reps=MULTI_SCALING_REPS, label="[multi-gpu] (d)")


# phase 17: the compiled run, each model entry point one CUDA graph
COMPILED_REPLAYS = 6  # (a): replays checked one by one, and walls in turns
COMPILED_ROUNDS = 3   # (a): rounds of (eager, captured, captured, eager)


def _peak_mib(held) -> tuple[float, float]:
    """(peak allocated, peak reserved) MiB since the last reset, above the
    `held` (allocated, reserved) MiB."""
    return (torch.cuda.max_memory_allocated() / 2**20 - held[0],
            torch.cuda.max_memory_reserved() / 2**20 - held[1])


def _fresh_peaks() -> tuple[float, float]:
    """Collect garbage, empty the allocator's cache and reset the peaks;
    returns the (allocated, reserved) MiB held then."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return (torch.cuda.memory_allocated() / 2**20,
            torch.cuda.memory_reserved() / 2**20)


def _equal_out(got, want) -> bool:
    """Every tensor of two (u, stats) results equal to the bit."""
    (u, stats), (u_w, stats_w) = got, want
    return (torch.equal(u, u_w) and set(stats) == set(stats_w)
            and all(torch.equal(stats[k], stats_w[k]) for k in stats_w))


def _in_turns(eager, compiled, rounds: int) -> tuple[list, list]:
    """Walls of `eager` and `compiled` in turns (eager, compiled,
    compiled, eager), `rounds` times, each ending in a synchronize."""
    walls = {eager: [], compiled: []}
    for _ in range(rounds):
        for fn in (eager, compiled, compiled, eager):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[fn].append(time.perf_counter() - t0)
    return walls[eager], walls[compiled]


def _graph_ms(program) -> float:
    """The card's time for one replay of a program's graph alone, by CUDA
    events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    program.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _compare_compiled(tag, owner, compiled, eager, smi,
                      profile_eager=True) -> None:
    """Phase 17 (b): a configuration captured against its eager run:
    launch counts and every output equal to the bit, capture seconds,
    nodes, walls in turns, busy and idle of both, peak MiB of both.
    `owner` is the model whose `programs` capture; `compiled()` and
    `eager()` return the same (u, stats)."""
    from hpcclassmultigridproject_tpu_torch.ops import cuda

    t_start = time.perf_counter()
    eager()
    held = _fresh_peaks()
    cuda.reset_launches()
    want = eager()
    torch.cuda.synchronize()
    want_counts = dict(cuda.LAUNCHES)
    peak_e = _peak_mib(held)
    held_c = _fresh_peaks()
    t0 = time.perf_counter()
    compiled()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak_c = _peak_mib(held_c)
    program = owner.programs.last
    require(owner.last_run_compiled and program is not None,
            f"compiled {tag}: the call was not compiled "
            f"({owner.last_run_reason})")
    cuda.reset_launches()
    got = compiled()
    torch.cuda.synchronize()
    counts = dict(cuda.LAUNCHES)
    require(counts == want_counts, f"compiled {tag}: replay launch counts "
            f"{counts}, eager {want_counts}")
    require(_equal_out(got, want), f"compiled {tag}: the replay's outputs "
            "are not the eager run's to the bit")
    walls_e, walls_c = _in_turns(eager, compiled, 1)
    _, busy_c, calls_c, _ = _profiled_run(compiled)
    busy_e = _profiled_run(eager)[1] if profile_eager else None
    med_e, med_c = statistics.median(walls_e), statistics.median(walls_c)
    idle_e = ("not measured" if busy_e is None
              else f"{1 - busy_e / 1e3 / med_e:.1%}")
    print(f"[compiled] (b) {tag} ({smi}): replay equal to eager to the bit, "
          f"launches {({k: v for k, v in counts.items() if v})} in both; "
          f"capture {program.seconds:.3f} s (first call {first:.3f} s), "
          f"{program.nodes} graph nodes; wall in turns (median of "
          f"{len(walls_c)}) captured {med_c:.5f} s, eager {med_e:.5f} s "
          f"({med_e / med_c:.2f}x); busy captured {busy_c:.2f} ms (idle "
          f"{1 - busy_c / 1e3 / med_c:.1%}, {calls_c} launch calls), eager "
          f"{'not measured' if busy_e is None else f'{busy_e:.2f} ms'} "
          f"(idle {idle_e}); peak MiB allocated / reserved above what each "
          f"call found held: eager {peak_e[0]:.1f} / {peak_e[1]:.1f}, the "
          f"capturing call {peak_c[0]:.1f} / {peak_c[1]:.1f} (held before "
          f"it {held_c[0]:.1f} / {held_c[1]:.1f}); checked in {time.perf_counter() - t_start:.1f} "
          "s")


def _tower_captured(model) -> None:
    """Phase 17 (a): the tower alone (K3, the dense solve, K4; two
    cooperative launches) captured from level 1 and replayed, against its
    eager call, to the bit."""
    from hpcclassmultigridproject_tpu_torch.core.layout import interior_mask
    from hpcclassmultigridproject_tpu_torch.ops.cuda.tower import (
        tower_vcycle,
    )

    level = model.levels[1]
    gen = torch.Generator(device=model.device).manual_seed(17)
    rhs = torch.randn(level.padded, generator=gen, device=model.device)
    rhs = rhs * interior_mask(level.n, level.padded, dtype=rhs.dtype,
                              device=model.device)
    want = tower_vcycle(model.levels, 1, rhs, model.solver)
    static = rhs.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tower_vcycle(model.levels, 1, static, model.solver)
    graph.replay()
    torch.cuda.synchronize()
    print(f"[compiled] (a) the tower alone from level 1 (n={level.n}), "
          f"captured and replayed: equal to its eager call to the bit: "
          f"{torch.equal(got, want)}")
    require(torch.equal(got, want), "compiled (a): the captured tower is "
            "not its eager call")


def _compiled_main(device, n, steps, uT_main, counts_main, smi):
    """Phase 17 (a): the main path captured and replayed against its eager
    run (`timestepper` called directly), then (c)'s semantics on the same
    model.  Returns the model."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops import cuda

    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                               delta_config(certify_every=10), device=device)
    _tower_captured(model)
    compiled = lambda: model.run(warn=False)

    def eager():
        uT, stats = timestepper(model.levels, model.u0, steps, model.solver,
                                model.fine_hi)
        return model.crop(uT), stats

    eager()
    held = _fresh_peaks()
    cuda.reset_launches()
    want = eager()
    torch.cuda.synchronize()
    want_counts = dict(cuda.LAUNCHES)
    peak_e = _peak_mib(held)
    require(want_counts == counts_main, f"compiled (a): eager launch counts "
            f"{want_counts}, phase 4's {counts_main}")
    require(torch.equal(want[0], uT_main),
            "compiled (a): the eager run's uT is not phase 4's")
    held_c = _fresh_peaks()
    t0 = time.perf_counter()
    compiled()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak_c = _peak_mib(held_c)
    program = model.programs.last
    require(model.last_run_compiled and program is not None,
            f"compiled (a): not compiled ({model.last_run_reason})")
    held_r = _fresh_peaks()
    replay_walls = []
    for k in range(COMPILED_REPLAYS):
        cuda.reset_launches()
        t0 = time.perf_counter()
        got = compiled()
        torch.cuda.synchronize()
        replay_walls.append(time.perf_counter() - t0)
        counts = dict(cuda.LAUNCHES)
        require(counts == want_counts, f"compiled (a): replay {k} launch "
                f"counts {counts}, eager {want_counts}")
        require(_equal_out(got, want), f"compiled (a): replay {k} is not "
                "the eager run to the bit")
    peak_r = _peak_mib(held_r)
    uT, stats = got
    _check_advection("compiled (a)", n, steps, uT, stats, CENTER_1024, True)
    walls_e, walls_c = [], []
    for _ in range(COMPILED_ROUNDS):
        e, c = _in_turns(eager, compiled, 1)
        walls_e += e
        walls_c += c
    wall_p, busy_c, calls_c, _ = _profiled_run(compiled)
    _, busy_e, calls_e, coop_e = _profiled_run(eager)
    graph_ms = statistics.median(_graph_ms(program) for _ in range(3))
    med_e, med_c = statistics.median(walls_e), statistics.median(walls_c)
    print(f"[compiled] (a) main n={n}, {steps} steps ({smi}): "
          f"{COMPILED_REPLAYS} replays, each with uT and every stats tensor "
          f"equal to the eager run's (phase 4's uT) to the bit and its "
          f"launch counts {({k: v for k, v in counts.items() if v})} equal "
          f"to eager's")
    print(f"[compiled] (a) capture (warm-up, capture, instantiation) "
          f"{program.seconds:.3f} s, first call {first:.3f} s; "
          f"{program.nodes} graph nodes; replay walls {replay_walls}")
    print(f"[compiled] (a) wall in turns (median of {len(walls_c)}): "
          f"captured {med_c:.5f} s {walls_c}, eager {med_e:.5f} s {walls_e}"
          f" ({med_e / med_c:.2f}x)")
    print(f"[compiled] (a) busy (torch.profiler over one call): captured "
          f"{busy_c:.2f} ms of a {wall_p:.4f} s profiled replay, "
          f"{calls_c} launch calls; eager {busy_e:.2f} ms, {calls_e} launch "
          f"calls ({coop_e} cooperative); the graph alone by CUDA events "
          f"{graph_ms:.3f} ms; idle captured {1 - busy_c / 1e3 / med_c:.1%}"
          f", eager {1 - busy_e / 1e3 / med_e:.1%} of the median walls")
    print(f"[compiled] (a) peak MiB allocated / reserved above what each "
          f"found held: eager run {peak_e[0]:.1f} / {peak_e[1]:.1f} "
          f"(PERF.md's eager phase 4: 217.3 allocated; held "
          f"{held[0]:.1f} / {held[1]:.1f}), the capturing call "
          f"{peak_c[0]:.1f} / {peak_c[1]:.1f} (held {held_c[0]:.1f} / "
          f"{held_c[1]:.1f}), replays {peak_r[0]:.1f} / {peak_r[1]:.1f} "
          f"(held {held_r[0]:.1f} / {held_r[1]:.1f}: the graph's pool)")
    return model


def _compiled_semantics(model, uT_main, smi) -> None:
    """Phase 17 (c): independent outputs of two runs, `step` and
    `run_chunk`, the checkpointed run, and every switch and the backend
    flipped between calls."""
    import dataclasses

    from hpcclassmultigridproject_tpu_torch.mg import cycle, delta
    from hpcclassmultigridproject_tpu_torch.mg.timestepper import (
        timestep,
        timestepper,
    )
    from hpcclassmultigridproject_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        run_with_checkpoints,
    )

    steps = model.problem.num_steps
    eager = lambda u, k: timestepper(model.levels, u, k, model.solver,
                                     model.fine_hi)
    u_a, u_b = model.u0, model.u0 * 0.5
    got_a = model.run(u_a, warn=False)
    got_b = model.run(u_b, warn=False)
    crop = lambda out: (model.crop(out[0]), out[1])
    require(_equal_out(got_a, crop(eager(u_a, steps)))
            and _equal_out(got_b, crop(eager(u_b, steps)))
            and got_a[0].data_ptr() != got_b[0].data_ptr()
            and torch.equal(got_a[0], uT_main),
            "compiled (c): two runs from different u0 are not independent")
    got = model.step(model.u0)
    want = timestep(model.levels, model.u0, model.solver, model.fine_hi)
    require(model.last_run_compiled and _equal_out(got, want),
            "compiled (c): step is not the eager step")
    got = model.run_chunk(model.u0, 10)
    require(model.last_run_compiled and _equal_out(got, eager(model.u0, 10)),
            "compiled (c): run_chunk(10) is not eager's")
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, model.problem)
        uT_ck, done = run_with_checkpoints(model, mgr, every=10)
    u = model.u0
    for _ in range(steps // 10):
        u, _ = eager(u, 10)
    du = float((uT_ck - uT_main).abs().max())
    require(done == steps and torch.equal(uT_ck, model.crop(u)),
            "compiled (c): the checkpointed run is not the eager chunks'")
    require(du <= 1e-9, f"compiled (c): the checkpointed run is off run's "
            f"uT by {du:.3g}")
    print("[compiled] (c) two runs from different u0: independent tensors, "
          "each its eager run's to the bit; step and run_chunk(10) equal "
          "eager's; run_with_checkpoints(every=10) equal to its eager chunks"
          f" to the bit and within {du!r} of run's uT (the delta form "
          "splits (hi, lo) anew at each chunk, eager too)")
    modules = {"cycle": cycle, "delta": delta}
    captured = len(model.programs)
    for mod, switch in ROUTE_SWITCHES + (("delta", "_FUSE_OPEN_SMOOTH"),):
        module = modules[mod]
        old = getattr(module, switch)
        try:
            setattr(module, switch, not old)
            got = model.run(warn=False)
            want = crop(eager(model.u0, steps))
        finally:
            setattr(module, switch, old)
        require(_equal_out(got, want) and torch.equal(got[0], uT_main),
                f"compiled (c): {switch} flipped: not the flipped route's "
                "eager uT")
    solver = model.solver
    try:
        model.solver = dataclasses.replace(solver, backend="jnp")
        got = model.run(warn=False)
        want = crop(eager(model.u0, steps))
    finally:
        model.solver = solver
    require(_equal_out(got, want), "compiled (c): backend flipped to jnp: "
            "not its eager run")
    back = model.run(warn=False)
    require(torch.equal(back[0], uT_main)
            and len(model.programs) == captured + 6,
            "compiled (c): flipping back did not replay the cached program")
    print(f"[compiled] (c) each of the five switches and backend='jnp' "
          f"flipped between calls: the flipped route's eager uT to the bit "
          f"(a program of its own: {len(model.programs)} captured), and the "
          f"default's replayed again on flipping back ({smi})")


def _compiled_configs(device, n, steps, smi) -> None:
    """Phase 17 (b): every other captured configuration against its eager
    run, at the path phases' sizes."""
    import dataclasses
    import gc

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch.mg import cycle, delta
    from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper
    from hpcclassmultigridproject_tpu_torch.models import (
        AdvectionDiffusion,
        Poisson,
    )

    def advection(solver, steps=steps):
        return AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                                  solver, device=device)

    def run_pair(model):
        def eager():
            uT, stats = timestepper(model.levels, model.u0,
                                    model.problem.num_steps, model.solver,
                                    model.fine_hi)
            return model.crop(uT), stats
        return lambda: model.run(warn=False), eager

    fixed = SolverConfig(dtype=torch.float32, tol=TOL, cycle_mode="fixed",
                         num_cycles=1, coarse_mode="dense")
    main = advection(delta_config(certify_every=10))
    modules = {"cycle": cycle, "delta": delta}
    for mod, switch, value in ((("delta", "_FUSE_OPEN_SMOOTH", True),)
                               + tuple((m, s, False)
                                       for m, s in ROUTE_SWITCHES)):
        module = modules[mod]
        old = getattr(module, switch)
        try:
            setattr(module, switch, value)
            _compare_compiled(f"main, {switch} {value}", main,
                              *run_pair(main), smi)
        finally:
            setattr(module, switch, old)
    main = None
    # (tag, solver, steps): Jacobi and Chebyshev, plain torch, launch
    # 10-40x more than the kernels a step, and run 10 steps
    cases = [
        ("galerkin (delta, K6)", delta_config(certify_every=10,
                                              coarse_operator="galerkin"),
         steps),
        ("refined fused", dataclasses.replace(
            fixed, refine_dtype=torch.float64), steps),
        ("mg_solve_fixed", fixed, steps),
        ("mg_solve_fixed galerkin (K6)", dataclasses.replace(
            fixed, coarse_operator="galerkin", restriction="full"), steps),
        ("fmg_solve dense", dataclasses.replace(fixed, cycle_mode="fmg"),
         steps),
        ("jacobi fixed", dataclasses.replace(fixed, smoother="jacobi",
                                             jacobi_omega=0.8), 10),
        ("chebyshev fixed", dataclasses.replace(fixed,
                                                smoother="chebyshev"), 10),
        ('backend="jnp"', delta_config(certify_every=10, backend="jnp"),
         steps),
    ]
    for tag, solver, k in cases:
        model = advection(solver, k)
        _compare_compiled(f"{tag}, {k} steps", model, *run_pair(model), smi,
                          profile_eager=solver.backend != "jnp")
        model = None
        gc.collect()
    from hpcclassmultigridproject_tpu_torch.mg.cycle import (
        fmg_solve,
        mg_solve_fixed,
    )
    for tag, dtype, mode, cycles in (("f64 fixed", torch.float64, "fixed", 7),
                                     ("f64 fmg", torch.float64, "fmg", 2),
                                     ("f32 fixed", torch.float32, "fixed",
                                      50)):
        solver = SolverConfig(dtype=dtype, tol=1e-10, restriction="full",
                              coarse_mode="dense", cycle_mode=mode,
                              num_cycles=cycles)
        model = Poisson(n=n, solver=solver, device=device)
        solve = mg_solve_fixed if mode == "fixed" else fmg_solve

        def eager(model=model, solve=solve):
            u, stats = solve(model.levels, torch.zeros_like(model.rhs),
                             model.rhs, model.solver)
            return u[:n + 1, :n + 1], stats

        _compare_compiled(f"poisson {tag} (K5)", model,
                          lambda model=model: model.solve(), eager, smi)
        model = None
        gc.collect()


def _compiled_big(device, big, smi) -> None:
    """Phase 17 (d): n=16384, BIG_STEPS steps at phase 13's cycle count,
    eager and then captured, each uT phase 13's to the bit."""
    import dataclasses
    import warnings

    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    cycles, fingerprint = big
    solver = dataclasses.replace(delta_config(certify_every=10),
                                 num_cycles=cycles)
    before = _fresh_peaks()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = AdvectionDiffusion(ProblemConfig(n=BIG_N,
                                                 num_steps=BIG_STEPS),
                                   solver, device=device)
    held = torch.cuda.memory_allocated() / 2**20 - before[0]
    t0 = time.perf_counter()
    uT, stats = timestepper(model.levels, model.u0, BIG_STEPS, model.solver,
                            model.fine_hi)
    torch.cuda.synchronize()
    wall_e = time.perf_counter() - t0
    same_e = _fingerprint(model.crop(uT))["sha256"] == fingerprint["sha256"]
    uT = stats = None
    peak_e = _peak_mib(before)
    _fresh_peaks()
    t0 = time.perf_counter()
    uT, stats = model.run(warn=False)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak_c = _peak_mib(before)
    program = model.programs.last
    ok, rel, mid, final = _certified(stats)
    same_c = _fingerprint(uT)["sha256"] == fingerprint["sha256"]
    uT = stats = None
    t0 = time.perf_counter()
    model.run(warn=False)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    print(f"[compiled] (d) n={BIG_N}, {BIG_STEPS} steps, {cycles} cycles "
          f"({smi}): uT equal to phase 13's to the bit: eager {same_e}, "
          f"captured {same_c}; certificates f32 {rel:.3e} / f64 mid-run "
          f"{mid:.3e} / final {final:.3e}; capture {program.seconds:.3f} s "
          f"(first call {first:.3f} s), {program.nodes} nodes; walls eager "
          f"{wall_e:.3f} s (first eager run), replay {wall_r:.3f} s; peak "
          f"MiB allocated / reserved, the model's included: eager "
          f"{peak_e[0]:.1f} / {peak_e[1]:.1f}, the capturing call "
          f"{peak_c[0]:.1f} / {peak_c[1]:.1f} (PERF.md's eager phase 13: "
          f"41073.2 allocated), {held:.1f} held by the model; "
          f"{before[0]:.1f} / {before[1]:.1f} held before the build")
    require(same_e and same_c and ok, f"compiled (d): n={BIG_N} uT off "
            "phase 13's, or not certified")


def phase_compiled(device, n, steps, uT_main, counts_main, big) -> None:
    """Phase 17: the compiled run (module docstring).  Frees its models
    and graphs and empties the allocator's cache at the end: phase 16's
    rank 0 takes cuda:0."""
    import gc

    smi = _smi()
    model = _compiled_main(device, n, steps, uT_main, counts_main, smi)
    _compiled_semantics(model, uT_main, smi)
    model = None
    gc.collect()
    _compiled_configs(device, n, steps, smi)
    _compiled_big(device, big, smi)
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); nothing was run")
    import hpcclassmultigridproject_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = phase_device()
    phase_build()
    measured = phase_kernels(device, MAIN_N)
    counts, uT_main = phase_main_path(device, MAIN_N, MAIN_STEPS, CENTER_1024)
    main_counts = dict(counts)
    phase_golden(device)
    counts["smooth9"] = phase_galerkin(device, MAIN_N, MAIN_STEPS)["smooth9"]
    counts["smooth5"] = phase_poisson(device, MAIN_N)["smooth5"]
    phase_refined(device, MAIN_N, MAIN_STEPS)
    counts["smooth_rows"] = phase_distributed(MAIN_N, MAIN_STEPS, uT_main)
    counts["open_presmooth"] = phase_open_smooth(
        device, MAIN_N, MAIN_STEPS, uT_main)["open_presmooth"]
    phase_cli(MAIN_N, MAIN_STEPS)
    probes = phase_probe()
    big = phase_device_build(device, MAIN_N, MAIN_STEPS, uT_main,
                             main_counts)
    phase_grid(MAIN_N, MAIN_STEPS, uT_main)
    phase_routes_oracle(device, MAIN_N, MAIN_STEPS, uT_main)
    phase_compiled(device, MAIN_N, MAIN_STEPS, uT_main, main_counts, big)
    phase_multi_gpu(MAIN_N, MAIN_STEPS, uT_main, big)
    kernels = []
    for key, label, source, replaces in KERNELS:
        if key in probes:
            err, ms, plain_ms, bound, bound_by, library, launches = probes[key]
        else:
            err, ms, plain_ms, bound, bound_by = measured[key]
            library, launches = None, counts[key]
        kernels.append({"name": label, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
