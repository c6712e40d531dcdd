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
   main path, K3/K4 tower, K5 five-band and K6 nine-band smoothers in the
   flag sets of their paths, K7 on every shape the distributed path's
   two schedules launch at W=4, K8 whole-step opening in both residual
   modes) against its plain PyTorch version on the card, at the paths'
   shapes, in float32 (within 4 ulp of the field's max-abs) and float64
   (within 1e-13), with kernel and plain times and the bound of the byte
   and operation model (utils/profiling.py); K2 also in all six of its
   flag sets on every level of the n=1024 hierarchy and at nsweeps 1 on
   the gsbench level (2056x2176), with misaligned arrays and at nsweeps
   20, K7 in all four of its on its 40 shapes, each bit-identical to its
   plain version; K3 and K4 (one cooperative launch each) bit-identical
   from level 1 and level 3 of n=1024 and level 1 of n=256 at nsweeps 1, 3
   and 14, each called 20 times with every result equal to the first, with
   the grid each launch chose; the four K7 blocks of level
   0, stitched, against K2 on the whole field; and K8 against K1 then K2;
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
    center, uT against phase 4's, and both paths' walls in turns;
11. cli: the port's CLI in subprocesses: the main configuration's `run`,
    the same checkpointed (its chunks' stats stitched: converged, every
    certificate <= 1e-6), `gsbench` at n=2048 with both backends, and
    `profile` of the main configuration;
12. probe: P's six kernels (ops/cuda/probe.py) against the JAX probe
    script's checks and bit for bit against their plain versions; the
    product kernel on dense operands (the three probe shapes, an unaligned
    one, two staging passes) bit for bit against its fixed order repeated
    in PyTorch and within k 2^-24 (|a| @ |b|) of the float64 product;
    flatten into a buffer of its own (no alias of x); with the library
    call's time beside each (torch.matmul for the products, a copy for
    flatten).

Each path phase (4, 6, 7, 8, 9, 10) resets the launch counts just before
the run it reads, checks every count, and runs the same path once more
through the plain versions.

The last two lines are a JSON object with the kernels' numbers (launches
on their path, max difference, kernel, plain and bound ms, and the time of
one PyTorch call computing the same function where there is one), then
{"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
TOWER_SWEEPS, TOWER_REPEATS = (1, 3, 14), 20  # 14: a chain of two links
# the host calls that launch a kernel, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaLaunchCooperativeKernelExC", "cuLaunchCooperativeKernel")
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


def _smooth_cases(tag, level, f, lvl):
    """K5 or K6 on `level` in the flag sets of its paths: {name: (kernel,
    plain version, shape, (bytes, flops))}."""
    from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother
    from hpcclassmultigridproject_tpu_torch.utils import profiling

    u, corr, rhs = f(lvl=lvl), f(1e-2, lvl), f(lvl=lvl)
    flag_sets = {
        "zero_init, residual": dict(want_residual=True, zero_init=True),
        "zero_init, res_rows_dec": dict(want_residual=True, zero_init=True,
                                        residual_rows_decimated=True),
        "corr": dict(corr=corr),
        "u, residual": dict(want_residual=True),
    }
    itemsize = rhs.element_size()
    return {f"{tag} ({name})": (
        lambda kw=kw: smoother.fused_rb_sweeps(level, u, rhs, 3, **kw),
        lambda kw=kw: smoother.fused_rb_sweeps_plain(level, u, rhs, 3, **kw),
        level.padded,
        profiling.smooth_cost(
            level, itemsize, 3, read_u=not kw.get("zero_init", False),
            corr="corr" in kw, want_residual=kw.get("want_residual", False),
            res_dec=kw.get("residual_rows_decimated", False)))
        for name, kw in flag_sets.items()}


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

    def one_off(x):
        """x in a buffer that starts one value before it."""
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(x.shape)

    lvl = len(levels) - 2
    level = levels[lvl]
    u, corr, rhs = f(1.0, lvl), f(1e-2, lvl), f(1.0, lvl)
    for name, ns, args in (
            ("arrays one value off alignment", 3,
             (one_off(u), one_off(rhs), dict(corr=one_off(corr)))),
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


def _k8_against_k1_k2(fine, hi, lo, d, dtype) -> None:
    """K8 against K1 followed by K2 from zero (both on the card), in both
    residual modes: the same expressions in the same order, so bit-identity
    is expected, and reported."""
    from hpcclassmultigridproject_tpu_torch.ops.cuda import (
        delta_step,
        smoother,
    )

    for dec in (True, False):
        got = delta_step.fused_open_presmooth(fine, hi, lo, d, 3, dec)
        hi2, lo2, rhs = delta_step.fused_accumulate_open(fine, hi, lo, d)
        u1, r0 = smoother.fused_rb_sweeps(fine, None, rhs, 3, True,
                                          zero_init=True,
                                          residual_rows_decimated=dec)
        torch.cuda.synchronize()
        mode = "res_rows_dec" if dec else "full residual"
        err, bound, exact = _compare(f"K8 vs K1, K2 ({mode})", got,
                                     (hi2, lo2, rhs, u1, r0), dtype)
        print(f"[kernels] open_presmooth ({mode}) {str(dtype)[6:]} against "
              f"K1 then K2 on the card: max|K8 - (K1, K2)| {err:.3g} "
              f"(bound {bound:.3g}), bit-identical {exact}")


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
            vel[0], vel[1], 0.1 / n, -4e-4, 2, dtype=dtype, device=device,
            coarse_operator="galerkin")[1]
        poisson = build_poisson_hierarchy(n, 1, dtype=dtype, device=device)[0]
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
            **_smooth_cases("smooth5", poisson, f, 0),
            **_smooth_cases("smooth9", galerkin, f, 1),
        }
        # K7 timed in the distributed path's flag sets; K2 and K7 checked
        # in all of theirs, and K2 on every level and the gsbench level
        gv1, gv2 = rotating_velocity(GSBENCH_N, dtype=dtype, device="cpu")
        gs_level = build_fine_level(gv1, gv2, (1.0 / GSBENCH_N) / 10, -4e-4,
                                    dtype=dtype, device=device)
        checks = _from_v_checks(levels, f, gs_level, lambda scale: _field(
            rng, gs_level.padded, gs_level.n, dtype, device, scale))
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
        _k8_against_k1_k2(fine, hi, lo, d, dtype)
        exact_from_v, exact_tower = [], []
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
    merged = {}
    for name, numbers in out.items():
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
    as the JAX package's does."""
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
            counts = got
        else:
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
    return out


def _collective_costs(model, reps: int = 100) -> dict:
    """Mean ms per call of each collective of the distributed path, with
    no kernel between the calls, at the path's shapes: the deep-halo
    exchange of (u, rhs) at level 0, the one-row exchange, the norm's
    all_sum, and the agglomeration's all-gather into level 3."""
    import torch.distributed as dist

    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed,
        level_shardings,
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
    nccl = launch_local(_nccl_rank, 1, (n, NCCL_STEPS), backend="nccl",
                        device="cuda:0")
    print(f"[distributed] one NCCL rank ({nccl['backend']}, world "
          f"{nccl['world']}): {NCCL_STEPS} steps, max|uT_dist - "
          f"uT_single| {nccl['max_diff']!r} (expected 0); all_gather_rows "
          f"and all_sum on device tensors right: {nccl['collectives_ok']}")
    require(nccl["backend"] == "nccl" and nccl["max_diff"] == 0.0
            and nccl["collectives_ok"], "the one-rank NCCL run")
    return res["plain"]["counts"]["smooth_rows"]


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
        print(f"[open-smooth] max|uT - uT(main path)| {du!r} (bound 1e-9, "
              "0 expected)")
        require(du <= 1e-9, f"open-smooth: uT off the main path's by {du:.3g}")
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


def phase_probe() -> dict:
    """P's six kernels once each between a reset and a read of the launch
    counts, held to the JAX probe script's checks and bit for bit to their
    plain versions (the products: each output one product or one rounding
    of a sum of two exact products, the same in any order); then the
    product kernel on dense operands and flatten's copy; then timed.
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
    phase_golden(device)
    counts["smooth9"] = phase_galerkin(device, MAIN_N, MAIN_STEPS)["smooth9"]
    counts["smooth5"] = phase_poisson(device, MAIN_N)["smooth5"]
    phase_refined(device, MAIN_N, MAIN_STEPS)
    counts["smooth_rows"] = phase_distributed(MAIN_N, MAIN_STEPS, uT_main)
    counts["open_presmooth"] = phase_open_smooth(
        device, MAIN_N, MAIN_STEPS, uT_main)["open_presmooth"]
    phase_cli(MAIN_N, MAIN_STEPS)
    probes = phase_probe()
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
