"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for the
H100; the kernels are built for sm_90a).

    python3 chip_smoke.py

Run from the repository root.  Phases, each printing its results and each
raising on failure:

1. device: the card's name, the device count, and nvidia-smi's name and
   power limit;
2. build: nvcc builds every kernel of the port from csrc/;
3. kernels: each kernel (K1 opening, K2 smoother in both flag sets of the
   main path, K3/K4 tower) against its plain PyTorch version on the card, at
   the main path's shapes, in float32 (within 4 ulp of the field's max-abs)
   and float64 (within 1e-13), with kernel and plain times;
4. main path: the n=1024, 100-step delta-form run through
   AdvectionDiffusion, with every certificate <= 1e-6, the center value,
   the launch count of every kernel, and the same run through the plain
   versions on the card;
5. golden: the n=256 delta-form run against tests/golden/uT_n256.npy.

The last two lines are a JSON object with the kernels' numbers, then
{"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "hpcclassmultigridproject_tpu_torch"
TPU = "hpcclassmultigridproject_tpu/ops/pallas"
KERNELS = [  # (counter, name, source, the TPU kernel's pallas_call)
    ("delta_open", "K1 delta opening", f"{PKG}/csrc/delta_step.cu",
     f"{TPU}/delta_step.py:131"),
    ("smooth", "K2 red-black smoother", f"{PKG}/csrc/smoother.cu",
     f"{TPU}/smoother.py:437"),
    ("tower_descent", "K3 tower descent", f"{PKG}/csrc/tower.cu",
     f"{TPU}/tower.py:326"),
    ("tower_ascent", "K4 tower ascent", f"{PKG}/csrc/tower.cu",
     f"{TPU}/tower.py:349"),
]
MAIN_N, MAIN_STEPS = 1024, 100
CENTER_1024 = 4.60419316843316e-5  # delta form at n=1024 (BENCH_r05.json)
TOL = 1e-6


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def delta_config(**kw):
    from hpcclassmultigridproject_tpu_torch import SolverConfig

    return SolverConfig(dtype=torch.float32, refine_dtype=torch.float64,
                        tol=TOL, cycle_mode="fixed", num_cycles=1,
                        coarse_mode="dense", delta_form=True, **kw)


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` in ms, by CUDA events around `reps` calls
    after one warm-up call."""
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
        if "Compiling entry" in line or "Used" in line:
            print(f"[build]   {line.strip()}")


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


def phase_kernels(device, n: int) -> dict:
    """Each kernel against its plain version at the main path's shapes for
    n, in float64 then float32; returns {counter: (max-abs difference,
    kernel ms, plain ms)} of the float32 run, the main path's dtype."""
    from hpcclassmultigridproject_tpu_torch.mg.cycle import coarse_solve_dense
    from hpcclassmultigridproject_tpu_torch.mg.levels import build_hierarchy
    from hpcclassmultigridproject_tpu_torch.ops.cuda import (
        delta_step,
        smoother,
        tower,
    )

    out = {}
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(2024)
        vel = np.random.default_rng(7).standard_normal((2, n + 1, n + 1))
        levels = build_hierarchy(
            vel[0], vel[1], 0.1 / n, -4e-4,
            delta_config().resolved_num_levels(n), dtype=dtype,
            device=device)
        fine = levels[0]
        f = lambda scale=1.0, lvl=0: _field(
            rng, levels[lvl].padded, levels[lvl].n, dtype, device, scale)
        hi, lo, d = f(), f(1e-8), f(1e-2)
        u, corr, rhs = f(), f(1e-2), f()
        rhs1 = f(lvl=1)
        u_mids, rhs_mids, bottom = tower.tower_descend_plain(levels, 1, rhs1, 3)
        v = coarse_solve_dense(levels[-1], bottom)
        cases = {  # name: (kernel, plain version, shape of the input)
            "delta_open": (
                lambda: delta_step.fused_accumulate_open(fine, hi, lo, d),
                lambda: delta_step.fused_accumulate_open_plain(fine, hi, lo, d),
                fine.padded),
            "smooth pre (zero_init, res_rows_dec)": (
                lambda: smoother.fused_rb_sweeps(
                    fine, None, rhs, 3, True, zero_init=True,
                    residual_rows_decimated=True),
                lambda: smoother.fused_rb_sweeps_plain(
                    fine, None, rhs, 3, True, zero_init=True,
                    residual_rows_decimated=True),
                fine.padded),
            "smooth post (corr, residual)": (
                lambda: smoother.fused_rb_sweeps(fine, u, rhs, 3, True,
                                                 corr=corr),
                lambda: smoother.fused_rb_sweeps_plain(fine, u, rhs, 3, True,
                                                       corr=corr),
                fine.padded),
            "tower_descent": (
                lambda: tower.tower_descend(levels, 1, rhs1, 3),
                lambda: tower.tower_descend_plain(levels, 1, rhs1, 3),
                levels[1].padded),
            "tower_ascent": (
                lambda: tower.tower_ascend(levels, 1, v, u_mids, rhs_mids, 3),
                lambda: tower.tower_ascend_plain(levels, 1, v, u_mids,
                                                 rhs_mids, 3),
                levels[1].padded),
        }
        for name, (kern, plain, shape) in cases.items():
            got, want = _flatten(kern()), _flatten(plain())
            torch.cuda.synchronize()
            err, bound, exact = _compare(name, got, want, dtype)
            line = (f"[kernels] {name} {str(dtype)[6:]} at {shape}: "
                    f"max|kernel - plain| {err:.3g} (bound {bound:.3g}), "
                    f"bit-identical {exact}")
            if dtype == torch.float32:
                ms = time_ms(kern, 200)
                plain_ms = time_ms(plain, 20)
                line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                out[name] = (err, ms, plain_ms)
            print(line)
    pre, post = out.pop("smooth pre (zero_init, res_rows_dec)"), out.pop(
        "smooth post (corr, residual)")
    out["smooth"] = (max(pre[0], post[0]), (pre[1] + post[1]) / 2,
                     (pre[2] + post[2]) / 2)
    return out


def phase_main_path(device, n: int, steps: int, center_ref: float):
    """The main path through AdvectionDiffusion; returns the launch counts
    of one run."""
    from hpcclassmultigridproject_tpu_torch import ProblemConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion
    from hpcclassmultigridproject_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    model = AdvectionDiffusion(ProblemConfig(n=n, num_steps=steps),
                               delta_config(certify_every=10),
                               device=device)
    print(f"[main] n={n}, {steps} steps, {model.num_levels} levels, model "
          f"built in {time.perf_counter() - t0:.2f} s")

    def run():
        uT, stats = model.run(warn=False)
        torch.cuda.synchronize()
        return uT, stats

    run()  # warm-up
    cuda.reset_launches()
    uT, stats = run()
    counts = dict(cuda.LAUNCHES)
    want = {"delta_open": steps, "smooth": 2 * steps, "tower_descent": steps,
            "tower_ascent": steps}
    print(f"[main] launches in one run: {counts}")
    require(counts == want, f"launch counts {counts}, expected {want}")

    require(tuple(uT.shape) == (n + 1, n + 1), f"uT shape {tuple(uT.shape)}")
    require(bool(torch.isfinite(uT).all()), "uT not finite")
    rel = stats["rel_residual"].cpu().numpy()
    hi = stats["rel_residual_hi_steps"].cpu().numpy()
    final = float(stats["final_rel_residual_hi"])
    certified = hi[hi >= 0]
    center = model.center_value(uT)
    print(f"[main] f32 step certificates: {rel.size}, max {rel.max():.3e}; "
          f"f64 mid-run certificates: {certified.size}, max "
          f"{certified.max():.3e}; final f64 certificate {final:.3e}")
    print(f"[main] center uT {center!r} (reference {center_ref!r}, "
          f"|diff| {abs(center - center_ref):.3g})")
    require(rel.size == steps and bool((rel <= TOL).all()),
            "an f32 step certificate exceeds 1e-6")
    require(certified.size == steps // 10 and bool((certified <= TOL).all()),
            "a mid-run f64 certificate is missing or exceeds 1e-6")
    require(final <= TOL, f"final f64 certificate {final:.3e} > 1e-6")
    require(abs(center - center_ref) <= 1e-9, "center value off by > 1e-9")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    run()
    peak = torch.cuda.max_memory_allocated()

    with cuda.plain_route():
        uT_plain, _ = run()  # warm-up
        plain_walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            uT_plain, _ = run()
            plain_walls.append(time.perf_counter() - t0)
    du = (uT - uT_plain).abs().max().item()
    print(f"[main] wall per run (median of 3): kernels "
          f"{statistics.median(walls):.4f} s {walls}, plain "
          f"{statistics.median(plain_walls):.4f} s {plain_walls}; peak "
          f"device memory {peak / 2**20:.1f} MiB")
    print(f"[main] max|uT(kernels) - uT(plain)| {du:.3g}")
    require(du <= 1e-8, f"kernel path and plain path differ by {du:.3g}")
    return counts


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
    counts = phase_main_path(device, MAIN_N, MAIN_STEPS, CENTER_1024)
    phase_golden(device)
    kernels = []
    for key, label, source, replaces in KERNELS:
        err, ms, plain_ms = measured[key]
        kernels.append({"name": label, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[key],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
