"""K1, K2, K7, K3, K4, K5, K6 and K8 of two trees of the PyTorch/CUDA port,
and the main, open-smooth, Galerkin and Poisson paths, timed in turns on
one card.

    python3 scripts/torch_smooth_turns.py --parent DIR [--order pccp]

DIR holds a copy of another commit of the repository (for example the
parent, unpacked with `git archive`).  Each turn is a fresh process that
imports `hpcclassmultigridproject_tpu_torch` from one tree (`p`: DIR, `c`:
this checkout), builds that tree's kernels, and prints one JSON line with
the card's time per call (`utils.timing.device_ms`, float32):

- K2 pre-smooth (zero_init, res_rows_dec) and post-smooth (corr, residual)
  at n=1024 (1032x1152), nsweeps 3, the main path's two calls;
- K1 (the opening) there, K1 then K2 pre-smooth as one timed call (the
  main path's opening, `k1_k2pre_ms`), and K8 (the whole-step opening,
  nsweeps 3) with the row-decimated and with the full residual;
- K7: the mean over the 40 block shapes and residual flag sets of the
  distributed path at W=4 (chip_smoke.py's cases);
- K2 at nsweeps 1 on the gsbench level, n=2048 (2056x2176);
- K3 (tower descent) and K4 (tower ascent) from level 1 of n=1024
  (levels 512 .. 64 onto the dense 32), nsweeps 3, the main path's calls;
- K5 at each smoothed level of the Poisson path (n=1024: 1032x1152 ..
  72x128, `k5_l0_ms` .. `k5_l4_ms`) and K6 at each nine-band level of the
  Galerkin path (520x640 .. 72x128, `k6_l1_ms` .. `k6_l4_ms`), nsweeps 3:
  the mean of the level's pre- and post-smooth calls, each launched once a
  cycle or step (chip_smoke.py's `_band_cases` and `_path_flags`);
- the CLI's `gsbench --n 2048 --sweeps 500 --backend pallas`, µs a sweep
  as the host issues it;
- the main path (AdvectionDiffusion, n=1024, 100 delta-form steps): the
  SHA-256 of its uT's bytes, its wall (host clock to a synchronize, median
  of 3 after a warm-up), and the kernel launch calls of one run under
  torch.profiler (chip_smoke.py's `_profiled_run`, cooperative launches
  counted);
- the same for the open-smooth path (the main path with
  `mg.delta._FUSE_OPEN_SMOOTH` on: K8 opens each step), the Galerkin path
  (the main path with Galerkin coarse levels, K6), the Poisson float32
  default (n=1024, 50 cycles, K5) and Poisson in float64 to tol 1e-10 (7
  cycles, K5).

Then a summary: per tree, the median of its turns, and whether every
turn's output of each path is the same to the bit.  The order defaults to
parent, change, change, parent, so drift of the card or the host shows.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("k2_pre_ms", "k2_post_ms", "k1_ms", "k1_k2pre_ms", "k8_dec_ms",
        "k8_full_ms", "k7_mean_ms", "k2_gs2048_ms",
        "gsbench_us_per_sweep", "k3_ms", "k4_ms",
        *(f"k5_l{lvl}_ms" for lvl in range(5)),
        *(f"k6_l{lvl}_ms" for lvl in range(1, 5)),
        *(f"{path}_{key}"
          for path in ("main", "open", "galerkin", "poisson32", "poisson64")
          for key in ("wall_s", "busy_ms", "launch_calls")))
HASHES = ("main_uT_sha256", "open_uT_sha256", "galerkin_uT_sha256",
          "poisson32_u_sha256", "poisson64_u_sha256")


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its helpers import the
    package lazily, so they use the tree first on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import hpcclassmultigridproject_tpu_torch as pkg
    from hpcclassmultigridproject_tpu_torch import (
        ProblemConfig,
        SolverConfig,
        cli,
    )
    from hpcclassmultigridproject_tpu_torch.core.problem import (
        rotating_velocity,
    )
    from hpcclassmultigridproject_tpu_torch.mg.levels import (
        build_fine_level,
        build_hierarchy,
    )
    from hpcclassmultigridproject_tpu_torch.mg import delta
    from hpcclassmultigridproject_tpu_torch.mg.cycle import coarse_solve_dense
    from hpcclassmultigridproject_tpu_torch.models import (
        AdvectionDiffusion,
        Poisson,
    )
    from hpcclassmultigridproject_tpu_torch.models.poisson import (
        build_poisson_hierarchy,
    )
    from hpcclassmultigridproject_tpu_torch.ops.cuda import (
        _build,
        delta_step,
        smoother,
        tower,
    )
    from hpcclassmultigridproject_tpu_torch.utils.timing import device_ms

    assert pathlib.Path(pkg.__file__).resolve().is_relative_to(
        pathlib.Path(root).resolve()), pkg.__file__
    smoke = _chip_smoke()
    _build.library()
    dev = torch.device("cuda", 0)
    n, dt = 1024, torch.float32
    rng = np.random.default_rng(2024)
    vel = np.random.default_rng(7).standard_normal((2, n + 1, n + 1))
    levels = build_hierarchy(
        vel[0], vel[1], 0.1 / n, -4e-4,
        smoke.delta_config().resolved_num_levels(n), dtype=dt, device=dev,
        coarse_mode="dense")
    fine = levels[0]
    f = lambda scale=1.0, lvl=0: smoke._field(
        rng, levels[lvl].padded, levels[lvl].n, dt, dev, scale)
    u, corr, rhs = f(), f(1e-2), f()
    out = {"root": root, "k2_pre_ms": device_ms(
        lambda: smoother.fused_rb_sweeps(fine, None, rhs, 3, True,
                                         zero_init=True,
                                         residual_rows_decimated=True), 200),
        "k2_post_ms": device_ms(
            lambda: smoother.fused_rb_sweeps(fine, u, rhs, 3, True,
                                             corr=corr), 200)}
    hi, lo, d = f(), f(1e-8), f(1e-2)

    def k1_k2pre():
        opened = delta_step.fused_accumulate_open(fine, hi, lo, d)
        return smoother.fused_rb_sweeps(fine, None, opened[2], 3, True,
                                        zero_init=True,
                                        residual_rows_decimated=True)

    out["k1_ms"] = device_ms(
        lambda: delta_step.fused_accumulate_open(fine, hi, lo, d), 200)
    out["k1_k2pre_ms"] = device_ms(k1_k2pre, 200)
    for key, dec in (("k8_dec_ms", True), ("k8_full_ms", False)):
        out[key] = device_ms(
            lambda dec=dec: delta_step.fused_open_presmooth(fine, hi, lo, d, 3,
                                                            dec), 200)
    rows = smoke._smooth_rows_cases(levels, f)
    out["k7_mean_ms"] = statistics.mean(
        device_ms(kern, 200) for name, (kern, *_) in rows.items()
        if "residual" in name)
    v1, v2 = rotating_velocity(2048, dtype=dt, device="cpu")
    gs = build_fine_level(v1, v2, (1.0 / 2048) / 10, -4e-4, dtype=dt,
                          device=dev)
    ones = torch.ones(gs.padded, dtype=dt, device=dev)
    zeros = torch.zeros_like(ones)
    out["k2_gs2048_ms"] = device_ms(
        lambda: smoother.fused_rb_sweeps(gs, ones, zeros, 1), 200)
    rhs1 = f(lvl=1)
    u_mids, rhs_mids, bottom = tower.tower_descend_plain(levels, 1, rhs1, 3)
    v = coarse_solve_dense(levels[-1], bottom)
    out["k3_ms"] = device_ms(
        lambda: tower.tower_descend(levels, 1, rhs1, 3), 200)
    out["k4_ms"] = device_ms(
        lambda: tower.tower_ascend(levels, 1, v, u_mids, rhs_mids, 3), 200)
    galerkin = build_hierarchy(
        vel[0], vel[1], 0.1 / n, -4e-4, len(levels), dtype=dt, device=dev,
        coarse_operator="galerkin")
    poisson = build_poisson_hierarchy(n, len(smoke.POISSON_LEVELS),
                                      dtype=dt, device=dev)
    for tag, key, hier, lvls in (
            ("smooth5", "k5", poisson, smoke.POISSON_LEVELS),
            ("smooth9", "k6", galerkin, smoke.GALERKIN_LEVELS)):
        cases = smoke._band_cases(tag, hier, f, lvls)
        for lvl in lvls:
            out[f"{key}_l{lvl}_ms"] = statistics.mean(
                device_ms(cases[f"{tag} (level {lvl}, {flags})"][0], 200)
                for flags in smoke._path_flags(tag, lvl))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["gsbench", "--n", "2048", "--sweeps", "500", "--backend",
                  "pallas"])
    out["gsbench_us_per_sweep"] = json.loads(
        buf.getvalue().splitlines()[-1])["us_per_sweep"]
    torch.backends.cuda.matmul.allow_tf32 = False
    for path, extra in (("main", {}),
                        ("galerkin", dict(coarse_operator="galerkin"))):
        model = AdvectionDiffusion(
            ProblemConfig(n=n, num_steps=100),
            smoke.delta_config(certify_every=10, **extra), device=dev)
        _path(out, path, "uT", lambda: model.run(warn=False)[0], smoke)
        if path == "main":
            delta._FUSE_OPEN_SMOOTH = True
            try:
                _path(out, "open", "uT", lambda: model.run(warn=False)[0],
                      smoke)
            finally:
                delta._FUSE_OPEN_SMOOTH = False
    f64 = SolverConfig(dtype=torch.float64, tol=1e-10, restriction="full",
                       coarse_mode="dense")
    for path, solver in (("poisson64", f64), ("poisson32",
                                              Poisson.DEFAULT_SOLVER)):
        model = Poisson(n=n, solver=solver, device=dev)
        _path(out, path, "u", lambda: model.solve()[0], smoke)
    return out


def _sha(x) -> str:
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()


def _path(out: dict, path: str, name: str, run, smoke) -> None:
    """One path's output SHA-256 (its first run), wall (median of 3 after
    it), and one profiled run's device busy ms and launch calls."""
    import torch

    out[f"{path}_{name}_sha256"] = _sha(run())
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out[f"{path}_wall_s"] = statistics.median(walls)
    _, busy_ms, launches, _ = smoke._profiled_run(run)
    out[f"{path}_launch_calls"] = launches
    out[f"{path}_busy_ms"] = busy_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return
    roots = {"p": str(pathlib.Path(args.parent).resolve()), "c": str(HERE)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[turns] card: {smi}; order {args.order}", flush=True)
    runs = {"p": [], "c": []}
    for turn in args.order:
        proc = subprocess.run(
            [sys.executable, __file__, "--parent", args.parent, "--measure",
             roots[turn]], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"turn {turn} failed:\n{proc.stderr}")
        rec = json.loads(proc.stdout.splitlines()[-1])
        runs[turn].append(rec)
        print(f"[turns] {turn}: " + ", ".join(
            f"{k} {rec[k]:.5f}" for k in KEYS), flush=True)
    summary = {tree: {k: statistics.median(r[k] for r in recs) for k in KEYS}
               for tree, recs in runs.items() if recs}
    equal = {h: len({r[h] for recs in runs.values() for r in recs}) == 1
             for h in HASHES}
    equal["open_uT_is_main_uT"] = all(
        r["open_uT_sha256"] == r["main_uT_sha256"]
        for recs in runs.values() for r in recs)
    print(f"[turns] each path's output the same to the bit in every turn: "
          f"{equal}", flush=True)
    print(json.dumps({"card": smi, "order": args.order, "median": summary,
                      "bit_equal": equal}))


if __name__ == "__main__":
    main()
