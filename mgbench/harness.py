"""One run of one cell: set-up, the measured window, an optional traced
segment, the correctness check, and the result line.

Every run in the window is one call of the port's
`AdvectionDiffusion.run(u0, warn=False)`, one replay of its captured
program on the card, and ends when the run's certificates are on the host.
The loop is closed: one client, runs back to back, each taking the next
initial condition of a bank made from the seed in set-up.  After the
window a sample of the runs, drawn from the seed, is compared with the
plain reference (reference/cn.py) from the same initial condition.
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import sys
import time
import types

import torch

from mgbench import spec, trace as tracing, traffic
from mgbench.reference import cn, cost

# top-level module names that must not be loaded in a run's process: the
# JAX stack and the JAX package (compared whole: the port's name begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "hpcclassmultigridproject_tpu")

DTYPES = {"float32": torch.float32, "float64": torch.float64}
PROBLEM_KEYS = ("n", "nu", "x0", "y0", "sigma", "kx", "ky", "dt",
                "num_steps")
# the value the delta stepper writes for a step it did not certify
UNCERTIFIED = -1.0


def solver_config(settings: dict):
    """The port's SolverConfig of a traffic file's solver settings."""
    from hpcclassmultigridproject_tpu_torch import SolverConfig

    kw = {k: DTYPES[v] if k.endswith("dtype") and v is not None else v
          for k, v in settings.items()}
    return SolverConfig(**kw)


def problem_config(config: dict):
    from hpcclassmultigridproject_tpu_torch import ProblemConfig

    return ProblemConfig(**{k: config[k] for k in PROBLEM_KEYS
                            if k in config})


def time_step(config: dict) -> float:
    """dt: the configuration's, or the upstream's dx/10."""
    return config.get("dt") or (1.0 / config["n"]) / 10.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Runner:
    """The program under test for one cell, and one timed run of it."""

    def __init__(self, cell: spec.Cell, device, seed: int):
        from hpcclassmultigridproject_tpu_torch.models import (
            AdvectionDiffusion,
        )

        self.device = device
        self.config, self.traffic = cell.config, cell.traffic
        t0 = time.perf_counter()
        self.model = AdvectionDiffusion(
            problem_config(self.config), solver_config(self.traffic["solver"]),
            device=device)
        sync(device)
        self.build_s = time.perf_counter() - t0
        inputs = self.traffic["inputs"]
        logical = traffic.gaussian_bank(seed, self.config, inputs, device)
        dtype = self.model.u0.dtype
        self.bank = [self.model.pad(u.to(dtype)) for u in logical]
        del logical
        self.certificates = self.traffic["certificates"]
        self.tol = self.model.solver.tol

    def logical_u0(self, j: int) -> torch.Tensor:
        return self.model.crop(self.bank[j])

    def run(self, j: int, events=None):
        """One run from bank entry j: (uT, certificates and cycles on the
        host).  `events` (start, end) CUDA events are recorded around the
        program's call."""
        if events:
            events[0].record()
        uT, stats = self.model.run(self.bank[j], warn=False)
        if events:
            events[1].record()
        with torch.profiler.record_function(tracing.READ_RANGE):
            parts = [stats[k].reshape(-1).to(torch.float64)
                     for k in self.certificates]
            parts.append(stats["cycles"].reshape(-1).to(torch.float64))
            host = torch.cat(parts).cpu()
        steps = self.config["num_steps"]
        return uT, host[:-steps], host[-steps:]

    def certified(self, certs: torch.Tensor) -> tuple[bool, float]:
        """(every certificate finite and ≤ tol, the largest certificate);
        steps the stepper did not certify are skipped."""
        finite = bool(torch.isfinite(certs).all())
        kept = certs[certs != UNCERTIFIED]
        worst = float(kept.max()) if kept.numel() else 0.0
        if not finite:
            worst = math.inf
        return finite and worst <= self.tol, worst

    def program(self):
        """The captured program the last run replayed (None off the
        card)."""
        return self.model.programs.last


def window(runner: Runner, seconds: float, seed: int, check_runs: int):
    """Runs back to back until `seconds` have passed; the walls, whether
    each was certified, the largest certificate, and a reservoir sample of
    `check_runs` runs (index, bank entry, uT) drawn from the seed."""
    inputs = runner.traffic["inputs"]
    rng = random.Random(seed)
    walls, passed, sample, cycles = [], [], [], []
    worst = 0.0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        j = traffic.order(i, inputs)
        t0 = time.perf_counter()
        uT, certs, cyc = runner.run(j)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        ok, w = runner.certified(certs)
        passed.append(ok)
        worst = max(worst, w)
        cycles.append(cyc)
        if i < check_runs:
            sample.append((i, j, uT))
        else:
            r = rng.randrange(i + 1)
            if r < check_runs:
                sample[r] = (i, j, uT)
        del uT
        i += 1
        if t1 >= deadline:
            break
    return types.SimpleNamespace(
        walls=walls, passed=passed, worst_certificate=worst,
        sample=sample, cycles=cycles, seconds=t1 - t_start)


def traced(runner: Runner, target_s: float, per_run_s: float,
           max_runs: int):
    """Runs under torch.profiler until about `target_s` of work: the trace
    (kept in memory), the walls, the device ms between CUDA events around
    each program call, and the loop tests and cycles the runs made."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from hpcclassmultigridproject_tpu_torch.ops import cuda as kernels

    runs = max(3, min(max_runs, math.ceil(target_s / max(per_run_s, 1e-6))))
    inputs = runner.traffic["inputs"]
    on_card = runner.device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    walls, device_ms, cycles = [], [], []
    tests0 = kernels.LAUNCHES["while_set"]
    with profile(activities=activities) as prof:
        for i in range(runs):
            events = ((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      if on_card else None)
            t0 = time.perf_counter()
            with record_function(tracing.RUN_RANGE):
                _, _, cyc = runner.run(traffic.order(i, inputs), events)
            walls.append(time.perf_counter() - t0)
            cycles.append(cyc)
            if events:
                device_ms.append(events[0].elapsed_time(events[1]))
        sync(runner.device)
    return types.SimpleNamespace(
        runs=runs, walls=walls, device_ms=device_ms, cycles=cycles,
        loop_tests=kernels.LAUNCHES["while_set"] - tests0,
        trace=tracing.collect(prof))


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def check(cell: spec.Cell, sample, logical: dict) -> float:
    """The largest relative max-norm gap between a sampled run's uT and
    the reference's from the same initial condition."""
    c = cell.config
    worst = 0.0
    refs = {}
    for _, j, uT in sorted(sample, key=lambda s: s[1]):
        if j not in refs:
            refs = {j: cn.cn_run(logical[j], c["n"], c["nu"], time_step(c),
                                 c["num_steps"], c["kx"], c["ky"])}
        ref = refs[j]
        gap = float((uT.to(torch.float64) - ref).abs().max())
        scale = float(ref.abs().max())
        worst = max(worst, gap / scale if math.isfinite(gap) else math.inf)
    return worst


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_process: float | None = None,
             root=spec.ROOT, bench_dir=spec.BENCH_DIR, patch=None) -> dict:
    """One run of cell `name`; returns the result line as a dict.  `patch`,
    called with the Runner after set-up, lets a test break the program
    underneath."""
    t_process = time.perf_counter() if t_process is None else t_process
    marks = [("imports", time.perf_counter())]
    cell = spec.load_cell(name, root, bench_dir)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("device", time.perf_counter()))
    runner = Runner(cell, device, seed)
    if patch is not None:
        patch(runner)
    marks.append(("model_and_bank", time.perf_counter()))
    for i in range(cell.traffic["warm_runs"]):
        runner.run(traffic.order(i, cell.traffic["inputs"]))
    sync(device)
    marks.append(("warm_runs", time.perf_counter()))
    setup_s = marks[-1][1] - t_process
    # where set-up went, part by part (the first warm run captures)
    setup_parts = {k: t - t0 for (k, t), (_, t0)
                   in zip(marks, [("", t_process)] + marks[:-1])}

    check_runs = cell.traffic["check"]["runs"]
    win = window(runner, seconds, seed, check_runs)
    program = runner.program()
    tr = None
    if trace:
        tr = traced(runner, cell.traffic["trace"]["device_seconds"],
                    sorted(win.walls)[len(win.walls) // 2],
                    cell.traffic["trace"]["max_runs"])
    peak = (torch.cuda.max_memory_reserved(device)
            if device.type == "cuda" else None)

    logical = {j: runner.logical_u0(j).clone() for _, j, _ in win.sample}
    runner.model = runner.bank = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gap = check(cell, win.sample, logical)
    win.sample = logical = None

    n, steps = cell.config["n"], cell.config["num_steps"]
    ctx = types.SimpleNamespace(
        cell=cell, seed=seed, device=device, n=n, steps=steps,
        dof_steps=(n - 1) ** 2 * steps, setup_s=setup_s, window=win,
        peak_reserved=peak, build_s=runner.build_s, program=program,
        traced=tr, layers=spec.read_data("metrics/kernel_layers.json",
                                         bench_dir)["patterns"],
        cost=cost)
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(m["name"], bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = cell.limits
    checks = {
        "uT_rel_gap": {"value": gap, "limit": limits["uT_rel_gap"]["limit"]},
        "certificate_max": {"value": win.worst_certificate,
                            "limit": runner.tol},
    }
    failed = win.passed.count(False)
    # a run over the certificate limit, or not finite, is a failed one
    correct = gap <= checks["uT_rel_gap"]["limit"] and failed == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(win.walls),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None and device.type == "cuda":
        t = tr.trace
        dev["busy_s"] = tracing.union_ns(
            tracing.clip(t.device_ops, t.span)) / 1e9
        dev["window_s"] = (t.span[1] - t.span[0]) / 1e9
        dev["power"] = power_limit()
        result["breakdown"] = tracing.breakdown(t, ctx.layers)
    walls_ms = sorted(1e3 * w for w in win.walls)
    result["setup_parts_s"] = setup_parts
    result["window"] = {
        "seconds": win.seconds, "runs": len(walls_ms),
        "wall_ms_min_q1_median_q3_max": [
            walls_ms[0], *statistics.quantiles(walls_ms, n=4),
            walls_ms[-1]] if len(walls_ms) > 1 else walls_ms * 5}
    result["checks"] = checks
    return result


def main(argv=None, t_process: float | None = None) -> int:
    import argparse
    import json
    import traceback

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
        if not torch.cuda.is_available():
            print("mgbench: torch sees no CUDA device; the benchmark runs "
                  "on the card only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"mgbench: {cell.name} needs {cell.chips} cards, torch "
                  f"sees {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_process=t_process)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"mgbench: the run's process loaded {', '.join(found)}; "
              "nothing of JAX or the JAX package may load", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

