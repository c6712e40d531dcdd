"""Command-line interface of the PyTorch/CUDA port: the JAX package's
`cli.py`, with its flags and printed JSON keys, plus `--device`.

    python -m hpcclassmultigridproject_tpu_torch.cli run --n 256 --dump uT.txt
    python -m hpcclassmultigridproject_tpu_torch.cli run --n 1024 --delta \\
        --cycle-mode fixed --num-cycles 1 --coarse dense --certify-every 10
    python -m hpcclassmultigridproject_tpu_torch.cli sweep --sizes 64,128,256
    python -m hpcclassmultigridproject_tpu_torch.cli gsbench --backend pallas
    python -m hpcclassmultigridproject_tpu_torch.cli profile --n 1024
    python -m hpcclassmultigridproject_tpu_torch.cli scaling --n 1024 \
        --max-devices 4 --mode strong --layout 2d --delta \
        --cycle-mode fixed --num-cycles 1 --coarse dense
    python -m hpcclassmultigridproject_tpu_torch.cli viz uT.txt --out uT.pdf
    python -m hpcclassmultigridproject_tpu_torch.cli diff uT.txt uTother.txt

Every solver subcommand runs on the card (`--device cuda`, the default)
through the hand-written kernels, or with `--device cpu` through their
plain PyTorch versions.  `--backend` picks the route of `run`, `sweep`,
`profile` and `scaling` as `SolverConfig.backend` does: `jnp` runs the
plain versions on the card too, `auto` and `pallas` the kernels.
`gsbench --backend` keeps its own meaning (K2 or the plain sweep).
The plots (`viz`, `plot-sweep`, `plot-scaling`) need matplotlib and import
it only when they run.  `scaling` runs each sweep point over that many
ranks, spawned on this host (`parallel.launch_local`: NCCL where every
rank has a GPU of its own, gloo otherwise, so ranks may share one card),
where the JAX package takes that many devices of one process; with
`--distributed` this process is one rank of a world joined through the
HPCMG_* variables, and the whole world is the one point.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _solver_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n", type=int, default=256, help="grid size (power of 2)")
    p.add_argument("--steps", type=int, default=100,
                   help="number of CN timesteps")
    p.add_argument("--nu", type=float, default=-4e-4)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--refine", action="store_true",
                   help="mixed-precision refinement (f64 residuals, f32 "
                        "cycles)")
    p.add_argument("--delta", action="store_true",
                   help="delta-form stepping (f32 increment solve + f32-pair "
                        "state, mg/delta.py); implies --refine, needs "
                        "--cycle-mode fixed")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--cycle-shape", type=int, default=1, help="1=V, 2=W")
    p.add_argument("--niter", type=int, default=3,
                   help="pre/post smoothing sweeps")
    p.add_argument("--levels", type=int, default=None)
    p.add_argument("--smoother", choices=["rbgs", "jacobi", "chebyshev"],
                   default="rbgs")
    p.add_argument("--restriction", choices=["inject", "full"],
                   default="inject")
    p.add_argument("--coarse", choices=["gs", "dense"], default="gs")
    p.add_argument("--coarse-tol", type=float, default=1e-5,
                   help="coarsest-level absolute residual")
    p.add_argument("--coarse-maxiter", type=int, default=1000,
                   help="coarsest-level smoothing sweep cap")
    p.add_argument("--max-cycles", type=int, default=50,
                   help="outer cycle cap")
    p.add_argument("--coarse-operator", choices=["rediscretize", "galerkin"],
                   default="rediscretize")
    p.add_argument("--cycle-mode", choices=["adaptive", "fixed", "fmg"],
                   default="adaptive")
    p.add_argument("--num-cycles", default=2,
                   type=lambda s: None if s == "auto" else int(s),
                   help="cycles per solve in fixed mode; 'auto' derives the "
                        "count from the diagonal-dominance model "
                        "(config.py::resolved_num_cycles)")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"],
                   default="auto",
                   help="validated for parity with the JAX package; the "
                        "solver's route follows --device")
    p.add_argument("--certify-every", type=int, default=0,
                   help="delta mode: rigorous refine-dtype certificate every "
                        "k-th step inside the timed run (0 = final-step "
                        "epilogue only)")
    p.add_argument("--device-build", dest="device_build", default=None,
                   action="store_true",
                   help="build the model on the device from the analytic "
                        "fields (default: auto, the device at n >= 4096 "
                        "with rediscretized levels; see "
                        "SolverConfig.device_build)")
    p.add_argument("--host-build", dest="device_build", action="store_false",
                   help="build the model in host numpy float64 and copy "
                        "it to the device")
    p.add_argument("--sharded-overlap", action="store_true",
                   help="rows-partitioned smoothing: overlap the deep-halo "
                        "exchange with the interior kernel "
                        "(SolverConfig.sharded_overlap; parallel/ only)")
    _device_arg(p)


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default, the kernels) or "
                        "'cpu' (their plain versions)")


def _build_model(args, mesh=None, layout="auto", device=None):
    """The model of the CLI arguments on `device` (default `args.device`);
    with `mesh` (the `scaling` subcommand), born partitioned over it in
    `layout` where the device build can build it (rediscretized levels,
    `--host-build` not forced), as the JAX package builds it; else whole,
    and `parallel.distributed_run` partitions it."""
    import torch

    from hpcclassmultigridproject_tpu_torch import ProblemConfig, SolverConfig
    from hpcclassmultigridproject_tpu_torch.models import AdvectionDiffusion

    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    delta = getattr(args, "delta", False)
    refine = torch.float64 if (args.refine or delta) else None
    problem = ProblemConfig(n=args.n, nu=args.nu, num_steps=args.steps)
    solver = SolverConfig(
        num_levels=args.levels,
        cycle_shape=args.cycle_shape,
        niter=args.niter,
        tol=args.tol,
        smoother=args.smoother,
        restriction=args.restriction,
        coarse_mode=args.coarse,
        coarse_tol=args.coarse_tol,
        coarse_maxiter=args.coarse_maxiter,
        max_cycles=args.max_cycles,
        coarse_operator=args.coarse_operator,
        cycle_mode=args.cycle_mode,
        num_cycles=args.num_cycles,
        dtype=dtype,
        refine_dtype=refine,
        backend=args.backend,
        delta_form=delta,
        certify_every=getattr(args, "certify_every", 0),
        device_build=getattr(args, "device_build", None),
        sharded_overlap=getattr(args, "sharded_overlap", False),
    )
    device = args.device if device is None else device
    if (mesh is not None and solver.coarse_operator == "rediscretize"
            and solver.device_build is not False):
        return AdvectionDiffusion(problem, solver, device=device, mesh=mesh,
                                  layout=layout)
    return AdvectionDiffusion(problem, solver, device=device)


def _run_chunked(model, args):
    """A checkpointed (`--checkpoint-dir`) or dump-series (`--dump-every`)
    run; returns (uT, the stats of the chunks this process ran, stitched),
    the stats None when it ran none."""
    from hpcclassmultigridproject_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        run_with_checkpoints,
        stitch_stats,
    )
    from hpcclassmultigridproject_tpu_torch.utils.io import save_field_txt

    chunks = []
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir, model.problem)
        uT, _ = run_with_checkpoints(model, mgr, every=args.checkpoint_every,
                                     on_chunk=chunks.append)
        return uT, stitch_stats(chunks)
    # trajectory capture for `viz --animate`: run in dump_every-step
    # chunks, writing a numbered dump series next to --dump
    if not args.dump:
        raise SystemExit("--dump-every requires --dump PREFIX")
    base = args.dump[:-4] if args.dump.endswith(".txt") else args.dump
    u, step = model.u0, 0
    save_field_txt(f"{base}.step0000.txt", model.crop(u))
    while step < model.problem.num_steps:
        chunk = min(args.dump_every, model.problem.num_steps - step)
        u, stats = model.run_chunk(u, chunk)
        chunks.append(stats)
        step += chunk
        save_field_txt(f"{base}.step{step:04d}.txt", model.crop(u))
    return model.crop(u), stitch_stats(chunks)


def cmd_run(args) -> int:
    from hpcclassmultigridproject_tpu_torch.utils.io import (
        as_numpy,
        save_field_txt,
    )
    from hpcclassmultigridproject_tpu_torch.utils.timing import time_run

    model = _build_model(args)

    if args.checkpoint_dir or args.dump_every:
        uT, stats = _run_chunked(model, args)
        timing = {"best_s": None}
    else:
        # warn=False inside the timed region (the warning check copies the
        # per-step stats to the host); convergence is reported below
        timing = time_run(lambda: model.run(warn=False), reps=args.reps)
        uT, stats = timing.pop("out")

    out = {
        "n": args.n,
        "steps": args.steps,
        "seconds": timing["best_s"],
        "center_uT": model.center_value(uT),
    }
    if stats is not None:
        out["max_cycles"] = int(as_numpy(stats["cycles"]).max())
        out["max_rel_residual"] = float(as_numpy(stats["rel_residual"]).max())
        out["converged"] = bool(as_numpy(stats["converged"]).all())
    print(json.dumps(out))
    if args.dump:
        save_field_txt(args.dump, uT)
    return 0


def cmd_sweep(args) -> int:
    from hpcclassmultigridproject_tpu_torch.utils.io import as_numpy
    from hpcclassmultigridproject_tpu_torch.utils.timing import time_run

    sizes = [int(s) for s in args.sizes.split(",")]
    for n in sizes:
        args.n = n
        model = _build_model(args)
        timing = time_run(lambda: model.run(warn=False), reps=args.reps)
        uT, stats = timing.pop("out")
        print(json.dumps({
            "n": n,
            "ms": timing["best_s"] * 1e3,
            "center_uT": model.center_value(uT),
            "max_rel_residual": float(as_numpy(stats["rel_residual"]).max()),
        }), flush=True)
    return 0


def _rank_device(args, mesh):
    """This rank's torch device, selected: `parallel.rank_device` of
    `args.device` (on CUDA without an index the card rank % device count,
    one card a rank under NCCL; ranks share cards under gloo).  CPU ranks
    share the host's threads."""
    import torch

    from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
        rank_device,
    )

    device = rank_device(args.device, mesh.rank, mesh.world, mesh.backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif mesh.world > 1:
        torch.set_num_threads(max(1, torch.get_num_threads() // mesh.world))
    return device


def scaling_point(args) -> dict:
    """One point of `scaling` in each rank of the process group (or alone,
    on one rank): the model built over every rank, and its
    `distributed_run` timed by `time_run` (best of `--reps`, synchronized,
    after a warm-up).  Where the run is one compiled program (on the card
    on one rank, and under NCCL unless `parallel.distributed.CAPTURE_NCCL`
    is set off in the ranks) the warm-up captures it, and the seconds are
    a replay's; under gloo the ranks run eagerly.  Returns the point's
    seconds, center value, mesh shape, whether it ran compiled and the
    capture's seconds (None where eager), as plain Python values."""
    from hpcclassmultigridproject_tpu_torch.parallel import (
        distributed_run,
        make_mesh,
    )
    from hpcclassmultigridproject_tpu_torch.utils.timing import time_run

    mesh = make_mesh()
    model = _build_model(args, mesh=mesh, layout=args.layout,
                         device=_rank_device(args, mesh))
    timing = time_run(lambda: distributed_run(model, mesh,
                                              layout=args.layout),
                      reps=args.reps)
    uT, _ = timing.pop("out")
    rows, cols = mesh.shape
    program = model.programs.last if model.last_run_compiled else None
    return {"seconds": timing["best_s"], "center_uT": model.center_value(uT),
            "mesh": {"x": rows, "y": cols},
            "compiled": program is not None,
            "capture_seconds": None if program is None else program.seconds}


def _point_backend(args, world: int) -> str:
    """NCCL where every rank of `world` has a GPU of its own, else gloo."""
    import torch

    if (torch.device(args.device).type == "cuda"
            and world <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def cmd_scaling(args) -> int:
    """Device-count scaling sweeps, the JAX package's `scaling`.

    --mode strong: a fixed problem over 1, 2, 4, 8, 16, 32 ranks, up to
    --max-devices.  --mode weak: the work per rank held constant over 1,
    4, 16, 64 ranks, the grid's n times √c for c ranks (the 2-D block
    decomposition); reports parallel efficiency t(1)/t(c).  Each point
    runs in that many spawned ranks (`parallel.launch_local`), the first
    in this process; rank 0 times it and prints one JSON line.

    --distributed: join the process group first
    (`parallel.initialize`: HPCMG_COORDINATOR / HPCMG_NUM_PROCESSES /
    HPCMG_PROCESS_ID, else torch's env://) and scale over the whole world,
    the one point; only rank 0 prints, and the ratios come from
    --baseline-seconds."""
    from hpcclassmultigridproject_tpu_torch.parallel import (
        initialize,
        is_multiprocess,
        launch_local,
        make_mesh,
    )

    if args.distributed:
        # the world size before the group exists: the HPCMG variable, else
        # torch's env:// one
        world = (os.environ.get("HPCMG_NUM_PROCESSES")
                 or os.environ.get("WORLD_SIZE") or "1")
        initialize(_point_backend(args, int(world)))
    mesh = make_mesh()
    emit = print if mesh.rank == 0 else (lambda *a, **k: None)
    if is_multiprocess() or args.distributed:
        counts = [mesh.world]
    elif args.mode == "weak":
        counts = [c for c in (1, 4, 16, 64) if c <= args.max_devices]
    else:
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= args.max_devices]

    def point(args, c):
        if args.distributed or c == 1:
            return scaling_point(args)
        return launch_local(scaling_point, c, (args,),
                            backend=_point_backend(args, c),
                            device=args.device)

    for rec in scaling_records(args, counts, point):
        emit(json.dumps(rec), flush=True)
    return 0


def scaling_records(args, counts, point):
    """`cmd_scaling`'s sweep: for each rank count c of `counts` (args.n
    grown by √c in weak mode, and restored at the end), the record it
    prints of `point(args, c)`, a `scaling_point` result; the ratios
    against the first point, or --baseline-seconds."""
    base_n, base_t = args.n, None
    try:
        for c in counts:
            if args.mode == "weak":
                args.n = base_n * int(round(c ** 0.5))
            got = point(args, c)
            if base_t is None and len(counts) > 1:
                base_t = got["seconds"]
            if args.baseline_seconds:
                base_t = args.baseline_seconds
            rec = {"devices": c, "n": args.n, "mesh": got["mesh"],
                   "layout": args.layout, "seconds": got["seconds"],
                   "center_uT": got["center_uT"]}
            have_ratio = base_t is not None
            rec["efficiency"] = (base_t / got["seconds"]
                                 if args.mode == "weak" and have_ratio
                                 else None)
            if args.mode == "strong" and have_ratio:
                rec["speedup"] = base_t / got["seconds"]
            rec["compiled"] = got["compiled"]
            rec["capture_seconds"] = got["capture_seconds"]
            yield rec
    finally:
        args.n = base_n


def gsbench_sweeps(n: int, sweeps: int, backend: str, dtype, device):
    """What `gsbench` times: (run, u0, sweep, keep).  `run(u)` is `sweeps`
    red–black sweeps from u, K2 (`fused_rb_sweeps`, one launch a sweep)
    for backend "pallas", the plain `rb_gauss_seidel` for "jnp", on the
    reference's fine level at n with rhs 0; u0 is a field of ones with a
    zero boundary; `sweep` is one sweep; `keep` the tensors a sweep reads
    besides u."""
    import torch

    from hpcclassmultigridproject_tpu_torch.core.layout import pad_field
    from hpcclassmultigridproject_tpu_torch.core.problem import (
        rotating_velocity,
    )
    from hpcclassmultigridproject_tpu_torch.mg.levels import build_fine_level
    from hpcclassmultigridproject_tpu_torch.ops.cuda import smoother
    from hpcclassmultigridproject_tpu_torch.ops.padded import rb_gauss_seidel

    v1, v2 = rotating_velocity(n, dtype=dtype, device="cpu")
    level = build_fine_level(v1, v2, (1.0 / n) / 10, -4e-4, dtype=dtype,
                             device=device)
    u = torch.zeros((n + 1, n + 1), dtype=dtype, device=device)
    u[1:-1, 1:-1] = 1.0
    u = pad_field(u)
    rhs = torch.zeros_like(u)

    if backend == "pallas":
        def sweep(u):
            return smoother.fused_rb_sweeps(level, u, rhs, 1)[0]
    else:
        def sweep(u):
            return rb_gauss_seidel(level, u, rhs)

    def run(u):
        for _ in range(sweeps):
            u = sweep(u)
        return u

    return run, u, sweep, (level, rhs)


def cmd_gsbench(args) -> int:
    """Red–black GS throughput microbenchmark: `--sweeps` sweeps at n from a
    field of ones, 31 flops/point/sweep model.  Reports GFLOP/s and
    stencil GDOF/s.  `--backend pallas` runs K2 (`fused_rb_sweeps`, one
    launch per sweep); `--backend jnp` the plain `rb_gauss_seidel`.  On
    the card the sweeps are one compiled program (utils/graphs.py), keyed
    by (n, sweeps, backend, dtype), as the JAX package's are one
    `jax.jit` of `lax.scan`: its capture is the untimed first call, and
    `compiled` and `capture_seconds` say so; on the CPU they run eagerly."""
    import torch

    from hpcclassmultigridproject_tpu_torch.utils.graphs import Programs
    from hpcclassmultigridproject_tpu_torch.utils.timing import time_run

    n = args.n
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    run, u, sweep, keep = gsbench_sweeps(n, args.sweeps, args.backend, dtype,
                                         args.device)
    programs = Programs()
    key = ("gsbench", n, args.sweeps, args.backend, dtype)

    def compiled(u):
        return programs(key, run, (u,), sweep, keep=keep)

    t = time_run(compiled, u, reps=args.reps)
    program = programs.last
    points = (n - 1) ** 2
    flops = 31.0 * points * args.sweeps
    secs = t["best_s"]
    print(json.dumps({
        "n": n,
        "sweeps": args.sweeps,
        "backend": args.backend,
        "seconds": secs,
        "gflops": flops / secs / 1e9,
        "stencil_gdof_s": points * args.sweeps / secs / 1e9,
        "us_per_sweep": secs / args.sweeps * 1e6,
        "compiled": program is not None,
        "capture_seconds": None if program is None else program.seconds,
    }))
    return 0


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def cmd_viz(args) -> int:
    """pcolormesh render of a dumped field; with --animate, an animation
    over a dump series."""
    import numpy as np

    from hpcclassmultigridproject_tpu_torch.utils.io import load_field_txt

    plt = _pyplot()
    if args.animate:
        import glob

        from matplotlib.animation import FuncAnimation, PillowWriter

        paths = sorted(glob.glob(args.field))
        if len(paths) < 2:
            raise SystemExit(
                f"--animate needs a dump series (glob {args.field!r} matched "
                f"{len(paths)} files; produce one with `run --dump prefix "
                "--dump-every K`)")
        frames = [load_field_txt(p) for p in paths]
        n = frames[0].shape[0] - 1
        x = np.linspace(0.0, 1.0, n + 1)
        vmax = max(float(np.abs(f).max()) for f in frames) or 1.0
        fig, ax = plt.subplots(figsize=(6, 5))
        pcm = ax.pcolormesh(x, x, frames[0].T, shading="auto",
                            vmin=0.0, vmax=vmax)
        fig.colorbar(pcm, ax=ax)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        title = ax.set_title(paths[0])

        def draw(i):
            pcm.set_array(frames[i].T.ravel())
            title.set_text(paths[i])
            return pcm, title

        anim = FuncAnimation(fig, draw, frames=len(frames))
        out = args.out if args.out.endswith(".gif") else args.out + ".gif"
        anim.save(out, writer=PillowWriter(fps=args.fps))
        print(json.dumps({"out": out, "n": n, "frames": len(frames)}))
        return 0

    field = load_field_txt(args.field)
    n = field.shape[0] - 1
    x = np.linspace(0.0, 1.0, n + 1)
    fig, ax = plt.subplots(figsize=(6, 5))
    pcm = ax.pcolormesh(x, x, field.T, shading="auto")
    fig.colorbar(pcm, ax=ax)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title(args.field)
    fig.savefig(args.out, bbox_inches="tight")
    print(json.dumps({"out": args.out, "n": n}))
    return 0


def _json_lines(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def cmd_plot_sweep(args) -> int:
    """Log-log runtime-vs-N plot from `sweep` JSON lines."""
    plt = _pyplot()
    series = {}
    for path in args.files:
        rows = _json_lines(path)
        series[path] = ([r["n"] for r in rows],
                        [r.get("ms", r.get("seconds", 0) * 1e3) for r in rows])
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for key, (ns, ms) in series.items():
        ax.loglog(ns, ms, marker="o", label=key)
    ax.set_xlabel("grid size N")
    ax.set_ylabel("runtime [ms]")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.savefig(args.out, bbox_inches="tight")
    print(json.dumps({"out": args.out, "series": list(series)}))
    return 0


def cmd_profile(args) -> int:
    """Per-phase roofline profile of one CN step."""
    from hpcclassmultigridproject_tpu_torch.utils.profiling import (
        profile_step,
        trace_step,
    )

    model = _build_model(args)
    prof = profile_step(model, reps=args.reps)
    for rec in prof.pop("phases"):
        print(json.dumps(rec), flush=True)
    print(json.dumps(prof), flush=True)
    if args.trace:
        print(json.dumps({"trace_logdir": trace_step(model, args.trace)}))
    return 0


def cmd_plot_scaling(args) -> int:
    """Runtime-vs-devices plot from scaling JSON lines, best point
    highlighted."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for path in args.files:
        rows = _json_lines(path)
        devs = [r.get("devices", r.get("threads")) for r in rows]
        secs = [r.get("seconds", r.get("ms", 0) / 1e3) for r in rows]
        ax.plot(devs, secs, marker="o", label=path)
        best = min(range(len(secs)), key=secs.__getitem__)
        ax.plot([devs[best]], [secs[best]], marker="*", markersize=15,
                color="tab:red", zorder=5)
        ax.annotate(f"best: {devs[best]} @ {secs[best]:.3g}s",
                    (devs[best], secs[best]),
                    textcoords="offset points", xytext=(8, 8))
    ax.set_xlabel("devices")
    ax.set_ylabel("runtime [s]")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.savefig(args.out, bbox_inches="tight")
    print(json.dumps({"out": args.out}))
    return 0


def cmd_diff(args) -> int:
    """Frobenius norm of the difference of two dumps."""
    from hpcclassmultigridproject_tpu_torch.utils.io import (
        field_difference_norm,
        load_field_txt,
    )

    norm = field_difference_norm(load_field_txt(args.a),
                                 load_field_txt(args.b))
    print(json.dumps({"frobenius_norm": norm}))
    return 0


def parser() -> argparse.ArgumentParser:
    """The CLI's argument parser: a subcommand each, its handler in `fn`."""
    top = argparse.ArgumentParser(prog="hpcclassmultigridproject_tpu_torch")
    sub = top.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="full timestepped solve")
    _solver_args(p)
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--dump", default=None,
                   help="write uT as tab-separated text")
    p.add_argument("--dump-every", type=int, default=0,
                   help="also dump every K steps as <dump>.stepNNNN.txt "
                        "(trajectory series for `viz --animate`)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sweep", help="grid-size timing sweep")
    _solver_args(p)
    p.add_argument("--sizes", default="32,64,128,256,512,1024")
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("scaling", help="device-count scaling")
    _solver_args(p)
    p.add_argument("--max-devices", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--mode", choices=["strong", "weak"], default="strong")
    p.add_argument("--layout", choices=["auto", "2d", "rows"], default="auto",
                   help="level partition layout (parallel/sharding.py): "
                        "'rows' runs the deep-halo kernel K7 on the "
                        "partitioned levels, '2d' splits rows and columns")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group from HPCMG_COORDINATOR, "
                        "HPCMG_NUM_PROCESSES and HPCMG_PROCESS_ID first "
                        "(one process a rank)")
    p.add_argument("--baseline-seconds", type=float, default=None,
                   help="recorded single-device runtime to ratio against "
                        "(required for speedup/efficiency under "
                        "--distributed, where only the whole world runs)")
    p.set_defaults(fn=cmd_scaling)

    p = sub.add_parser("gsbench", help="red-black GS throughput microbench")
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--sweeps", type=int, default=500)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--backend", choices=["jnp", "pallas"], default="jnp",
                   help="'pallas': K2, the fused smoother kernel, one launch "
                        "per sweep; 'jnp': the plain PyTorch rb_gauss_seidel")
    p.add_argument("--reps", type=int, default=3)
    _device_arg(p)
    p.set_defaults(fn=cmd_gsbench)

    p = sub.add_parser("viz", help="render a field dump, or an animation of "
                                   "a dump series")
    p.add_argument("field", help="dump file; with --animate, a glob over a "
                                 "dump series (quote it)")
    p.add_argument("--out", default="uT.pdf")
    p.add_argument("--animate", action="store_true")
    p.add_argument("--fps", type=int, default=8)
    p.set_defaults(fn=cmd_viz)

    p = sub.add_parser("plot-sweep", help="log-log runtime plot")
    p.add_argument("files", nargs="+", help="sweep JSON-lines output files")
    p.add_argument("--out", default="sweep.pdf")
    p.set_defaults(fn=cmd_plot_sweep)

    p = sub.add_parser("profile", help="per-phase roofline profile of one step")
    _solver_args(p)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--trace", default=None,
                   help="also record a torch.profiler trace to this logdir")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("plot-scaling", help="runtime-vs-devices plot")
    p.add_argument("files", nargs="+", help="scaling JSON-lines output files")
    p.add_argument("--out", default="scaling.pdf")
    p.set_defaults(fn=cmd_plot_scaling)

    p = sub.add_parser("diff", help="compare two field dumps")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_diff)

    return top


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
