"""Flagship problem: 2-D advection–diffusion with CN multigrid, the port of
the JAX package's `models/advection_diffusion.py`.

The default problem is the reference's: a Gaussian at (0.2, 0.4), the
rotating velocity field, ν = −4e-4, dt = dx/10, 100 steps.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from hpcclassmultigridproject_tpu_torch.config import ProblemConfig, SolverConfig
from hpcclassmultigridproject_tpu_torch.core.layout import crop_field, pad_field
from hpcclassmultigridproject_tpu_torch.core.problem import (
    gaussian_u0,
    gaussian_u0_padded_device,
    rotating_velocity,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    build_fine_level,
    build_fine_level_device,
    build_hierarchy,
    build_hierarchy_device,
)
from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestep, timestepper
from hpcclassmultigridproject_tpu_torch.parallel import (
    Mesh,
    capture_reason,
    fetch_outputs,
    level_shardings_for_ns,
    resolve_layout,
    shard_windows,
)
from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
    prepare_peer,
)
from hpcclassmultigridproject_tpu_torch.utils import graphs

# auto (device_build None) builds on the device from this n up
DEVICE_BUILD_MIN_N = 4096


def use_device_build(problem: ProblemConfig, solver: SolverConfig,
                     mesh=None) -> bool:
    """Whether the model is built on the device: `solver.device_build`,
    and for None (auto) the JAX package's rule, the device from n = 4096
    with rediscretized levels (the JAX package also asks for x64, which
    torch always has).  Auto's choice of the device is announced by a
    warning, where the JAX package says nothing.  A model born
    partitioned (`mesh`) needs the device build; forcing the host
    build then raises ValueError, and so does the device build with
    Galerkin levels."""
    dev = solver.device_build
    if mesh is not None:
        if dev is False:
            raise ValueError(
                "a model built partitioned over a mesh needs the device "
                "build (device_build=False was forced)")
        dev = True
    elif dev is None:
        dev = (problem.n >= DEVICE_BUILD_MIN_N
               and solver.coarse_operator == "rediscretize")
        if dev:
            warnings.warn(
                f"device_build=None (auto): building the model on the "
                f"device at n={problem.n}, since n >= {DEVICE_BUILD_MIN_N} "
                "with rediscretized levels; its fields agree with the host "
                "build to the ulp of sin/cos/exp, not to the bit "
                "(device_build=False keeps the host build)", stacklevel=3)
    if dev and solver.coarse_operator != "rediscretize":
        raise ValueError(
            "device_build supports coarse_operator='rediscretize' only "
            "(Galerkin R·A·P levels are built on the host)")
    return dev


class AdvectionDiffusion:
    """End-to-end advection–diffusion solver.

    >>> model = AdvectionDiffusion(ProblemConfig(n=1024), SolverConfig(
    ...     refine_dtype=torch.float64, cycle_mode="fixed", num_cycles=1,
    ...     coarse_mode="dense", delta_form=True, certify_every=10))
    >>> uT, stats = model.run()

    Every stepper of `mg/timestepper.py` runs, and either coarse operator;
    `parallel.distributed_run(model, mesh)` runs the model partitioned
    over ranks, in the rows or the 2-D layout.
    It runs on the card (`device="cuda"`, the default) through the
    hand-written kernels, and on the CPU (`device="cpu"`) through their
    plain PyTorch versions; without a card `device="cuda"` raises, with no
    move to the CPU.

    The model is built in host numpy float64 and copied to `device`, or
    built on `device` from the analytic fields (`use_device_build`).
    With a `mesh` it is born partitioned, in `layout` "rows" or "2d"
    ("auto": `parallel.resolve_layout`'s rule, "rows" under red–black GS
    and "2d" otherwise, as `distributed_run` picks), and the levels whose
    block holds at least `min_local` grid nodes along each split axis are
    partitioned, as `parallel.distributed_run` partitions them
    (`model.shardings`).  This rank then builds only its part: a
    partitioned level's block and halo (rows, or a 2-D window), `fine_hi`
    likewise and `u0`'s block, so that no rank holds a whole partitioned
    level; replicated levels and the coarsest are built whole.  Every
    rank builds its model, and `run` is then collective.

    `run`, `step` and `run_chunk` are compiled programs on the card, as
    the JAX model's are `jax.jit` programs: each step count (and the step)
    is captured once as a CUDA graph and replayed (utils/graphs.py), in
    every configuration: the adaptive solvers and the GS coarse solve are
    conditional WHILE nodes in it (`utils.graphs.while_loop`), as they are
    `lax.while_loop`s in the JAX programs.  Born partitioned under NCCL
    (unless `parallel.distributed.CAPTURE_NCCL` is set off), every rank
    captures and replays its own graph, with the step's halo exchanges and
    norms in it, as the JAX model's sharded programs hold theirs, in every
    configuration: those inside a WHILE body take the peer transport
    (parallel/distributed.py); the program's key adds the mesh, layout
    and min_local.  A run on the CPU, or partitioned otherwise (gloo with
    CUDA tensors, NCCL with the switch set off), is eager
    (`eager_reason`).  After each call,
    `last_run_compiled` says which way it ran and `last_run_reason` why
    it was eager (None when it was compiled).  Eager on the card means
    calling `mg.timestepper.timestepper` or `timestep` directly.
    """

    def __init__(self, problem: ProblemConfig, solver: SolverConfig, *,
                 device="cuda", mesh=None, layout: str = "auto",
                 min_local: int = 64):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch sees no CUDA device")
        self.device = device
        self.programs = graphs.Programs()
        self.last_run_compiled, self.last_run_reason = False, None
        self.problem = p = problem
        s = solver
        if s.num_cycles is None:
            s = dataclasses.replace(
                s, num_cycles=s.resolved_num_cycles(p.dt_, p.nu, 1.0 / p.n))
        self.solver = s
        self.num_levels = s.resolved_num_levels(p.n)
        self.mesh, self.shardings = mesh, None
        self.layout = self.min_local = None
        # parallel.partition's parts of a model built whole, per partition
        self.partitions = {}
        if mesh is not None:
            self.layout = resolve_layout(layout, s)
            self.min_local = min_local
            self.shardings = level_shardings_for_ns(
                [p.n >> lvl for lvl in range(self.num_levels)], mesh,
                min_local, self.layout, nsweeps=s.niter)
        u0_dtype = s.dtype if s.refine_dtype is None else s.refine_dtype
        if use_device_build(p, s, mesh):
            self._build_on_device(u0_dtype)
            return
        v1, v2 = rotating_velocity(p.n, p.kx, p.ky, dtype=s.dtype,
                                   device="cpu")
        self.levels = build_hierarchy(
            v1, v2, p.dt_, p.nu, self.num_levels, dtype=s.dtype,
            device=device, coarse_mode=s.coarse_mode,
            coarse_operator=s.coarse_operator, restriction=s.restriction)
        self.fine_hi = None
        if s.refine_dtype is not None:
            vh1, vh2 = rotating_velocity(p.n, p.kx, p.ky,
                                         dtype=s.refine_dtype, device="cpu")
            self.fine_hi = build_fine_level(vh1, vh2, p.dt_, p.nu,
                                            dtype=s.refine_dtype,
                                            device=device)
        self.u0 = pad_field(gaussian_u0(
            p.n, p.x0, p.y0, p.sigma, dtype=u0_dtype, device=device))

    def _build_on_device(self, u0_dtype) -> None:
        """The levels, fine_hi and u0 built on the model's device; born
        partitioned, only this rank's part of them."""
        p, s = self.problem, self.solver
        part = None if self.shardings is None else self.shardings[0]
        whole = part is None
        self.levels = build_hierarchy_device(
            p.n, p.kx, p.ky, p.dt_, p.nu, self.num_levels, dtype=s.dtype,
            device=self.device, coarse_mode=s.coarse_mode,
            coarse_operator=s.coarse_operator,
            rows=None if whole else shard_windows(self.shardings),
            cols=None if whole else shard_windows(self.shardings, cols=True))
        self.fine_hi = None
        if s.refine_dtype is not None:
            self.fine_hi = build_fine_level_device(
                p.n, p.kx, p.ky, p.dt_, p.nu, dtype=s.refine_dtype,
                device=self.device, rows=None if whole else part.window,
                cols=None if whole else part.col_window)
        self.u0 = gaussian_u0_padded_device(
            p.n, p.x0, p.y0, p.sigma, dtype=u0_dtype, device=self.device,
            rows=None if whole else (part.start, part.stop),
            cols=None if whole else (part.col_start, part.col_stop))

    def run(self, u0: torch.Tensor | None = None, warn: bool = True):
        """Full run; returns (uT cropped to the logical grid, per-step
        stats).  With `warn`, reads the stats back and warns on a step
        that missed tol, a certificate without margin, or a failed
        high-dtype certificate.  Born partitioned, `u0` is this rank's
        block and uT is gathered whole on every rank."""
        part = None if self.shardings is None else self.shardings[0]
        uT, stats = self._run_chunk(self.u0 if u0 is None else u0,
                                    self.problem.num_steps, part is None)
        if part is not None:
            uT, stats = fetch_outputs(uT, stats, part)
        if warn:
            self._warn(stats)
        return crop_field(uT, self.problem.n), stats

    def _warn(self, stats) -> None:
        """The JAX model's warnings: a step that missed tol, and under
        delta_form a certificate without margin or a failed high-dtype
        certificate."""
        tol = self.solver.tol
        conv = stats["converged"].cpu()
        rel = stats["rel_residual"].cpu()
        if not bool(conv.all()):
            bad = int(torch.argmin(conv.to(torch.int8)))
            warnings.warn(
                f"multigrid did not converge at step {bad}: relative "
                f"residual {float(rel[bad]):.3e} > tol {tol:g}")
        max_rel = float(rel.max())
        if self.solver.delta_form and max_rel > tol / 2:
            warnings.warn(
                f"delta-form f32 certificate max {max_rel:.3e} exceeds "
                f"tol/2 ({tol / 2:g}): num_cycles={self.solver.num_cycles} "
                "has no safety margin at these parameters; use "
                "num_cycles=None (auto) or increase it")
        if "certified" in stats:
            cert = stats["certified"].cpu()
            if not bool(cert.all()):
                bad = int(torch.argmin(cert.to(torch.int8)))
                hi = float(stats["rel_residual_hi_steps"].cpu()[bad])
                warnings.warn(
                    f"delta-form rigorous certificate FAILED at step {bad}: "
                    f"true high-dtype relative residual {hi:.3e} > tol "
                    f"{tol:g} (certify_every={self.solver.certify_every})")

    def eager_reason(self, mesh=None) -> str | None:
        """Why this model's calls run eagerly, or None where each replays
        a captured program: the CPU, or a run partitioned over `mesh`
        (default: the mesh the model was born on) under gloo with CUDA
        tensors, whose collectives stage through the host, or under NCCL
        while `parallel.distributed.CAPTURE_NCCL` is set off
        (`parallel.capture_reason`).  At the switch's default (on), every
        run partitioned under NCCL is captured, as on one device, the
        adaptive solves too."""
        mesh = self.mesh if mesh is None else mesh
        return capture_reason(Mesh(1) if mesh is None else mesh, self.device)

    def _key(self) -> tuple:
        """What a program's key holds of the partition: the mesh, layout
        and min_local of a model born partitioned (empty for a whole
        one)."""
        if self.mesh is None:
            return ()
        return self.mesh.key, self.layout, self.min_local

    def compiled(self, key, fn, u, warm=None, keep=None, mesh=None,
                 fresh=True):
        """`fn(u)` as the compiled program of `key` in `self.programs`
        (the counterpart of the JAX model's `_jit_*` programs), or called
        directly where `eager_reason(mesh)` gives a reason; records which
        way it ran.  `keep` (default the model's levels and fine_hi) are
        the tensors the program reads besides u; `fresh` False returns a
        replay's static outputs, for a caller that copies them at once
        (`utils.graphs.Programs`)."""
        reason = self.eager_reason(mesh)
        mesh = self.mesh if mesh is None else mesh
        if (reason is None and mesh is not None
                and self.solver.cycle_mode not in ("fixed", "fmg")):
            # its loop bodies hold collectives: the peer transport
            prepare_peer(self.programs, mesh, self.device)
        keep = (self.levels, self.fine_hi) if keep is None else keep
        out = fn(u) if reason is not None else self.programs(
            key, fn, (u,), warm, keep=keep, fresh=fresh)
        self.last_run_compiled, self.last_run_reason = reason is None, reason
        return out

    def step(self, u: torch.Tensor):
        """One CN step from a padded state (born partitioned, this
        rank's block of it); returns (u_next, stats).  One compiled
        program, as the JAX model's `_jit_step`."""
        levels, cfg = self.levels, self.solver
        fine_hi, shardings = self.fine_hi, self.shardings
        return self.compiled(
            ("step", cfg, *self._key()),
            lambda u: timestep(levels, u, cfg, fine_hi, shardings), u)

    def run_chunk(self, u_padded: torch.Tensor, nsteps: int):
        """`nsteps` CN steps from a padded state (checkpointed runs and
        trajectory dumps); returns (u padded, per-step stats).  Born
        partitioned, u is this rank's block in and out.  One compiled
        program per step count, shared with `run` (the JAX model's
        `_jit_run` and `_chunk_cache`), warmed up by one step."""
        return self._run_chunk(u_padded, nsteps)

    def _run_chunk(self, u_padded: torch.Tensor, nsteps: int,
                   fresh: bool = True):
        """`run_chunk`; `fresh` False returns a replay's static outputs
        (`compiled`)."""
        levels, cfg = self.levels, self.solver
        fine_hi, shardings = self.fine_hi, self.shardings
        return self.compiled(
            ("steps", nsteps, cfg, *self._key()),
            lambda u: timestepper(levels, u, nsteps, cfg, fine_hi,
                                  shardings),
            u_padded,
            lambda u: timestepper(levels, u, 1, cfg, fine_hi, shardings),
            fresh=fresh)

    def pad(self, u_logical: torch.Tensor) -> torch.Tensor:
        """Embed a logical (n+1)^2 field into the padded layout."""
        return pad_field(u_logical)

    def crop(self, u_padded: torch.Tensor) -> torch.Tensor:
        """The logical (n+1)^2 field of a padded state."""
        return crop_field(u_padded, self.problem.n)

    def center_value(self, uT: torch.Tensor) -> float:
        """uT[N/2][N/2], the reference's convergence oracle."""
        return float(uT[self.problem.n // 2, self.problem.n // 2])
