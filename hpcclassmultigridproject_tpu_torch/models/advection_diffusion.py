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
    rotating_velocity,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    build_fine_level,
    build_hierarchy,
)
from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestep, timestepper


class AdvectionDiffusion:
    """End-to-end advection–diffusion solver on one device.

    >>> model = AdvectionDiffusion(ProblemConfig(n=1024), SolverConfig(
    ...     refine_dtype=torch.float64, cycle_mode="fixed", num_cycles=1,
    ...     coarse_mode="dense", delta_form=True, certify_every=10),
    ...     device="cuda")
    >>> uT, stats = model.run()

    On a CUDA device the path runs the hand-written kernels; on the CPU it
    runs their plain PyTorch versions.  `device="cuda"` without a card
    raises.
    """

    def __init__(self, problem: ProblemConfig, solver: SolverConfig, *,
                 device, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh: not ported yet (ROADMAP queue 1, item 14)")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch sees no CUDA device")
        self.device = device
        self.problem = p = problem
        s = solver
        if s.num_cycles is None:
            s = dataclasses.replace(
                s, num_cycles=s.resolved_num_cycles(p.dt_, p.nu, 1.0 / p.n))
        self.solver = s
        self.num_levels = s.resolved_num_levels(p.n)
        v1, v2 = rotating_velocity(p.n, p.kx, p.ky, dtype=s.dtype,
                                   device="cpu")
        self.levels = build_hierarchy(v1, v2, p.dt_, p.nu, self.num_levels,
                                      dtype=s.dtype, device=device)
        vh1, vh2 = rotating_velocity(p.n, p.kx, p.ky, dtype=s.refine_dtype,
                                     device="cpu")
        self.fine_hi = build_fine_level(vh1, vh2, p.dt_, p.nu,
                                        dtype=s.refine_dtype, device=device)
        self.u0 = pad_field(gaussian_u0(p.n, p.x0, p.y0, p.sigma,
                                        dtype=s.refine_dtype, device=device))

    def run(self, u0: torch.Tensor | None = None, warn: bool = True):
        """Full run; returns (uT cropped to the logical grid, per-step
        stats).  With `warn`, reads the stats back and warns on a step
        that missed tol, a certificate without margin, or a failed
        high-dtype certificate."""
        uT, stats = timestepper(self.levels,
                                self.u0 if u0 is None else u0,
                                self.problem.num_steps, self.solver,
                                self.fine_hi)
        if warn:
            self._warn(stats)
        return crop_field(uT, self.problem.n), stats

    def _warn(self, stats) -> None:
        tol = self.solver.tol
        conv = stats["converged"].cpu()
        rel = stats["rel_residual"].cpu()
        if not bool(conv.all()):
            bad = int(torch.argmin(conv.to(torch.int8)))
            warnings.warn(
                f"multigrid did not converge at step {bad}: relative "
                f"residual {float(rel[bad]):.3e} > tol {tol:g}")
        max_rel = float(rel.max())
        if max_rel > tol / 2:
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

    def step(self, u: torch.Tensor):
        """One CN step from a padded state; returns (u_next, stats)."""
        return timestep(self.levels, u, self.solver, self.fine_hi)

    def crop(self, u_padded: torch.Tensor) -> torch.Tensor:
        """The logical (n+1)^2 field of a padded state."""
        return crop_field(u_padded, self.problem.n)

    def center_value(self, uT: torch.Tensor) -> float:
        """uT[N/2][N/2], the reference's convergence oracle."""
        return float(uT[self.problem.n // 2, self.problem.n // 2])
