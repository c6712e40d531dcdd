"""Crank–Nicolson timestepping: rhs = B·u^n, then solve A·u^{n+1} = rhs, the
port of the JAX package's `mg/timestepper.py`.  A Python loop replaces its
`lax.scan`; the statistics stay on the device.

Solve-path dispatch (every combination shares the same cycle kernels):

  cycle_mode   refine_dtype   solver
  adaptive     None           mg_solve          (reference mg_outer semantics)
  fixed        None           mg_solve_fixed
  fmg          None           fmg_solve         (full-multigrid opening)
  adaptive     float64        refined_solve     (mixed-precision refinement)
  fixed        float64        refined_solve     (timestepper_refined_fused
                                                 for a whole run)
  fmg          float64        refined_solve     (FMG first correction)
  fixed + delta_form          timestepper_delta (mg/delta.py)

`shardings` (parallel/) runs any of them on this rank's blocks of the
partitioned levels, in either layout: see mg/cycle.py.  Every solver runs
on the route `cfg.backend` names (`ops.cuda.routed`): "jnp" the kernels'
plain versions on every device, "auto" and "pallas" the kernels on the
card.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.mg.cycle import (
    fmg_solve,
    mg_solve,
    mg_solve_fixed,
)
from hpcclassmultigridproject_tpu_torch.mg.delta import timestepper_delta
from hpcclassmultigridproject_tpu_torch.mg.refine import (
    refined_solve,
    timestepper_refined_fused,
)
from hpcclassmultigridproject_tpu_torch.ops.cuda import routed
from hpcclassmultigridproject_tpu_torch.parallel.blocks import (
    compute_rhs,
    rhs_and_residual0,
)


@routed
def timestep(levels, u, cfg: SolverConfig, fine_hi=None, shardings=None):
    """One CN step; returns (u_next, stats of that step).  With `fine_hi`
    (the finest operator in `cfg.refine_dtype`) the step runs under
    mixed-precision refinement, or with cfg.delta_form one delta step."""
    if fine_hi is not None and cfg.delta_form:
        u_next, stats = timestepper_delta(levels, fine_hi, u, 1, cfg,
                                          shardings)
        return u_next, {k: v[0] if v.ndim >= 1 else v
                        for k, v in stats.items()}
    part = None if shardings is None else shardings[0]
    if fine_hi is not None:
        rhs, r0 = rhs_and_residual0(fine_hi, u, part)
        return refined_solve(levels, fine_hi, u, rhs, cfg, r0=r0,
                             shardings=shardings)
    rhs = compute_rhs(levels[0], u, part)
    if cfg.cycle_mode == "fixed":
        return mg_solve_fixed(levels, u, rhs, cfg, shardings)
    if cfg.cycle_mode == "fmg":
        return fmg_solve(levels, u, rhs, cfg, shardings)
    return mg_solve(levels, u, rhs, cfg, shardings)


@routed
def timestepper(levels, u0, num_steps: int, cfg: SolverConfig,
                fine_hi=None, shardings=None):
    """Run `num_steps` CN steps from the padded state u0; returns (uT,
    per-step stats stacked along the first axis)."""
    if fine_hi is not None and cfg.delta_form:
        return timestepper_delta(levels, fine_hi, u0, num_steps, cfg,
                                 shardings)
    if fine_hi is not None and cfg.cycle_mode == "fixed":
        return timestepper_refined_fused(levels, fine_hi, u0, num_steps, cfg,
                                         shardings)
    u, steps = u0, []
    for _ in range(num_steps):
        u, stats = timestep(levels, u, cfg, fine_hi, shardings)
        steps.append(stats)
    return u, {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
