"""Crank–Nicolson timestepping: the delta-form dispatch of the JAX
package's `mg/timestepper.py`, the only stepper the port runs so far (the
configuration refuses the others)."""

from __future__ import annotations

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.mg.delta import timestepper_delta


def timestepper(levels, u0, num_steps: int, cfg: SolverConfig, fine_hi):
    """Run `num_steps` CN steps from the padded state u0; returns
    (uT, per-step stats)."""
    return timestepper_delta(levels, fine_hi, u0, num_steps, cfg)


def timestep(levels, u, cfg: SolverConfig, fine_hi):
    """One CN step; returns (u_next, stats of that step)."""
    u_next, stats = timestepper_delta(levels, fine_hi, u, 1, cfg)
    return u_next, {k: v[0] if v.ndim >= 1 else v for k, v in stats.items()}
