"""The V-cycle of the port's slice: red–black smoothing, injection, bilinear
prolongation, and the dense coarse solve.

The arrangement is the JAX package's fused one (`mg/cycle.py::mg_cycle`
under its Pallas backend): the smoothing blocks are K2, whose pre-smooth
emits the row-decimated residual for the injection, whose post-smooth
folds in the prolonged correction; and the zero-iterate sub-cycle from
n <= 512 down runs as the coarse tower (K3, dense solve, K4).  Each kernel
wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import fused_rb_sweeps
from hpcclassmultigridproject_tpu_torch.ops.cuda.tower import (
    TOWER_MAX_N,
    tower_vcycle,
)
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    prolong_bilinear,
    residual_from_v,
    restrict_inject_rows_decimated,
)


def _tower_eligible(cfg: SolverConfig, levels, lvl: int,
                    u_is_zero: bool) -> bool:
    """The tower covers a correction solve (zero iterate) from a level
    below the finest with n <= TOWER_MAX_N down to the dense coarse solve,
    in a float32 working dtype (the JAX package's gate; the configuration
    itself guarantees V-cycles, injection and red–black GS)."""
    return (u_is_zero and 0 < lvl < len(levels) - 1
            and levels[lvl].n <= TOWER_MAX_N
            and levels[-1].a_inv is not None
            and cfg.dtype.itemsize == 4)


def coarse_solve_dense(level, rhs: torch.Tensor) -> torch.Tensor:
    """Exact coarse solve: one matrix–vector product with the precomputed
    interior inverse."""
    n, m = level.n, level.n - 1
    flat = rhs[1:n, 1:n].reshape(m * m)
    out = torch.zeros_like(rhs)
    out[1:n, 1:n] = (level.a_inv @ flat).reshape(m, m)
    return out


def mg_cycle(levels, u, rhs, cfg: SolverConfig, lvl: int = 0,
             want_final_residual: bool = False, u_is_zero: bool = False):
    """One V-cycle from level `lvl`.  With `u_is_zero` the iterate is zero
    and `u` may be None.  With `want_final_residual` (top level), also
    return rhs − A·u of the result, which the post-smooth emits: returns
    (u, res) instead of u."""
    if not want_final_residual and _tower_eligible(cfg, levels, lvl,
                                                   u_is_zero):
        return tower_vcycle(levels, lvl, rhs, cfg)
    level = levels[lvl]
    if lvl == len(levels) - 1:
        u = coarse_solve_dense(level, rhs)
        if want_final_residual:
            return u, residual_from_v(level, u, rhs)
        return u
    u, r0 = fused_rb_sweeps(level, u, rhs, cfg.niter, True,
                            zero_init=u_is_zero,
                            residual_rows_decimated=True)
    rhs_c = restrict_inject_rows_decimated(r0, levels[lvl + 1].padded)
    u_c = mg_cycle(levels, None, rhs_c, cfg, lvl + 1, u_is_zero=True)
    corr = prolong_bilinear(u_c, level.padded)
    u, res = fused_rb_sweeps(level, u, rhs, cfg.niter, want_final_residual,
                             corr=corr)
    if want_final_residual:
        return u, res
    return u
