"""Multigrid cycling: V/W-cycles, coarse solves and the outer solvers, the
port of the JAX package's `mg/cycle.py` on one device.

The arrangement is the JAX package's fused one (its Pallas backend):
every smoothing block is one launch of the level form's smoother kernel
(K2 from_v, K5 five-band, K6 nine-band; `ops/cuda/smoother.py`), whose
pre-smooth emits the residual (row-decimated under injection) and whose
post-smooth folds in the prolonged correction.  A zero-iterate V-cycle
over from_v levels from n <= 512 down to a dense coarse solve runs as the
coarse tower (K3, dense solve, K4).  Each kernel wrapper launches its CUDA
kernel for CUDA tensors and runs its plain PyTorch version for CPU tensors.

PyTorch has no on-device while loop, so the adaptive solvers
(`mg_solve`, `coarse_solve_gs`) are host loops that read one norm per
iteration, and stop after the same count as the JAX package's
`lax.while_loop`.
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
    interior_norm,
    prolong_bilinear,
    rb_gauss_seidel,
    residual,
    restrict_full_weighting,
    restrict_inject,
    restrict_inject_rows_decimated,
)


def _tower_eligible(cfg: SolverConfig, levels, lvl: int,
                    u_is_zero: bool) -> bool:
    """The tower covers a correction solve (zero iterate) over a V-shaped
    sub-cycle of from_v levels, from a level below the finest with
    n <= TOWER_MAX_N down to a dense coarse solve, under injection and
    red–black GS, in a float32 working dtype: the JAX package's gate.  Its
    backend test has no counterpart: the tower's wrappers pick the kernel
    or the plain version by device."""
    if not u_is_zero or lvl == 0 or lvl >= len(levels) - 1:
        return False
    if levels[lvl].n > TOWER_MAX_N:
        return False
    if (cfg.cycle_shape != 1 or cfg.restriction != "inject"
            or cfg.coarse_mode != "dense" or levels[-1].a_inv is None):
        return False
    if any(l.form != "from_v" for l in levels[lvl:-1]):
        return False
    return cfg.smoother == "rbgs" and cfg.dtype.itemsize == 4


def _restrict(cfg: SolverConfig, res, coarse_level):
    shape = coarse_level.padded
    if cfg.restriction == "inject":
        return restrict_inject(res, shape)
    if cfg.restriction == "full":
        return restrict_full_weighting(res, shape, coarse_level.n)
    raise ValueError(f"unknown restriction {cfg.restriction!r}")


def coarse_solve_gs(level, u, rhs, cfg: SolverConfig):
    """Coarsest-level solve by red–black GS sweeps until the absolute
    residual norm is at most `coarse_tol` or `coarse_maxiter` sweeps ran:
    check before each sweep, with a placeholder residual of 1 at the
    start (the JAX package's semantics).  A host loop: each sweep reads one
    norm.  `u` None starts from zero."""
    if u is None:
        u = torch.zeros_like(rhs)
    res = torch.ones((), dtype=torch.promote_types(rhs.dtype, torch.float32),
                     device=rhs.device)
    it = 0
    while it < cfg.coarse_maxiter and bool(res > cfg.coarse_tol):
        u = rb_gauss_seidel(level, u, rhs)
        res = interior_norm(residual(level, u, rhs))
        it += 1
    return u


def coarse_solve_dense(level, rhs: torch.Tensor) -> torch.Tensor:
    """Exact coarse solve: one matrix–vector product with the precomputed
    interior inverse (the iterate is not needed)."""
    n, m = level.n, level.n - 1
    flat = rhs[1:n, 1:n].reshape(m * m)
    out = torch.zeros_like(rhs)
    out[1:n, 1:n] = (level.a_inv @ flat).reshape(m, m)
    return out


def _coarse_solve(level, u, rhs, cfg: SolverConfig):
    if cfg.coarse_mode == "dense" and level.a_inv is not None:
        return coarse_solve_dense(level, rhs)
    return coarse_solve_gs(level, u, rhs, cfg)


def mg_cycle(levels, u, rhs, cfg: SolverConfig, lvl: int = 0,
             want_final_residual: bool = False, u_is_zero: bool = False):
    """One V- (cycle_shape 1) or W-cycle (2) from level `lvl`; the shape
    loop wraps the whole level body, the coarsest solve included.  With
    `u_is_zero` the iterate is zero and `u` may be None.  With
    `want_final_residual` (top level), also return rhs − A·u of the result,
    which the last post-smooth emits: returns (u, res) instead of u."""
    if not want_final_residual and _tower_eligible(cfg, levels, lvl,
                                                   u_is_zero):
        return tower_vcycle(levels, lvl, rhs, cfg)
    level = levels[lvl]
    res = None
    for sh in range(cfg.cycle_shape):
        last_pass = sh == cfg.cycle_shape - 1
        if lvl == len(levels) - 1:
            u = _coarse_solve(level, u, rhs, cfg)
            if want_final_residual and last_pass:
                res = residual(level, u, rhs)
            continue
        # under injection the pre-smooth emits the residual's even rows
        # only, the row half of the restriction
        res_dec = cfg.restriction == "inject"
        u, r0 = fused_rb_sweeps(level, u, rhs, cfg.niter, True,
                                zero_init=u_is_zero and sh == 0,
                                residual_rows_decimated=res_dec)
        if res_dec:
            rhs_c = restrict_inject_rows_decimated(r0, levels[lvl + 1].padded)
        else:
            rhs_c = _restrict(cfg, r0, levels[lvl + 1])
        u_c = mg_cycle(levels, None, rhs_c, cfg, lvl + 1, u_is_zero=True)
        corr = prolong_bilinear(u_c, level.padded)
        u, res = fused_rb_sweeps(level, u, rhs, cfg.niter,
                                 want_final_residual and last_pass, corr=corr)
    if want_final_residual:
        return u, res
    return u


def _safe(res0):
    return torch.clamp_min(res0, torch.finfo(res0.dtype).tiny)


def _stats(cycles: int, rel, cfg: SolverConfig) -> dict:
    return {
        "cycles": torch.tensor(cycles, dtype=torch.int32, device=rel.device),
        "rel_residual": rel,
        "converged": rel <= cfg.tol,
    }


def mg_solve(levels, u, rhs, cfg: SolverConfig):
    """Solve A u = rhs by repeated cycles until the relative residual is at
    most tol or `max_cycles` cycles ran.  Returns (u, stats) with stats
    {"cycles", "rel_residual", "converged"} on the device; the tolerance
    test runs in the norm's dtype, as in the JAX package."""
    fine = levels[0]
    res0 = interior_norm(residual(fine, u, rhs))
    res0_safe = _safe(res0)
    res, it = res0, 0
    while it < cfg.max_cycles and bool(res / res0_safe > cfg.tol):
        u = mg_cycle(levels, u, rhs, cfg)
        res = interior_norm(residual(fine, u, rhs))
        it += 1
    return u, _stats(it, res / res0_safe, cfg)


def mg_solve_fixed(levels, u, rhs, cfg: SolverConfig):
    """Exactly `cfg.num_cycles` cycles, with the relative-residual
    certificate in stats; no host read."""
    fine = levels[0]
    res0_safe = _safe(interior_norm(residual(fine, u, rhs)))
    for _ in range(cfg.num_cycles):
        u = mg_cycle(levels, u, rhs, cfg)
    rel = interior_norm(residual(fine, u, rhs)) / res0_safe
    return u, _stats(cfg.num_cycles, rel, cfg)


def fmg_iterate(levels, rhs, cfg: SolverConfig):
    """The FMG ascent without a certificate: restrict `rhs` down the
    tower, solve the coarsest level, then prolong upward running
    `cfg.num_cycles` cycles per level.  Shared by `fmg_solve` and the
    refined path's FMG opening (mg/refine.py)."""
    rhs_l = [rhs]
    for lvl in range(1, len(levels)):
        rhs_l.append(_restrict(cfg, rhs_l[-1], levels[lvl]))
    v = _coarse_solve(levels[-1], None, rhs_l[-1], cfg)
    for lvl in range(len(levels) - 2, -1, -1):
        v = prolong_bilinear(v, levels[lvl].padded)
        for _ in range(cfg.num_cycles):
            v = mg_cycle(levels, v, rhs_l[lvl], cfg, lvl=lvl)
    return v


def fmg_solve(levels, u, rhs, cfg: SolverConfig):
    """Full multigrid: the FMG iterate replaces `u`, which only sets the
    certificate's baseline residual.  stats["cycles"] counts num_cycles at
    each non-coarsest level."""
    fine = levels[0]
    res0_safe = _safe(interior_norm(residual(fine, u, rhs)))
    v = fmg_iterate(levels, rhs, cfg)
    rel = interior_norm(residual(fine, v, rhs)) / res0_safe
    return v, _stats(cfg.num_cycles * (len(levels) - 1), rel, cfg)
