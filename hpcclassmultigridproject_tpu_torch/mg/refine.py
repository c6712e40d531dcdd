"""Mixed-precision iterative refinement, the port of the JAX package's
`mg/refine.py`:

    r   = rhs − A·u            in the refine dtype (float64)
    e   ≈ A⁻¹ r                one multigrid cycle in the working dtype
    u  += e                    accumulated in the refine dtype

All smoothing runs in the working dtype; only the residuals and the update
run in the high one.  The CN system is strongly diagonally dominant, so one
cycle per step certifies the reference tolerance of 1e-6 that a pure
float32 solve cannot.  The adaptive mode is a `utils.graphs.while_loop`,
as the JAX package's is a `lax.while_loop` (eagerly one norm read per
test, captured a WHILE node on the card); the fixed and FMG modes have no
loop to test.

With `shardings` (parallel/) the high-dtype residuals and norms of a
partitioned fine level run in their block forms (parallel/blocks.py), in
either layout, and the FMG opening restricts and prolongs by blocks
(mg/cycle.py::fmg_iterate).
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.mg.cycle import (
    _zero_count,
    fmg_iterate,
    mg_cycle,
)
from hpcclassmultigridproject_tpu_torch.ops.cuda import routed
from hpcclassmultigridproject_tpu_torch.ops.padded import as_dtype
from hpcclassmultigridproject_tpu_torch.parallel.blocks import (
    coefs,
    interior_norm,
    neighbor_sum,
    residual,
)
from hpcclassmultigridproject_tpu_torch.utils.graphs import while_loop


def _correction(levels, r_lo, cfg: SolverConfig, shardings):
    """Solve A e = r approximately with one cycle from zero, in the working
    dtype."""
    return mg_cycle(levels, None, r_lo, cfg, u_is_zero=True,
                    shardings=shardings)


@routed
def refined_solve(levels, fine_hi, u, rhs, cfg: SolverConfig, r0=None,
                  shardings=None):
    """Solve A u = rhs with u, rhs and residuals in `fine_hi`'s dtype and
    the cycle corrections in `cfg.dtype`.  cycle_mode "adaptive" cycles
    until the relative residual is at most tol or `max_cycles` ran;
    "fixed" runs `cfg.num_cycles` cycles; "fmg" is "fixed" with a
    full-multigrid ascent as the first correction.  `r0` is the initial
    residual rhs − A·u when the caller has it.  The certificate norms run
    on the residual's `cfg.dtype` downcast, as in the JAX package.  Returns
    (u, stats) with stats on the device."""
    part = None if shardings is None else shardings[0]
    r = residual(fine_hi, u, rhs, part) if r0 is None else r0
    r_lo = r.to(cfg.dtype)
    res0 = interior_norm(r_lo, part)
    res0_safe = torch.clamp_min(res0, torch.finfo(res0.dtype).tiny)

    if cfg.cycle_mode in ("fixed", "fmg"):
        for k in range(cfg.num_cycles):
            if cfg.cycle_mode == "fmg" and k == 0:
                e = fmg_iterate(levels, r_lo, cfg, shardings)
            else:
                e = _correction(levels, r_lo, cfg, shardings)
            u = u + e.to(u.dtype)
            r_lo = residual(fine_hi, u, rhs, part).to(cfg.dtype)
        rel = interior_norm(r_lo, part) / res0_safe
        cycles = torch.full((), cfg.num_cycles, dtype=torch.int32,
                            device=u.device)
    else:
        def cond(carry):
            _, _, res, it = carry
            return (it < cfg.max_cycles) & (res / res0_safe > cfg.tol)

        def body(carry):
            u, r_lo, _, it = carry
            u = u + _correction(levels, r_lo, cfg, shardings).to(u.dtype)
            r_lo = residual(fine_hi, u, rhs, part).to(cfg.dtype)
            return u, r_lo, interior_norm(r_lo, part), it + 1

        u, r_lo, res, cycles = while_loop(
            cond, body, (u, r_lo, res0, _zero_count(u.device)))
        rel = res / res0_safe

    stats = {
        "cycles": cycles,
        "rel_residual": rel.to(torch.float32),
        "converged": rel <= cfg.tol,
    }
    return u, stats


@routed
def timestepper_refined_fused(levels, fine_hi, u0: torch.Tensor,
                              num_steps: int, cfg: SolverConfig,
                              shardings=None):
    """Refined fixed-cycle stepping with cross-step stencil fusion: the
    closing certificate of step t (rhs_t − A·u_{t+1}) and the opening of
    step t+1 (rhs = B·u, r0 = rhs − A·u) share one high-dtype neighbour
    sum of the current state.  The last step's certificate is one epilogue
    stencil.  Per-step stats mean what `refined_solve`'s do; needs
    cycle_mode "fixed"."""
    part = None if shardings is None else shardings[0]
    tiny = torch.finfo(torch.float32).tiny
    c_hi = coefs(fine_hi, part)
    d_a = c_hi.diagonal(u0.dtype)
    d_b = as_dtype(fine_hi.diag_b, u0.dtype)

    def cert(rhs, au):
        return interior_norm((rhs - au).to(cfg.dtype), part).to(
            torch.float32)

    u, rhs_prev, res0_prev = u0, None, None
    rels = []
    for _ in range(num_steps):
        # the one high-dtype stencil of the step
        ns = neighbor_sum(c_hi, u, part)
        au = d_a * u + ns
        if rhs_prev is not None:
            rels.append(cert(rhs_prev, au) / res0_prev)
        rhs = d_b * u - ns
        r_lo = (rhs - au).to(cfg.dtype)
        res0 = torch.clamp_min(interior_norm(r_lo, part).to(torch.float32),
                               tiny)
        for k in range(cfg.num_cycles):
            u = u + _correction(levels, r_lo, cfg, shardings).to(u.dtype)
            if k + 1 < cfg.num_cycles:
                r_lo = residual(fine_hi, u, rhs, part, c_hi).to(cfg.dtype)
        rhs_prev, res0_prev = rhs, res0
    last = residual(fine_hi, u, rhs_prev, part, c_hi).to(cfg.dtype)
    rels.append(interior_norm(last, part).to(torch.float32) / res0_prev)
    rel = torch.stack(rels)
    stats = {
        "cycles": torch.full((num_steps,), cfg.num_cycles, dtype=torch.int32,
                             device=u0.device),
        "rel_residual": rel,
        "converged": rel <= cfg.tol,
    }
    return u, stats
