"""Delta (incremental) Crank–Nicolson stepping: float32 compute and storage,
float64 accuracy (the JAX package's `mg/delta.py`; see its docstring for
the derivation).

Each step solves A·δ = (B − A)·u^n in the working dtype and accumulates
u^{n+1} = u^n + δ.  The rhs is formed in difference form (every
subtraction between neighbouring values, so no catastrophic
cancellation), the state is a float32 pair u ≈ hi + lo accumulated by
TwoSum, and the step's certificate is ||rhs_δ − A δ|| / ||rhs_δ||.  Every
`certify_every`-th step also computes the step's true residual in the high
dtype, and the epilogue certifies the last step in the high dtype.

A Python loop replaces the JAX package's `lax.scan`; the statistics stay on
the device, so the loop never waits for the card.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.core.layout import interior_mask, shift
from hpcclassmultigridproject_tpu_torch.mg.cycle import mg_cycle
from hpcclassmultigridproject_tpu_torch.ops.cuda.delta_step import (
    fused_accumulate_open,
)
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    as_dtype,
    interior_norm,
    neighbor_sum_from_v,
    residual_from_v,
)


def difference_form_constants(level) -> tuple[float, float]:
    """(2rν, r·h) in double; the difference form rounds them to its dtype."""
    return 2.0 * level.rr * level.nu, level.rr * level.h


def _dform(x):
    """Σ(x_nb − x) and the two centred differences Δ_i x, Δ_j x."""
    up, dn = shift(x, -1, 0), shift(x, 1, 0)
    lf, rt = shift(x, 0, -1), shift(x, 0, 1)
    lap = (up - x) + (dn - x) + (lf - x) + (rt - x)
    return lap, dn - up, rt - lf


def delta_rhs(level, u_hi, u_lo=None):
    """(B − A)(hi + lo) = −2rν·lap(u) − r·h·(v1·Δ_i u + v2·Δ_j u), masked to
    the open interior, in the dtype of u_hi."""
    dtype = u_hi.dtype
    two_rnu, r_h = (as_dtype(c, dtype) for c in difference_form_constants(level))
    lap, di, dj = _dform(u_hi)
    if u_lo is not None:
        lap_l, di_l, dj_l = _dform(u_lo)
        lap, di, dj = lap + lap_l, di + di_l, dj + dj_l
    out = -(two_rnu * lap) - r_h * (level.v1 * di + level.v2 * dj)
    return out * interior_mask(level.n, u_hi.shape, dtype=dtype,
                               device=u_hi.device)


def _split_hi_lo(x, dtype):
    hi = x.to(dtype)
    lo = (x - hi.to(x.dtype)).to(dtype)
    return hi, lo


def _accumulate(hi, lo, d):
    """(hi, lo) + d by TwoSum (exact: t + err == hi + d) with a Fast2Sum
    renormalization, so |lo| stays within an ulp of hi."""
    t = hi + d
    bv = t - hi
    err = (hi - (t - bv)) + (d - bv)
    lo2 = lo + err
    hi2 = t + lo2
    lo3 = lo2 - (hi2 - t)
    return hi2, lo3


def _certify_hi(fine_hi, hi2, lo2, d, acc_dtype):
    """The step's true relative residual in the high dtype, by the delta
    identity rhs − A·u^{n+1} = (B−A)·u^n − A·δ: two high-dtype stencils."""
    u_prev = hi2.to(acc_dtype) + lo2.to(acc_dtype)
    rhs_d_hi = delta_rhs(fine_hi, u_prev)
    d_hi = d.to(acc_dtype)
    res_hi = rhs_d_hi - (fine_hi.diag_a * d_hi
                         + neighbor_sum_from_v(fine_hi, d_hi))
    rel = interior_norm(res_hi) / torch.clamp_min(
        interior_norm(rhs_d_hi), torch.finfo(rhs_d_hi.dtype).tiny)
    return rel.to(torch.float32)


def timestepper_delta(levels, fine_hi, u0: torch.Tensor, num_steps: int,
                      cfg: SolverConfig):
    """`num_steps` delta-form CN steps from the padded high-dtype state u0;
    returns (uT in the high dtype, per-step stats on the device).  The
    stats keys are the JAX package's."""
    fine = levels[0]
    tiny = torch.finfo(torch.float32).tiny
    acc_dtype = u0.dtype
    hi, lo = _split_hi_lo(u0, cfg.dtype)
    d_pend = torch.zeros_like(hi)
    seg = cfg.certify_every
    nseg = num_steps // seg if seg and num_steps >= seg else 0
    rels, conv, certs = [], [], []
    for t in range(num_steps):
        # invariant: u_t = hi + lo + d_pend; the opening folds d_pend in
        hi, lo, rhs_d = fused_accumulate_open(fine, hi, lo, d_pend)
        res0 = torch.clamp_min(interior_norm(rhs_d), tiny)
        d = None
        for k in range(cfg.num_cycles):
            if k == cfg.num_cycles - 1:
                d, r = mg_cycle(levels, d, rhs_d, cfg,
                                want_final_residual=True, u_is_zero=k == 0)
            else:
                d = mg_cycle(levels, d, rhs_d, cfg, u_is_zero=k == 0)
        rel = interior_norm(r) / res0
        rels.append(rel.to(torch.float32))
        conv.append(rel <= cfg.tol)
        d_pend = d
        if t < nseg * seg and t % seg == seg - 1:
            certs.append(_certify_hi(fine_hi, hi, lo, d_pend, acc_dtype))

    # epilogue: fold the last correction in the high dtype and certify the
    # last step there, by three independent stencils
    u_prev = hi.to(acc_dtype) + lo.to(acc_dtype)
    uT = u_prev + d_pend.to(acc_dtype)
    rhs_hi = fine_hi.diag_b * u_prev - neighbor_sum_from_v(fine_hi, u_prev)
    r_hi = residual_from_v(fine_hi, uT, rhs_hi)
    res0_hi = interior_norm(residual_from_v(fine_hi, u_prev, rhs_hi))
    rel_hi = interior_norm(r_hi) / torch.clamp_min(
        res0_hi, torch.finfo(res0_hi.dtype).tiny)

    device = u0.device
    stats = {
        "cycles": torch.full((num_steps,), cfg.num_cycles, dtype=torch.int32,
                             device=device),
        "rel_residual": torch.stack(rels),
        "converged": torch.stack(conv),
        "final_rel_residual_hi": rel_hi.to(torch.float32),
    }
    if cfg.certify_every:
        # per-step high-dtype certificates; -1 marks uncertified steps
        rels_hi = torch.full((num_steps,), -1.0, dtype=torch.float32,
                             device=device)
        if certs:
            idx = torch.arange(nseg, device=device) * seg + (seg - 1)
            rels_hi[idx] = torch.stack(certs)
        stats["rel_residual_hi_steps"] = rels_hi
        stats["certified"] = torch.where(rels_hi >= 0, rels_hi <= cfg.tol,
                                         True)
    return uT, stats
