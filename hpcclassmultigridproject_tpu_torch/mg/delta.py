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

With `shardings` (parallel/) a partitioned fine level, in either layout,
opens with the plain block ops (the TwoSum needs no halo, the delta rhs a
one-line halo of hi and lo on each side), not K1, as the JAX package's
sharded fine level does; the norms, the certificates and the epilogue run
in their block forms (parallel/blocks.py), and `fine_hi` is cut like
level 0 (its rows, or its 2-D window).

A whole fine level opens each step with K1 (`_FUSE_OPEN`), or under
`_FUSE_OPEN_SMOOTH` an eligible run with K8, the whole-step opening
(`step_open_smooth`), whose residual is row-decimated as
`mg/cycle.py::_RESTRICT_DEC` says.  Each switch is the JAX package's, read
at each call.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.core.layout import interior_mask, shift
from hpcclassmultigridproject_tpu_torch.mg import cycle
from hpcclassmultigridproject_tpu_torch.mg.cycle import _smooth_block, mg_cycle
from hpcclassmultigridproject_tpu_torch.ops.cuda import routed
from hpcclassmultigridproject_tpu_torch.ops.cuda.delta_step import (
    fused_accumulate_open,
    fused_open_presmooth,
)
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    as_dtype,
    prolong_bilinear,
    restrict_inject,
    restrict_inject_rows_decimated,
)
from hpcclassmultigridproject_tpu_torch.parallel import blocks

# Open each step of a whole fine level with K1
# (ops/cuda/delta_step.py::fused_accumulate_open): the TwoSum fold of the
# pending correction and the delta rhs in one pass, instead of
# `_accumulate` then `delta_rhs`; the two are equal to the bit.
_FUSE_OPEN = True

# Whole-step opening: fold the top level's zero-init pre-smooth block, with
# its residual (row-decimated under `_RESTRICT_DEC`), into the opening, so
# one kernel (K8, ops/cuda/delta_step.py::fused_open_presmooth) does the
# accumulate, the delta rhs and the pre-smooth in one pass over device
# memory; the separate kernels (K1, then K2) read (rhs_δ, v1, v2) again,
# and launch twice.  It applies with `_FUSE_OPEN` on, to one V-cycle per
# step under injection and red–black GS, on an unpartitioned from_v fine
# level with a coarser level below it; rhs_δ is still written, for the
# post-smooth and the certificate norm.  Off by default, as in the JAX
# package: whether it pays is decided by measured walls, not by the saved
# traffic alone.
_FUSE_OPEN_SMOOTH = False


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
                               device=u_hi.device, row_off=level.row_off,
                               col_off=level.col_off)


def _delta_rhs(level, part, u_hi, u_lo=None):
    """`delta_rhs` on this rank's block: a one-line halo of hi and lo."""
    if part is None:
        return delta_rhs(level, u_hi, u_lo)
    ext = blocks.extend([u_hi] if u_lo is None else [u_hi, u_lo], part)
    return blocks.inner(delta_rhs(blocks.halo_level(level, part), *ext),
                        part)


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


def _certify_hi(fine_hi, hi2, lo2, d, acc_dtype, part=None):
    """The step's true relative residual in the high dtype, by the delta
    identity rhs − A·u^{n+1} = (B−A)·u^n − A·δ: two high-dtype stencils."""
    u_prev = hi2.to(acc_dtype) + lo2.to(acc_dtype)
    rhs_d_hi = _delta_rhs(fine_hi, part, u_prev)
    d_hi = d.to(acc_dtype)
    res_hi = rhs_d_hi - (fine_hi.diag_a * d_hi + blocks.neighbor_sum(
        blocks.coefs(fine_hi, part), d_hi, part))
    rel = blocks.interior_norm(res_hi, part) / torch.clamp_min(
        blocks.interior_norm(rhs_d_hi, part), torch.finfo(rhs_d_hi.dtype).tiny)
    return rel.to(torch.float32)


def _open_smooth_eligible(levels, cfg: SolverConfig, part) -> bool:
    """The JAX package's gate for the whole-step opening, item for item."""
    return (_FUSE_OPEN_SMOOTH
            and _FUSE_OPEN
            and levels[0].form == "from_v"
            and part is None
            and cfg.num_cycles == 1
            and cfg.cycle_shape == 1
            and cfg.restriction == "inject"
            and cfg.smoother == "rbgs"
            and len(levels) > 1)


def step_open_smooth(levels, cfg: SolverConfig, hi, lo, d_pend):
    """One delta step whose opening is K8: the top level of its single
    V-cycle written out, the recursion below it run by `mg_cycle` at
    level 1 (the tower where eligible).  Returns (hi', lo', rhs_δ, δ,
    rhs_δ − A δ)."""
    fine = levels[0]
    dec = cycle._RESTRICT_DEC
    hi, lo, rhs_d, u1, r0 = fused_open_presmooth(
        fine, hi, lo, d_pend, cfg.niter, residual_rows_decimated=dec)
    if dec:
        rhs_c = restrict_inject_rows_decimated(r0, levels[1].padded)
    else:
        rhs_c = restrict_inject(r0, levels[1].padded)
    u_c = mg_cycle(levels, None, rhs_c, cfg, lvl=1, u_is_zero=True)
    corr = prolong_bilinear(u_c, fine.padded)
    d, r = _smooth_block(cfg, fine, u1, rhs_d, True, corr=corr)
    return hi, lo, rhs_d, d, r


@routed
def timestepper_delta(levels, fine_hi, u0: torch.Tensor, num_steps: int,
                      cfg: SolverConfig, shardings=None):
    """`num_steps` delta-form CN steps from the padded high-dtype state u0
    (this rank's block of it under `shardings`); returns (uT in the high
    dtype, per-step stats on the device).  The stats keys are the JAX
    package's, and every rank holds the same stats."""
    fine = levels[0]
    part = None if shardings is None else shardings[0]
    tiny = torch.finfo(torch.float32).tiny
    acc_dtype = u0.dtype
    hi, lo = _split_hi_lo(u0, cfg.dtype)
    d_pend = torch.zeros_like(hi)
    seg = cfg.certify_every
    nseg = num_steps // seg if seg and num_steps >= seg else 0
    open_smooth = _open_smooth_eligible(levels, cfg, part)
    rels, conv, certs = [], [], []
    for t in range(num_steps):
        # invariant: u_t = hi + lo + d_pend; the opening folds d_pend in
        if open_smooth:
            hi, lo, rhs_d, d, r = step_open_smooth(levels, cfg, hi, lo,
                                                   d_pend)
        else:
            if part is None and _FUSE_OPEN:
                hi, lo, rhs_d = fused_accumulate_open(fine, hi, lo, d_pend)
            else:
                hi, lo = _accumulate(hi, lo, d_pend)
                rhs_d = _delta_rhs(fine, part, hi, lo)
            d = None
            for k in range(cfg.num_cycles):
                if k == cfg.num_cycles - 1:
                    d, r = mg_cycle(levels, d, rhs_d, cfg,
                                    want_final_residual=True,
                                    u_is_zero=k == 0, shardings=shardings)
                else:
                    d = mg_cycle(levels, d, rhs_d, cfg, u_is_zero=k == 0,
                                 shardings=shardings)
        res0 = torch.clamp_min(blocks.interior_norm(rhs_d, part), tiny)
        rel = blocks.interior_norm(r, part) / res0
        rels.append(rel.to(torch.float32))
        conv.append(rel <= cfg.tol)
        d_pend = d
        if t < nseg * seg and t % seg == seg - 1:
            certs.append(_certify_hi(fine_hi, hi, lo, d_pend, acc_dtype,
                                     part))

    # epilogue: fold the last correction in the high dtype and certify the
    # last step there, by three independent stencils
    u_prev = hi.to(acc_dtype) + lo.to(acc_dtype)
    uT = u_prev + d_pend.to(acc_dtype)
    c_hi = blocks.coefs(fine_hi, part)
    rhs_hi = fine_hi.diag_b * u_prev - blocks.neighbor_sum(c_hi, u_prev, part)
    r_hi = blocks.residual(fine_hi, uT, rhs_hi, part, c_hi)
    res0_hi = blocks.interior_norm(
        blocks.residual(fine_hi, u_prev, rhs_hi, part, c_hi), part)
    rel_hi = blocks.interior_norm(r_hi, part) / torch.clamp_min(
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
