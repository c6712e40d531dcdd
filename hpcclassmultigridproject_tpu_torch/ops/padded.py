"""Level operations on the padded layout (core/layout.py), in plain PyTorch.

These are the JAX package's `ops/padded.py` operations, and the building
blocks of every kernel's plain version.  All fields share one padded shape;
the stencil

    (A u) = diag·u + Σ,  (B u) = diag_b·u − Σ,
    Σ = cc·u_N + dd·u_S + aa·u_W + bb·u_E [+ ne·u_NE + nw·u_NW + se·u_SE + sw·u_SW]

takes its bands from `coefs(level)`: recomputed from (v1, v2) on a from_v
level, stored on a five- or nine-band level (mg/levels.py).  The diagonal
is the scalar diag_a, or on a nine-band level the stored varying `diag`.
Scalar constants (rr, h/2, ν, diag_a, 1/diag_a) are rounded to the working
dtype first, and every expression keeps the JAX package's operation order,
as the kernels do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.core.layout import (
    color_mask,
    interior_mask,
    shift,
)


# the numpy type of each floating dtype `as_dtype` rounds to
_NUMPY_FLOAT = {torch.float16: np.float16, torch.float32: np.float32,
                torch.float64: np.float64}


def as_dtype(x: float, dtype: torch.dtype) -> float:
    """A Python float rounded to `dtype` (a kernel's scalar constant), on
    the host by numpy's IEEE conversion: the same bits as a torch tensor of
    `dtype` would hold, with no tensor made and nothing read back."""
    return float(_NUMPY_FLOAT[dtype](x))


@dataclasses.dataclass(frozen=True)
class Coefs:
    """A level's stencil: the four edge bands, the corner bands (ne, nw,
    se, sw) of a nine-band level or None, and the diagonal (a tensor on a
    nine-band level, else None for the scalar `diag_a`)."""

    aa: torch.Tensor
    bb: torch.Tensor
    cc: torch.Tensor
    dd: torch.Tensor
    corners: Optional[tuple[torch.Tensor, ...]]
    diag: Optional[torch.Tensor]
    diag_a: float

    def diagonal(self, dtype: torch.dtype):
        """The diagonal of A: the stored array, or diag_a rounded to dtype."""
        return as_dtype(self.diag_a, dtype) if self.diag is None else self.diag


def _from_v_bands(level):
    """A maker of each band (aa, bb, cc, dd) of a from_v level, from its
    velocities, zero outside the open interior: a band is a whole field,
    made when its maker is called."""
    v1, v2 = level.v1, level.v2
    dt = v1.dtype
    rr = as_dtype(level.rr, dt)
    hh = as_dtype(0.5 * level.h, dt)
    nu = as_dtype(level.nu, dt)
    mask = interior_mask(level.n, level.padded, dtype=dt, device=v1.device,
                         row_off=level.row_off, col_off=level.col_off)
    return (lambda: rr * (-v2 * hh + nu) * mask,
            lambda: rr * (v2 * hh + nu) * mask,
            lambda: rr * (-v1 * hh + nu) * mask,
            lambda: rr * (v1 * hh + nu) * mask)


def coefs_from_v(level):
    """(aa, bb, cc, dd) recomputed from the level's velocities, zero
    outside the open interior."""
    return tuple(make() for make in _from_v_bands(level))


def coefs(level) -> Coefs:
    """The level's stencil, whatever its form: the from_v recompute or the
    stored bands."""
    if level.form == "from_v":
        return Coefs(*coefs_from_v(level), None, None, level.diag_a)
    corners = None if level.ne is None else (level.ne, level.nw, level.se,
                                             level.sw)
    return Coefs(level.aa, level.bb, level.cc, level.dd, corners, level.diag,
                 level.diag_a)


def neighbor_sum(c: Coefs, u: torch.Tensor) -> torch.Tensor:
    """Σ = cc·u[i−1,j] + dd·u[i+1,j] + aa·u[i,j−1] + bb·u[i,j+1], plus
    ne·u[i−1,j+1] + nw·u[i−1,j−1] + se·u[i+1,j+1] + sw·u[i+1,j−1] on a
    nine-band level."""
    s = (c.cc * shift(u, -1, 0) + c.dd * shift(u, 1, 0)
         + c.aa * shift(u, 0, -1) + c.bb * shift(u, 0, 1))
    if c.corners is not None:
        ne, nw, se, sw = c.corners
        s = (s + ne * shift(u, -1, 1) + nw * shift(u, -1, -1)
             + se * shift(u, 1, 1) + sw * shift(u, 1, -1))
    return s


def level_neighbor_sums(level, us) -> list:
    """`[neighbor_sum(coefs(level), u) for u in us]` to the bit, holding
    fewer whole fields at once: a from_v level's bands are made one at a
    time, each applied to every u and dropped after its products, and
    each sum's terms are added in place in the same order (the float64
    certificates and the epilogue of the delta form take this form: they
    hold a run's peak of device memory).  Each band is made once, however
    many the us."""
    if level.form != "from_v":
        c = coefs(level)
        return [neighbor_sum(c, u) for u in us]
    aa, bb, cc, dd = _from_v_bands(level)
    sums = [None] * len(us)
    # neighbor_sum's order: cc·u_N + dd·u_S + aa·u_W + bb·u_E
    for band, di, dj in ((cc, -1, 0), (dd, 1, 0), (aa, 0, -1), (bb, 0, 1)):
        b = band()
        for k, u in enumerate(us):
            term = b * shift(u, di, dj)
            if sums[k] is None:
                sums[k] = term
            else:
                sums[k] += term
            term = None
        b = None
    return sums


def apply_A(level, u: torch.Tensor, c: Coefs | None = None) -> torch.Tensor:
    """A·u = diag·u + Σ (u is zero outside the interior, so the diagonal
    term needs no mask)."""
    c = coefs(level) if c is None else c
    return c.diagonal(u.dtype) * u + neighbor_sum(c, u)


def apply_B(level, u: torch.Tensor) -> torch.Tensor:
    """Explicit CN operator B·u = diag_b·u − Σ."""
    return as_dtype(level.diag_b, u.dtype) * u - neighbor_sum(coefs(level), u)


def compute_rhs(level, u: torch.Tensor) -> torch.Tensor:
    """The CN right-hand side of a step from u: B·u."""
    return apply_B(level, u)


def rhs_and_residual0(level, u: torch.Tensor):
    """rhs = B·u and r0 = rhs − A·u from one neighbour sum."""
    c = coefs(level)
    ns = neighbor_sum(c, u)
    rhs = as_dtype(level.diag_b, u.dtype) * u - ns
    return rhs, rhs - c.diagonal(u.dtype) * u - ns


def residual(level, u, rhs, c: Coefs | None = None) -> torch.Tensor:
    """rhs − A·u; zero outside the interior by the layout invariant."""
    c = coefs(level) if c is None else c
    return rhs - c.diagonal(u.dtype) * u - neighbor_sum(c, u)


def interior_norm(res: torch.Tensor) -> torch.Tensor:
    """l2 norm over interior nodes, accumulated in at least float32.  The
    padding and boundary are exact zeros, so a full-array reduction equals
    the interior norm."""
    acc = res.to(torch.promote_types(res.dtype, torch.float32))
    return torch.sqrt(torch.sum(acc * acc))


def rb_gauss_seidel(level, u, rhs, c: Coefs | None = None) -> torch.Tensor:
    """One red–black Gauss–Seidel sweep: red = (i+j) even first, then black
    reading the fresh red values.  On a nine-band level the corner
    neighbours share the node's colour and are read at their values from
    before the pass."""
    c = coefs(level) if c is None else c
    inv_diag = _inv_diagonal(c, u.dtype)
    red = color_mask(u.shape, 0, device=u.device, row_off=level.row_off,
                     col_off=level.col_off)
    u = torch.where(red, (rhs - neighbor_sum(c, u)) * inv_diag, u)
    u = torch.where(~red, (rhs - neighbor_sum(c, u)) * inv_diag, u)
    return u


def _inv_diagonal(c: Coefs, dtype: torch.dtype):
    """1/diag: 1/diag_a rounded to dtype, or the reciprocal array."""
    return as_dtype(1.0 / c.diag_a, dtype) if c.diag is None else 1.0 / c.diag


def weighted_jacobi(level, u, rhs, omega: float = 1.0,
                    c: Coefs | None = None) -> torch.Tensor:
    """One weighted-Jacobi sweep, (1 − ω)·u + ω·(rhs − Σ)/diag."""
    c = coefs(level) if c is None else c
    jac = (rhs - neighbor_sum(c, u)) * _inv_diagonal(c, u.dtype)
    return (1.0 - omega) * u + omega * jac


def gershgorin_ratio(c: Coefs) -> torch.Tensor:
    """Σ_j|a_ij| / |d_i| at every node (|d_i|, so a positive ν cannot flip
    the bound's sign)."""
    rowsum = c.aa.abs() + c.bb.abs() + c.cc.abs() + c.dd.abs()
    if c.corners is not None:
        ne, nw, se, sw = c.corners
        rowsum = rowsum + ne.abs() + nw.abs() + se.abs() + sw.abs()
    diag = abs(c.diag_a) if c.diag is None else c.diag.abs()
    return rowsum / diag


def gershgorin_bound(level, c: Coefs | None = None) -> torch.Tensor:
    """Gershgorin bound on the spectrum of D⁻¹A: 1 + max Σ_j|a_ij| / |d_i|."""
    c = coefs(level) if c is None else c
    return 1.0 + torch.max(gershgorin_ratio(c))


def chebyshev_smooth(level, u, rhs, degree: int = 3,
                     lower_frac: float = 1.0 / 30.0, upper_frac: float = 1.1,
                     c: Coefs | None = None) -> torch.Tensor:
    """Degree-`degree` Chebyshev smoother on the Jacobi-preconditioned
    system D⁻¹A over [max(lower_frac·λ̂, 2 − λ̂), upper_frac·λ̂], λ̂ the
    Gershgorin bound (the lower end is Gershgorin's own lower bound where
    the operator is diagonally dominant), by the three-term recurrence on
    the residual."""
    c = coefs(level) if c is None else c
    lam = gershgorin_bound(level, c).to(u.dtype)
    # a tensor, so `inv_diag / theta` is one division (a Python float over
    # a tensor is taken as a reciprocal and a product)
    inv_diag = (torch.full((), 1.0 / c.diag_a, dtype=u.dtype,
                           device=u.device)
                if c.diag is None else 1.0 / c.diag)
    return chebyshev_steps(u, lambda v: residual(level, v, rhs, c), lam,
                           inv_diag, degree, lower_frac, upper_frac)


def chebyshev_steps(u, res_fn, lam, inv_diag, degree: int,
                    lower_frac: float, upper_frac: float) -> torch.Tensor:
    """The Chebyshev recurrence of `chebyshev_smooth` from u, given the
    residual map v -> rhs − A·v, the Gershgorin bound `lam` in u's dtype
    and 1/diag (a 0-d tensor or an array)."""
    lmax = upper_frac * lam
    lmin = torch.maximum(lower_frac * lam, 2.0 - lam)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    r = res_fn(u)
    d = (inv_diag / theta) * r
    u = u + d
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = res_fn(u)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (inv_diag * r)
        u = u + d
        rho = rho_new
    return u


def _fit(x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Crop or zero-pad a 2-D array to `shape` (top-left anchored)."""
    x = x[: shape[0], : shape[1]]
    return F.pad(x, (0, shape[1] - x.shape[1], 0, shape[0] - x.shape[0])
                 ).contiguous()


def restrict_inject(fine: torch.Tensor, coarse_shape) -> torch.Tensor:
    """Injection: coarse[I,J] = fine[2I,2J], zero where 2I or 2J is past
    the fine array.  Strided indexing: the JAX package's 0/1 column
    matmul works around a TPU lane stride that the GPU does not have."""
    return _fit(fine[::2, ::2], coarse_shape)


def restrict_inject_rows_decimated(dec: torch.Tensor,
                                   coarse_shape) -> torch.Tensor:
    """Finish an injection whose row decimation already happened in the
    smoother (its `residual_rows_decimated` output, dec = res[::2, :])."""
    return _fit(dec[:, ::2], coarse_shape)


def full_weighting_smooth(fine: torch.Tensor) -> torch.Tensor:
    """The 9-point smooth 1/16·[1 2 1; 2 4 2; 1 2 1] of full weighting, on
    the whole array."""
    return (
        4.0 * fine
        + 2.0 * (shift(fine, -1, 0) + shift(fine, 1, 0) + shift(fine, 0, -1)
                 + shift(fine, 0, 1))
        + shift(fine, -1, -1)
        + shift(fine, -1, 1)
        + shift(fine, 1, -1)
        + shift(fine, 1, 1)
    ) * (1.0 / 16.0)


def restrict_full_weighting(fine: torch.Tensor, coarse_shape,
                            n_coarse: int) -> torch.Tensor:
    """Full weighting: the 9-point smooth, then injection by strided
    indexing, with the coarse boundary ring masked back to zero."""
    coarse = restrict_inject(full_weighting_smooth(fine), coarse_shape)
    return coarse * interior_mask(n_coarse, coarse_shape, dtype=coarse.dtype,
                                  device=coarse.device)


def prolong_bilinear(coarse: torch.Tensor, fine_shape) -> torch.Tensor:
    """Bilinear prolongation by row then column interleaving:
    fine[2I,2J] = c, edge midpoints 0.5·(a+b), centers the column average
    of two row averages.  Needs a zero logical boundary ring on `coarse`
    (true of corrections), so the padding stays zero."""
    rows_odd = 0.5 * (coarse + shift(coarse, 1, 0))
    x = torch.stack([coarse, rows_odd], dim=1).reshape(
        2 * coarse.shape[0], coarse.shape[1])
    cols_odd = 0.5 * (x + shift(x, 0, 1))
    y = torch.stack([x, cols_odd], dim=2).reshape(x.shape[0], 2 * x.shape[1])
    return _fit(y, fine_shape)
