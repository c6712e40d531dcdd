"""Level operations on the padded layout (core/layout.py), in plain PyTorch.

These are the JAX package's `ops/padded.py` operations that the port's
path needs, and the building blocks of every kernel's plain version.
All fields and velocities share one padded shape; the CN coefficients

    aa → u[i,j−1], bb → u[i,j+1], cc → u[i−1,j], dd → u[i+1,j],
    (A u) = diag_a·u + Σ,  Σ = cc·u_N + dd·u_S + aa·u_W + bb·u_E

are recomputed from (v1, v2) with the arithmetic of the kernels: the
constants rr, h/2, ν, diag_a and 1/diag_a are rounded to the working dtype
first, and every expression keeps the JAX package's operation order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.core.layout import (
    color_mask,
    interior_mask,
    shift,
)


def as_dtype(x: float, dtype: torch.dtype) -> float:
    """A Python float rounded to `dtype` (a kernel's scalar constant)."""
    return torch.tensor(x, dtype=dtype).item()


def coefs_from_v(level):
    """(aa, bb, cc, dd) recomputed from the level's velocities, zero
    outside the open interior."""
    v1, v2 = level.v1, level.v2
    dt = v1.dtype
    rr = as_dtype(level.rr, dt)
    hh = as_dtype(0.5 * level.h, dt)
    nu = as_dtype(level.nu, dt)
    mask = interior_mask(level.n, level.padded, dtype=dt, device=v1.device)
    aa = rr * (-v2 * hh + nu) * mask
    bb = rr * (v2 * hh + nu) * mask
    cc = rr * (-v1 * hh + nu) * mask
    dd = rr * (v1 * hh + nu) * mask
    return aa, bb, cc, dd


def neighbor_sum(coefs, u: torch.Tensor) -> torch.Tensor:
    """Σ = cc·u[i−1,j] + dd·u[i+1,j] + aa·u[i,j−1] + bb·u[i,j+1]."""
    aa, bb, cc, dd = coefs
    return (cc * shift(u, -1, 0) + dd * shift(u, 1, 0)
            + aa * shift(u, 0, -1) + bb * shift(u, 0, 1))


def neighbor_sum_from_v(level, u: torch.Tensor) -> torch.Tensor:
    """`neighbor_sum` with coefficients recomputed from (v1, v2)."""
    return neighbor_sum(coefs_from_v(level), u)


def residual_from_v(level, u, rhs, coefs=None) -> torch.Tensor:
    """rhs − A·u; zero outside the interior by the layout invariant."""
    if coefs is None:
        coefs = coefs_from_v(level)
    diag = as_dtype(level.diag_a, u.dtype)
    return rhs - diag * u - neighbor_sum(coefs, u)


def interior_norm(res: torch.Tensor) -> torch.Tensor:
    """l2 norm over interior nodes, accumulated in at least float32.  The
    padding and boundary are exact zeros, so a full-array reduction equals
    the interior norm."""
    acc = res.to(torch.promote_types(res.dtype, torch.float32))
    return torch.sqrt(torch.sum(acc * acc))


def rb_gauss_seidel(level, u, rhs, coefs=None) -> torch.Tensor:
    """One red–black Gauss–Seidel sweep: red = (i+j) even first, then black
    reading the fresh red values."""
    if coefs is None:
        coefs = coefs_from_v(level)
    inv_diag = as_dtype(1.0 / level.diag_a, u.dtype)
    red = color_mask(u.shape, 0, device=u.device)
    u = torch.where(red, (rhs - neighbor_sum(coefs, u)) * inv_diag, u)
    u = torch.where(~red, (rhs - neighbor_sum(coefs, u)) * inv_diag, u)
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
