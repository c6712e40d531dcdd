"""Red–black Gauss–Seidel and weighted Jacobi on logical (n+1)² fields, the
port of the JAX package's `ops/smoothers.py` (its oracle operations), in
plain PyTorch on any device.

Red = nodes with (i+j) even, updated first; black = (i+j) odd, updated
second and reading the fresh red values.  Each colour pass is a masked
update over the whole interior, in the JAX package's operation order.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.ops.padded import as_dtype
from hpcclassmultigridproject_tpu_torch.ops.stencil import neighbor_sum


def checkerboard(shape: tuple[int, int], parity: int, dtype=torch.bool,
                 device=None) -> torch.Tensor:
    """Interior-node colour mask: parity 0 → red ((i+j) even), 1 → black.

    Interior index (r, c) is node (i, j) = (r+1, c+1), so (i+j) % 2 ==
    (r+c) % 2."""
    r = torch.arange(shape[0], dtype=torch.int32, device=device)[:, None]
    c = torch.arange(shape[1], dtype=torch.int32, device=device)[None, :]
    return ((r + c) % 2 == parity).to(dtype)


def _set_interior(u: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
    out = u.clone()
    out[1:-1, 1:-1] = interior
    return out


def _color_pass(coef, u, rhs, mask):
    """One Gauss–Seidel half-sweep on the masked colour."""
    inv_diag = as_dtype(1.0 / coef.diag_a, u.dtype)
    update = (rhs[1:-1, 1:-1] - neighbor_sum(coef, u)) * inv_diag
    return _set_interior(u, torch.where(mask, update, u[1:-1, 1:-1]))


def rb_gauss_seidel(coef, u: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """One full red–black Gauss–Seidel sweep (red pass, then black)."""
    shape = (u.shape[0] - 2, u.shape[1] - 2)
    u = _color_pass(coef, u, rhs, checkerboard(shape, 0, device=u.device))
    return _color_pass(coef, u, rhs, checkerboard(shape, 1, device=u.device))


def weighted_jacobi(coef, u: torch.Tensor, rhs: torch.Tensor,
                    omega: float = 1.0) -> torch.Tensor:
    """One weighted-Jacobi sweep: (1 − ω)·u + ω·D⁻¹(rhs − Σ)."""
    dtype = u.dtype
    jac = ((rhs[1:-1, 1:-1] - neighbor_sum(coef, u))
           * as_dtype(1.0 / coef.diag_a, dtype))
    interior = (as_dtype(1.0 - omega, dtype) * u[1:-1, 1:-1]
                + as_dtype(omega, dtype) * jac)
    return _set_interior(u, interior)
