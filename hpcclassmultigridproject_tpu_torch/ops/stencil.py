"""The variable-coefficient 5-point stencil on logical (n+1)² fields, the
port of the JAX package's `ops/stencil.py`: its oracle operations, in plain
PyTorch on any device.

Conventions (shared with core.problem.CNCoefficients):
  * fields u, rhs, res: shape (n+1, n+1), u[i, j], Dirichlet boundary ring;
  * coefficient arrays aa/bb/cc/dd: interior shape (n-1, n-1);
  * every operation touches interior nodes only and emits a zero ring.

Each expression keeps the JAX package's operation order term for term, and
the scalar constants are rounded to the field's dtype first, as its weak
typing rounds them, so float64 results are the JAX package's to the bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.ops.padded import as_dtype


def _pad1(interior: torch.Tensor) -> torch.Tensor:
    """Embed an (n-1, n-1) interior field into (n+1, n+1) with a zero ring."""
    return F.pad(interior, (1, 1, 1, 1))


def neighbor_sum(coef, u: torch.Tensor) -> torch.Tensor:
    """Interior-shaped sum  cc·u[i−1,j] + dd·u[i+1,j] + aa·u[i,j−1] + bb·u[i,j+1],
    the off-diagonal part of A, B, the residual and the GS update."""
    return (coef.cc * u[:-2, 1:-1]
            + coef.dd * u[2:, 1:-1]
            + coef.aa * u[1:-1, :-2]
            + coef.bb * u[1:-1, 2:])


def apply_A(coef, u: torch.Tensor) -> torch.Tensor:
    """Implicit CN operator: (A u)_ij = diag_a·u_ij + neighbor_sum."""
    diag_a = as_dtype(coef.diag_a, u.dtype)
    return _pad1(diag_a * u[1:-1, 1:-1] + neighbor_sum(coef, u))


def apply_B(coef, u: torch.Tensor) -> torch.Tensor:
    """Explicit CN operator: (B u)_ij = diag_b·u_ij − neighbor_sum."""
    diag_b = as_dtype(coef.diag_b, u.dtype)
    return _pad1(diag_b * u[1:-1, 1:-1] - neighbor_sum(coef, u))


def compute_rhs(coef, u: torch.Tensor) -> torch.Tensor:
    """Per-timestep right-hand side rhs = B·u^n."""
    return apply_B(coef, u)


def residual(coef, u: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """res = rhs − A·u on the interior, zero ring."""
    diag_a = as_dtype(coef.diag_a, u.dtype)
    return _pad1(rhs[1:-1, 1:-1] - diag_a * u[1:-1, 1:-1]
                 - neighbor_sum(coef, u))


def interior_norm(res: torch.Tensor) -> torch.Tensor:
    """Unnormalized l2 norm over the interior nodes, the sum of squares
    accumulated in promote(dtype, float32)."""
    inner = res[1:-1, 1:-1].to(torch.promote_types(res.dtype, torch.float32))
    return torch.sqrt(torch.sum(inner * inner))
