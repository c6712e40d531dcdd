"""Restriction and prolongation on logical fields, the port of the JAX
package's `ops/transfer.py` (its oracle operations), in plain PyTorch on
any device.

Grid sizes: fine (2n+1)² ↔ coarse (n+1)²; coarse node (I, J) coincides
with fine node (2I, 2J).
"""

from __future__ import annotations

import torch


def restrict_inject(fine: torch.Tensor) -> torch.Tensor:
    """Injection: coarse[I, J] = fine[2I, 2J]."""
    return fine[::2, ::2].clone()


def restrict_full_weighting(fine: torch.Tensor) -> torch.Tensor:
    """Full weighting with the 1/16 [1 2 1; 2 4 2; 1 2 1] stencil at the
    interior coarse nodes; the boundary coarse nodes (Dirichlet) inject."""
    c = fine[::2, ::2].clone()
    center = fine[2:-2:2, 2:-2:2]
    edges = (fine[1:-2:2, 2:-2:2]
             + fine[3::2, 2:-2:2]
             + fine[2:-2:2, 1:-2:2]
             + fine[2:-2:2, 3::2])
    corners = (fine[1:-2:2, 1:-2:2]
               + fine[1:-2:2, 3::2]
               + fine[3::2, 1:-2:2]
               + fine[3::2, 3::2])
    c[1:-1, 1:-1] = (4.0 * center + 2.0 * edges + corners) * (1.0 / 16.0)
    return c


def prolong_bilinear(coarse: torch.Tensor) -> torch.Tensor:
    """Bilinear prolongation (n+1)² → (2n+1)²: coincident nodes copy, edge
    midpoints average two coarse values, cell centres four."""
    n = coarse.shape[0] - 1
    m = 2 * n + 1
    fine = torch.zeros((m, m), dtype=coarse.dtype, device=coarse.device)
    fine[::2, ::2] = coarse
    fine[1::2, ::2] = 0.5 * (coarse[:-1, :] + coarse[1:, :])
    fine[::2, 1::2] = 0.5 * (coarse[:, :-1] + coarse[:, 1:])
    fine[1::2, 1::2] = 0.25 * (coarse[:-1, :-1] + coarse[1:, :-1]
                               + coarse[:-1, 1:] + coarse[1:, 1:])
    return fine
