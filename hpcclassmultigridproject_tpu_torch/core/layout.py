"""Padded field layout, the JAX package's (`core/layout.py`) kept as it is.

Every field lives on an array of shape
    (R, C) = (ceil((n+1)/8)·8, ceil((n+1)/128)·128)
with the logical (n+1)^2 node grid at [0:n+1, 0:n+1] and zeros elsewhere.
The port keeps the TPU's (8,128) padding for now so that every tensor
compares elementwise with the JAX package; a layout chosen for the GPU is
ROADMAP work.  Invariant: u / rhs / residual fields are zero outside the
open interior [1:n, 1:n], and so are the CN coefficients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ROW_TILE = 8
COL_TILE = 128


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_shape(n: int) -> tuple[int, int]:
    """Padded array shape for an (n+1)x(n+1) node grid."""
    return _ceil_to(n + 1, ROW_TILE), _ceil_to(n + 1, COL_TILE)


def pad_field(u: torch.Tensor) -> torch.Tensor:
    """Embed a logical (n+1)x(n+1) field into its padded array."""
    r, c = padded_shape(u.shape[0] - 1)
    return F.pad(u, (0, c - u.shape[1], 0, r - u.shape[0]))


def crop_field(u_p: torch.Tensor, n: int) -> torch.Tensor:
    """Extract the logical (n+1)x(n+1) field from a padded array."""
    return u_p[: n + 1, : n + 1]


def shift(u: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Same-shape shifted copy with zero fill: out[i, j] = u[i+di, j+dj],
    for |di|, |dj| <= 1."""
    if di == 1:
        u = F.pad(u[1:, :], (0, 0, 0, 1))
    elif di == -1:
        u = F.pad(u[:-1, :], (0, 0, 1, 0))
    if dj == 1:
        u = F.pad(u[:, 1:], (0, 1))
    elif dj == -1:
        u = F.pad(u[:, :-1], (1, 0))
    return u


def _index_planes(shape, device):
    r = torch.arange(shape[0], device=device)[:, None]
    c = torch.arange(shape[1], device=device)[None, :]
    return r, c


def interior_mask(n: int, shape: tuple[int, int], *, dtype=torch.bool,
                  device) -> torch.Tensor:
    """Mask of the open interior [1:n, 1:n] inside a padded array."""
    r, c = _index_planes(shape, device)
    inside = ((r >= 1) & (r <= n - 1)) & ((c >= 1) & (c <= n - 1))
    return inside.to(dtype)


def color_mask(shape: tuple[int, int], parity: int, *,
               device) -> torch.Tensor:
    """Red–black mask: (i+j) % 2 == parity in global indices (red = even)."""
    r, c = _index_planes(shape, device)
    return ((r + c) & 1) == parity
