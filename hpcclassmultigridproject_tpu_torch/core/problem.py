"""Problem setup: the Gaussian initial condition, the rotating velocity
field and the Crank–Nicolson coefficients, on the (n+1)x(n+1) node grid of
[0,1]^2 with h = 1/n, u[i, j] with i the x/row direction and j the y/col
direction.

Two builds of the fields, as in the JAX package (`core/problem.py`):

- the host build (`gaussian_u0`, `rotating_velocity`): numpy float64, then
  cast once to the requested dtype; the oracle;
- the device build (`rotating_velocity_trace`, `gaussian_u0_trace`,
  `gaussian_u0_padded_device`): the same formulas evaluated by torch on an
  explicit device from `torch.arange`, in float64, then cast.  It takes an
  optional global row window `rows=(start, stop)` and column window
  `cols=(start, stop)` of the padded array, so that a rank builds only its
  own part (parallel/); a window may start below 0 and end past the padded
  array, and every value outside the logical grid is 0.  It agrees with the host build to the ulp of sin, cos
  and exp, not to the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.core.layout import (
    interior_mask,
    padded_shape,
)


def _node_coords(n: int) -> tuple[np.ndarray, np.ndarray]:
    """x[i,j] = i*h, y[i,j] = j*h on the (n+1)^2 node grid, float64."""
    idx = np.arange(n + 1, dtype=np.float64) * (1.0 / n)
    x = idx[:, None] * np.ones((1, n + 1))
    y = np.ones((n + 1, 1)) * idx[None, :]
    return x, y


def gaussian_u0(n: int, x0: float = 0.2, y0: float = 0.4,
                sigma: float = 100.0, *, dtype, device) -> torch.Tensor:
    """Gaussian initial condition exp(-sigma·|x - x0|²), boundary ring 0."""
    x, y = _node_coords(n)
    u0 = np.exp(-sigma * ((x - x0) ** 2 + (y - y0) ** 2))
    u0[0, :] = 0.0
    u0[-1, :] = 0.0
    u0[:, 0] = 0.0
    u0[:, -1] = 0.0
    return torch.from_numpy(u0).to(device=device, dtype=dtype)


def rotating_velocity(n: int, kx: float = np.pi, ky: float = np.pi, *,
                      dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotating velocity field:

    v1 = -ky·sin(kx·x)·cos(ky·y)   (x/row component, couples i±1)
    v2 =  kx·cos(kx·x)·sin(ky·y)   (y/col component, couples j±1)
    """
    x, y = _node_coords(n)
    v1 = -ky * np.sin(kx * x) * np.cos(ky * y)
    v2 = kx * np.cos(kx * x) * np.sin(ky * y)
    return (torch.from_numpy(v1).to(device=device, dtype=dtype),
            torch.from_numpy(v2).to(device=device, dtype=dtype))


def _iota_coords(n: int, shape: tuple[int, int], *, device, rows=None,
                 cols=None):
    """(r, c, x, y): the global row indices of the window `rows` (default:
    every row of `shape`) as a column, the column indices of the window
    `cols` (default: every column) as a row, and their coordinates
    x = r·h, y = c·h in float64 (the host build's correctly rounded i·h
    products).  Fields are formed by broadcasting, so a formula of x alone
    is evaluated once a row."""
    start, stop = (0, shape[0]) if rows is None else rows
    c_start, c_stop = (0, shape[1]) if cols is None else cols
    r = torch.arange(start, stop, device=device)[:, None]
    c = torch.arange(c_start, c_stop, device=device)[None, :]
    h = 1.0 / n
    return r, c, r.to(torch.float64) * h, c.to(torch.float64) * h


def rotating_velocity_trace(n: int, kx: float, ky: float,
                            shape: tuple[int, int], *, dtype, device,
                            rows=None,
                            cols=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded rotating-velocity fields (the window `rows` x `cols` of
    them), 0 outside the logical (n+1)² node grid."""
    r, c, x, y = _iota_coords(n, shape, device=device, rows=rows, cols=cols)
    outside = (r < 0) | (r > n) | (c < 0) | (c > n)
    v1 = -ky * torch.sin(kx * x) * torch.cos(ky * y)
    v2 = kx * torch.cos(kx * x) * torch.sin(ky * y)
    return (v1.masked_fill_(outside, 0.0).to(dtype),
            v2.masked_fill_(outside, 0.0).to(dtype))


def gaussian_u0_trace(n: int, x0: float, y0: float, sigma: float,
                      shape: tuple[int, int], *, dtype, device,
                      rows=None, cols=None) -> torch.Tensor:
    """The padded Gaussian initial condition (the window `rows` x `cols`
    of it), 0 on the boundary ring and outside the logical grid."""
    r, c, x, y = _iota_coords(n, shape, device=device, rows=rows, cols=cols)
    outside = (r < 1) | (r > n - 1) | (c < 1) | (c > n - 1)
    dx, dy = x - x0, y - y0
    u0 = (dx * dx + dy * dy).mul_(-sigma).exp_()
    return u0.masked_fill_(outside, 0.0).to(dtype)


def gaussian_u0_padded_device(n: int, x0: float = 0.2, y0: float = 0.4,
                              sigma: float = 100.0, *, dtype, device,
                              rows=None, cols=None) -> torch.Tensor:
    """The device twin of pad_field(gaussian_u0(...)): the padded Gaussian
    initial condition built on `device`, or its global window `rows` x
    `cols`."""
    return gaussian_u0_trace(n, x0, y0, sigma, padded_shape(n), dtype=dtype,
                             device=device, rows=rows, cols=cols)


class CNCoefficients(NamedTuple):
    """The coefficient fields of the CN 5-point operators, with r =
    dt/(2h²):

      aa = r(−v2·h/2 + ν)  couples u[i, j−1]
      bb = r(+v2·h/2 + ν)  couples u[i, j+1]
      cc = r(−v1·h/2 + ν)  couples u[i−1, j]
      dd = r(+v1·h/2 + ν)  couples u[i+1, j]

    (A u)_ij = (1 − 4rν)·u_ij + Σ and (B u)_ij = (1 + 4rν)·u_ij − Σ, Σ the
    neighbour sum."""

    aa: torch.Tensor
    bb: torch.Tensor
    cc: torch.Tensor
    dd: torch.Tensor
    diag_a: float
    diag_b: float


def _cn(v1, v2, dt, nu, h, mask=None) -> CNCoefficients:
    rr = 0.5 * dt / (h * h)
    half_h = 0.5 * h
    bands = [rr * (-v2 * half_h + nu), rr * (v2 * half_h + nu),
             rr * (-v1 * half_h + nu), rr * (v1 * half_h + nu)]
    if mask is not None:
        bands = [b * mask for b in bands]
    return CNCoefficients(*bands, 1.0 - 4.0 * rr * nu, 1.0 + 4.0 * rr * nu)


def cn_coefficients(v1: torch.Tensor, v2: torch.Tensor, dt: float,
                    nu: float, h: float) -> CNCoefficients:
    """The coefficient fields at the interior nodes of logical (n+1)²
    velocity fields: arrays of shape (n−1, n−1), entry [i−1, j−1] at node
    (i, j); computed in the velocities' dtype."""
    return _cn(v1[1:-1, 1:-1], v2[1:-1, 1:-1], dt, nu, h)


def cn_coefficients_padded(v1_p: torch.Tensor, v2_p: torch.Tensor, n: int,
                           dt: float, nu: float, h: float) -> CNCoefficients:
    """The coefficient fields of padded velocity fields: the padded shape,
    0 outside the open interior; computed in the velocities' dtype."""
    mask = interior_mask(n, tuple(v1_p.shape), dtype=v1_p.dtype,
                         device=v1_p.device)
    return _cn(v1_p, v2_p, dt, nu, h, mask)
