"""Problem setup: the Gaussian initial condition and the rotating velocity
field, on the (n+1)x(n+1) node grid of [0,1]^2 with h = 1/n, u[i, j] with
i the x/row direction and j the y/col direction.

Built in numpy float64 exactly as the JAX package's host build
(`core/problem.py`), then cast once to the requested dtype.
"""

from __future__ import annotations

import numpy as np
import torch


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
