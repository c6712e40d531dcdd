"""The plain reference: Crank–Nicolson steps of the 2-D advection–diffusion
problem, each linear system solved by Jacobi iteration to round-off.

Written from the problem's formulas alone (the upstream project
soniareilly/HPCClassMultigridProject, multigrid.cpp:124-240): on the
(n+1)² node grid of [0,1]² with h = 1/n, zero Dirichlet boundary,

  v1 = −ky·sin(kx·x)·cos(ky·y),  v2 = kx·cos(kx·x)·sin(ky·y),
  r  = dt / (2h²),
  aa = r(−v2·h/2 + ν)  couples u[i, j−1],   bb = r(v2·h/2 + ν)  u[i, j+1],
  cc = r(−v1·h/2 + ν)  couples u[i−1, j],   dd = r(v1·h/2 + ν)  u[i+1, j],
  (A u)_ij = (1 − 4rν)·u_ij + Σ_ij,  (B u)_ij = (1 + 4rν)·u_ij − Σ_ij,

and each step solves A·u^{n+1} = B·u^n.  At the upstream's settings A is
strictly diagonally dominant, so Jacobi contracts the error in the max
norm by ρ = max Σ|bands| / (1 − 4rν) < 1 a sweep; the solve stops once a
sweep changes the iterate by no more than `rtol` of its size, which
bounds the error by ρ/(1 − ρ) times that.

Plain PyTorch on any device, in the dtype asked for (float64 for the
reference, float32 for the control).  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _no_tf32() -> None:
    """Matrix products in full float32 on the card (none are used here, but
    a float32 control must not be TF32 by accident)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class CNOperator:
    """The interior bands of A and B at one grid size, in `dtype`."""

    def __init__(self, n: int, nu: float, dt: float, kx: float = math.pi,
                 ky: float = math.pi, *, dtype=torch.float64, device="cpu"):
        _no_tf32()
        self.n, self.dtype = n, dtype
        h = 1.0 / n
        idx = torch.arange(1, n, dtype=torch.float64, device=device) * h
        x, y = idx[:, None], idx[None, :]
        v1 = -ky * torch.sin(kx * x) * torch.cos(ky * y)
        v2 = kx * torch.cos(kx * x) * torch.sin(ky * y)
        r = 0.5 * dt / (h * h)
        self.aa = (r * (-v2 * (0.5 * h) + nu)).to(dtype)
        self.bb = (r * (v2 * (0.5 * h) + nu)).to(dtype)
        self.cc = (r * (-v1 * (0.5 * h) + nu)).to(dtype)
        self.dd = (r * (v1 * (0.5 * h) + nu)).to(dtype)
        self.diag_a = 1.0 - 4.0 * r * nu
        self.diag_b = 1.0 + 4.0 * r * nu
        off = (self.aa.abs() + self.bb.abs() + self.cc.abs()
               + self.dd.abs()).max()
        self.rho = float(off) / self.diag_a
        if not self.rho < 1.0:
            raise ValueError(f"A is not diagonally dominant (ρ = "
                             f"{self.rho:.3g}): Jacobi would not converge")

    def neighbours(self, u: torch.Tensor) -> torch.Tensor:
        """Σ_ij on the interior block u ((n−1)², zero outside)."""
        p = F.pad(u, (1, 1, 1, 1))
        return (self.aa * p[1:-1, :-2] + self.bb * p[1:-1, 2:]
                + self.cc * p[:-2, 1:-1] + self.dd * p[2:, 1:-1])

    def solve(self, rhs: torch.Tensor, u: torch.Tensor, rtol: float,
              max_sweeps: int = 1000, check_every: int = 4) -> torch.Tensor:
        """A·u = rhs by Jacobi from the guess u, until a sweep moves the
        iterate by at most rtol·max|u|."""
        for sweep in range(1, max_sweeps + 1):
            new = (rhs - self.neighbours(u)) / self.diag_a
            if sweep % check_every == 0:
                moved = float((new - u).abs().max())
                if moved <= rtol * float(new.abs().max()):
                    return new
            u = new
        raise RuntimeError(f"Jacobi did not reach rtol {rtol:g} in "
                           f"{max_sweeps} sweeps")


def cn_run(u0: torch.Tensor, n: int, nu: float, dt: float, num_steps: int,
           kx: float = math.pi, ky: float = math.pi, *,
           dtype=torch.float64) -> torch.Tensor:
    """uT of `num_steps` CN steps from the logical (n+1)² field u0, on
    u0's device and in `dtype`; returns the logical (n+1)² field (boundary
    ring zero), in `dtype`."""
    op = CNOperator(n, nu, dt, kx, ky, dtype=dtype, device=u0.device)
    rtol = 4.0 * torch.finfo(dtype).eps
    u = u0[1:n, 1:n].to(dtype)
    for _ in range(num_steps):
        rhs = op.diag_b * u - op.neighbours(u)
        u = op.solve(rhs, u, rtol)
    return F.pad(u, (1, 1, 1, 1))


def gaussian(n: int, x0: float, y0: float, sigma: float, *,
             dtype=torch.float64, device="cpu") -> torch.Tensor:
    """exp(−σ·|x − (x0, y0)|²) on the (n+1)² nodes, boundary ring zero."""
    idx = torch.arange(n + 1, dtype=torch.float64, device=device) * (1.0 / n)
    x, y = idx[:, None], idx[None, :]
    u = torch.exp(-sigma * ((x - x0) ** 2 + (y - y0) ** 2))
    u[0, :] = u[-1, :] = 0.0
    u[:, 0] = u[:, -1] = 0.0
    return u.to(dtype)
