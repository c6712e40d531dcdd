"""Poisson model family: −∆u = f on [0,1]² with homogeneous Dirichlet BCs,
the port of the JAX package's `models/poisson.py`.

The 5-point Laplacian is a five-band level (mg/levels.py):

    diag = 4/h²,  aa = bb = cc = dd = −1/h²

so every level's smoothing is K5 on the card.  `method="gs"` is the
precursor programs' smoother-only iteration; `method="mg"` the multigrid
solve.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.core.layout import (
    crop_field,
    interior_mask,
    pad_field,
    padded_shape,
)
from hpcclassmultigridproject_tpu_torch.mg.cycle import (
    fmg_solve,
    mg_solve,
    mg_solve_fixed,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import BANDS, banded_level
from hpcclassmultigridproject_tpu_torch.ops.cuda import backend_route
from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import fused_rb_sweeps
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    interior_norm,
    residual,
)
from hpcclassmultigridproject_tpu_torch.sparse.galerkin import (
    attach_dense_inverse,
)


def poisson_level(n: int, h: float, *, dtype: torch.dtype, device):
    """The constant-coefficient 5-point Laplacian as a five-band level.
    Unlike the JAX package's, it carries no (zero) velocity fields: nothing
    reads them."""
    off = (-1.0 / (h * h)) * interior_mask(n, padded_shape(n),
                                           dtype=torch.float64, device="cpu")
    return banded_level(dict.fromkeys(BANDS, off), n=n, h=h, dt=0.0, nu=0.0,
                        diag_a=4.0 / (h * h), diag_b=0.0, dtype=dtype,
                        device=device)


def build_poisson_hierarchy(n: int, num_levels: int, *, dtype: torch.dtype,
                            device, coarse_mode: str = "gs"):
    levels = []
    for lvl in range(num_levels):
        nl = n >> lvl
        if nl < 2:
            raise ValueError(f"num_levels={num_levels} too deep for n={n}")
        levels.append(poisson_level(nl, (1.0 / n) * (1 << lvl), dtype=dtype,
                                    device=device))
    if coarse_mode == "dense":
        levels[-1] = attach_dense_inverse(levels[-1])
    return tuple(levels)


class Poisson:
    """−∆u = f solver on one device.

    >>> m = Poisson(n=128, f=lambda x, y: torch.ones_like(x))
    >>> u, stats = m.solve()            # multigrid
    >>> u, stats = m.solve(method="gs") # red–black GS alone

    `f` takes the node coordinates x, y as torch tensors in the solver's
    dtype and returns f on them; the default is f ≡ 1.  It runs on the
    card (`device="cuda"`, the default) or, asked for, on the CPU.
    """

    # The JAX package's defaults: full weighting and the dense coarse solve
    # (injection stalls on the pure Laplacian, and the absolute coarse
    # tolerance makes the GS coarse solve a no-op on correction equations).
    DEFAULT_SOLVER = SolverConfig(restriction="full", coarse_mode="dense")

    def __init__(self, n: int, f=None, solver: SolverConfig = DEFAULT_SOLVER,
                 *, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device")
        self.n = n
        self.solver = solver
        self.device = device
        self.num_levels = solver.resolved_num_levels(n)
        self.levels = build_poisson_hierarchy(
            n, self.num_levels, dtype=solver.dtype, device=device,
            coarse_mode=solver.coarse_mode)
        dtype = solver.dtype
        idx = torch.arange(n + 1, dtype=dtype, device=device) * (1.0 / n)
        x = idx[:, None] * torch.ones((1, n + 1), dtype=dtype, device=device)
        y = torch.ones((n + 1, 1), dtype=dtype, device=device) * idx[None, :]
        fv = torch.ones_like(x) if f is None else f(x, y)
        fv = fv * interior_mask(n, (n + 1, n + 1), dtype=dtype, device=device)
        self.rhs = pad_field(fv.to(dtype))

    def solve(self, method: str = "mg", max_iters: int = 100_000,
              check_every: int = 100):
        """Returns (u cropped to the logical grid, stats).  "mg": the
        solver's cycle_mode (adaptive, fixed or fmg) from u = 0.  "gs":
        red–black GS sweeps from u = 0 with a relative-residual check every
        `check_every` sweeps, at most `max_iters` sweeps; stats {"iters",
        "rel_residual"}."""
        u0 = torch.zeros_like(self.rhs)
        if method == "mg":
            solve = {"fixed": mg_solve_fixed, "fmg": fmg_solve,
                     "adaptive": mg_solve}[self.solver.cycle_mode]
            u, stats = solve(self.levels, u0, self.rhs, self.solver)
        elif method == "gs":
            with backend_route(self.solver.backend):
                u, stats = self._gs(u0, max_iters, check_every)
        else:
            raise ValueError(f"unknown method {method!r}")
        return crop_field(u, self.n), stats

    def _gs(self, u, max_iters: int, check_every: int):
        """The precursors' iteration: a host loop that reads the residual
        norm every `check_every` sweeps, as the JAX package's while_loop
        tests it."""
        fine, rhs, tol = self.levels[0], self.rhs, self.solver.tol
        res0 = interior_norm(residual(fine, u, rhs))
        res, iters = res0, 0
        while iters < max_iters and bool(res / res0 > tol):
            for _ in range(check_every):
                u, _ = fused_rb_sweeps(fine, u, rhs, 1)
            res = interior_norm(residual(fine, u, rhs))
            iters += check_every
        return u, {"iters": torch.tensor(iters, dtype=torch.int32,
                                         device=u.device),
                   "rel_residual": res / res0}
