"""Poisson model family: −∆u = f on [0,1]² with homogeneous Dirichlet BCs,
the port of the JAX package's `models/poisson.py`.

The 5-point Laplacian is a five-band level (mg/levels.py):

    diag = 4/h²,  aa = bb = cc = dd = −1/h²

so every level's smoothing is K5 on the card.  `method="gs"` is the
precursor programs' smoother-only iteration; `method="mg"` the multigrid
solve.
"""

from __future__ import annotations

import dataclasses

import torch

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.core.layout import (
    crop_field,
    interior_mask,
    pad_field,
    padded_shape,
)
from hpcclassmultigridproject_tpu_torch.mg.cycle import (
    _zero_count,
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
from hpcclassmultigridproject_tpu_torch.utils import graphs


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

    On the card `solve("mg")` in every cycle_mode and `solve("gs")` are
    compiled programs, as the JAX model's `_jit_mg` and `_jit_gs` are:
    captured once as a CUDA graph and replayed (utils/graphs.py), the
    adaptive solve, the GS coarse solve and the "gs" iteration as
    conditional WHILE nodes (`utils.graphs.while_loop`).  "gs" is one
    program per (max_iters, check_every), the JAX `_jit_gs`'s static
    arguments.  On the CPU each runs eagerly; `last_run_compiled` and
    `last_run_reason` say which way the last solve ran and why.  Eager
    means calling `mg.cycle.mg_solve`, `mg_solve_fixed` or `fmg_solve`, or
    `_gs`, directly.
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
        self.programs = graphs.Programs()
        self.last_run_compiled, self.last_run_reason = False, None
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
        if method not in ("mg", "gs"):
            raise ValueError(f"unknown method {method!r}")
        reason = self.eager_reason(method)
        levels, cfg = self.levels, self.solver
        if method == "gs":
            key = ("gs", max_iters, check_every, cfg)

            def run(rhs, max_iters=max_iters):
                with backend_route(cfg.backend):
                    return self._gs(rhs, max_iters, check_every)

            def warm(rhs):  # one trip of check_every sweeps
                return run(rhs, check_every)
        else:
            key = ("mg", cfg)
            solve = {"fixed": mg_solve_fixed, "fmg": fmg_solve,
                     "adaptive": mg_solve}[cfg.cycle_mode]

            def run(rhs, cfg=cfg):
                return solve(levels, torch.zeros_like(rhs), rhs, cfg)

            def warm(rhs):  # one cycle
                return run(rhs, dataclasses.replace(cfg, num_cycles=1,
                                                    max_cycles=1))
        if reason is None:
            u, stats = self.programs(key, run, (self.rhs,), warm,
                                     keep=(levels,))
        else:
            u, stats = run(self.rhs)
        self.last_run_compiled, self.last_run_reason = reason is None, reason
        return crop_field(u, self.n), stats

    def eager_reason(self, method: str = "mg") -> str | None:
        """Why `solve(method)` runs eagerly, or None where it replays a
        captured program: only on the CPU."""
        if not graphs.on_card(self.device):
            return "the CPU was asked for: the function is called directly"
        return None

    def _gs(self, rhs, max_iters: int, check_every: int):
        """The precursors' iteration from u = 0: a `while_loop` over (u,
        res, iters) whose body is `check_every` sweeps (K5) and one
        residual norm, as the JAX package's `_jit_gs` tests it."""
        fine, tol = self.levels[0], self.solver.tol
        u = torch.zeros_like(rhs)
        res0 = interior_norm(residual(fine, u, rhs))

        def cond(carry):
            _, res, it = carry
            return (it < max_iters) & (res / res0 > tol)

        def body(carry):
            u, _, it = carry
            for _ in range(check_every):
                u, _ = fused_rb_sweeps(fine, u, rhs, 1)
            return (u, interior_norm(residual(fine, u, rhs)),
                    it + check_every)

        u, res, iters = graphs.while_loop(cond, body,
                                          (u, res0, _zero_count(u.device)))
        return u, {"iters": iters, "rel_residual": res / res0}
