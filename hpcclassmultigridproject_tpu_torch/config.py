"""Configuration dataclasses, field for field the JAX package's
(`hpcclassmultigridproject_tpu/config.py`), with torch dtypes.

Defaults and validation are the reference package's.  The port runs every
single-device configuration: red–black Gauss–Seidel, weighted-Jacobi and
Chebyshev smoothing, V- and W-cycles, injection and full weighting, dense
and GS coarse solves, rediscretized and Galerkin coarse operators, and the
adaptive, fixed, FMG, refined and delta steppers; and each of them
partitioned over ranks by rows or in 2-D blocks (`parallel.distributed_run`,
in either `sharded_overlap` schedule).  `device_build` picks the host or the
device build of the model (models/advection_diffusion.py::use_device_build).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """The 2-D advection–diffusion problem on [0,1]^2 with Dirichlet BCs
    (u_t + v·∇u + ν∇²u = 0, ν passed negative)."""

    n: int = 256                  # finest grid: (n+1)^2 nodes, h = 1/n; power of 2
    nu: float = -4e-4             # diffusion parameter (negative by convention)
    x0: float = 0.2               # Gaussian IC center x
    y0: float = 0.4               # Gaussian IC center y
    sigma: float = 100.0          # Gaussian IC width
    kx: float = math.pi           # rotating-velocity wavenumbers
    ky: float = math.pi
    dt: Optional[float] = None    # default dx/10
    num_steps: int = 100          # T = 100*dt

    @property
    def dx(self) -> float:
        return 1.0 / self.n

    @property
    def dt_(self) -> float:
        return self.dt if self.dt is not None else self.dx / 10.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Multigrid solver parameters; see the JAX package for each field's
    meaning.  `backend` picks a solve's route (`ops.cuda.routed`): "auto"
    and "pallas" launch the hand-written kernels on CUDA tensors, in
    float32 and float64; "jnp" runs their plain PyTorch versions on every
    device.  CPU tensors run the plain versions under every backend."""

    num_levels: Optional[int] = None
    cycle_shape: int = 1
    niter: int = 3
    tol: float = 1e-6
    max_cycles: int = 50
    coarse_tol: float = 1e-5
    coarse_maxiter: int = 1000
    coarse_mode: str = "gs"
    smoother: str = "rbgs"
    jacobi_omega: float = 1.0
    cheby_degree: int = 3
    cheby_lower: float = 1.0 / 30.0
    cheby_upper: float = 1.1
    restriction: str = "inject"
    coarse_operator: str = "rediscretize"
    dtype: torch.dtype = torch.float32
    backend: str = "auto"
    cycle_mode: str = "adaptive"
    num_cycles: Optional[int] = 2
    refine_dtype: Optional[torch.dtype] = None
    delta_form: bool = False
    slim_hi_operator: Optional[bool] = None
    device_build: Optional[bool] = None
    sharded_overlap: bool = False
    certify_every: int = 0

    def __post_init__(self):
        _check = {
            "cycle_mode": ("adaptive", "fixed", "fmg"),
            "smoother": ("rbgs", "jacobi", "chebyshev"),
            "restriction": ("inject", "full"),
            "coarse_mode": ("gs", "dense"),
            "coarse_operator": ("rediscretize", "galerkin"),
            "backend": ("auto", "jnp", "pallas"),
        }
        for field, allowed in _check.items():
            val = getattr(self, field)
            if val not in allowed:
                raise ValueError(f"{field}={val!r} not in {allowed}")
        if self.delta_form and (
            self.refine_dtype is None or self.cycle_mode != "fixed"
        ):
            raise ValueError(
                "delta_form requires refine_dtype set and cycle_mode='fixed' "
                "(the f64 state accumulator and a static cycle count)"
            )
        if self.num_cycles is not None and self.num_cycles < 1:
            raise ValueError(
                f"num_cycles={self.num_cycles}: need >= 1, or None for the "
                "auto derivation (resolved_num_cycles)"
            )
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype={self.dtype}: need float32 or float64")
        if self.certify_every and not self.delta_form:
            warnings.warn(
                "certify_every is only honored by the delta stepper "
                "(delta_form=True); this configuration will compute no "
                "mid-run rigorous certificates",
                stacklevel=2,
            )

    def resolved_num_cycles(self, dt: float, nu: float, h: float) -> int:
        """Cycle count for fixed/delta modes when `num_cycles` is None: the
        smallest k whose predicted residual clears tol/2, from the
        diagonal-dominance model of the JAX package (same fit, same cap).
        Unlike the JAX package it warns when the cap of 6 cycles binds."""
        delta_dom = 4.0 * (0.5 * dt / (h * h)) * abs(nu)
        rel1 = max(1.2e-7, 4.0 * 1.58e-3 * delta_dom ** 6.82)
        target = self.tol / 2.0
        if rel1 >= 0.5:
            k = 6
        else:
            k = max(1, math.ceil(math.log(target) / math.log(rel1)))
        if self.niter < 3:
            k += 1
        if k > 6 or rel1 >= 0.5:
            warnings.warn(
                "resolved_num_cycles: outside the calibrated regime "
                f"(predicted one-cycle residual {rel1:.3g}); capped at 6 "
                "cycles",
                stacklevel=2,
            )
        return min(k, 6)

    def resolved_num_levels(self, n: int) -> int:
        if self.num_levels is not None:
            return self.num_levels
        # maxlvl = log2(N) - 4, so the coarsest grid is 32^2
        return max(int(math.log2(n)) - 4, 1)
