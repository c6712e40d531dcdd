"""Grid-level hierarchy: the `Level` type and its host builders.

A level holds what the from_v kernels read: the two velocity fields in
the padded layout (core/layout.py), the static CN parameters, and at the
coarsest level the dense inverse of the interior operator.  Unlike the JAX
package, no level stores the four coefficient fields aa..dd: every kernel
and every plain op on the port's path recomputes them from (v1, v2).

The build runs in numpy float64 like the JAX package's host build
(`mg/levels.py::build_hierarchy`): velocities are restricted by injection,
which for node-sampled analytic fields is exact sampling at coarse nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.core.layout import padded_shape


@dataclasses.dataclass(frozen=True)
class Level:
    """One grid level: (n+1)^2 nodes, h = 2^lvl / n_fine.  `v1`, `v2` have
    the padded shape; `a_inv` ((n-1)^2 square) is set at the coarsest level
    of a dense-coarse hierarchy only."""

    v1: torch.Tensor
    v2: torch.Tensor
    a_inv: Optional[torch.Tensor]
    n: int
    h: float
    dt: float
    nu: float
    diag_a: float
    diag_b: float

    @property
    def padded(self) -> tuple[int, int]:
        """Padded storage shape (the shape of every field at this level)."""
        return tuple(self.v1.shape)

    @property
    def rr(self) -> float:
        """r = dt / (2h²), the CN coefficient scale."""
        return 0.5 * self.dt / (self.h * self.h)


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def _diagonals(h, dt, nu):
    rr = 0.5 * dt / (h * h)
    return float(1.0 - 4.0 * rr * nu), float(1.0 + 4.0 * rr * nu)


def _np_pad_field(u: np.ndarray) -> np.ndarray:
    r, c = padded_shape(u.shape[0] - 1)
    return np.pad(u, ((0, r - u.shape[0]), (0, c - u.shape[1])))


def _np_restrict_inject(fine: np.ndarray, coarse_shape) -> np.ndarray:
    s = fine[::2, ::2][: coarse_shape[0], : coarse_shape[1]]
    return np.pad(
        s, ((0, coarse_shape[0] - s.shape[0]), (0, coarse_shape[1] - s.shape[1]))
    )


def _np_cn_coefficients(v1p, v2p, n, dt, nu, h):
    """CN coefficient fields, float64, zero outside the open interior:
    aa → u[i,j−1], bb → u[i,j+1], cc → u[i−1,j], dd → u[i+1,j]."""
    rr = 0.5 * dt / (h * h)
    half_h = 0.5 * h
    r = np.arange(v1p.shape[0])[:, None]
    c = np.arange(v1p.shape[1])[None, :]
    mask = (((r >= 1) & (r <= n - 1)) & ((c >= 1) & (c <= n - 1))).astype(
        np.float64)
    return {
        "aa": rr * (-v2p * half_h + nu) * mask,
        "bb": rr * (v2p * half_h + nu) * mask,
        "cc": rr * (-v1p * half_h + nu) * mask,
        "dd": rr * (v1p * half_h + nu) * mask,
    }


def dense_interior_matrix(coef: dict, n: int, diag_a: float) -> np.ndarray:
    """Dense interior operator A ((n-1)^2 square, float64) from padded
    coefficient fields; interior ordering p = (i-1)*(n-1) + (j-1)."""
    m = n - 1
    A = np.zeros((m * m, m * m))
    idx = np.arange(m * m)
    A[idx, idx] = diag_a
    ii, jj = np.divmod(idx, m)
    bands = {(0, -1): "aa", (0, 1): "bb", (-1, 0): "cc", (1, 0): "dd"}
    for (di, dj), name in bands.items():
        band = np.asarray(coef[name], np.float64)[1:n, 1:n]
        ok = (ii + di >= 0) & (ii + di <= m - 1) & (jj + dj >= 0) & (jj + dj <= m - 1)
        A[idx[ok], idx[ok] + di * m + dj] = band[ii[ok], jj[ok]]
    return A


def _dense_inverse(v1p, v2p, n, h, dt, nu, dtype) -> np.ndarray:
    """Inverse of the interior operator, built as the JAX package builds it
    (`sparse/galerkin.py::attach_dense_inverse`): the coefficients are
    rounded to the level's dtype first, then widened to float64 and
    inverted, then cast.  Inverting the unrounded float64 coefficients
    would differ in the last bits."""
    npd = np_dtype(dtype)
    coef = {k: v.astype(npd).astype(np.float64)
            for k, v in _np_cn_coefficients(v1p, v2p, n, dt, nu, h).items()}
    diag_a, _ = _diagonals(h, dt, nu)
    return np.linalg.inv(dense_interior_matrix(coef, n, diag_a)).astype(npd)


def _to_numpy64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def build_hierarchy(v1, v2, dt: float, nu: float, num_levels: int, *,
                    dtype: torch.dtype, device) -> tuple[Level, ...]:
    """Build the level tower from the finest logical (n+1)^2 velocity
    fields (torch tensors or numpy arrays); every level lands on `device`
    in `dtype`, and the coarsest carries its dense inverse (the port's
    only coarse solve so far)."""
    n = int(v1.shape[0]) - 1
    v1l = _np_pad_field(_to_numpy64(v1))
    v2l = _np_pad_field(_to_numpy64(v2))
    levels = []
    for lvl in range(num_levels):
        nl = n >> lvl
        if nl < 2:
            raise ValueError(
                f"num_levels={num_levels} too deep for n={n} (level {lvl} has n={nl})"
            )
        h = 1.0 / n * (1 << lvl)
        diag_a, diag_b = _diagonals(h, dt, nu)
        a_inv = None
        if lvl == num_levels - 1:
            a_inv = torch.from_numpy(
                _dense_inverse(v1l, v2l, nl, h, dt, nu, dtype)).to(device)
        levels.append(Level(
            v1=torch.from_numpy(v1l).to(device=device, dtype=dtype),
            v2=torch.from_numpy(v2l).to(device=device, dtype=dtype),
            a_inv=a_inv, n=nl, h=h, dt=dt, nu=nu,
            diag_a=diag_a, diag_b=diag_b,
        ))
        if lvl + 1 < num_levels:
            shape_c = padded_shape(nl >> 1)
            v1l = _np_restrict_inject(v1l, shape_c)
            v2l = _np_restrict_inject(v2l, shape_c)
    return tuple(levels)


def build_fine_level(v1, v2, dt: float, nu: float, *, dtype: torch.dtype,
                     device) -> Level:
    """The finest level alone at `dtype`: the high-precision operator of
    the delta stepper's certificates.  It stores (v1, v2) only, like the
    JAX package's slim form, and every consumer recomputes coefficients
    (bit-identical in IEEE float64)."""
    n = int(v1.shape[0]) - 1
    h = 1.0 / n
    diag_a, diag_b = _diagonals(h, dt, nu)
    as_dev = lambda a: torch.from_numpy(_np_pad_field(_to_numpy64(a))).to(
        device=device, dtype=dtype)
    return Level(v1=as_dev(v1), v2=as_dev(v2), a_inv=None, n=n, h=h,
                 dt=dt, nu=nu, diag_a=diag_a, diag_b=diag_b)
