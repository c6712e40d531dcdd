"""The explicit-matrix operator path, the port of the JAX package's
`sparse/matrix.py`: a level's interior operator assembled as a torch
sparse COO or CSR matrix, and the SpMV apply and residual, which agree
with the stencil ops of ops/padded.py.

The matrix is for generality (operators that are not 5- or 9-point
stencils, external matrices), not speed: the stencil path reads the bands
with no gathers.  On the card the product is cuSPARSE's, a library call,
as the JAX package's BCOO product is an XLA op.

The bands are the level's stored ones; a from_v level stores none, so its
bands are formed as the host build stores them (mg/levels.py::
stored_coefficients: float64 from the level's velocities, rounded to the
level's dtype).  Interior ordering as mg/levels.py::dense_interior_matrix:
row-major p = (i−1)·(n−1) + (j−1).
"""

from __future__ import annotations

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.mg.levels import (
    BANDS,
    CORNERS,
    Level,
    stored_coefficients,
)

_OFFS_5 = {(0, -1): "aa", (0, 1): "bb", (-1, 0): "cc", (1, 0): "dd"}
_OFFS_9 = {(-1, 1): "ne", (-1, -1): "nw", (1, 1): "se", (1, -1): "sw"}


def _numpy64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _bands(level: Level) -> dict:
    """The level's bands (and a nine-band level's diagonal) in numpy
    float64, padded shape."""
    if (level.row_off or level.col_off
            or min(level.padded) < level.n + 1):
        raise ValueError("the explicit matrix takes a whole level, not a "
                         "rank's block")
    if level.form == "from_v":
        return stored_coefficients(_numpy64(level.v1), _numpy64(level.v2),
                                   level.n, level.h, level.dt, level.nu,
                                   level.v1.dtype)
    return {k: _numpy64(getattr(level, k)) for k in (*BANDS, *CORNERS, "diag")
            if getattr(level, k) is not None}


def _coo_entries(level: Level):
    """(rows, cols, vals) numpy triplets of the interior operator."""
    n = level.n
    m = n - 1
    idx = np.arange(m * m)
    ii, jj = np.divmod(idx, m)
    bands = _bands(level)

    rows, cols = [idx], [idx]
    vals = [np.full(m * m, level.diag_a) if bands.get("diag") is None
            else bands["diag"][1:n, 1:n].ravel()]
    offs = dict(_OFFS_5)
    if "ne" in bands:
        offs.update(_OFFS_9)
    for (di, dj), name in offs.items():
        band = bands[name][1:n, 1:n]
        ok = ((ii + di >= 0) & (ii + di <= m - 1) & (jj + dj >= 0)
              & (jj + dj <= m - 1))
        rows.append(idx[ok])
        cols.append(idx[ok] + di * m + dj)
        vals.append(band[ii[ok], jj[ok]])
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def _level_dtype(level: Level) -> torch.dtype:
    return (level.v1 if level.aa is None else level.aa).dtype


def level_to_bcoo(level: Level, dtype=None) -> torch.Tensor:
    """The interior operator as a coalesced sparse COO matrix
    ((n−1)², (n−1)²) on the level's device, in `dtype` (default: the
    level's)."""
    rows, cols, vals = _coo_entries(level)
    device = (level.v1 if level.aa is None else level.aa).device
    m2 = (level.n - 1) ** 2
    return torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows, cols])),
        torch.from_numpy(vals).to(dtype or _level_dtype(level)),
        (m2, m2), check_invariants=True).coalesce().to(device)


def level_to_bcsr(level: Level, dtype=None) -> torch.Tensor:
    """The interior operator as a sparse CSR matrix."""
    return level_to_bcoo(level, dtype).to_sparse_csr()


def spmv_apply(mat: torch.Tensor, level: Level,
               u_padded: torch.Tensor) -> torch.Tensor:
    """A·u by SpMV on the explicit matrix: u in the padded layout, the
    result in it too (0 on the boundary ring and the margins)."""
    n = level.n
    m = n - 1
    flat = u_padded[1:n, 1:n].reshape(m * m, 1)
    out = torch.zeros_like(u_padded)
    out[1:n, 1:n] = (mat @ flat).reshape(m, m)
    return out


def spmv_residual(mat: torch.Tensor, level: Level, u_padded: torch.Tensor,
                  rhs_padded: torch.Tensor) -> torch.Tensor:
    """rhs − A·u by SpMV: the explicit-matrix residual."""
    return rhs_padded - spmv_apply(mat, level, u_padded)
