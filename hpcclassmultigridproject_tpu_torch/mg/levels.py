"""Grid-level hierarchy: the `Level` type and its host builders.

A level comes in one of three forms, told apart by which fields are set:

- **from_v** (`aa` None): the two velocity fields in the padded layout
  (core/layout.py) and the static CN parameters; every kernel and plain op
  recomputes the coefficients from (v1, v2).  Rediscretized
  advection–diffusion levels and the high-precision fine operator.
- **five-band** (`aa..dd` set, `ne` and `diag` None): stored coefficient
  bands with the scalar diagonal `diag_a`.  Poisson levels.
- **nine-band** (`aa..dd`, `ne..sw` and `diag` set): a Galerkin R·A·P
  coarse operator (sparse/galerkin.py), with corner couplings and a
  diagonal that varies in space and is 1 outside the open interior.

A rank's block of a partitioned level (parallel/sharding.py) is a level
too: its fields hold the global rows [row_off, row_off + rows) and columns
[col_off, col_off + cols), and every op reads the offsets (`row_off`,
`col_off`, both 0 on a whole level; `col_off` is 0 in the rows layout).

Each level stores only what its form reads: from_v levels carry no bands,
banded levels no velocities.  The coarsest level of a dense-coarse
hierarchy also carries the dense inverse of its interior operator.

Two builds, as in the JAX package (`mg/levels.py`):

- the host build (`build_hierarchy`, `build_fine_level`) runs in numpy
  float64 and copies each level to the device: velocities are restricted
  by injection, which for node-sampled analytic fields is exact sampling
  at coarse nodes;
- the device build (`build_hierarchy_device`, `build_fine_level_device`)
  samples each level's (v1, v2) at its own nodes, in torch float64 on the
  device (core/problem.py), and copies nothing but the coarsest level's
  bands, to invert them on the host.  It takes a global row window, and
  in the 2-D layout a column window, per level, so that a rank builds only
  the part it keeps (parallel/).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.core.layout import padded_shape
from hpcclassmultigridproject_tpu_torch.core.problem import (
    cn_coefficients_padded,
    rotating_velocity_trace,
)

BANDS = ("aa", "bb", "cc", "dd")
CORNERS = ("ne", "nw", "se", "sw")


@dataclasses.dataclass(frozen=True)
class Level:
    """One grid level: (n+1)^2 nodes, h = 2^lvl / n_fine.  Every tensor has
    the padded shape, except `a_inv` ((n-1)^2 square), which is set at the
    coarsest level of a dense-coarse hierarchy only.  The stencil bands
    couple aa → u[i,j−1], bb → u[i,j+1], cc → u[i−1,j], dd → u[i+1,j],
    ne → u[i−1,j+1], nw → u[i−1,j−1], se → u[i+1,j+1], sw → u[i+1,j−1]."""

    v1: Optional[torch.Tensor]
    v2: Optional[torch.Tensor]
    a_inv: Optional[torch.Tensor]
    n: int
    h: float
    dt: float
    nu: float
    diag_a: float
    diag_b: float
    aa: Optional[torch.Tensor] = None
    bb: Optional[torch.Tensor] = None
    cc: Optional[torch.Tensor] = None
    dd: Optional[torch.Tensor] = None
    ne: Optional[torch.Tensor] = None
    nw: Optional[torch.Tensor] = None
    se: Optional[torch.Tensor] = None
    sw: Optional[torch.Tensor] = None
    diag: Optional[torch.Tensor] = None
    row_off: int = 0
    col_off: int = 0

    @property
    def form(self) -> str:
        """"from_v", "five" or "nine" (see the module docstring)."""
        if self.aa is None:
            return "from_v"
        return "five" if self.ne is None and self.diag is None else "nine"

    @property
    def padded(self) -> tuple[int, int]:
        """Padded storage shape (the shape of every field at this level)."""
        return tuple((self.v1 if self.aa is None else self.aa).shape)

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
    """Dense interior operator A ((n-1)^2 square, float64) from padded band
    fields: aa..dd, and for a nine-band level ne..sw and the varying
    `diag` (else the scalar `diag_a`).  Interior ordering
    p = (i-1)*(n-1) + (j-1)."""
    m = n - 1
    A = np.zeros((m * m, m * m))
    idx = np.arange(m * m)
    ii, jj = np.divmod(idx, m)
    diag = coef.get("diag")
    A[idx, idx] = (diag_a if diag is None
                   else np.asarray(diag, np.float64)[1:n, 1:n][ii, jj])
    offsets = {(0, -1): "aa", (0, 1): "bb", (-1, 0): "cc", (1, 0): "dd",
               (-1, 1): "ne", (-1, -1): "nw", (1, 1): "se", (1, -1): "sw"}
    for (di, dj), name in offsets.items():
        if coef.get(name) is None:
            continue
        band = np.asarray(coef[name], np.float64)[1:n, 1:n]
        ok = (ii + di >= 0) & (ii + di <= m - 1) & (jj + dj >= 0) & (jj + dj <= m - 1)
        A[idx[ok], idx[ok] + di * m + dj] = band[ii[ok], jj[ok]]
    return A


def stored_coefficients(v1p, v2p, n, h, dt, nu, dtype) -> dict:
    """The coefficient bands the JAX package stores on a rediscretized
    level: computed in float64 from the float64 velocities, rounded to the
    level's dtype, and widened back to float64.  In float32 these differ in
    the last bits from the port's from_v recompute, and the dense inverse
    and the Galerkin bands below a from_v level are built from them, as the
    JAX package builds them."""
    npd = np_dtype(dtype)
    return {k: v.astype(npd).astype(np.float64)
            for k, v in _np_cn_coefficients(v1p, v2p, n, dt, nu, h).items()}


def _to_numpy64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def banded_level(coef: dict, *, n, h, dt, nu, diag_a, diag_b, dtype,
                 device) -> Level:
    """A five- or nine-band level from numpy or torch band fields."""
    as_dev = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    fields = {k: as_dev(coef[k]) for k in (*BANDS, *CORNERS, "diag")
              if coef.get(k) is not None}
    return Level(v1=None, v2=None, a_inv=None, n=n, h=h, dt=dt, nu=nu,
                 diag_a=diag_a, diag_b=diag_b, **fields)


def _hierarchy_meta(n: int, num_levels: int) -> list[tuple[int, float]]:
    """(n, h) of every level, finest first."""
    meta = []
    for lvl in range(num_levels):
        nl = n >> lvl
        if nl < 2:
            raise ValueError(
                f"num_levels={num_levels} too deep for n={n} (level {lvl} has n={nl})"
            )
        meta.append((nl, 1.0 / n * (1 << lvl)))
    return meta


def build_hierarchy(v1, v2, dt: float, nu: float, num_levels: int, *,
                    dtype: torch.dtype, device, coarse_mode: str = "gs",
                    coarse_operator: str = "rediscretize",
                    restriction: str = "inject") -> tuple[Level, ...]:
    """Build the level tower from the finest logical (n+1)^2 velocity
    fields (torch tensors or numpy arrays); every level lands on `device`
    in `dtype`.

    coarse_operator "rediscretize" makes every level a from_v level on the
    injected velocities; "galerkin" builds each coarse level as the exact
    R·A·P product of the level above it (sparse/galerkin.py, nine-band;
    `restriction` selects R).  coarse_mode "dense" attaches the dense
    inverse of the coarsest interior operator; "gs" leaves it None."""
    from hpcclassmultigridproject_tpu_torch.sparse.galerkin import (
        galerkin_coarse_level,
    )

    n = int(v1.shape[0]) - 1
    meta = _hierarchy_meta(n, num_levels)
    v1l = _np_pad_field(_to_numpy64(v1))
    v2l = _np_pad_field(_to_numpy64(v2))
    levels, coef = [], None
    for lvl, (nl, h) in enumerate(meta):
        diag_a, diag_b = _diagonals(h, dt, nu)
        if lvl > 0 and coarse_operator == "galerkin":
            if lvl == 1:
                # extract from the fine level's stored bands, as the JAX
                # package does, not from its from_v recompute
                fine = banded_level(coef, n=n, h=1.0 / n, dt=dt, nu=nu,
                                    diag_a=levels[0].diag_a,
                                    diag_b=levels[0].diag_b, dtype=dtype,
                                    device="cpu")
            else:
                fine = levels[-1]
            level = galerkin_coarse_level(fine, restriction)
            coef = {k: _to_numpy64(getattr(level, k))
                    for k in (*BANDS, *CORNERS, "diag")}
        else:
            coef = stored_coefficients(v1l, v2l, nl, h, dt, nu, dtype)
            level = Level(
                v1=torch.from_numpy(v1l).to(dtype=dtype),
                v2=torch.from_numpy(v2l).to(dtype=dtype),
                a_inv=None, n=nl, h=h, dt=dt, nu=nu,
                diag_a=diag_a, diag_b=diag_b,
            )
        levels.append(level)
        if lvl + 1 < num_levels:
            shape_c = padded_shape(nl >> 1)
            v1l = _np_restrict_inject(v1l, shape_c)
            v2l = _np_restrict_inject(v2l, shape_c)
    if coarse_mode == "dense":
        levels[-1] = dataclasses.replace(levels[-1], a_inv=_dense_inverse(
            coef, levels[-1].n, levels[-1].diag_a, dtype))
    return tuple(to_device(level, device) for level in levels)


def _dense_inverse(coef: dict, n: int, diag_a: float, dtype) -> torch.Tensor:
    """The inverse of the dense interior operator of float64 band fields,
    inverted in float64 on the host and rounded to `dtype`."""
    a_inv = np.linalg.inv(dense_interior_matrix(coef, n, diag_a))
    return torch.from_numpy(a_inv.astype(np_dtype(dtype)))


def to_device(level: Level, device) -> Level:
    """The level with every tensor moved to `device`."""
    return dataclasses.replace(level, **{
        f.name: getattr(level, f.name).to(device)
        for f in dataclasses.fields(level)
        if isinstance(getattr(level, f.name), torch.Tensor)})


def level_window(level: Level, rows: tuple[int, int],
                 cols: tuple[int, int] | None = None) -> Level:
    """The level on its global rows [rows[0], rows[1]) and, given `cols`,
    its global columns [cols[0], cols[1]) (else its stored columns): every
    field of the stored shape cut to that window (zero where it passes the
    stored fields, and a nine-band diagonal of 1 there, as outside the
    interior), with `row_off` and `col_off` its origin.  Inside the stored
    fields the cut is a view; `a_inv` stays as it is."""
    r_lo, r_hi = rows[0] - level.row_off, rows[1] - level.row_off
    if cols is None:
        cols = (level.col_off, level.col_off + level.padded[1])
    c_lo, c_hi = cols[0] - level.col_off, cols[1] - level.col_off
    stored_r, stored_c = level.padded

    def cut(t, fill):
        if t is None:
            return t
        x = t[max(r_lo, 0):min(r_hi, stored_r),
              max(c_lo, 0):min(c_hi, stored_c)]
        pads = (max(-c_lo, 0), max(c_hi - stored_c, 0),
                max(-r_lo, 0), max(r_hi - stored_r, 0))
        return F.pad(x, pads, value=fill) if any(pads) else x

    fields = {k: cut(getattr(level, k), 0.0)
              for k in ("v1", "v2", *BANDS, *CORNERS)}
    return dataclasses.replace(level, row_off=rows[0], col_off=cols[0],
                               diag=cut(level.diag, 1.0), **fields)


def level_rows(level: Level, start: int, stop: int) -> Level:
    """`level_window` on the global rows [start, stop) and every stored
    column: the rows layout's cut."""
    return level_window(level, (start, stop))


def build_fine_level(v1, v2, dt: float, nu: float, *, dtype: torch.dtype,
                     device) -> Level:
    """The finest level alone at `dtype`: the high-precision operator of
    the refined and delta steppers.  It stores (v1, v2) only, like the
    JAX package's slim form, and every consumer recomputes coefficients
    (bit-identical in IEEE float64)."""
    n = int(v1.shape[0]) - 1
    h = 1.0 / n
    diag_a, diag_b = _diagonals(h, dt, nu)
    as_dev = lambda a: torch.from_numpy(_np_pad_field(_to_numpy64(a))).to(
        device=device, dtype=dtype)
    return Level(v1=as_dev(v1), v2=as_dev(v2), a_inv=None, n=n, h=h,
                 dt=dt, nu=nu, diag_a=diag_a, diag_b=diag_b)


# ---------------------------------------------------------------------------
# The device build.  The problem's fields are analytic, so each level's
# velocities are sampled at its own nodes (h = 2^lvl / n), which is what
# injection of the sampled fields gives; no level passes through the host.
# ---------------------------------------------------------------------------


def _device_cn_coefficients(v1p, v2p, *, n, dt, nu, h, dtype) -> dict:
    """The CN bands of padded velocity fields, computed in float64 on their
    device and rounded to `dtype`: the bands the host build stores."""
    coef = cn_coefficients_padded(v1p.to(torch.float64),
                                  v2p.to(torch.float64), n, dt, nu, h)
    return {k: getattr(coef, k).to(dtype) for k in BANDS}


def _device_dense_inverse(n, kx, ky, dt, nu, h, dtype, device):
    """The dense inverse of a level's interior operator, from the bands
    formed on `device` as `stored_coefficients` forms them (float64,
    rounded to `dtype`, widened) and inverted on the host, like the host
    build's."""
    v1, v2 = rotating_velocity_trace(n, kx, ky, padded_shape(n),
                                     dtype=torch.float64, device=device)
    coef = {k: _to_numpy64(b) for k, b in _device_cn_coefficients(
        v1, v2, n=n, dt=dt, nu=nu, h=h, dtype=dtype).items()}
    return _dense_inverse(coef, n, _diagonals(h, dt, nu)[0], dtype).to(device)


def build_hierarchy_device(n: int, kx: float, ky: float, dt: float,
                           nu: float, num_levels: int, *, dtype, device,
                           coarse_mode: str = "gs",
                           coarse_operator: str = "rediscretize",
                           rows=None, cols=None) -> tuple[Level, ...]:
    """`build_hierarchy` of the rotating velocity field, built on `device`:
    every level a from_v level whose (v1, v2) are sampled at its nodes in
    float64 and rounded to `dtype`.

    `rows` (optional) holds one entry per level: a global row window
    (start, stop) of that level's padded array, which is all the level
    then holds (with `row_off` = start, equal to `level_rows` of the whole
    level), or None for the whole level.  `cols` (optional, the 2-D
    layout) likewise holds a global column window per level, or None for
    every stored column (with `col_off` = its start; `level_window` of the
    whole level).  coarse_mode "dense" attaches the
    dense inverse of the whole coarsest level.  Galerkin coarse levels
    need the R·A·P product of the fine operator and raise ValueError, as
    in the JAX package."""
    if coarse_operator != "rediscretize":
        raise ValueError(
            "build_hierarchy_device supports coarse_operator='rediscretize' "
            "only (Galerkin R·A·P levels are built on the host)")
    meta = _hierarchy_meta(n, num_levels)
    rows = (None,) * num_levels if rows is None else tuple(rows)
    cols = (None,) * num_levels if cols is None else tuple(cols)
    if len(rows) != num_levels or len(cols) != num_levels:
        raise ValueError(f"{len(rows)} row and {len(cols)} column windows "
                         f"for {num_levels} levels")
    levels = []
    for (nl, h), r_win, c_win in zip(meta, rows, cols):
        levels.append(build_fine_level_device(
            nl, kx, ky, dt, nu, dtype=dtype, device=device, rows=r_win,
            cols=c_win, h=h))
    if coarse_mode == "dense":
        nl, h = meta[-1]
        levels[-1] = dataclasses.replace(levels[-1], a_inv=(
            _device_dense_inverse(nl, kx, ky, dt, nu, h, dtype, device)))
    return tuple(levels)


def build_fine_level_device(n: int, kx: float, ky: float, dt: float,
                            nu: float, *, dtype, device, rows=None,
                            cols=None, h: float | None = None) -> Level:
    """`build_fine_level` of the rotating velocity field, built on
    `device`: the slim (v1, v2) finest level in `dtype`, or its global row
    window `rows` and column window `cols` (with `row_off`, `col_off` their
    starts).  `h` (default 1/n) is a coarse level's own spacing, which the
    hierarchy passes."""
    h = 1.0 / n if h is None else h
    diag_a, diag_b = _diagonals(h, dt, nu)
    v1, v2 = rotating_velocity_trace(n, kx, ky, padded_shape(n), dtype=dtype,
                                     device=device, rows=rows, cols=cols)
    return Level(v1=v1, v2=v2, a_inv=None, n=n, h=h, dt=dt, nu=nu,
                 diag_a=diag_a, diag_b=diag_b,
                 row_off=0 if rows is None else rows[0],
                 col_off=0 if cols is None else cols[0])
