"""Galerkin coarse operators: A_c = R·A_f·P extracted to nine stencil bands,
the port of the JAX package's `sparse/galerkin.py`.

R·A·P of a 5-point operator under bilinear prolongation is a 9-point
operator, so a Galerkin coarse level is a nine-band level (mg/levels.py):
the four edge bands, the four corner bands and a diagonal that varies in
space (stored as 1 outside the open interior, so its reciprocal stays
finite).

Extraction uses period-3 comb probing: applying C = R∘A_f∘P to the nine
comb indicators e_{k,l}[I,J] = [I≡k (3)]·[J≡l (3)] recovers every stencil
entry exactly, since a radius-1 stencil sees one comb point of each class
in its neighbourhood.  Nine operator applications with the port's own
transfer and stencil ops, in the working dtype.

Red–black smoothing on a 9-point operator is not an exact two-colour
Gauss–Seidel (corner neighbours share the node's colour and are read at
their values from before the pass); it remains a valid smoother.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.core.layout import (
    interior_mask,
    padded_shape,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    Level,
    dense_interior_matrix,
    np_dtype,
)
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    apply_A,
    prolong_bilinear,
    restrict_full_weighting,
    restrict_inject,
)

# stencil offset -> Level band field name
_BANDS = {
    (0, -1): "aa",
    (0, 1): "bb",
    (-1, 0): "cc",
    (1, 0): "dd",
    (-1, 1): "ne",
    (-1, -1): "nw",
    (1, 1): "se",
    (1, -1): "sw",
}


def _index_planes(shape, device):
    r = torch.arange(shape[0], device=device)[:, None]
    c = torch.arange(shape[1], device=device)[None, :]
    return r, c


def _comb(shape, k: int, l: int, n: int, dtype, device) -> torch.Tensor:
    r, c = _index_planes(shape, device)
    comb = ((r % 3 == k) & (c % 3 == l)).to(dtype)
    return comb * interior_mask(n, shape, dtype=dtype, device=device)


def _extract_bands(fine: Level, restriction: str, nc: int) -> dict:
    """The eight bands and the diagonal of R·A_fine·P at coarse extent nc,
    in the fine level's dtype and on its device."""
    shape_c = padded_shape(nc)
    ref = fine.v1 if fine.aa is None else fine.aa
    dtype, device = ref.dtype, ref.device
    if restriction == "inject":
        restrict = lambda x: restrict_inject(x, shape_c)
    elif restriction == "full":
        restrict = lambda x: restrict_full_weighting(x, shape_c, nc)
    else:
        raise ValueError(f"unknown restriction {restriction!r}")

    probes = {}
    for k in range(3):
        for l in range(3):
            e = _comb(shape_c, k, l, nc, dtype, device)
            probes[(k, l)] = restrict(apply_A(fine, prolong_bilinear(
                e, fine.padded)))

    r, c = _index_planes(shape_c, device)
    mask_i = interior_mask(nc, shape_c, dtype=dtype, device=device)

    def band(di: int, dj: int) -> torch.Tensor:
        out = torch.zeros(shape_c, dtype=dtype, device=device)
        for (k, l), ce in probes.items():
            sel = ((r + di) % 3 == k) & ((c + dj) % 3 == l)
            out = torch.where(sel, ce, out)
        return out * mask_i

    fields = {name: band(di, dj) for (di, dj), name in _BANDS.items()}
    # ones outside the interior keep 1/diag finite
    fields["diag"] = torch.where(mask_i.bool(), band(0, 0),
                                 torch.ones_like(mask_i))
    return fields


def galerkin_coarse_level(fine: Level, restriction: str) -> Level:
    """The coarse nine-band level whose operator is R·A_fine·P, exactly for
    the port's restriction (`restriction`) and bilinear prolongation.
    Unlike the JAX package's, it carries no velocity fields: no consumer of
    a nine-band level reads them."""
    nc = fine.n >> 1
    return Level(
        v1=None, v2=None, a_inv=None, n=nc, h=fine.h * 2, dt=fine.dt,
        nu=fine.nu, diag_a=fine.diag_a, diag_b=fine.diag_b,
        **_extract_bands(fine, restriction, nc),
    )


def dense_interior_matrix_9pt(level: Level) -> np.ndarray:
    """Dense interior operator (float64) of a banded level: five-band with
    the scalar diag_a, or nine-band with its varying diagonal."""
    coef = {k: getattr(level, k).cpu().numpy()
            for k in (*_BANDS.values(), "diag")
            if getattr(level, k) is not None}
    return dense_interior_matrix(coef, level.n, level.diag_a)


def attach_dense_inverse(level: Level) -> Level:
    """The banded level with the dense inverse of its interior operator,
    inverted in float64 and cast to the level's dtype."""
    dtype = level.aa.dtype
    a_inv = np.linalg.inv(dense_interior_matrix_9pt(level)).astype(
        np_dtype(dtype))
    return dataclasses.replace(
        level, a_inv=torch.from_numpy(a_inv).to(level.aa.device))
