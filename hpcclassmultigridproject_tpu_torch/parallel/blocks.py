"""The plain level ops on a rank's block of a row-partitioned level.

The JAX package has no such file: GSPMD inserts the halo exchanges,
all-reduces and reshards around every jnp op on a sharded array.  PyTorch
has no GSPMD, so here each op the steppers run on a partitioned level is
written out as SPMD over `torch.distributed`.  Every function takes the
level's partition `part` (parallel/sharding.py) last; with `part` None
(a replicated level, or one device) it is the op of ops/padded.py itself.

A block holds the rows [start, stop) of its field.  A stencil op takes a
one-row halo of its operand, runs the plain op on the (local + 2)-row
extended block, whose coefficients are the level's rows
[start − 1, stop + 1) (`mg/levels.py::level_rows`), and keeps the centre
rows: the same operations on the same values as on the whole field, so
the same bits.  A norm sums the squares of the owned rows only, then adds
the ranks' sums (`distributed.all_sum`): that is a different order of
addition from the single-device sum, the one result here that differs
from it in the last bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.core.layout import (
    color_mask,
    interior_mask,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import level_rows
from hpcclassmultigridproject_tpu_torch.ops import padded as P
from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
    all_gather_rows,
    all_sum,
    fit_rows,
)
from hpcclassmultigridproject_tpu_torch.parallel.rows_halo import (
    exchange,
    extend,
)


def halo_level(level, part):
    """The level on this rank's rows and one halo row on each side."""
    return level_rows(level, part.start - 1, part.stop + 1)


def coefs(level, part) -> P.Coefs:
    """The stencil on this rank's rows and their one-row halos."""
    return P.coefs(level if part is None else halo_level(level, part))


def neighbor_sum(c: P.Coefs, u, part):
    """Σ of `ops/padded.py::neighbor_sum` on the block's rows; `c` from
    `coefs(level, part)`."""
    if part is None:
        return P.neighbor_sum(c, u)
    (u_ext,) = extend([u], 1, part.mesh)
    return P.neighbor_sum(c, u_ext)[1:-1]


def residual(level, u, rhs, part, c: P.Coefs | None = None):
    """rhs − A·u on the block."""
    if part is None:
        return P.residual(level, u, rhs, c)
    c = coefs(level, part) if c is None else c
    return rhs - c.diagonal(u.dtype) * u - neighbor_sum(c, u, part)


def compute_rhs(level, u, part):
    """B·u on the block."""
    if part is None:
        return P.compute_rhs(level, u)
    c = coefs(level, part)
    return P.as_dtype(level.diag_b, u.dtype) * u - neighbor_sum(c, u, part)


def rhs_and_residual0(level, u, part):
    """rhs = B·u and r0 = rhs − A·u on the block, from one neighbour sum."""
    if part is None:
        return P.rhs_and_residual0(level, u)
    c = coefs(level, part)
    ns = neighbor_sum(c, u, part)
    rhs = P.as_dtype(level.diag_b, u.dtype) * u - ns
    return rhs, rhs - c.diagonal(u.dtype) * u - ns


def interior_norm(res, part):
    """The l2 norm of the whole field from this rank's block: the owned
    rows' sum of squares in the accumulation dtype, added over the ranks,
    then the square root; the same value on every rank."""
    if part is None:
        return P.interior_norm(res)
    acc = res.to(torch.promote_types(res.dtype, torch.float32))
    return torch.sqrt(all_sum(torch.sum(acc * acc), part.mesh))


def restrict(restriction: str, res, coarse, part, part_c):
    """The fine block's residual to the coarse level: this block's coarse
    rows (the partitions nest, parallel/sharding.py), which a replicated
    coarse level (`part_c` None) all-gathers: the agglomeration.  Full
    weighting takes a one-row halo."""
    shape = (part.local // 2, coarse.padded[1])
    if restriction == "inject":
        block = P.restrict_inject(res, shape)
    elif restriction == "full":
        (ext,) = extend([res], 1, part.mesh)
        block = P.restrict_inject(P.full_weighting_smooth(ext)[1:-1], shape)
        block = block * interior_mask(coarse.n, shape, dtype=block.dtype,
                                      device=block.device,
                                      row_off=part.start // 2)
    else:
        raise ValueError(f"unknown restriction {restriction!r}")
    if part_c is not None:
        return block
    return fit_rows(all_gather_rows(block, part.mesh), coarse.padded[0])


def prolong(coarse, fine_shape, part, part_c):
    """Bilinear prolongation onto the fine block.  It reads the block's
    coarse rows and the one below: a one-row halo from a partitioned
    coarse level, a slice of a replicated one."""
    if part is None:
        return P.prolong_bilinear(coarse, fine_shape)
    if part_c is None:
        first = part.start // 2
        rows = F.pad(coarse, (0, 0, 0, 1))[first:first + part.local // 2 + 1]
        src = fit_rows(rows, part.local // 2 + 1)
    else:
        ((_, below),) = exchange([coarse], 1, part_c.mesh)
        src = torch.cat([coarse, below])
    return P.prolong_bilinear(src, part.shape)


def rb_sweeps(level, u, rhs, nsweeps: int, part, zero_init: bool = False):
    """`nsweeps` red–black sweeps on a block too thin for the deep halo
    (fewer than 2h rows): a one-row exchange of u before each colour pass,
    the schedule GSPMD gives the JAX package's jnp smoother.  Levels with a
    scalar diagonal (a partitioned nine-band level is refused,
    parallel/__init__.py)."""
    c = P.coefs(halo_level(level, part))
    inv = P.as_dtype(1.0 / level.diag_a, rhs.dtype)
    if zero_init:
        u = torch.zeros_like(rhs)
    for _ in range(nsweeps):
        for parity in (0, 1):
            (u_ext,) = extend([u], 1, part.mesh)
            mask = color_mask(u.shape, parity, device=u.device,
                              row_off=part.start)
            u = torch.where(mask, (rhs - P.neighbor_sum(c, u_ext)[1:-1]) * inv,
                            u)
    return u
