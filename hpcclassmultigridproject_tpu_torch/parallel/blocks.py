"""The plain level ops on a rank's block of a partitioned level, in both
layouts (parallel/sharding.py: `RowBlocks`, `GridBlocks`).

The JAX package has no such file: GSPMD inserts the halo exchanges,
all-reduces and reshards around every jnp op on a sharded array.  PyTorch
has no GSPMD, so here each op the steppers run on a partitioned level is
written out as SPMD over `torch.distributed`.  Every function takes the
level's partition `part` last; with `part` None (a replicated level, or
one device) it is the op of ops/padded.py itself.

A block holds the rows [start, stop) and the columns [col_start,
col_stop) of its field (every column in the rows layout).  A stencil op
extends its operand by a one-line halo on each side (`extend`), runs the
plain op on the extended block, whose coefficients are the level's window
one node wider on each side (`halo_level`, mg/levels.py::level_window),
and keeps the centre (`inner`): the same operations on the same values as
on the whole field, so the same bits.  In the rows layout the halo is one
row above and below, of the full width, so it carries a nine-band
stencil's diagonal neighbours too; in the 2-D layout the rows are
exchanged first and then the columns of the row-extended block, whose end
cells are the diagonal neighbours' corners.  A norm sums the squares of
the owned nodes only, then adds the ranks' sums in rank order
(`distributed.all_sum`): that is a different order of addition from the
single-device sum, the one result here that differs from it in the last
bits.  Chebyshev's Gershgorin bound is a max over the ranks
(`distributed.all_max`), exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.core.layout import (
    color_mask,
    interior_mask,
    padded_shape,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import level_window
from hpcclassmultigridproject_tpu_torch.ops import padded as P
from hpcclassmultigridproject_tpu_torch.parallel import rows_halo
from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
    all_gather_blocks,
    all_max,
    all_sum,
    assemble,
    fit,
    start_exchange,
)
from hpcclassmultigridproject_tpu_torch.parallel.sharding import GridBlocks


def is_grid(part) -> bool:
    """True iff `part` partitions a level in the 2-D layout."""
    return isinstance(part, GridBlocks)


def _cols(part, k: int):
    """The global columns of the block and k more on each side in the 2-D
    layout; None (every stored column) in the rows layout."""
    if not is_grid(part):
        return None
    return part.col_start - k, part.col_stop + k


def halo_level(level, part):
    """The level on this rank's block and one halo line on each side."""
    return level_window(level, (part.start - 1, part.stop + 1),
                        _cols(part, 1))


def block_level(level, part):
    """The level on this rank's block alone."""
    return level_window(level, (part.start, part.stop), _cols(part, 0))


def extend(xs, part):
    """Each block of `xs` with a one-line halo on each side: a row above
    and below in the rows layout; in the 2-D layout a row above and below
    (exchanged along "x"), then a column left and right of that
    row-extended block (along "y"), corners included."""
    mesh = part.mesh
    if not is_grid(part):
        return rows_halo.extend(xs, 1, mesh)
    up, down, left, right = mesh.neighbors
    pairs = start_exchange(xs, 1, mesh, [(0, up, down)]).wait()
    xs = [torch.cat([t, x, b]) for x, (t, b) in zip(xs, pairs)]
    pairs = start_exchange(xs, 1, mesh, [(1, left, right)]).wait()
    return [torch.cat([lf, x, rt], dim=1) for x, (lf, rt) in zip(xs, pairs)]


def inner(x, part):
    """The block of an extended one: without its one-line halo."""
    return x[1:-1, 1:-1] if is_grid(part) else x[1:-1]


def coefs(level, part) -> P.Coefs:
    """The stencil on this rank's block and its one-line halo."""
    return P.coefs(level if part is None else halo_level(level, part))


def neighbor_sum(c: P.Coefs, u, part):
    """Σ of `ops/padded.py::neighbor_sum` on the block (the corner terms
    too on a nine-band level); `c` from `coefs(level, part)`."""
    if part is None:
        return P.neighbor_sum(c, u)
    (u_ext,) = extend([u], part)
    return inner(P.neighbor_sum(c, u_ext), part)


def level_neighbor_sums(level, us, part) -> list:
    """`[neighbor_sum(coefs(level, part), u, part) for u in us]` to the
    bit, holding fewer whole fields at once and making each band once
    (`ops.padded.level_neighbor_sums`); the blocks' halos come in one
    exchange."""
    if part is None:
        return P.level_neighbor_sums(level, us)
    exts = extend(list(us), part)
    return [inner(s, part)
            for s in P.level_neighbor_sums(halo_level(level, part), exts)]


def _diagonal(c: P.Coefs, dtype, part):
    """A's diagonal on the block: diag_a, or the stored array's centre."""
    d = c.diagonal(dtype)
    return d if c.diag is None or part is None else inner(d, part)


def _inv_diagonal(c: P.Coefs, dtype, part):
    """1/diag on the block, as `ops/padded.py::_inv_diagonal`."""
    d = P._inv_diagonal(c, dtype)
    return d if c.diag is None or part is None else inner(d, part)


def residual(level, u, rhs, part, c: P.Coefs | None = None):
    """rhs − A·u on the block."""
    if part is None:
        return P.residual(level, u, rhs, c)
    c = coefs(level, part) if c is None else c
    return rhs - _diagonal(c, u.dtype, part) * u - neighbor_sum(c, u, part)


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
    return rhs, rhs - _diagonal(c, u.dtype, part) * u - ns


def interior_norm(res, part):
    """The l2 norm of the whole field from this rank's block: the owned
    nodes' sum of squares in the accumulation dtype, added over the ranks,
    then the square root; the same value on every rank."""
    if part is None:
        return P.interior_norm(res)
    acc = res.to(torch.promote_types(res.dtype, torch.float32))
    return torch.sqrt(all_sum(torch.sum(acc * acc), part.mesh))


def _coarse_shape(part, coarse):
    """The shape of this rank's block of the coarse level below `part`'s:
    half the block (the partitions nest), every coarse column in the rows
    layout."""
    if is_grid(part):
        return part.local // 2, part.local_cols // 2
    return part.local // 2, padded_shape(coarse.n)[1]


def restrict(restriction: str, res, coarse, part, part_c):
    """The fine block's residual to the coarse level: this block's coarse
    nodes (the partitions nest, parallel/sharding.py), which a replicated
    coarse level (`part_c` None) gathers from every rank: the
    agglomeration.  Full weighting takes a one-line halo."""
    shape = _coarse_shape(part, coarse)
    if restriction == "inject":
        block = P.restrict_inject(res, shape)
    elif restriction == "full":
        (ext,) = extend([res], part)
        block = P.restrict_inject(inner(P.full_weighting_smooth(ext), part),
                                  shape)
        block = block * interior_mask(
            coarse.n, shape, dtype=block.dtype, device=block.device,
            row_off=part.start // 2, col_off=part.col_start // 2)
    else:
        raise ValueError(f"unknown restriction {restriction!r}")
    if part_c is not None:
        return block
    return assemble(all_gather_blocks(block, part.mesh), part.grid,
                    padded_shape(coarse.n))


def prolong(coarse, fine_shape, part, part_c):
    """Bilinear prolongation onto the fine block.  It reads the block's
    coarse nodes and one more row below and (2-D layout) one more column
    to the right, with the corner between them: from a partitioned coarse
    level by an exchange, from a replicated one by a slice."""
    if part is None:
        return P.prolong_bilinear(coarse, fine_shape)
    rows = part.local // 2 + 1
    if part_c is None:
        r0 = part.start // 2
        if is_grid(part):
            c0, cols = part.col_start // 2, part.local_cols // 2 + 1
            src = fit(F.pad(coarse, (0, 1, 0, 1))[r0:r0 + rows,
                                                  c0:c0 + cols], rows, cols)
        else:
            src = fit(F.pad(coarse, (0, 0, 0, 1))[r0:r0 + rows], rows)
    elif is_grid(part):
        (ext,) = extend([coarse], part_c)
        src = ext[1:, 1:]
    else:
        ((_, below),) = rows_halo.exchange([coarse], 1, part_c.mesh)
        src = torch.cat([coarse, below])
    return P.prolong_bilinear(src, part.shape)


def rb_sweeps(level, u, rhs, nsweeps: int, part, zero_init: bool = False):
    """`nsweeps` red–black sweeps on the block with a one-line exchange of
    u before each colour pass: the schedule GSPMD gives the JAX package's
    jnp smoother.  It runs a rows-layout block too thin for the deep halo
    (fewer than 2h rows), and a partitioned nine-band level in either
    layout (its corner neighbours keep their values from before the pass,
    as in `ops/padded.py::rb_gauss_seidel`)."""
    c = coefs(level, part)
    inv = _inv_diagonal(c, rhs.dtype, part)
    if zero_init:
        u = torch.zeros_like(rhs)
    for _ in range(nsweeps):
        for parity in (0, 1):
            mask = color_mask(u.shape, parity, device=u.device,
                              row_off=part.start, col_off=part.col_start)
            u = torch.where(mask, (rhs - neighbor_sum(c, u, part)) * inv, u)
    return u


def weighted_jacobi(level, u, rhs, omega: float, part):
    """One weighted-Jacobi sweep on the block,
    (1 − ω)·u + ω·(rhs − Σ)/diag."""
    if part is None:
        return P.weighted_jacobi(level, u, rhs, omega)
    c = coefs(level, part)
    jac = (rhs - neighbor_sum(c, u, part)) * _inv_diagonal(c, u.dtype, part)
    return (1.0 - omega) * u + omega * jac


def gershgorin_bound(level, part):
    """`ops/padded.py::gershgorin_bound` of the whole level from this
    rank's block: the max over the ranks of the block's ratios."""
    if part is None:
        return P.gershgorin_bound(level)
    ratio = P.gershgorin_ratio(P.coefs(block_level(level, part)))
    return 1.0 + all_max(torch.max(ratio), part.mesh)


def chebyshev_smooth(level, u, rhs, degree: int, lower_frac: float,
                     upper_frac: float, part):
    """`ops/padded.py::chebyshev_smooth` on the block: the Gershgorin
    bound of the whole level, and each residual by `residual`."""
    if part is None:
        return P.chebyshev_smooth(level, u, rhs, degree, lower_frac,
                                  upper_frac)
    c = coefs(level, part)
    lam = gershgorin_bound(level, part).to(u.dtype)
    inv_diag = (torch.full((), 1.0 / c.diag_a, dtype=u.dtype,
                           device=u.device)
                if c.diag is None else inner(1.0 / c.diag, part))
    return P.chebyshev_steps(u, lambda v: residual(level, v, rhs, part, c),
                             lam, inv_diag, degree, lower_frac, upper_frac)
