"""Explicit halo-exchange smoothing of a 2-D block, the port of the JAX
package's `parallel/halo.py`.

Each rank holds a block of a level partitioned in the 2-D layout
(parallel/sharding.py::GridBlocks): rows over the mesh's "x" axis, columns
over its "y" axis.  A red–black colour pass reads one cell beyond the
block on each of its four sides, so each pass first exchanges the block's
four edge lines with the neighbours on the mesh (`_start_halo`, the JAX
package's four `_from_prev` / `_from_next` ppermutes, posted as one batch
of sends and receives); a rank with no neighbour on a side receives
zeros, as `ppermute` leaves it, which is what the padded layout holds
past the grid's edges, so edge ranks are no special case.  Two exchange
rounds a sweep: black reads the freshly updated red halo lines.

Two schedules, both the JAX package's:

  * plain (`_sweep_local`): exchange, then the pass on the block from its
    four shifted views (`_halo_shifts`);
  * overlapped (`_sweep_local_overlapped`, `SolverConfig.sharded_overlap`
    in the 2-D layout): post the exchange, update the block from local
    shifts (zero past the block's edges) while the lines are in flight,
    wait, then recompute the four border lines with the received halos in
    the plain sweep's term order (cc, dd, aa, bb), so both give the same
    bits.

The stencil is the 5-point one (a five-band or from_v level; a
nine-band level raises, as in the JAX package: it reads the diagonal
neighbours, which `parallel/blocks.py::rb_sweeps` exchanges).  Every
expression keeps the order of `ops/padded.py::rb_gauss_seidel` and
`residual`, so a distributed sweep equals the single-device one to the
bit; the norm `smooth_distributed` returns adds the ranks' sums of
squares in rank order (`distributed.all_sum`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.core.layout import color_mask
from hpcclassmultigridproject_tpu_torch.mg.levels import level_window
from hpcclassmultigridproject_tpu_torch.ops import padded as P
from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
    Exchange,
    all_sum,
    start_exchange,
)


def _start_halo(u: torch.Tensor, mesh) -> Exchange:
    """Post the four one-cell edge exchanges of the block u: its first row
    to the rank above and last row to the rank below (the JAX package's
    `_from_next(u[:1, :], x)` and `_from_prev(u[-1:, :], x)`), its first
    and last columns to the ranks left and right; `wait()` gives
    [(top, bottom), (left, right)], the neighbours' adjacent lines."""
    up, down, left, right = mesh.neighbors
    return start_exchange([u], 1, mesh, [(0, up, down), (1, left, right)])


def _halo_shifts(u: torch.Tensor, mesh):
    """The four one-cell shifted views of the global field on the block:
    (up, down, left, right) with up[i, j] = u_global[i−1, j] and so on,
    from the block and the exchanged halo lines."""
    (top, bot), (lef, rig) = _start_halo(u, mesh).wait()
    up = torch.cat([top, u[:-1, :]])
    dn = torch.cat([u[1:, :], bot])
    lf = torch.cat([lef, u[:, :-1]], dim=1)
    rt = torch.cat([u[:, 1:], rig], dim=1)
    return up, dn, lf, rt


def _origin(u: torch.Tensor, mesh) -> tuple[int, int]:
    """The block's global origin: its mesh coordinates times its shape
    (the blocks are even), the JAX package's `_local_color_mask`."""
    i, j = mesh.coords
    return i * u.shape[0], j * u.shape[1]


def _mask(u: torch.Tensor, parity: int, origin) -> torch.Tensor:
    return color_mask(u.shape, parity, device=u.device, row_off=origin[0],
                      col_off=origin[1])


def _sweep_local(c: P.Coefs, u, rhs, mesh, origin):
    """One red–black sweep on the block with explicit halos."""
    inv_diag = P._inv_diagonal(c, u.dtype)
    for parity in (0, 1):
        up, dn, lf, rt = _halo_shifts(u, mesh)
        nb = c.cc * up + c.dd * dn + c.aa * lf + c.bb * rt
        u = torch.where(_mask(u, parity, origin), (rhs - nb) * inv_diag, u)
    return u


def _residual_local(c: P.Coefs, u, rhs, mesh):
    """rhs − A·u on the block."""
    up, dn, lf, rt = _halo_shifts(u, mesh)
    nb = c.cc * up + c.dd * dn + c.aa * lf + c.bb * rt
    return rhs - c.diagonal(u.dtype) * u - nb


def _sweep_local_overlapped(c: P.Coefs, u, rhs, mesh, origin):
    """One red–black sweep whose exchanges overlap the block's interior
    update: each colour pass posts the four edge exchanges first, updates
    the block from local shifts (zero past its edges) while they are in
    flight, then rewrites the four border lines from the received halos in
    the plain sweep's term order.  Equal to `_sweep_local` to the bit."""
    inv_diag = P._inv_diagonal(c, u.dtype)
    aa, bb, cc, dd = c.aa, c.bb, c.cc, c.dd
    cat = torch.cat
    r0, rn = slice(0, 1), slice(-1, None)
    for parity in (0, 1):
        # 1) the halo exchange, in flight during step 2
        halos = _start_halo(u, mesh)
        # 2) the update from local shifts; the border lines are rewritten
        #    in step 3
        up_l = F.pad(u[:-1, :], (0, 0, 1, 0))
        dn_l = F.pad(u[1:, :], (0, 0, 0, 1))
        lf_l = F.pad(u[:, :-1], (1, 0))
        rt_l = F.pad(u[:, 1:], (0, 1))
        nb = cc * up_l + dd * dn_l + aa * lf_l + bb * rt_l
        mask = _mask(u, parity, origin)
        u_new = torch.where(mask, (rhs - nb) * inv_diag, u)
        # 3) the border lines with the received halos, in the term order
        #    (cc, dd, aa, bb) of the plain sweep
        (top, bot), (lef, rig) = halos.wait()

        def line(nb_line, rows, cols):
            return torch.where(mask[rows, cols],
                               (rhs[rows, cols] - nb_line) * inv_diag,
                               u[rows, cols])

        nb_top = (cc[r0, :] * top + dd[r0, :] * u[1:2, :]
                  + aa[r0, :] * cat([lef[r0, :], u[r0, :-1]], dim=1)
                  + bb[r0, :] * cat([u[r0, 1:], rig[r0, :]], dim=1))
        nb_bot = (cc[rn, :] * u[-2:-1, :] + dd[rn, :] * bot
                  + aa[rn, :] * cat([lef[rn, :], u[rn, :-1]], dim=1)
                  + bb[rn, :] * cat([u[rn, 1:], rig[rn, :]], dim=1))
        nb_lef = (cc[:, r0] * cat([top[:, r0], u[:-1, r0]])
                  + dd[:, r0] * cat([u[1:, r0], bot[:, r0]])
                  + aa[:, r0] * lef + bb[:, r0] * u[:, 1:2])
        nb_rig = (cc[:, rn] * cat([top[:, rn], u[:-1, rn]])
                  + dd[:, rn] * cat([u[1:, rn], bot[:, rn]])
                  + aa[:, rn] * u[:, -2:-1] + bb[:, rn] * rig)
        every = slice(None)
        u_new[r0, :] = line(nb_top, r0, every)
        u_new[rn, :] = line(nb_bot, rn, every)
        u_new[:, r0] = line(nb_lef, every, r0)
        u_new[:, rn] = line(nb_rig, every, rn)
        u = u_new
    return u


def _block_coefs(level, u, mesh) -> P.Coefs:
    """The 5-point stencil on the block's own nodes, from this rank's
    level (a whole level, or its cut window: `level_window` reads the
    offsets); a nine-band level raises."""
    if level.form == "nine":
        raise NotImplementedError(
            "explicit halo smoothing supports 5-point levels only "
            "(a partitioned Galerkin level smooths by "
            "parallel/blocks.py::rb_sweeps, whose exchanges carry the "
            "corners)")
    ox, oy = _origin(u, mesh)
    return P.coefs(level_window(level, (ox, ox + u.shape[0]),
                                (oy, oy + u.shape[1])))


def smooth_block(mesh, level, u, rhs, nsweeps: int = 1,
                 want_residual: bool = False, overlap: bool = False):
    """`nsweeps` red–black sweeps on this rank's block (u, rhs) of a
    2-D-partitioned 5-point level, and the residual rhs − A·u on the block
    if `want_residual`; returns (u, residual or None).  `level` is this
    rank's level: a whole one, or its window holding the block."""
    c = _block_coefs(level, u, mesh)
    origin = _origin(u, mesh)
    sweep = _sweep_local_overlapped if overlap else _sweep_local
    for _ in range(nsweeps):
        u = sweep(c, u, rhs, mesh, origin)
    return u, _residual_local(c, u, rhs, mesh) if want_residual else None


def smooth_distributed(mesh, level, u, rhs, nsweeps: int = 1,
                       want_residual: bool = False, overlap: bool = False):
    """`nsweeps` red–black sweeps with explicit halo exchanges, each rank
    on its block (u, rhs) of a level partitioned in the 2-D layout over
    `mesh`; `level` is this rank's level (whole, or a window holding the
    block).  Returns u, or with `want_residual` (u, residual, norm): the
    norm is the whole field's l2 norm, the same on every rank.  `overlap`
    picks the overlapped sweep (same bits).  5-point levels only."""
    u, res = smooth_block(mesh, level, u, rhs, nsweeps, want_residual,
                          overlap)
    if not want_residual:
        return u
    acc = res.to(torch.promote_types(res.dtype, torch.float32))
    return u, res, torch.sqrt(all_sum(torch.sum(acc * acc), mesh))
