"""Deep-halo smoothing of a row-partitioned level: the counterpart of the
JAX package's `parallel/pallas_halo.py`, with K7 in place of its sharded
Pallas kernel.

Each rank holds a block of `local` rows of every field (parallel/
sharding.py).  One smoothing block (`nsweeps` red–black sweeps and the
trailing residual) is one exchange of an h-row halo of every operand that
changes (u and rhs; the coefficient fields v1, v2 were cut with their halos
once, `sharding.shard_level_data`), then K7 on the (local + 2h)-row
extended block, whose array row 0 is global row start − h.  The error the
extended block's artificial edges bring in moves one row per colour pass,
so after 2·nsweeps passes and the residual (2·nsweeps + 1 <= h rows) the
centre rows are exactly the single-device result.  Rank 0's top halo and
the last rank's bottom halo are zero, which the padded layout holds past
the grid's true edges: no rank is a special case.

Two schedules, as in the JAX package:

  * plain: the exchange, then one K7 launch on the extended block;
  * overlap (`SolverConfig.sharded_overlap`): K7 on the raw block is
    launched before the exchange is waited on (its rows [h, local − h) need
    no halo), then K7 on the two 3h-row slabs (halo + 2h block rows) at
    start − h and stop − 2h, whose middle h rows patch the block's edges.

Five-band levels run K5 on the extended block with no offset (their stored
bands carry the mask).  Nine-band levels are refused, as in the JAX
package.

`exchange` carries every halo of the rows layout, through
`distributed.start_exchange` (`dist.batch_isend_irecv`): device tensors
under NCCL; under gloo, CUDA tensors' halo rows are copied to the host,
exchanged and copied back (parallel/distributed.py::host_staged).  The
per-rank computation (`smooth_block`) takes its halos from an `Exchange`,
a posted exchange or halos given by hand, so it runs with no process
group too.
"""

from __future__ import annotations

import math

import torch

from hpcclassmultigridproject_tpu_torch.mg.levels import level_rows
from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import (
    fused_rb_sweeps,
    fused_rb_sweeps_rows,
)
from hpcclassmultigridproject_tpu_torch.parallel import distributed
from hpcclassmultigridproject_tpu_torch.parallel.distributed import Exchange


def halo_rows(nsweeps: int) -> int:
    """Halo rows per side: the dependency radius 2·nsweeps + 1, rounded up
    to 8 rows (the JAX package's `_halo`; even, as colour parity needs)."""
    return -(-(2 * nsweeps + 1) // 8) * 8


def _row_multiple(ndev: int, depth: int = 1) -> int:
    return math.lcm(2 ** depth * ndev, 8)


def padded_rows_for(rows: int, ndev: int, depth: int = 1) -> int:
    """`rows` rounded up to a multiple of lcm(2^depth · ndev, 8): rows that
    split into `ndev` equal blocks whose starts stay even through `depth`
    halvings.  depth 1 is the JAX package's `padded_rows_for`."""
    m = _row_multiple(ndev, depth)
    return -(-rows // m) * m


def is_rows_sharding(part) -> bool:
    """True iff `part` partitions a level by rows (a
    `sharding.RowBlocks`); None is a replicated level."""
    from hpcclassmultigridproject_tpu_torch.parallel.sharding import RowBlocks

    return isinstance(part, RowBlocks)


def sharded_eligible(level, part, nsweeps: int) -> bool:
    """The deep-halo path (K7, or K5 on five-band levels) runs a
    partitioned level whose blocks are at least 2h rows and whose
    coefficient halo covers the cascade: the counterpart of the JAX
    package's `mg/cycle.py::_pallas_sharded_eligible`.  Nine-band levels
    and thinner blocks take the one-row-per-pass schedule
    (parallel/blocks.py::rb_sweeps)."""
    return (is_rows_sharding(part) and level.form != "nine"
            and part.halo >= 2 * nsweeps + 1 and part.local >= 2 * part.halo)


def start_exchange(blocks, k: int, mesh) -> Exchange:
    """Post the exchange of k halo rows of each block: its first k rows to
    the rank before, its last k rows to the rank after, and the receives of
    theirs.  Rank 0's top and the last rank's bottom halos are zero."""
    rank, world = mesh.rank, mesh.world
    side = (0, rank - 1 if rank > 0 else None,
            rank + 1 if rank < world - 1 else None)
    return distributed.start_exchange(blocks, k, mesh, [side])


def exchange(blocks, k: int, mesh):
    """(top, bottom) k-row halos of each block, waited on."""
    return start_exchange(blocks, k, mesh).wait()


def extend(blocks, k: int, mesh):
    """Each block with its k-row halos above and below."""
    return [torch.cat([t, b, bo]) for b, (t, bo)
            in zip(blocks, exchange(blocks, k, mesh))]


def smooth_extended(level, u, rhs, nsweeps: int, want_residual: bool,
                    zero_init: bool):
    """One kernel launch on a block whose rows are the level's stored rows
    (array row 0 is global row `level.row_off`): K7 on a from_v level, K5
    on a five-band one."""
    if level.form == "from_v":
        return fused_rb_sweeps_rows(level, u, rhs, nsweeps, want_residual,
                                    zero_init)
    return fused_rb_sweeps(level, u, rhs, nsweeps, want_residual, zero_init)


def smooth_block(level, part, blocks, halos: Exchange, nsweeps: int,
                 want_residual: bool = False, zero_init: bool = False,
                 overlap: bool = False):
    """The per-rank computation of `fused_smooth_sharded`: `level` is this
    rank's cut level (rows [start − h, stop + h)), `blocks` its (u, rhs)
    blocks, or (rhs,) with `zero_init`, and `halos` their h-row halos.
    Returns (u, residual or None) on the block's rows."""
    h, local = part.halo, part.local
    start, stop = part.start, part.stop
    u, rhs = (None, blocks[0]) if zero_init else blocks
    run = lambda lvl, uu, rr: smooth_extended(lvl, uu, rr, nsweeps,
                                              want_residual, zero_init)
    if not overlap:
        ext = [torch.cat([t, b, bo]) for b, (t, bo) in zip(blocks,
                                                           halos.wait())]
        uu, rr = (None, ext[0]) if zero_init else ext
        outs = run(level, uu, rr)
        return tuple(None if o is None else o[h:h + local] for o in outs)
    # the raw block first: its centre rows need no halo
    out_i = run(level_rows(level, start, stop), u, rhs)
    pairs = halos.wait()
    tops = [torch.cat([t, b[:2 * h]]) for b, (t, _) in zip(blocks, pairs)]
    bots = [torch.cat([b[-2 * h:], bo]) for b, (_, bo) in zip(blocks, pairs)]
    slab = lambda xs: (None, xs[0]) if zero_init else xs
    out_t = run(level_rows(level, start - h, start + 2 * h), *slab(tops))
    out_b = run(level_rows(level, stop - 2 * h, stop + h), *slab(bots))

    def stitch(i, t, b):
        if i is None:
            return None
        return torch.cat([t[h:2 * h], i[h:local - h], b[h:2 * h]])

    return tuple(stitch(*o) for o in zip(out_i, out_t, out_b))


def fused_smooth_sharded(part, level, u, rhs, nsweeps: int,
                         want_residual: bool = False,
                         zero_init: bool = False, overlap: bool = False):
    """`nsweeps` red–black sweeps (and the trailing residual) on this
    rank's block of a row-partitioned level: one deep-halo exchange and
    K7 per block, in the plain or the overlap schedule.  With `zero_init`
    the iterate is zero: its operand and its exchange are dropped.
    Returns (u, residual or None)."""
    if level.form == "nine":
        raise NotImplementedError(
            "fused sharded smoothing takes 5-point levels only (a "
            "partitioned Galerkin level smooths by one-line exchanges, "
            "parallel/blocks.py::rb_sweeps, as the JAX package's GSPMD "
            "path does)")
    if not sharded_eligible(level, part, nsweeps):
        raise ValueError(
            f"per-rank block of {part.local} rows with a halo of "
            f"{part.halo} cannot carry a {nsweeps}-sweep cascade")
    blocks = [rhs] if zero_init else [u, rhs]
    halos = start_exchange(blocks, part.halo, part.mesh)
    return smooth_block(level, part, blocks, halos, nsweeps, want_residual,
                        zero_init, overlap)
