"""Which levels are partitioned, and how: the port of the JAX package's
`parallel/sharding.py` in its rows layout.

A fine level is split by rows over every rank; a level whose block would
hold fewer than `min_local` grid rows is agglomerated, that is, replicated
on every rank (coarse grids are latency-bound: cheaper to compute
redundantly than to communicate).  That is the JAX package's rule.

The partitions nest: rank k's block of a coarser partitioned level is
exactly the coarse rows of its block of the finer one (rows 2I of fine
block k are rows I of coarse block k), so restriction and prolongation
between partitioned levels move at most one halo row.  The JAX package's
even split of each level's padded rows does not nest (at n=1024 over 4
ranks, fine block k's even rows start at coarse row 129k, coarse block k
at 130k), and GSPMD moves the misplaced rows.  Here level 0's padded rows
are zero-padded up to a multiple of lcm(2^P·W, 8) for P partitioned levels
and W ranks (`rows_halo.padded_rows_for`; P = 1 is the JAX package's
multiple), split evenly, and each coarser level's block is half its finer
one's: every block starts at an even global row on every partitioned
level, as red–black colour parity needs.
"""

from __future__ import annotations

import dataclasses

from hpcclassmultigridproject_tpu_torch.core.layout import padded_shape
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    BANDS,
    CORNERS,
    Level,
    level_rows,
)
from hpcclassmultigridproject_tpu_torch.parallel.mesh import Mesh
from hpcclassmultigridproject_tpu_torch.parallel.rows_halo import (
    halo_rows,
    padded_rows_for,
)

_NOT_PORTED = "not ported yet (ROADMAP queue 1: the rest of parallel/)"


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """A partitioned level: rank k holds the global rows
    [k·local, (k+1)·local) of its `rows` x `cols` padded array (rows past
    `rows` are zero), and its coefficient fields with `halo` more rows on
    each side (`shard_level_data`)."""

    mesh: Mesh
    local: int
    rows: int
    cols: int
    halo: int

    @property
    def start(self) -> int:
        return self.mesh.rank * self.local

    @property
    def stop(self) -> int:
        return self.start + self.local

    @property
    def span(self) -> int:
        """Rows the blocks of all ranks cover (>= rows)."""
        return self.mesh.world * self.local

    @property
    def shape(self) -> tuple[int, int]:
        """The shape of this rank's block of a field."""
        return self.local, self.cols

    @property
    def window(self) -> tuple[int, int]:
        """The global rows of this rank's coefficient fields: its block
        and `halo` rows on each side."""
        return self.start - self.halo, self.stop + self.halo


def level_shardings_for_ns(ns, mesh: Mesh, min_local: int = 64,
                           layout: str = "rows", nsweeps: int = 3):
    """One entry per level of grid extents `ns` (finest first, each half
    the one before): a `RowBlocks` for a partitioned level, None for a
    replicated one.  A level is partitioned when (n+1)//W >= min_local and
    W > 1 (the JAX package's rule).  `nsweeps` sets the coefficient halo
    (`rows_halo.halo_rows`)."""
    if layout == "2d":
        raise NotImplementedError(
            "layout='2d' (2-D blocks, a halo exchange on both axes for every "
            f"op): {_NOT_PORTED}")
    if layout != "rows":
        raise ValueError(f"unknown layout {layout!r} (want 'rows')")
    ns = [int(n) for n in ns]
    if any(n != ns[0] >> lvl for lvl, n in enumerate(ns)):
        raise ValueError(f"grid extents {ns} do not halve level by level")
    world = mesh.world
    parts = [world > 1 and (n + 1) // world >= min_local for n in ns]
    depth = sum(parts)
    if depth == 0:
        return (None,) * len(ns)
    local0 = padded_rows_for(padded_shape(ns[0])[0], world, depth) // world
    out = []
    for lvl, n in enumerate(ns):
        rows, cols = padded_shape(n)
        out.append(RowBlocks(mesh, local0 >> lvl, rows, cols,
                             halo_rows(nsweeps)) if parts[lvl] else None)
    return tuple(out)


def level_shardings(levels: tuple[Level, ...], mesh: Mesh,
                    min_local: int = 64, layout: str = "rows",
                    nsweeps: int = 3):
    """`level_shardings_for_ns` of the levels' grid extents."""
    return level_shardings_for_ns([level.n for level in levels], mesh,
                                  min_local, layout, nsweeps)


def shard_level_data(level: Level, part: RowBlocks | None,
                     whole: bool = False) -> Level:
    """This rank's part of a level: its fields' rows [start − halo,
    stop + halo), cut once (zero past the array; the coefficient fields
    never change, so no later exchange re-sends their halos), with
    `row_off` = start − halo.  `a_inv` stays whole.  A replicated level
    (`part` None), and with `whole` a partitioned one whose every op runs
    on the gathered array (the coarsest level), stays as it is."""
    if part is None or whole:
        return level
    cut = level_rows(level, *part.window)
    return dataclasses.replace(cut, **{
        k: getattr(cut, k).clone() for k in ("v1", "v2", *BANDS, *CORNERS,
                                             "diag")
        if getattr(cut, k) is not None})


def shard_hierarchy(levels: tuple[Level, ...], mesh: Mesh,
                    min_local: int = 64, layout: str = "rows",
                    nsweeps: int = 3):
    """(this rank's levels, their shardings).  The coarsest level stays
    whole: its solve runs on the gathered field (mg/cycle.py)."""
    shardings = level_shardings(levels, mesh, min_local, layout, nsweeps)
    last = len(levels) - 1
    sharded = tuple(shard_level_data(level, s, whole=i == last)
                    for i, (level, s) in enumerate(zip(levels, shardings)))
    return sharded, shardings


def shard_windows(shardings) -> tuple:
    """The global rows of each level that `shard_hierarchy` keeps on this
    rank: a partitioned level's `window`, None for a level kept whole (a
    replicated one, and the coarsest).  A model born row-partitioned
    builds only these rows (mg/levels.py::build_hierarchy_device)."""
    last = len(shardings) - 1
    return tuple(None if part is None or i == last else part.window
                 for i, part in enumerate(shardings))
