"""Which levels are partitioned, and how: the port of the JAX package's
`parallel/sharding.py`, in both of its layouts.

  * "rows" (`RowBlocks`): a partitioned level is split by rows over every
    rank, both mesh axes flattened into one (the JAX package's
    `P((x, y), None)`); the layout of the deep-halo smoother K7
    (parallel/rows_halo.py);
  * "2d" (`GridBlocks`): a partitioned level is split by rows over the
    mesh's "x" axis and by columns over its "y" axis (the JAX package's
    `P(x, y)`); its ops exchange one cell on both axes
    (parallel/halo.py, parallel/blocks.py).

A level whose block would hold fewer than `min_local` grid nodes along
an axis it is split on is agglomerated, that is, replicated on every rank
(coarse grids are latency-bound: cheaper to compute redundantly than to
communicate).  That is the JAX package's rule: (n+1)//W >= min_local in
the rows layout, min((n+1)//nx, (n+1)//ny) >= min_local in the 2-D one,
and more than one rank.

The partitions nest, on both axes: rank k's block of a coarser
partitioned level is exactly the coarse nodes of its block of the finer
one (rows and columns 2I of fine block k are rows and columns I of coarse
block k), so restriction and prolongation between partitioned levels move
at most one halo line.  The JAX package's even split of each level's
padded array does not nest (at n=1024 over 4 ranks, fine block k's even
rows start at coarse row 129k, coarse block k at 130k), and GSPMD moves
the misplaced nodes.  Here level 0's padded rows are zero-padded up to a
multiple of lcm(2^P·W, 8) in the rows layout (P partitioned levels, W
ranks; `rows_halo.padded_rows_for`, P = 1 being the JAX package's
multiple), and in the 2-D layout its rows up to a multiple of
lcm(2^P·nx, 8) and its columns up to one of lcm(2^P·ny, 128); the array
is split evenly, and each coarser level's block is half its finer one's:
every block starts at an even global row and column on every partitioned
level, as red–black colour parity needs.  Nodes past a level's padded
array are zero.
"""

from __future__ import annotations

import dataclasses
import math

from hpcclassmultigridproject_tpu_torch.core.layout import (
    COL_TILE,
    padded_shape,
)
from hpcclassmultigridproject_tpu_torch.mg.levels import (
    BANDS,
    CORNERS,
    Level,
    level_window,
)
from hpcclassmultigridproject_tpu_torch.parallel.mesh import Mesh
from hpcclassmultigridproject_tpu_torch.parallel.rows_halo import (
    halo_rows,
    padded_rows_for,
)

LAYOUTS = ("rows", "2d")


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """A level partitioned in the rows layout: rank k holds the global rows
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

    # the columns: a row block holds every one
    col_start = 0
    col_window = None

    @property
    def col_stop(self) -> int:
        return self.cols

    @property
    def col_span(self) -> int:
        return self.cols

    @property
    def grid(self) -> tuple[int, int]:
        """(block rows, block columns) of the tiling, ranks in order."""
        return self.mesh.world, 1


@dataclasses.dataclass(frozen=True)
class GridBlocks:
    """A level partitioned in the 2-D layout: the rank at mesh coordinates
    (i, j) holds the global rows [i·local, (i+1)·local) and columns
    [j·local_cols, (j+1)·local_cols) of its `rows` x `cols` padded array
    (zero past it), and its coefficient fields with `halo` more nodes on
    each side (`shard_level_data`)."""

    mesh: Mesh
    local: int
    local_cols: int
    rows: int
    cols: int
    halo: int = 1

    @property
    def start(self) -> int:
        return self.mesh.coords[0] * self.local

    @property
    def stop(self) -> int:
        return self.start + self.local

    @property
    def col_start(self) -> int:
        return self.mesh.coords[1] * self.local_cols

    @property
    def col_stop(self) -> int:
        return self.col_start + self.local_cols

    @property
    def span(self) -> int:
        """Rows the blocks of all ranks cover (>= rows)."""
        return self.mesh.shape[0] * self.local

    @property
    def col_span(self) -> int:
        """Columns the blocks of all ranks cover (>= cols)."""
        return self.mesh.shape[1] * self.local_cols

    @property
    def shape(self) -> tuple[int, int]:
        """The shape of this rank's block of a field."""
        return self.local, self.local_cols

    @property
    def window(self) -> tuple[int, int]:
        """The global rows of this rank's coefficient fields."""
        return self.start - self.halo, self.stop + self.halo

    @property
    def col_window(self) -> tuple[int, int]:
        """The global columns of this rank's coefficient fields."""
        return self.col_start - self.halo, self.col_stop + self.halo

    @property
    def grid(self) -> tuple[int, int]:
        """(block rows, block columns) of the tiling: the mesh's shape."""
        return self.mesh.shape


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def level_shardings_for_ns(ns, mesh: Mesh, min_local: int = 64,
                           layout: str = "rows", nsweeps: int = 3):
    """One entry per level of grid extents `ns` (finest first, each half
    the one before): a `RowBlocks` ("rows") or `GridBlocks` ("2d") for a
    partitioned level, None for a replicated one, by the JAX package's
    rule (module docstring).  `nsweeps` sets the rows layout's coefficient
    halo (`rows_halo.halo_rows`); the 2-D layout's is one node."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (want 'rows' or '2d')")
    ns = [int(n) for n in ns]
    if any(n != ns[0] >> lvl for lvl, n in enumerate(ns)):
        raise ValueError(f"grid extents {ns} do not halve level by level")
    world = mesh.world
    nx, ny = mesh.shape
    if layout == "rows":
        parts = [world > 1 and (n + 1) // world >= min_local for n in ns]
    else:
        parts = [world > 1 and min((n + 1) // nx, (n + 1) // ny) >= min_local
                 for n in ns]
    depth = sum(parts)
    if depth == 0:
        return (None,) * len(ns)
    rows0, cols0 = padded_shape(ns[0])
    if layout == "rows":
        local0 = padded_rows_for(rows0, world, depth) // world
    else:
        local0 = padded_rows_for(rows0, nx, depth) // nx
        lcols0 = _ceil_to(cols0, math.lcm(2 ** depth * ny, COL_TILE)) // ny
    out = []
    for lvl, n in enumerate(ns):
        rows, cols = padded_shape(n)
        if not parts[lvl]:
            out.append(None)
        elif layout == "rows":
            out.append(RowBlocks(mesh, local0 >> lvl, rows, cols,
                                 halo_rows(nsweeps)))
        else:
            out.append(GridBlocks(mesh, local0 >> lvl, lcols0 >> lvl, rows,
                                  cols))
    return tuple(out)


def level_shardings(levels: tuple[Level, ...], mesh: Mesh,
                    min_local: int = 64, layout: str = "rows",
                    nsweeps: int = 3):
    """`level_shardings_for_ns` of the levels' grid extents."""
    return level_shardings_for_ns([level.n for level in levels], mesh,
                                  min_local, layout, nsweeps)


def shard_level_data(level: Level, part, whole: bool = False) -> Level:
    """This rank's part of a level: its fields' rows [start − halo,
    stop + halo), and in the 2-D layout its columns [col_start − halo,
    col_stop + halo), cut once (zero past the array; the coefficient
    fields never change, so no later exchange re-sends their halos), with
    `row_off` and `col_off` the window's origin.  `a_inv` stays whole.  A
    replicated level (`part` None), and with `whole` a partitioned one
    whose every op runs on the gathered array (the coarsest level), stays
    as it is."""
    if part is None or whole:
        return level
    cut = level_window(level, part.window, part.col_window)
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


def shard_windows(shardings, cols: bool = False) -> tuple:
    """The global rows of each level that `shard_hierarchy` keeps on this
    rank, or with `cols` its global columns: a partitioned level's
    `window` (`col_window`, None in the rows layout), None for a level kept
    whole (a replicated one, and the coarsest).  A model born partitioned
    builds only these (mg/levels.py::build_hierarchy_device)."""
    last = len(shardings) - 1
    return tuple(None if part is None or i == last
                 else part.col_window if cols else part.window
                 for i, part in enumerate(shardings))
