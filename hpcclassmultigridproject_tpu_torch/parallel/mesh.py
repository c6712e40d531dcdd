"""The ranks of a distributed run, the port of the JAX package's
`parallel/mesh.py`.

PyTorch has no device mesh that its ops follow: a run is one process per
rank over `torch.distributed`, and each process runs the SPMD program on
its own block.  `Mesh` describes the ranks: the world size, this process's
rank, the process group's backend, and the 2-D shape `factor_2d` gives the
JAX package's mesh, with axes ("x", "y") over the grid's rows and columns.
Rank k sits at mesh coordinates (k // cols, k % cols), as the JAX
package's `make_mesh` reshapes its device list.  The 2-D layout
(parallel/halo.py, parallel/blocks.py) exchanges with the four neighbours
of those coordinates; the rows layout (parallel/rows_halo.py) flattens
both axes into one row of ranks, as the JAX package's `rows_spec` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist


def factor_2d(n_devices: int) -> tuple[int, int]:
    """Factor a device count into the most-square (rows, cols) grid."""
    best = (1, n_devices)
    for rows in range(1, int(math.isqrt(n_devices)) + 1):
        if n_devices % rows == 0:
            best = (rows, n_devices // rows)
    return best


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`world` ranks of the default process group; this process is `rank`.
    A mesh built by hand describes another rank's view for the per-block
    functions and the tests; a collective over it raises unless a process
    group of `world` ranks is initialized."""

    world: int
    rank: int = 0

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(
                f"rank {self.rank} outside a world of {self.world}")

    @property
    def shape(self) -> tuple[int, int]:
        """The JAX package's 2-D mesh shape for `world` devices."""
        return factor_2d(self.world)

    axis_names = ("x", "y")

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's (row, col) on the mesh: (rank // cols, rank % cols)."""
        return divmod(self.rank, self.shape[1])

    @property
    def neighbors(self) -> tuple[int | None, ...]:
        """The ranks (up, down, left, right) beside this one on the mesh:
        up is the previous along "x" (the grid rows above), left the
        previous along "y"; None past the mesh's edge."""
        (rows, cols), (i, j) = self.shape, self.coords
        return (self.rank - cols if i > 0 else None,
                self.rank + cols if i < rows - 1 else None,
                self.rank - 1 if j > 0 else None,
                self.rank + 1 if j < cols - 1 else None)

    @property
    def backend(self) -> str | None:
        """The process group's backend ("gloo", "nccl"), or None with no
        process group."""
        return dist.get_backend() if dist.is_initialized() else None

    @property
    def key(self) -> tuple:
        """(world, rank, shape, backend): what a captured program of a
        partitioned run is keyed by (utils/graphs.py)."""
        return self.world, self.rank, self.shape, self.backend


def make_mesh() -> Mesh:
    """The mesh of every rank of the default process group; one rank when
    no process group is initialized."""
    if not dist.is_initialized():
        return Mesh(world=1, rank=0)
    return Mesh(world=dist.get_world_size(), rank=dist.get_rank())
