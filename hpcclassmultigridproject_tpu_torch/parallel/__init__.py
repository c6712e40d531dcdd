"""The distributed run: the JAX package's `parallel/`, as SPMD over
`torch.distributed` (one process per rank), in both of its layouts.

  mesh.py          the ranks (`Mesh`, `make_mesh`, `factor_2d`), their mesh
                   coordinates and neighbours
  distributed.py   process group, collectives, the point-to-point exchange,
                   local spawning
  sharding.py      which levels are partitioned, in the rows layout
                   (`RowBlocks`) or the 2-D one (`GridBlocks`); cutting a
                   level to a block
  rows_halo.py     deep-halo smoothing of a rows-layout level (K7)
  halo.py          explicit halo smoothing of a 2-D block
                   (`smooth_distributed`)
  blocks.py        the plain level ops on a block of either layout (halo
                   exchange, norms, restriction, prolongation,
                   agglomeration, the Jacobi and Chebyshev smoothers)
"""

from typing import NamedTuple

from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
    capture_reason,
    fetch,
    initialize,
    is_multiprocess,
    launch_local,
    make_global,
)
from hpcclassmultigridproject_tpu_torch.parallel.halo import (
    smooth_distributed,
)
from hpcclassmultigridproject_tpu_torch.parallel.mesh import (
    Mesh,
    factor_2d,
    make_mesh,
)
from hpcclassmultigridproject_tpu_torch.parallel.sharding import (
    GridBlocks,
    RowBlocks,
    level_shardings,
    level_shardings_for_ns,
    shard_hierarchy,
    shard_level_data,
    shard_windows,
)

# the default of distributed_run's `min_local` and `layout`, told apart from
# the same value passed
_UNSET = object()


def resolve_layout(layout: str, solver) -> str:
    """The layout a run takes: `layout` itself, or for "auto" the JAX
    package's rule with the port's kernel in place of its TPU gate:
    "rows" where K7 smooths the partitioned levels (red–black GS on the
    kernel route), "2d" otherwise (the Jacobi and Chebyshev smoothers, and
    backend "jnp", whose route launches no kernel)."""
    if layout != "auto":
        return layout
    kernel = solver.smoother == "rbgs" and solver.backend != "jnp"
    return "rows" if kernel else "2d"


def _born_partitioned(model, mesh, min_local, layout):
    """The partition of a model born partitioned, which holds its blocks
    already; a mesh, `min_local` or layout other than the model's raises
    ValueError."""
    built = ("row-partitioned" if model.layout == "rows"
             else "2-D-partitioned")
    if mesh is not None and mesh != model.mesh:
        raise ValueError(
            f"the model was built {built} over {model.mesh}, not "
            f"{mesh}: build it with AdvectionDiffusion(..., mesh=mesh)")
    if min_local is not _UNSET and min_local != model.min_local:
        raise ValueError(
            f"min_local={min_local}: the model was built {built} "
            f"with min_local={model.min_local}")
    if (layout is not _UNSET
            and resolve_layout(layout, model.solver) != model.layout):
        raise ValueError(
            f"layout={layout!r}: the model was built {built} in "
            f"layout {model.layout!r}")
    return Partition(model.levels, model.shardings, model.fine_hi, model.u0,
                     model.mesh, model.layout, model.min_local)


class Partition(NamedTuple):
    """A model's levels, shardings, fine_hi and u0 on this rank, over
    `mesh` in `layout` with `min_local`."""

    levels: tuple
    shardings: tuple
    fine_hi: object
    u0: object
    mesh: Mesh
    layout: str
    min_local: int


def partition(model, mesh: Mesh | None = None, min_local: int = _UNSET,
              layout: str = _UNSET) -> Partition:
    """This rank's part of `model` over `mesh` (default `make_mesh()`), as
    `distributed_run` runs it.  A model born partitioned gives its own
    parts (another mesh, `min_local` or layout raises ValueError).  A
    model built whole is partitioned once per (mesh, `min_local`, layout,
    sweeps a smoothing), and the parts are kept on the model
    (`model.partitions`), so the programs that read them see the same
    tensors on every call."""
    if getattr(model, "shardings", None) is not None:
        return _born_partitioned(model, mesh, min_local, layout)
    cfg = model.solver
    mesh = make_mesh() if mesh is None else mesh
    min_local = 64 if min_local is _UNSET else min_local
    layout = resolve_layout("auto" if layout is _UNSET else layout, cfg)
    key = (mesh, min_local, layout, cfg.niter)
    if key not in model.partitions:
        levels, shardings = shard_hierarchy(model.levels, mesh, min_local,
                                            layout, nsweeps=cfg.niter)
        fine_hi = (None if model.fine_hi is None
                   else shard_level_data(model.fine_hi, shardings[0]))
        model.partitions[key] = Partition(
            levels, shardings, fine_hi, make_global(model.u0, shardings[0]),
            mesh, layout, min_local)
    return model.partitions[key]


def distributed_run(model, mesh: Mesh | None = None, min_local: int = _UNSET,
                    layout: str = _UNSET):
    """Run a model's whole timestepped solve with its levels partitioned
    over the ranks of `mesh` (default: `make_mesh()`), in the rows or the
    2-D layout.

    Every rank calls this with the same model.  Built whole, the model is
    partitioned (`partition`, once per mesh, `min_local` and layout):
    levels whose block holds at least `min_local` (default 64) grid nodes
    along each axis it is split on are partitioned (each rank keeps its
    block, and the coefficients of its halo); coarser ones are replicated
    on every rank (parallel/sharding.py).  A model born partitioned
    (`AdvectionDiffusion(..., mesh=...)`) holds only its blocks already
    and runs as built: a mesh, `min_local` or layout passed here that
    differs from its own raises ValueError.

    `layout` "rows" splits the rows over every rank: the fine levels
    smooth by one deep-halo exchange and K7 per block
    (parallel/rows_halo.py, in `model.solver.sharded_overlap`'s schedule).
    "2d" splits rows and columns over the mesh's two axes: 5-point levels
    smooth by one-cell exchanges before each colour pass
    (parallel/halo.py; `sharded_overlap` picks its overlapped sweep, the
    same bits).  "auto" (the default) is `resolve_layout`'s rule: "rows"
    under red–black GS, "2d" for the Jacobi and Chebyshev smoothers.
    Every configuration runs in both layouts: FMG, every smoother, and
    Galerkin (nine-band) levels, whose partitioned blocks smooth by
    one-line exchanges with corners (parallel/blocks.py).  The replicated
    levels run as on one device, the coarse tower included.

    The run can be one compiled program, as the JAX package's is one
    jitted program: on one rank, and under NCCL with
    `distributed.CAPTURE_NCCL` on (it is off by default), each rank
    captures the call (the steps, their halo exchanges and norms, and the
    gather of uT) once per key as a CUDA graph in `model.programs`, and
    replays it (utils/graphs.py), keyed by the step count, the
    SolverConfig, the mesh, layout and `min_local`.  Otherwise it runs
    eagerly (`distributed.capture_reason`: the CPU; gloo with CUDA
    tensors, whose collectives stage through the host; NCCL with the
    switch off).  `model.last_run_compiled` and `last_run_reason` say
    which.

    Returns (uT cropped to the logical grid, stats) on every rank: the
    blocks are gathered (`fetch`), and the stats, computed from norms
    added over the ranks, are the same on every rank."""
    from hpcclassmultigridproject_tpu_torch.core.layout import crop_field
    from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper

    cfg, n, steps = model.solver, model.problem.n, model.problem.num_steps
    part = partition(model, mesh, min_local, layout)
    levels, shardings, fine_hi = part.levels, part.shardings, part.fine_hi

    def run(u, nsteps=steps):
        uT, stats = timestepper(levels, u, nsteps, cfg, fine_hi,
                                shardings=shardings)
        return crop_field(fetch(uT, shardings[0]), n), stats

    key = ("distributed", steps, cfg, part.mesh.key, part.layout,
           part.min_local)
    return model.compiled(key, run, part.u0, lambda u: run(u, 1),
                          keep=(levels, fine_hi), mesh=part.mesh)


__all__ = [
    "Mesh",
    "GridBlocks",
    "RowBlocks",
    "factor_2d",
    "make_mesh",
    "level_shardings",
    "level_shardings_for_ns",
    "shard_hierarchy",
    "shard_level_data",
    "shard_windows",
    "distributed_run",
    "partition",
    "Partition",
    "capture_reason",
    "resolve_layout",
    "smooth_distributed",
    "initialize",
    "is_multiprocess",
    "launch_local",
    "make_global",
    "fetch",
]
