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

from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
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
    """The levels, shardings, fine_hi and u0 of a model born partitioned,
    which holds its blocks already; a mesh, `min_local` or layout other
    than the model's raises ValueError."""
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
    return model.levels, model.shardings, model.fine_hi, model.u0


def distributed_run(model, mesh: Mesh | None = None, min_local: int = _UNSET,
                    layout: str = _UNSET):
    """Run a model's whole timestepped solve with its levels partitioned
    over the ranks of `mesh` (default: `make_mesh()`), in the rows or the
    2-D layout.

    Every rank calls this with the same model.  Built whole, the model is
    partitioned here: levels whose block holds at least `min_local`
    (default 64) grid nodes along each axis it is split on are
    partitioned (each rank keeps its block, and the coefficients of its
    halo); coarser ones are replicated on every rank
    (parallel/sharding.py).  A model born partitioned
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

    Returns (uT cropped to the logical grid, stats) on every rank: the
    blocks are gathered (`fetch`), and the stats, computed from norms
    added over the ranks, are the same on every rank."""
    from hpcclassmultigridproject_tpu_torch.core.layout import crop_field
    from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper

    cfg = model.solver
    if getattr(model, "shardings", None) is not None:
        levels, shardings, fine_hi, u0 = _born_partitioned(
            model, mesh, min_local, layout)
    else:
        levels, shardings = shard_hierarchy(
            model.levels, make_mesh() if mesh is None else mesh,
            64 if min_local is _UNSET else min_local,
            resolve_layout("auto" if layout is _UNSET else layout, cfg),
            nsweeps=cfg.niter)
        fine_hi = (None if model.fine_hi is None
                   else shard_level_data(model.fine_hi, shardings[0]))
        u0 = make_global(model.u0, shardings[0])
    uT, stats = timestepper(levels, u0, model.problem.num_steps, cfg,
                            fine_hi, shardings=shardings)
    return crop_field(fetch(uT, shardings[0]), model.problem.n), stats


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
    "resolve_layout",
    "smooth_distributed",
    "initialize",
    "is_multiprocess",
    "launch_local",
    "make_global",
    "fetch",
]
