"""The distributed run: the JAX package's `parallel/` in its rows layout,
as SPMD over `torch.distributed` (one process per rank).

  mesh.py          the ranks (`Mesh`, `make_mesh`, `factor_2d`)
  distributed.py   process group, collectives, local spawning
  sharding.py      which levels are partitioned; cutting a level to a block
  rows_halo.py     deep-halo smoothing of a partitioned level (K7)
  blocks.py        the plain level ops on a block (halo exchange, norms,
                   restriction, prolongation, agglomeration)
"""

from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
    fetch,
    initialize,
    is_multiprocess,
    launch_local,
    make_global,
)
from hpcclassmultigridproject_tpu_torch.parallel.mesh import (
    Mesh,
    factor_2d,
    make_mesh,
)
from hpcclassmultigridproject_tpu_torch.parallel.sharding import (
    RowBlocks,
    level_shardings,
    level_shardings_for_ns,
    shard_hierarchy,
    shard_level_data,
)

_NOT_PORTED = "not ported yet (ROADMAP queue 1, item {})"


def distributed_run(model, mesh: Mesh | None = None, min_local: int = 64,
                    layout: str = "auto"):
    """Run a model's whole timestepped solve with its levels partitioned
    by rows over the ranks of `mesh` (default: `make_mesh()`).

    Every rank calls this with the same host-built model.  Levels whose
    block holds at least `min_local` grid rows are partitioned (each rank
    keeps its block, and the coefficient rows of its halo); coarser ones
    are replicated on every rank (parallel/sharding.py).  The fine levels
    smooth by one deep-halo exchange and K7 per block
    (parallel/rows_halo.py, in `model.solver.sharded_overlap`'s schedule);
    the replicated ones run as on one device, the coarse tower included.

    Returns (uT cropped to the logical grid, stats) on every rank: the
    blocks are gathered (`fetch`), and the stats, computed from norms
    added over the ranks, are the same on every rank.

    `layout` "auto" and "rows" mean rows: every level of the port has a
    kernel and a plain version, so the JAX package's TPU-only choice of
    "2d" has no counterpart, and "2d" raises.  A partitioned Galerkin
    level, FMG and the Jacobi and Chebyshev smoothers over partitioned
    levels raise too, before any collective."""
    from hpcclassmultigridproject_tpu_torch.core.layout import crop_field
    from hpcclassmultigridproject_tpu_torch.mg.cycle import refuse_sharded_fmg
    from hpcclassmultigridproject_tpu_torch.mg.timestepper import timestepper

    if layout == "auto":
        layout = "rows"
    cfg = model.solver
    levels, shardings = shard_hierarchy(
        model.levels, make_mesh() if mesh is None else mesh, min_local,
        layout, nsweeps=cfg.niter)
    if any(part is not None and level.form == "nine"
           for level, part in zip(levels, shardings)):
        raise NotImplementedError(
            f"a partitioned Galerkin (nine-band) level: "
            f"{_NOT_PORTED.format(14)}")
    if cfg.smoother != "rbgs" and any(p is not None for p in shardings):
        raise NotImplementedError(
            f"smoother={cfg.smoother!r} over partitioned levels: "
            f"{_NOT_PORTED.format(14)}")
    if cfg.cycle_mode == "fmg":
        refuse_sharded_fmg(shardings)
    fine_hi = (None if model.fine_hi is None
               else shard_level_data(model.fine_hi, shardings[0]))
    u0 = make_global(model.u0, shardings[0])
    uT, stats = timestepper(levels, u0, model.problem.num_steps, cfg,
                            fine_hi, shardings=shardings)
    return crop_field(fetch(uT, shardings[0]), model.problem.n), stats


__all__ = [
    "Mesh",
    "RowBlocks",
    "factor_2d",
    "make_mesh",
    "level_shardings",
    "level_shardings_for_ns",
    "shard_hierarchy",
    "shard_level_data",
    "distributed_run",
    "initialize",
    "is_multiprocess",
    "launch_local",
    "make_global",
    "fetch",
]
