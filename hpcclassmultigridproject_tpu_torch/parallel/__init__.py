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
    shard_windows,
)

_NOT_PORTED = "not ported yet (ROADMAP queue 1: the rest of parallel/)"
# the default of distributed_run's `min_local` and `layout`, told apart from
# the same value passed
_UNSET = object()


def refuse_partitioned(cfg, shardings, levels=None) -> None:
    """Raise NotImplementedError, before any collective, for what does not
    run over partitioned levels yet: a partitioned Galerkin (nine-band)
    level, the Jacobi and Chebyshev smoothers, and FMG."""
    from hpcclassmultigridproject_tpu_torch.mg.cycle import refuse_sharded_fmg

    if levels is not None and any(
            part is not None and level.form == "nine"
            for level, part in zip(levels, shardings)):
        raise NotImplementedError(
            f"a partitioned Galerkin (nine-band) level: {_NOT_PORTED}")
    if cfg.smoother != "rbgs" and any(p is not None for p in shardings):
        raise NotImplementedError(
            f"smoother={cfg.smoother!r} over partitioned levels: "
            f"{_NOT_PORTED}")
    if cfg.cycle_mode == "fmg":
        refuse_sharded_fmg(shardings)


def _born_partitioned(model, mesh, min_local, layout):
    """The levels, shardings, fine_hi and u0 of a model born
    row-partitioned, which holds its blocks already; a mesh, `min_local`
    or layout other than the model's raises ValueError."""
    if mesh is not None and mesh != model.mesh:
        raise ValueError(
            f"the model was built row-partitioned over {model.mesh}, not "
            f"{mesh}: build it with AdvectionDiffusion(..., mesh=mesh)")
    if min_local is not _UNSET and min_local != model.min_local:
        raise ValueError(
            f"min_local={min_local}: the model was built row-partitioned "
            f"with min_local={model.min_local}")
    if layout is not _UNSET and _rows_layout(layout) != model.layout:
        raise ValueError(
            f"layout={layout!r}: the model was built row-partitioned in "
            f"layout {model.layout!r}")
    return model.levels, model.shardings, model.fine_hi, model.u0


def _rows_layout(layout: str) -> str:
    return "rows" if layout == "auto" else layout


def distributed_run(model, mesh: Mesh | None = None, min_local: int = _UNSET,
                    layout: str = _UNSET):
    """Run a model's whole timestepped solve with its levels partitioned
    by rows over the ranks of `mesh` (default: `make_mesh()`).

    Every rank calls this with the same model.  Built whole, the model is
    partitioned here: levels whose block holds at least `min_local`
    (default 64) grid rows are partitioned (each rank keeps its block,
    and the coefficient rows of its halo); coarser ones are replicated on
    every rank (parallel/sharding.py).  A model born row-partitioned
    (`AdvectionDiffusion(..., mesh=...)`) holds only its blocks already
    and runs as built: a mesh, `min_local` or layout passed here that
    differs from its own raises ValueError.  The fine levels smooth by
    one deep-halo exchange and K7 per block (parallel/rows_halo.py, in
    `model.solver.sharded_overlap`'s schedule); the replicated ones run
    as on one device, the coarse tower included.

    Returns (uT cropped to the logical grid, stats) on every rank: the
    blocks are gathered (`fetch`), and the stats, computed from norms
    added over the ranks, are the same on every rank.

    `layout` "auto" (the default) and "rows" mean rows: every level of
    the port has a kernel and a plain version, so the JAX package's
    TPU-only choice of "2d" has no counterpart, and "2d" raises.  A
    partitioned Galerkin level, FMG and the Jacobi and Chebyshev
    smoothers over partitioned levels raise too, before any collective."""
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
            _rows_layout("auto" if layout is _UNSET else layout),
            nsweeps=cfg.niter)
        fine_hi = (None if model.fine_hi is None
                   else shard_level_data(model.fine_hi, shardings[0]))
        u0 = make_global(model.u0, shardings[0])
    refuse_partitioned(cfg, shardings, levels)
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
    "shard_windows",
    "distributed_run",
    "refuse_partitioned",
    "initialize",
    "is_multiprocess",
    "launch_local",
    "make_global",
    "fetch",
]
