"""Multigrid cycling: V/W-cycles, coarse solves and the outer solvers, the
port of the JAX package's `mg/cycle.py` on one device.

The arrangement is the JAX package's fused one (its Pallas backend):
under red–black GS every smoothing block is one launch of the level form's
smoother kernel
(K2 from_v, K5 five-band, K6 nine-band; `ops/cuda/smoother.py`), whose
pre-smooth emits the residual (row-decimated under injection,
`_RESTRICT_DEC`) and whose post-smooth folds in the prolonged correction
(`_FUSE_CORR`).  A zero-iterate V-cycle over from_v levels from n <= 512
down to a dense coarse solve runs as the coarse tower (K3, dense solve,
K4; `_USE_TOWER`).  Each of the three switches is the JAX package's, read
at each call; off, it takes the unfused form.  Each kernel wrapper
launches its CUDA kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors; a solve of `backend="jnp"` runs the plain
versions on every device (`ops.cuda.routed`).
The weighted-Jacobi and Chebyshev smoothers have no kernel, in the JAX
package either: their blocks are `niter` plain applications and a
residual on either device, whole or partitioned, and the coarse GS solve
and the FMG bottom iterate the configured smoother.

PyTorch has no on-device while loop, so the adaptive solvers
(`mg_solve`, `coarse_solve_gs`) are host loops that read one norm per
iteration, and stop after the same count as the JAX package's
`lax.while_loop`.

With `shardings` (one partition or None per level, from
`parallel.distributed_run`: a `parallel.sharding.RowBlocks` in the rows
layout, a `GridBlocks` in the 2-D one) a level with a partition holds
this rank's block.  Under red–black GS a rows-layout 5-point block smooths
by one deep-halo exchange and K7 per block (parallel/rows_halo.py), a
2-D-layout 5-point block by one-cell exchanges on both axes before each
colour pass (parallel/halo.py), and a block thinner than the deep halo or
a nine-band block by one-line exchanges with corners
(parallel/blocks.py::rb_sweeps); the Jacobi and Chebyshev smoothers and
every other op run in their block forms (parallel/blocks.py).
Restriction into a replicated level gathers it on every rank (the
agglomeration), a partitioned coarsest level is solved on its gathered
field, and FMG restricts, solves and prolongs the same way.  The norms are
added over the ranks, so every rank reads the same value and takes the
same branch.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.config import SolverConfig
from hpcclassmultigridproject_tpu_torch.ops.cuda import routed
from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import fused_rb_sweeps
from hpcclassmultigridproject_tpu_torch.ops.cuda.tower import (
    TOWER_MAX_N,
    tower_vcycle,
)
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    interior_norm,
    rb_gauss_seidel,
    residual,
    restrict_full_weighting,
    restrict_inject,
    restrict_inject_rows_decimated,
)
from hpcclassmultigridproject_tpu_torch.parallel import blocks, halo
from hpcclassmultigridproject_tpu_torch.parallel.distributed import (
    fetch,
    make_global,
)
from hpcclassmultigridproject_tpu_torch.parallel.rows_halo import (
    fused_smooth_sharded,
    sharded_eligible,
)

# Fold the prolonged correction into the post-smooth kernel's reads
# (fused_rb_sweeps(corr=...)) instead of a separate u + corr pass; the two
# are equal to the bit.
_FUSE_CORR = True

# Run the zero-iterate sub-cycle from n <= TOWER_MAX_N down as the coarse
# tower (K3, the dense solve, K4) instead of per-level smoothing blocks.
_USE_TOWER = True

# Under injection, let a whole level's pre-smooth emit the residual's even
# rows only (the row half of the restriction) instead of the full residual
# and `restrict_inject`; mg/delta.py's whole-step opening follows it too.
_RESTRICT_DEC = True


def _get_smoother(cfg: SolverConfig, part=None):
    """One plain sweep of the configured smoother, (level, u, rhs) -> u,
    on a whole level or (Jacobi, Chebyshev) on this rank's block of a
    partitioned one (`part`)."""
    if cfg.smoother == "rbgs" and part is None:
        return rb_gauss_seidel
    if cfg.smoother == "jacobi":
        return lambda level, u, rhs: blocks.weighted_jacobi(
            level, u, rhs, cfg.jacobi_omega, part)
    if cfg.smoother == "chebyshev":
        return lambda level, u, rhs: blocks.chebyshev_smooth(
            level, u, rhs, cfg.cheby_degree, cfg.cheby_lower,
            cfg.cheby_upper, part)
    raise ValueError(f"unknown smoother {cfg.smoother!r}")


def _part(shardings, lvl: int):
    """Level lvl's partition, or None (replicated, or one device)."""
    return None if shardings is None else shardings[lvl]


def _tower_eligible(cfg: SolverConfig, levels, lvl: int,
                    u_is_zero: bool, shardings=None) -> bool:
    """The tower covers a correction solve (zero iterate) over a V-shaped
    sub-cycle of from_v levels, from a level below the finest with
    n <= TOWER_MAX_N down to a dense coarse solve, under injection and
    red–black GS, in a float32 working dtype, with no level from lvl down
    partitioned, with `_USE_TOWER` on: the JAX package's gate.  Its backend
    test has no counterpart: the tower's wrappers pick the kernel or the
    plain version by device and route."""
    if not _USE_TOWER or not u_is_zero or lvl == 0 or lvl >= len(levels) - 1:
        return False
    if shardings is not None and any(s is not None for s in shardings[lvl:]):
        return False
    if levels[lvl].n > TOWER_MAX_N:
        return False
    if (cfg.cycle_shape != 1 or cfg.restriction != "inject"
            or cfg.coarse_mode != "dense" or levels[-1].a_inv is None):
        return False
    if any(l.form != "from_v" for l in levels[lvl:-1]):
        return False
    return cfg.smoother == "rbgs" and cfg.dtype.itemsize == 4


def _restrict(cfg: SolverConfig, res, coarse_level):
    shape = coarse_level.padded
    if cfg.restriction == "inject":
        return restrict_inject(res, shape)
    if cfg.restriction == "full":
        return restrict_full_weighting(res, shape, coarse_level.n)
    raise ValueError(f"unknown restriction {cfg.restriction!r}")


def coarse_solve_gs(level, u, rhs, cfg: SolverConfig):
    """Coarsest-level solve by sweeps of the configured smoother until the
    absolute residual norm is at most `coarse_tol` or `coarse_maxiter`
    sweeps ran: check before each sweep, with a placeholder residual of 1
    at the start (the JAX package's semantics).  A host loop: each sweep
    reads one norm.  `u` None starts from zero."""
    smoother = _get_smoother(cfg)
    if u is None:
        u = torch.zeros_like(rhs)
    res = torch.ones((), dtype=torch.promote_types(rhs.dtype, torch.float32),
                     device=rhs.device)
    it = 0
    while it < cfg.coarse_maxiter and bool(res > cfg.coarse_tol):
        u = smoother(level, u, rhs)
        res = interior_norm(residual(level, u, rhs))
        it += 1
    return u


def coarse_solve_dense(level, rhs: torch.Tensor) -> torch.Tensor:
    """Exact coarse solve: one matrix–vector product with the precomputed
    interior inverse (the iterate is not needed)."""
    n, m = level.n, level.n - 1
    flat = rhs[1:n, 1:n].reshape(m * m)
    out = torch.zeros_like(rhs)
    out[1:n, 1:n] = (level.a_inv @ flat).reshape(m, m)
    return out


def _coarse_solve(level, u, rhs, cfg: SolverConfig, part=None):
    """The coarsest solve; a partitioned coarsest level (kept whole,
    parallel/sharding.py) is solved on its gathered field, the same on
    every rank, and each rank keeps its block."""
    if part is not None:
        u = None if u is None else fetch(u, part)
        return make_global(_coarse_solve(level, u, fetch(rhs, part), cfg),
                           part)
    if cfg.coarse_mode == "dense" and level.a_inv is not None:
        return coarse_solve_dense(level, rhs)
    return coarse_solve_gs(level, u, rhs, cfg)


def _smooth_block(cfg: SolverConfig, level, u, rhs, want_residual: bool,
                  part=None, zero_init: bool = False, corr=None,
                  residual_rows_decimated: bool = False):
    """One smoothing block: under red–black GS the level form's kernel on a
    whole level; on a partitioned one, the correction added first, then in
    the rows layout the deep-halo exchange and K7 per block, in the 2-D
    layout the explicit halo sweeps of parallel/halo.py (in
    `cfg.sharded_overlap`'s schedule), and on a rows block thinner than
    the halo or a nine-band block red–black sweeps with a one-line
    exchange per colour pass.  Another smoother runs `niter` plain sweeps
    and the residual (its even rows with `residual_rows_decimated`), in
    their block forms on a partitioned level."""
    if cfg.smoother != "rbgs":
        smoother = _get_smoother(cfg, part)
        if zero_init:
            u = torch.zeros_like(rhs)
        elif corr is not None:
            u = u + corr
        for _ in range(cfg.niter):
            u = smoother(level, u, rhs)
        if not want_residual:
            return u, None
        res = blocks.residual(level, u, rhs, part)
        return u, res[::2].contiguous() if residual_rows_decimated else res
    if part is None:
        if corr is not None and not _FUSE_CORR:
            u, corr = u + corr, None
        return fused_rb_sweeps(level, u, rhs, cfg.niter, want_residual,
                               zero_init=zero_init, corr=corr,
                               residual_rows_decimated=residual_rows_decimated)
    if corr is not None:
        u = u + corr
    if sharded_eligible(level, part, cfg.niter):
        return fused_smooth_sharded(part, level, u, rhs, cfg.niter,
                                    want_residual, zero_init=zero_init,
                                    overlap=cfg.sharded_overlap)
    if blocks.is_grid(part) and level.form != "nine":
        if zero_init:
            u = torch.zeros_like(rhs)
        return halo.smooth_block(part.mesh, level, u, rhs, cfg.niter,
                                 want_residual, cfg.sharded_overlap)
    u = blocks.rb_sweeps(level, u, rhs, cfg.niter, part, zero_init)
    return u, (blocks.residual(level, u, rhs, part) if want_residual
               else None)


@routed
def mg_cycle(levels, u, rhs, cfg: SolverConfig, lvl: int = 0,
             want_final_residual: bool = False, u_is_zero: bool = False,
             shardings=None):
    """One V- (cycle_shape 1) or W-cycle (2) from level `lvl`; the shape
    loop wraps the whole level body, the coarsest solve included.  With
    `u_is_zero` the iterate is zero and `u` may be None.  With
    `want_final_residual` (top level), also return rhs − A·u of the result,
    which the last post-smooth emits: returns (u, res) instead of u.
    `shardings`: see the module docstring."""
    if not want_final_residual and _tower_eligible(cfg, levels, lvl,
                                                   u_is_zero, shardings):
        return tower_vcycle(levels, lvl, rhs, cfg)
    level, part = levels[lvl], _part(shardings, lvl)
    res = None
    for sh in range(cfg.cycle_shape):
        last_pass = sh == cfg.cycle_shape - 1
        if lvl == len(levels) - 1:
            u = _coarse_solve(level, u, rhs, cfg, part)
            if want_final_residual and last_pass:
                res = blocks.residual(level, u, rhs, part)
            continue
        coarse, part_c = levels[lvl + 1], _part(shardings, lvl + 1)
        # under injection the pre-smooth of a whole level emits the
        # residual's even rows only, the row half of the restriction
        res_dec = (_RESTRICT_DEC and cfg.restriction == "inject"
                   and part is None)
        u, r0 = _smooth_block(cfg, level, u, rhs, True, part,
                              zero_init=u_is_zero and sh == 0,
                              residual_rows_decimated=res_dec)
        if res_dec:
            rhs_c = restrict_inject_rows_decimated(r0, coarse.padded)
        elif part is None:
            rhs_c = _restrict(cfg, r0, coarse)
        else:
            rhs_c = blocks.restrict(cfg.restriction, r0, coarse, part, part_c)
        u_c = mg_cycle(levels, None, rhs_c, cfg, lvl + 1, u_is_zero=True,
                       shardings=shardings)
        corr = blocks.prolong(u_c, level.padded, part, part_c)
        u, res = _smooth_block(cfg, level, u, rhs,
                               want_final_residual and last_pass, part,
                               corr=corr)
    if want_final_residual:
        return u, res
    return u


def _safe(res0):
    return torch.clamp_min(res0, torch.finfo(res0.dtype).tiny)


def _stats(cycles: int, rel, cfg: SolverConfig) -> dict:
    return {
        "cycles": torch.full((), cycles, dtype=torch.int32,
                             device=rel.device),
        "rel_residual": rel,
        "converged": rel <= cfg.tol,
    }


def host_reads(levels, cfg: SolverConfig) -> str | None:
    """Why a solve of `cfg` over `levels` reads the host inside its body,
    so that no CUDA graph can hold it (utils/graphs.py), or None: the
    adaptive solvers and the GS coarse solve are host loops here, where
    the JAX package runs them as `lax.while_loop`."""
    if cfg.cycle_mode == "adaptive":
        return ("cycle_mode 'adaptive': mg_solve (or the adaptive refined "
                "solve) reads one norm a cycle")
    if cfg.coarse_mode != "dense" or levels[-1].a_inv is None:
        return "the GS coarse solve: coarse_solve_gs reads one norm a sweep"
    return None


def _fine_norm(levels, u, rhs, shardings):
    part = _part(shardings, 0)
    return blocks.interior_norm(blocks.residual(levels[0], u, rhs, part),
                                part)


@routed
def mg_solve(levels, u, rhs, cfg: SolverConfig, shardings=None):
    """Solve A u = rhs by repeated cycles until the relative residual is at
    most tol or `max_cycles` cycles ran.  Returns (u, stats) with stats
    {"cycles", "rel_residual", "converged"} on the device; the tolerance
    test runs in the norm's dtype, as in the JAX package."""
    res0 = _fine_norm(levels, u, rhs, shardings)
    res0_safe = _safe(res0)
    res, it = res0, 0
    while it < cfg.max_cycles and bool(res / res0_safe > cfg.tol):
        u = mg_cycle(levels, u, rhs, cfg, shardings=shardings)
        res = _fine_norm(levels, u, rhs, shardings)
        it += 1
    return u, _stats(it, res / res0_safe, cfg)


@routed
def mg_solve_fixed(levels, u, rhs, cfg: SolverConfig, shardings=None):
    """Exactly `cfg.num_cycles` cycles, with the relative-residual
    certificate in stats; no host read."""
    res0_safe = _safe(_fine_norm(levels, u, rhs, shardings))
    for _ in range(cfg.num_cycles):
        u = mg_cycle(levels, u, rhs, cfg, shardings=shardings)
    rel = _fine_norm(levels, u, rhs, shardings) / res0_safe
    return u, _stats(cfg.num_cycles, rel, cfg)


@routed
def fmg_iterate(levels, rhs, cfg: SolverConfig, shardings=None):
    """The FMG ascent without a certificate: restrict `rhs` down the
    tower, solve the coarsest level, then prolong upward running
    `cfg.num_cycles` cycles per level.  Shared by `fmg_solve` and the
    refined path's FMG opening (mg/refine.py).  Partitioned levels
    restrict and prolong by blocks, and a partitioned coarsest level is
    solved on its gathered field."""
    rhs_l = [rhs]
    for lvl in range(1, len(levels)):
        part = _part(shardings, lvl - 1)
        if part is None:
            rhs_l.append(_restrict(cfg, rhs_l[-1], levels[lvl]))
        else:
            rhs_l.append(blocks.restrict(cfg.restriction, rhs_l[-1],
                                         levels[lvl], part,
                                         _part(shardings, lvl)))
    last = len(levels) - 1
    v = _coarse_solve(levels[-1], None, rhs_l[-1], cfg,
                      _part(shardings, last))
    for lvl in range(last - 1, -1, -1):
        v = blocks.prolong(v, levels[lvl].padded, _part(shardings, lvl),
                           _part(shardings, lvl + 1))
        for _ in range(cfg.num_cycles):
            v = mg_cycle(levels, v, rhs_l[lvl], cfg, lvl=lvl,
                         shardings=shardings)
    return v


@routed
def fmg_solve(levels, u, rhs, cfg: SolverConfig, shardings=None):
    """Full multigrid: the FMG iterate replaces `u`, which only sets the
    certificate's baseline residual.  stats["cycles"] counts num_cycles at
    each non-coarsest level."""
    res0_safe = _safe(_fine_norm(levels, u, rhs, shardings))
    v = fmg_iterate(levels, rhs, cfg, shardings)
    rel = _fine_norm(levels, v, rhs, shardings) / res0_safe
    return v, _stats(cfg.num_cycles * (len(levels) - 1), rel, cfg)
