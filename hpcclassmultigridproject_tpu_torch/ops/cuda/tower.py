"""K3 and K4: the coarse tower of the V-cycle, `csrc/tower.cu`.

A zero-iterate V-cycle over levels[s:] runs as the descent (K3: per level,
a cascade from zero, the residual, and injection into the next rhs), the
dense coarse solve, and the ascent (K4: per level, bilinear prolongation of
the coarser solution added to the stored iterate, then a cascade).
Replaces the JAX package's `ops/pallas/tower.py::tower_vcycle`; each
wrapper issues one kernel launch per level.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build
from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import (
    cn_constants,
    fused_rb_sweeps_plain,
)
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    prolong_bilinear,
    restrict_inject,
)

# Levels with n <= this run inside the tower (the JAX package's value).
TOWER_MAX_N = 512


def tower_descend_plain(levels, s, rhs, nsweeps: int):
    """The plain PyTorch version of the descent: the unfused recursion's
    smooth, residual and injection per level."""
    sub = levels[s:]
    u_mids, rhs_l = [], [rhs]
    for level, coarse in zip(sub[:-1], sub[1:]):
        u, res = fused_rb_sweeps_plain(level, None, rhs_l[-1], nsweeps,
                                       want_residual=True, zero_init=True)
        u_mids.append(u)
        rhs_l.append(restrict_inject(res, coarse.padded))
    return u_mids, rhs_l[:-1], rhs_l[-1]


def tower_descend(levels, s, rhs, nsweeps: int):
    """Descent over levels[s:-1] from a zero iterate.  Returns (u per level,
    rhs per level, rhs of the coarsest level)."""
    sub = levels[s:]
    if not cuda.use_kernel(rhs, *(l.v1 for l in sub[:-1])):
        return tower_descend_plain(levels, s, rhs, nsweeps)
    fn = _build.entry("mg_tower_descend", rhs.element_size())
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    u_mids, rhs_l = [], [rhs]
    for level, coarse in zip(sub[:-1], sub[1:]):
        cuda.check_inputs(level.padded, rhs.dtype, rhs=rhs_l[-1],
                          v1=level.v1, v2=level.v2)
        u = torch.empty_like(rhs_l[-1])
        rhs_c = torch.empty(coarse.padded, dtype=rhs.dtype, device=rhs.device)
        err = fn(rhs_l[-1].data_ptr(), level.v1.data_ptr(),
                 level.v2.data_ptr(), u.data_ptr(), rhs_c.data_ptr(),
                 *level.padded, *coarse.padded, level.n, nsweeps,
                 *cn_constants(level), stream)
        _build.check(err, f"tower descent kernel at n={level.n}")
        u_mids.append(u)
        rhs_l.append(rhs_c)
    cuda.LAUNCHES["tower_descent"] += 1
    return u_mids, rhs_l[:-1], rhs_l[-1]


def tower_ascend_plain(levels, s, v, u_mids, rhs_mids, nsweeps: int):
    """The plain PyTorch version of the ascent: prolong, add, smooth."""
    mids = levels[s:-1]
    for i in range(len(mids) - 1, -1, -1):
        corr = prolong_bilinear(v, mids[i].padded)
        v, _ = fused_rb_sweeps_plain(mids[i], u_mids[i], rhs_mids[i],
                                     nsweeps, corr=corr)
    return v


def tower_ascend(levels, s, v, u_mids, rhs_mids, nsweeps: int):
    """Ascent from the coarsest solution `v` up to level s, with the
    descent's per-level iterates and rhs.  Returns u at level s."""
    mids = levels[s:-1]
    if not cuda.use_kernel(v, *u_mids, *rhs_mids):
        return tower_ascend_plain(levels, s, v, u_mids, rhs_mids, nsweeps)
    fn = _build.entry("mg_tower_ascend", v.element_size())
    stream = torch.cuda.current_stream(v.device).cuda_stream
    cuda.check_inputs(levels[-1].padded, v.dtype, v=v)
    for i in range(len(mids) - 1, -1, -1):
        level = mids[i]
        cuda.check_inputs(level.padded, v.dtype, u=u_mids[i],
                          rhs=rhs_mids[i], v1=level.v1, v2=level.v2)
        u = torch.empty_like(u_mids[i])
        err = fn(v.data_ptr(), *v.shape, u_mids[i].data_ptr(),
                 rhs_mids[i].data_ptr(), level.v1.data_ptr(),
                 level.v2.data_ptr(), u.data_ptr(), *level.padded, level.n,
                 nsweeps, *cn_constants(level), stream)
        _build.check(err, f"tower ascent kernel at n={level.n}")
        v = u
    cuda.LAUNCHES["tower_ascent"] += 1
    return v


def tower_vcycle(levels, s, rhs, cfg):
    """One V-cycle over levels[s:] from a zero iterate: descent, dense
    coarse solve, ascent.  The caller checks eligibility
    (mg/cycle.py::_tower_eligible)."""
    # imported here: mg/cycle.py imports this module
    from hpcclassmultigridproject_tpu_torch.mg.cycle import coarse_solve_dense

    u_mids, rhs_mids, rhs_bottom = tower_descend(levels, s, rhs, cfg.niter)
    v = coarse_solve_dense(levels[-1], rhs_bottom)
    return tower_ascend(levels, s, v, u_mids, rhs_mids, cfg.niter)
