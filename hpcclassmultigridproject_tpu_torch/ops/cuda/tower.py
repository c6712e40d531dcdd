"""K3 and K4: the coarse tower of the V-cycle, `csrc/tower.cu`.

A zero-iterate V-cycle over levels[s:] runs as the descent (K3: per level,
a cascade from zero, the residual, and injection into the next rhs), the
dense coarse solve, and the ascent (K4: per level, bilinear prolongation of
the coarser solution added to the stored iterate, then a cascade).
Replaces the JAX package's `ops/pallas/tower.py::tower_vcycle`; each
wrapper issues one cooperative kernel launch that walks every level, with a
grid-wide barrier between levels, as the JAX package runs each half as one
program.
"""

from __future__ import annotations

import ctypes

import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build
from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import (
    FROM_V_MAX_SWEEPS,
    cn_constants,
    fused_rb_sweeps_plain,
)
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    prolong_bilinear,
    restrict_inject,
)

# Levels with n <= this run inside the tower (the JAX package's value).
TOWER_MAX_N = 512

# (blocks per SM, SMs, grid) of the last launch of each half, by dtype:
# what the kernel chose for this card (csrc/tower.cu::launch_tower).
GRID = {}


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


def _carve(shapes, like: torch.Tensor):
    """Contiguous tensors of `shapes`, views of one buffer on `like`'s
    device and dtype: one allocation for all of a launch's outputs.  Every
    padded shape holds a multiple of 8x128 values, so each view starts
    aligned as its own allocation would."""
    sizes = [r * c for r, c in shapes]
    flat = torch.empty(sum(sizes), dtype=like.dtype, device=like.device)
    return [x.view(shape) for x, shape in zip(flat.split(sizes), shapes)]


def _launch(name, half, ptrs, dims, consts, nsweeps, scratch, like):
    """Call the C entry `name` once for every level of the half: pointers,
    shapes and CN constants in three flat arrays."""
    fn = _build.entry(name, like.element_size())
    info = (ctypes.c_int * 3)()
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_int * len(dims))(*dims),
             (ctypes.c_double * len(consts))(*consts), len(dims) // 5,
             nsweeps, None if scratch is None else scratch.data_ptr(), info,
             torch.cuda.current_stream(like.device).cuda_stream)
    _build.check(err, f"tower {half} kernel")
    GRID[half, like.dtype] = tuple(info)


def tower_descend(levels, s, rhs, nsweeps: int):
    """Descent over levels[s:-1] from a zero iterate.  Returns (u per level,
    rhs per level, rhs of the coarsest level)."""
    sub = levels[s:]
    mids = sub[:-1]
    if not cuda.use_kernel(rhs, *(l.v1 for l in mids)):
        return tower_descend_plain(levels, s, rhs, nsweeps)
    cuda.check_inputs(sub[0].padded, rhs.dtype, rhs=rhs)
    for level in mids:
        cuda.check_inputs(level.padded, rhs.dtype, v1=level.v1, v2=level.v2)
    chained = nsweeps > FROM_V_MAX_SWEEPS
    out = _carve([l.padded for l in mids] + [c.padded for c in sub[1:]]
                 + [sub[0].padded] * chained, rhs)
    u_mids, rhs_l = out[:len(mids)], [rhs, *out[len(mids):2 * len(mids)]]
    ptrs, dims, consts = [], [], []
    for i, (level, coarse) in enumerate(zip(mids, sub[1:])):
        ptrs += [rhs_l[i].data_ptr(), level.v1.data_ptr(),
                 level.v2.data_ptr(), u_mids[i].data_ptr(),
                 rhs_l[i + 1].data_ptr()]
        dims += [*level.padded, level.n, *coarse.padded]
        consts += cn_constants(level)
    _launch("mg_tower_descend", "descent", ptrs, dims, consts, nsweeps,
            out[-1] if chained else None, rhs)
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
    cuda.check_inputs(levels[-1].padded, v.dtype, v=v)
    for level, u, rhs in zip(mids, u_mids, rhs_mids, strict=True):
        cuda.check_inputs(level.padded, v.dtype, u=u, rhs=rhs, v1=level.v1,
                          v2=level.v2)
    chained = nsweeps > FROM_V_MAX_SWEEPS
    out = _carve([l.padded for l in mids] + [mids[0].padded] * chained, v)
    srcs = [*out[1:len(mids)], v]
    ptrs, dims, consts = [], [], []
    for level, src, u, rhs, u_out in zip(mids, srcs, u_mids, rhs_mids, out):
        ptrs += [src.data_ptr(), u.data_ptr(), rhs.data_ptr(),
                 level.v1.data_ptr(), level.v2.data_ptr(), u_out.data_ptr()]
        dims += [*level.padded, level.n, *src.shape]
        consts += cn_constants(level)
    _launch("mg_tower_ascend", "ascent", ptrs, dims, consts, nsweeps,
            out[-1] if chained else None, v)
    cuda.LAUNCHES["tower_ascent"] += 1
    return out[0]


def tower_vcycle(levels, s, rhs, cfg):
    """One V-cycle over levels[s:] from a zero iterate: descent, dense
    coarse solve, ascent.  The caller checks eligibility
    (mg/cycle.py::_tower_eligible)."""
    # imported here: mg/cycle.py imports this module
    from hpcclassmultigridproject_tpu_torch.mg.cycle import coarse_solve_dense

    u_mids, rhs_mids, rhs_bottom = tower_descend(levels, s, rhs, cfg.niter)
    v = coarse_solve_dense(levels[-1], rhs_bottom)
    return tower_ascend(levels, s, v, u_mids, rhs_mids, cfg.niter)
