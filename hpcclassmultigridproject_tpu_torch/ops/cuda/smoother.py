"""K2, K5, K6, K7: the fused red–black Gauss–Seidel smoothing block,
`csrc/smoother.cu`.

`nsweeps` sweeps plus an optional trailing residual, in one pass over
device memory.  Replaces the JAX package's
`ops/pallas/smoother.py::fused_rb_sweeps`, whose three single-device forms
become three kernels picked by the level's form (mg/levels.py):

- K2 (`smooth`): from_v levels, the CN coefficients recomputed from (v1, v2);
- K5 (`smooth5`): five-band levels, stored aa..dd and the scalar diagonal;
- K6 (`smooth9`): nine-band (Galerkin) levels, stored aa..dd, ne..sw and
  the varying diagonal;

all three on one block (`csrc/common.cuh::smooth_from_v`, its coefficient
source a compile-time variant),

and its sharded form (`_fused(with_row_off=True)`):

- K7 (`smooth_rows`, `fused_rb_sweeps_rows`): K2 on a rank's block of a
  row-partitioned from_v level, whose interior mask reads global rows
  through the level's `row_off` (parallel/rows_halo.py).
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.mg.levels import BANDS, CORNERS
from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    coefs,
    rb_gauss_seidel,
    residual,
)

# flag bits of the C entry points (csrc/smoother.cu)
_ZERO_INIT, _ADD_CORR, _WANT_RES, _RES_ROWS_DEC = 1, 2, 4, 8

# The most sweeps one launch of the from_v block (K2, K5, K6, K7) takes: its
# 64x64 window (csrc/common.cuh, FV_WIN_H x FV_WIN_W) must keep a tile
# inside a halo of 2·nsweeps+1 rows and as many columns rounded up to 4.
# The wrapper runs more as a chain of launches (`in_launches`).
FROM_V_MAX_SWEEPS = 13

# per form: (C entry point, launch counter, stored fields it reads)
_FORMS = {
    "from_v": ("mg_smooth", "smooth", ("v1", "v2")),
    "five": ("mg_smooth5", "smooth5", BANDS),
    "nine": ("mg_smooth9", "smooth9", (*BANDS, *CORNERS, "diag")),
}


def cn_constants(level):
    """(rr, h/2, ν, diag_a, 1/diag_a) in double, for a kernel that
    recomputes the CN coefficients; it rounds each to its dtype."""
    return (level.rr, 0.5 * level.h, level.nu, level.diag_a,
            1.0 / level.diag_a)


def fused_rb_sweeps_plain(level, u, rhs, nsweeps: int,
                          want_residual: bool = False,
                          zero_init: bool = False, corr=None,
                          residual_rows_decimated: bool = False):
    """The plain PyTorch version: `nsweeps` calls of
    `ops/padded.py::rb_gauss_seidel` and one `residual`, on the level's
    stencil whatever its form."""
    c = coefs(level)
    if zero_init:
        u = torch.zeros_like(rhs)
    elif corr is not None:
        u = u + corr
    for _ in range(nsweeps):
        u = rb_gauss_seidel(level, u, rhs, c)
    if not want_residual:
        return u, None
    res = residual(level, u, rhs, c)
    if residual_rows_decimated:
        res = res[::2].contiguous()
    return u, res


def fused_rb_sweeps(level, u, rhs, nsweeps: int, want_residual: bool = False,
                    zero_init: bool = False, corr=None,
                    residual_rows_decimated: bool = False):
    """Returns (u, residual or None) after `nsweeps` red–black sweeps.

    `zero_init`: start from u = 0 (u may be None).  `corr`: start from
    u + corr.  `residual_rows_decimated`: return the residual's even rows
    only, shape (rows/2, cols), the row half of an injection.  CUDA tensors
    launch the level form's kernel (K2, K5 or K6), CPU tensors run the
    plain version.  Every form takes any nsweeps, past `FROM_V_MAX_SWEEPS`
    as a chain of launches, one count in `LAUNCHES`."""
    if zero_init and corr is not None:
        raise ValueError("zero_init and corr are exclusive")
    if residual_rows_decimated and not want_residual:
        raise ValueError("residual_rows_decimated needs want_residual")
    if level.form == "from_v" and level.row_off:
        raise ValueError("a block of a row-partitioned level (row_off "
                         f"{level.row_off}) takes fused_rb_sweeps_rows (K7)")
    if level.col_off:
        raise ValueError("a block of a 2-D-partitioned level (col_off "
                         f"{level.col_off}) is smoothed by parallel/halo.py")
    return _launch(level, u, rhs, nsweeps, want_residual, zero_init, corr,
                   residual_rows_decimated, _FORMS[level.form])


def fused_rb_sweeps_rows(level, u, rhs, nsweeps: int,
                         want_residual: bool = False,
                         zero_init: bool = False):
    """K7: `fused_rb_sweeps` on a rank's block of a row-partitioned from_v
    level, whose array row 0 is global row `level.row_off`.  The block
    (u, rhs and the level's v1, v2) has the level's stored shape; the
    kernel reads colours from array rows, so an odd `row_off` raises.
    CUDA tensors launch the kernel, CPU tensors run the plain version
    (`fused_rb_sweeps_plain`, which reads `row_off` through
    `ops/padded.py::coefs`)."""
    if level.form != "from_v" or level.col_off:
        raise ValueError(f"K7 takes whole-width from_v levels, not "
                         f"{level.form} with col_off {level.col_off}")
    if level.row_off % 2:
        raise ValueError(
            f"row_off {level.row_off} is odd: K7 takes a cell's colour from "
            "its array row, which is its global colour only at an even "
            "offset")
    return _launch(level, u, rhs, nsweeps, want_residual, zero_init, None,
                   False, ("mg_smooth", "smooth_rows", ("v1", "v2")))


def in_launches(u, corr, nsweeps: int, launch):
    """`nsweeps` sweeps as launches of at most `FROM_V_MAX_SWEEPS` each:
    `launch(u, corr, k, last)` runs k sweeps from u (+ corr) and returns
    (u, residual); every launch but the last skips the residual.  Each
    launch matches the global-barrier schedule exactly, so the chain equals
    one launch of `nsweeps` to the bit."""
    while nsweeps > FROM_V_MAX_SWEEPS:
        u, _ = launch(u, corr, FROM_V_MAX_SWEEPS, False)
        corr, nsweeps = None, nsweeps - FROM_V_MAX_SWEEPS
    return launch(u, corr, nsweeps, True)


def _launch(level, u, rhs, nsweeps, want_residual, zero_init, corr,
            residual_rows_decimated, form):
    """Launch `form`'s (entry point, counter, stored fields) kernel, or run
    the plain version for CPU tensors."""
    if zero_init:
        u = None
    entry, counter, names = form
    stored = [getattr(level, k) for k in names]
    if not cuda.use_kernel(u, corr, rhs, *stored):
        return fused_rb_sweeps_plain(level, u, rhs, nsweeps, want_residual,
                                     zero_init, corr, residual_rows_decimated)
    fields = dict(zip(names, stored), rhs=rhs)
    fields.update({k: t for k, t in (("u", u), ("corr", corr))
                   if t is not None})
    cuda.check_inputs(level.padded, rhs.dtype, **fields)
    out = in_launches(u, corr, nsweeps,
                      launcher(level, rhs, want_residual,
                               residual_rows_decimated, form))
    cuda.LAUNCHES[counter] += 1
    return out


def launcher(level, rhs, want_residual: bool, residual_rows_decimated: bool,
             form=None):
    """`in_launches`' launch(u, corr, nsweeps, last) for CUDA tensors of the
    level's shape: one launch of `form`'s kernel (the level form's by
    default) on `rhs`, from u + corr (from zero where u is None), with the
    residual on the last launch if `want_residual`.  Counts nothing: the
    caller counts its call."""
    entry, counter, names = form or _FORMS[level.form]
    stored = [getattr(level, k) for k in names]
    rows, cols = level.padded
    stream = torch.cuda.current_stream(rhs.device).cuda_stream
    fn = _build.entry(entry, rhs.element_size())
    ptr = lambda t: None if t is None else t.data_ptr()

    def launch(u, corr, nsweeps, last):
        res_out = want_residual and last
        u_out = torch.empty_like(rhs)
        res = None
        if res_out:
            res_rows = rows // 2 if residual_rows_decimated else rows
            res = torch.empty((res_rows, cols), dtype=rhs.dtype,
                              device=rhs.device)
        flags = ((_ZERO_INIT if u is None else 0)
                 | (_ADD_CORR if corr is not None else 0)
                 | (_WANT_RES if res_out else 0)
                 | (_RES_ROWS_DEC if res_out and residual_rows_decimated
                    else 0))
        head = (ptr(u), ptr(corr), rhs.data_ptr(),
                *(t.data_ptr() for t in stored), u_out.data_ptr(), ptr(res),
                rows, cols)
        if level.form == "from_v":
            err = fn(*head, level.n, level.row_off, nsweeps,
                     *cn_constants(level), flags, stream)
        elif level.form == "five":
            err = fn(*head, nsweeps, level.diag_a, 1.0 / level.diag_a, flags,
                     stream)
        else:
            err = fn(*head, nsweeps, flags, stream)
        _build.check(err, f"{counter} kernel")
        return u_out, res

    return launch
