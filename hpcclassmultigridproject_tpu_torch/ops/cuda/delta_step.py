"""K1 and K8: the delta step's opening, `csrc/delta_step.cu`.

K1 folds the pending correction d into the float32 state pair (hi, lo) by
TwoSum and forms the next step's difference-form delta rhs, in one pass.
Replaces the JAX package's `ops/pallas/delta_step.py::fused_accumulate_open`.

K8, the whole-step opening, adds the top level's zero-init pre-smooth
block and its trailing residual (full or row-decimated) to the same pass,
on the from_v smoothing block that K2 launches.  Replaces
`ops/pallas/delta_step.py::fused_open_presmooth`; the delta stepper
reaches it only under `mg/delta.py::_FUSE_OPEN_SMOOTH`.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build, smoother
from hpcclassmultigridproject_tpu_torch.ops.cuda.smoother import (
    cn_constants,
    fused_rb_sweeps_plain,
)

# the C entry's res_mode (csrc/common.cuh, ResMode)
_RES_NONE, _RES_FULL, _RES_ROWS_DEC = 0, 1, 2


def fused_accumulate_open_plain(level, hi, lo, d):
    """The plain PyTorch version: `mg/delta.py::_accumulate` then
    `delta_rhs`."""
    # imported here: mg/delta.py imports this module
    from hpcclassmultigridproject_tpu_torch.mg import delta

    hi2, lo2 = delta._accumulate(hi, lo, d)
    return hi2, lo2, delta.delta_rhs(level, hi2, lo2)


def fused_accumulate_open(level, hi, lo, d):
    """Returns (hi', lo', rhs_δ) with hi' + lo' = hi + lo + d (TwoSum) and
    rhs_δ = (B − A)(hi' + lo') in difference form, masked to the open
    interior.  CUDA tensors launch the kernel, CPU tensors run the plain
    version."""
    if not cuda.use_kernel(hi, lo, d, level.v1, level.v2):
        return fused_accumulate_open_plain(level, hi, lo, d)
    from hpcclassmultigridproject_tpu_torch.mg import delta

    cuda.check_inputs(level.padded, hi.dtype, hi=hi, lo=lo, d=d, v1=level.v1,
                      v2=level.v2)
    hi2, lo2, rhs = (torch.empty_like(hi) for _ in range(3))
    rows, cols = level.padded
    two_rnu, r_h = delta.difference_form_constants(level)
    err = _build.entry("mg_delta_open", hi.element_size())(
        hi.data_ptr(), lo.data_ptr(), d.data_ptr(), level.v1.data_ptr(),
        level.v2.data_ptr(), hi2.data_ptr(), lo2.data_ptr(), rhs.data_ptr(),
        rows, cols, level.n, two_rnu, r_h,
        torch.cuda.current_stream(hi.device).cuda_stream)
    _build.check(err, "delta_open kernel")
    cuda.LAUNCHES["delta_open"] += 1
    return hi2, lo2, rhs


def fused_open_presmooth_plain(level, hi, lo, d, nsweeps: int,
                               residual_rows_decimated: bool = False):
    """The plain PyTorch version: `fused_accumulate_open_plain`, then
    `fused_rb_sweeps_plain` from zero on its rhs, with the residual."""
    hi2, lo2, rhs = fused_accumulate_open_plain(level, hi, lo, d)
    u1, r0 = fused_rb_sweeps_plain(
        level, None, rhs, nsweeps, want_residual=True, zero_init=True,
        residual_rows_decimated=residual_rows_decimated)
    return hi2, lo2, rhs, u1, r0


def open_in_launches(nsweeps: int, opening, link):
    """`nsweeps` sweeps of the whole-step opening as launches of at most
    `FROM_V_MAX_SWEEPS` each (`smoother.in_launches`): `opening(k, last)`
    first (K8: the opening, k sweeps from zero), then `link(u, None, k,
    last)` from its iterate (K2 on K8's rhs_δ); each returns (u, residual)
    and only the last writes the residual.  Each launch matches the
    global-barrier schedule exactly, so the chain equals one schedule to
    the bit."""
    return smoother.in_launches(
        None, None, nsweeps,
        lambda u, corr, k, last: (opening(k, last) if u is None
                                  else link(u, corr, k, last)))


def fused_open_presmooth(level, hi, lo, d, nsweeps: int,
                         residual_rows_decimated: bool = False):
    """The whole-step opening: returns (hi', lo', rhs_δ, u1, r0), where
    (hi', lo', rhs_δ) are `fused_accumulate_open`'s, u1 is `nsweeps`
    red–black sweeps of A u = rhs_δ from zero, and r0 = rhs_δ − A u1 (its
    even rows only, shape (rows/2, cols), with `residual_rows_decimated`).
    From_v levels on one device, any nsweeps (past `FROM_V_MAX_SWEEPS`, K8
    then K2 launches: `open_in_launches`, one count).  CUDA tensors launch
    the kernel, CPU tensors run the plain version."""
    if level.form != "from_v" or level.row_off or level.col_off:
        raise ValueError("the whole-step opening takes a whole from_v level")
    if not cuda.use_kernel(hi, lo, d, level.v1, level.v2):
        return fused_open_presmooth_plain(level, hi, lo, d, nsweeps,
                                          residual_rows_decimated)
    from hpcclassmultigridproject_tpu_torch.mg import delta

    cuda.check_inputs(level.padded, hi.dtype, hi=hi, lo=lo, d=d, v1=level.v1,
                      v2=level.v2)
    rows, cols = level.padded
    hi2, lo2, rhs = (torch.empty_like(hi) for _ in range(3))
    fn = _build.entry("mg_open_smooth", hi.element_size())
    stream = torch.cuda.current_stream(hi.device).cuda_stream
    mode = _RES_ROWS_DEC if residual_rows_decimated else _RES_FULL

    def opening(k, last):
        u1 = torch.empty_like(hi)
        r0 = None
        if last:
            r0 = torch.empty((rows // 2 if residual_rows_decimated else rows,
                              cols), dtype=hi.dtype, device=hi.device)
        err = fn(hi.data_ptr(), lo.data_ptr(), d.data_ptr(),
                 level.v1.data_ptr(), level.v2.data_ptr(), hi2.data_ptr(),
                 lo2.data_ptr(), rhs.data_ptr(), u1.data_ptr(),
                 None if r0 is None else r0.data_ptr(), rows, cols, level.n,
                 k, *cn_constants(level),
                 *delta.difference_form_constants(level),
                 mode if last else _RES_NONE, stream)
        _build.check(err, "open_presmooth kernel")
        return u1, r0

    def link(u, corr, k, last):
        return smoother.launcher(level, rhs, True,
                                 residual_rows_decimated)(u, corr, k, last)

    u1, r0 = open_in_launches(nsweeps, opening, link)
    cuda.LAUNCHES["open_presmooth"] += 1
    return hi2, lo2, rhs, u1, r0
