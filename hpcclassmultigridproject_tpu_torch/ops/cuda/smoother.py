"""K2: the fused red–black Gauss–Seidel smoothing block, `csrc/smoother.cu`.

`nsweeps` sweeps with the CN coefficients recomputed from (v1, v2), plus
an optional trailing residual, in one pass over device memory.  Replaces
the JAX package's `ops/pallas/smoother.py::fused_rb_sweeps` in its from_v
form.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build
from hpcclassmultigridproject_tpu_torch.ops.padded import (
    coefs_from_v,
    rb_gauss_seidel,
    residual_from_v,
)

# flag bits of the C entry point (csrc/smoother.cu)
_ZERO_INIT, _ADD_CORR, _WANT_RES, _RES_ROWS_DEC = 1, 2, 4, 8


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
    `ops/padded.py::rb_gauss_seidel` and one `residual_from_v`."""
    coefs = coefs_from_v(level)
    if zero_init:
        u = torch.zeros_like(rhs)
    elif corr is not None:
        u = u + corr
    for _ in range(nsweeps):
        u = rb_gauss_seidel(level, u, rhs, coefs)
    if not want_residual:
        return u, None
    res = residual_from_v(level, u, rhs, coefs)
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
    launch the kernel, CPU tensors run the plain version."""
    if zero_init and corr is not None:
        raise ValueError("zero_init and corr are exclusive")
    if residual_rows_decimated and not want_residual:
        raise ValueError("residual_rows_decimated needs want_residual")
    if zero_init:
        u = None
    if not cuda.use_kernel(u, corr, rhs, level.v1, level.v2):
        return fused_rb_sweeps_plain(level, u, rhs, nsweeps, want_residual,
                                     zero_init, corr, residual_rows_decimated)
    fields = dict(rhs=rhs, v1=level.v1, v2=level.v2)
    fields.update({k: t for k, t in (("u", u), ("corr", corr))
                   if t is not None})
    cuda.check_inputs(level.padded, rhs.dtype, **fields)
    rows, cols = level.padded
    u_out = torch.empty_like(rhs)
    res = None
    if want_residual:
        res_rows = rows // 2 if residual_rows_decimated else rows
        res = torch.empty((res_rows, cols), dtype=rhs.dtype,
                          device=rhs.device)
    flags = ((_ZERO_INIT if zero_init else 0)
             | (_ADD_CORR if corr is not None else 0)
             | (_WANT_RES if want_residual else 0)
             | (_RES_ROWS_DEC if residual_rows_decimated else 0))
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.entry("mg_smooth", rhs.element_size())(
        ptr(u), ptr(corr), rhs.data_ptr(), level.v1.data_ptr(),
        level.v2.data_ptr(), u_out.data_ptr(), ptr(res), rows, cols, level.n,
        nsweeps, *cn_constants(level), flags,
        torch.cuda.current_stream(rhs.device).cuda_stream)
    _build.check(err, "smooth kernel")
    cuda.LAUNCHES["smooth"] += 1
    return u_out, res
