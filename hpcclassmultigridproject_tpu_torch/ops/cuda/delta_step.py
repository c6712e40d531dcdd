"""K1: the delta step's opening, `csrc/delta_step.cu`.

Folds the pending correction d into the float32 state pair (hi, lo) by
TwoSum and forms the next step's difference-form delta rhs, in one pass.
Replaces the JAX package's `ops/pallas/delta_step.py::fused_accumulate_open`.
"""

from __future__ import annotations

import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build


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
