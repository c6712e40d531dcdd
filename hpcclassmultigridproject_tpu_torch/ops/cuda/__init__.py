"""Hand-written CUDA kernels for Hopper (sm_90a) and their routing.

Each kernel module (delta_step, smoother, tower) holds a wrapper and the
kernel's plain PyTorch version.  The wrapper launches the kernel for CUDA
tensors and runs the plain version for CPU tensors; there is no other
route and no fallback.  Each launch adds one to its entry of `LAUNCHES`,
so a run can show which kernels carried it.

Nothing here imports ctypes or calls nvcc at import time: the library is
built and loaded at the first launch (`_build.library`).
"""

from __future__ import annotations

import contextlib

import torch

# Launch counts per kernel, one per wrapper call that launched it.
LAUNCHES = {"delta_open": 0, "smooth": 0, "tower_descent": 0,
            "tower_ascent": 0}

_plain_on_cuda = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_route():
    """Run every kernel's plain PyTorch version, CUDA tensors included, for
    as long as the context lasts.  Only for comparing the kernel path with
    the plain path on the card; the main path never enters it."""
    global _plain_on_cuda
    _plain_on_cuda = True
    try:
        yield
    finally:
        _plain_on_cuda = False


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensors), False for the plain
    version (CPU tensors).  Tensors on two devices, or on any other kind
    of device, raise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    kind = devices.pop().type
    if kind == "cuda":
        return not _plain_on_cuda
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel route for device type {kind!r}")


def check_inputs(shape, dtype, **tensors) -> None:
    """Raise unless every named tensor has `shape` and `dtype` and is
    contiguous: what the kernels take."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernels take float32 or float64, not {dtype}")
    for name, t in tensors.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(
                f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                f"{tuple(shape)} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
