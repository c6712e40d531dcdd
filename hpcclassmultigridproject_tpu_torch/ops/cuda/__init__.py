"""Hand-written CUDA kernels for Hopper (sm_90a) and their routing.

Each kernel module (delta_step, smoother, tower, probe, loop, peer) holds its
wrappers and the kernels' plain PyTorch versions.  The wrapper launches
the kernel for CUDA tensors and runs the plain version for CPU tensors,
or for every tensor inside `plain_route()`, which a solve of
`SolverConfig.backend="jnp"` enters (`routed`; `loop.while_set` and the
peer transport aside);
there is no other route and no fallback.  Each launch
adds one to its entry of `LAUNCHES`, so a run can show which kernels
carried it.

Nothing here imports ctypes or calls nvcc at import time: the library is
built and loaded at the first launch (`_build.library`).
"""

from __future__ import annotations

import contextlib
import functools
import inspect

import torch

# Launch counts per kernel, one per wrapper call that launched it.
LAUNCHES = {"delta_open": 0, "open_presmooth": 0, "smooth": 0, "smooth5": 0,
            "smooth9": 0, "smooth_rows": 0, "tower_descent": 0,
            "tower_ascent": 0, "probe_stride2_rows": 0,
            "probe_dot_decimate": 0, "probe_interleave_rows": 0,
            "probe_flatten": 0, "probe_dot_decimate_rows": 0,
            "probe_dot_prolong_rows": 0, "while_set": 0,
            "peer_exchange": 0, "peer_gather": 0, "peer_reduce": 0}

# The predicate tests that the host form of `utils.graphs.while_loop` made,
# one host read each: where the loop is captured, each test is a launch of
# while_set instead, so a replay's LAUNCHES["while_set"] is the eager run's
# count here.
HOST_TESTS = {"while_set": 0}

# The collectives of a partitioned run, one per call that posted it:
# `batch_isend_irecv` batches and `all_gather` calls, counted by the
# wrappers of parallel/distributed.py (`start_exchange`, `all_sum`,
# `all_gather_blocks`), whichever transport carries them (NCCL, gloo, or
# inside a captured WHILE body the peer kernels, which count their
# launches in LAUNCHES too).  A captured program's replay adds them as it
# adds LAUNCHES (utils/graphs.py).
COLLECTIVES = {"batch_isend_irecv": 0, "all_gather": 0}

_plain_on_cuda = False


def reset_launches() -> None:
    """Zero LAUNCHES, HOST_TESTS and COLLECTIVES."""
    for counts in (LAUNCHES, HOST_TESTS, COLLECTIVES):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def plain_route():
    """Run every kernel's plain PyTorch version, CUDA tensors included, for
    as long as the context lasts, then restore the route it found (but
    the while node's `loop.while_set`, the counterpart of XLA's own
    `while`, which the JAX package's "jnp" backend keeps).  A solve
    of backend "jnp" runs in it (`routed`), and the card's checks enter it
    to compare the kernel path with the plain path."""
    global _plain_on_cuda
    old, _plain_on_cuda = _plain_on_cuda, True
    try:
        yield
    finally:
        _plain_on_cuda = old


def backend_route(backend: str):
    """The context a solve of `SolverConfig.backend` runs in: "jnp" the
    plain versions on every device (the JAX package's XLA-only route),
    "auto" and "pallas" the kernels on CUDA tensors."""
    return plain_route() if backend == "jnp" else contextlib.nullcontext()


def routed(fn):
    """Decorate a solver entry point whose SolverConfig parameter is named
    `cfg`: each call runs in `backend_route(cfg.backend)`, so the route is
    decided per solve, and left as it was found when the call returns or
    raises."""
    at = list(inspect.signature(fn).parameters).index("cfg")

    @functools.wraps(fn)
    def call(*args, **kwargs):
        cfg = args[at] if len(args) > at else kwargs["cfg"]
        if cfg.backend != "jnp":
            return fn(*args, **kwargs)
        with plain_route():
            return fn(*args, **kwargs)

    return call


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
