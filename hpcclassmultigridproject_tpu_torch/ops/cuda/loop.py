"""The while node of a captured loop, `csrc/loop.cu`.

`while_set` is the wrapper of the port's one kernel that replaces no
pl.pallas_call: the test of a `utils.graphs.while_loop` captured on the card
(the counterpart of XLA's `while`, which the JAX package's `lax.while_loop`
becomes).  A loop's cond returns a `LoopTest`, the predicate's operands, and
`while_set` launches `mg_while_set`, which evaluates the whole predicate,
sets the conditional node's value to it and counts a trip where it holds:
one launch a test.  Its plain version is the host form's test: the
predicate as the torch expression every loop of the port wrote before
(`predicate`), one host read of it, and the trip counted on the host
tensor.

The other three calls are the host half of the node, plain C on torch's
stream handle: the conditional handle, the node and its body's capture.

`plain_route()` (backend "jnp") does not reach it: that route swaps the
Pallas kernels' counterparts for their plain versions, and the JAX
package's "jnp" backend keeps XLA's `while` all the same.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build

_INT32 = (-2**31, 2**31 - 1)
# the kernel's `kind` of a residual clause: none, float32, float64
_KINDS = {None: 0, torch.float32: 1, torch.float64: 2}


@dataclasses.dataclass(frozen=True, eq=False)
class LoopTest:
    """A while_loop's test as one kernel evaluates it: `it < max_it`, and
    where `res` is given also `res / denom > tol` (`res > tol` without a
    denominator), in res's dtype.  `it` is the carry's int32 counter,
    `max_it` a Python int or an int32 on the loop's device, `res` a
    float32 or float64 scalar of the carry and `denom` one of res's dtype
    (the loop's initial norm); each a tensor of one element."""

    it: torch.Tensor
    max_it: int | torch.Tensor
    res: torch.Tensor | None = None
    denom: torch.Tensor | None = None
    tol: float | None = None


def _scalar(name: str, t, dtypes) -> None:
    if not isinstance(t, torch.Tensor) or t.numel() != 1 or (
            t.dtype not in dtypes):
        got = (f"{tuple(t.shape)} {t.dtype}" if isinstance(t, torch.Tensor)
               else type(t).__name__)
        raise ValueError(f"loop test: {name} is {got}, expected one of "
                         f"{[str(d) for d in dtypes]} of one element")


def check(test) -> torch.device:
    """Validate a loop's test; returns its device.  A cond that does not
    return a LoopTest raises TypeError: every test of a captured loop is
    the one kernel, so no loop may build its predicate itself.  Called once
    where a test enters: by `while_set`, and by the host form on a loop's
    first test (a cond's result keeps its form, as the carry keeps its
    structure)."""
    if not isinstance(test, LoopTest):
        raise TypeError(
            f"a while_loop's cond returned {type(test).__name__}, not a "
            "LoopTest: the loop's test is one kernel (ops/cuda/loop.py), "
            "so its cond hands over (it, max_it, res, denom, tol)")
    _scalar("it", test.it, (torch.int32,))
    tensors = [test.it]
    if isinstance(test.max_it, torch.Tensor):
        _scalar("max_it", test.max_it, (torch.int32,))
        tensors.append(test.max_it)
    elif not (isinstance(test.max_it, int)
              and _INT32[0] <= test.max_it <= _INT32[1]):
        raise ValueError(f"loop test: max_it {test.max_it!r} is not an "
                         "int32")
    if test.res is None:
        if test.denom is not None or test.tol is not None:
            raise ValueError("loop test: a denominator or tol without res")
    else:
        _scalar("res", test.res, (torch.float32, torch.float64))
        tensors.append(test.res)
        if test.denom is not None:
            _scalar("denom", test.denom, (test.res.dtype,))
            tensors.append(test.denom)
        if not isinstance(test.tol, (int, float)):
            raise ValueError(f"loop test: tol {test.tol!r} is not a number")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"loop test on several devices: {devices}")
    return test.it.device


def predicate(test: LoopTest) -> torch.Tensor:
    """The plain version's predicate, a bool tensor: the torch expression
    `(it < max_it) & (res / denom > tol)` the loops wrote themselves
    (`res > tol` without a denominator, `it < max_it` without res), of a
    test that `check` has passed."""
    go = test.it < test.max_it
    if test.res is None:
        return go
    ratio = test.res if test.denom is None else test.res / test.denom
    return go & (ratio > test.tol)


def while_set_plain(test: LoopTest, trips: torch.Tensor) -> bool:
    """The plain version: the predicate read on the host, and one trip
    added to `trips` where it holds."""
    go = bool(predicate(test))
    if go:
        trips += 1
    return go


def rounded_tol(tol: float, dtype: torch.dtype) -> float:
    """tol rounded to `dtype` (to nearest, as torch casts a Python scalar
    compared with a float32 or float64 tensor), as a Python float."""
    return float(np.float32(tol)) if dtype == torch.float32 else float(tol)


def kernel_args(handle: int, test: LoopTest, trips: torch.Tensor) -> tuple:
    """mg_while_set's arguments but the stream: the handle, it, the
    limit's address (None for a number) and number, res, denom (None where
    absent), tol rounded to res's dtype, the kind of the residual clause
    (0 none, 1 float32, 2 float64) and trips."""
    limit = test.max_it if isinstance(test.max_it, torch.Tensor) else None
    res, denom = test.res, test.denom
    return (handle, test.it.data_ptr(),
            None if limit is None else limit.data_ptr(),
            0 if limit is not None else test.max_it,
            None if res is None else res.data_ptr(),
            None if denom is None else denom.data_ptr(),
            0.0 if res is None else rounded_tol(test.tol, res.dtype),
            _KINDS[None if res is None else res.dtype], trips.data_ptr())


def while_set(handle: int, test: LoopTest, trips: torch.Tensor):
    """Test a loop and set the while node of `handle` to the result,
    counting a trip in `trips` where it holds: the kernel on CUDA tensors
    (inside the capture that owns the handle), the plain version on CPU
    tensors, which returns the predicate's value."""
    device = check(test)
    if trips.dtype != torch.int32 or trips.numel() != 1:
        raise ValueError(f"trips: {tuple(trips.shape)} {trips.dtype}, "
                         "expected one int32")
    if trips.device != device:
        raise ValueError(f"kernel inputs on several devices: {device}, "
                         f"{trips.device}")
    if device.type == "cpu":
        return while_set_plain(test, trips)
    if device.type != "cuda":
        raise ValueError(f"no kernel route for device type {device.type!r}")
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(_build.entry("mg_while_set")(
        *kernel_args(handle, test, trips), stream), "mg_while_set")
    cuda.LAUNCHES["while_set"] += 1
    return None


def while_handle(stream: torch.cuda.Stream) -> int:
    """A conditional handle on the graph `stream` is capturing into."""
    handle = ctypes.c_ulonglong(0)
    _build.check(_build.entry("mg_while_handle")(stream.cuda_stream,
                                                 ctypes.byref(handle)),
                 "cudaGraphConditionalHandleCreate")
    return handle.value


def while_begin(stream: torch.cuda.Stream, handle: int,
                body: torch.cuda.Stream) -> int:
    """Add a WHILE node of `handle` after `stream`'s captured work, move
    `stream` past it, and begin capturing the node's body on `body`;
    returns the body graph (a cudaGraph_t)."""
    graph = ctypes.c_void_p(0)
    _build.check(_build.entry("mg_while_begin")(
        stream.cuda_stream, handle, body.cuda_stream, ctypes.byref(graph)),
        "the conditional WHILE node")
    return graph.value


def while_end(body: torch.cuda.Stream) -> None:
    """End the capture of a node's body on `body`."""
    _build.check(_build.entry("mg_while_end")(body.cuda_stream),
                 "the end of a WHILE body's capture")
