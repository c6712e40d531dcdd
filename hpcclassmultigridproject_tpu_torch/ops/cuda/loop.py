"""The while node of a captured loop, `csrc/loop.cu`.

`while_set` is the wrapper of the port's one kernel that replaces no
pl.pallas_call: the test of a `utils.graphs.while_loop` captured on the card
(the counterpart of XLA's `while`, which the JAX package's `lax.while_loop`
becomes).  It launches `mg_while_set`, which reads the loop's predicate (a
device bool), sets the conditional node's value to it and counts a trip
where it holds.  Its plain version is the host form's test: one read of the
predicate, and the trip counted on the host tensor.

The other three calls are the host half of the node, plain C on torch's
stream handle: the conditional handle, the node and its body's capture.

`plain_route()` (backend "jnp") does not reach it: that route swaps the
Pallas kernels' counterparts for their plain versions, and the JAX
package's "jnp" backend keeps XLA's `while` all the same.
"""

from __future__ import annotations

import ctypes

import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build


def while_set_plain(pred: torch.Tensor, trips: torch.Tensor) -> bool:
    """The plain version: the predicate read on the host, and one trip
    added to `trips` where it holds."""
    go = bool(pred)
    if go:
        trips += 1
    return go


def _check(pred: torch.Tensor, trips: torch.Tensor) -> None:
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"predicate: {tuple(pred.shape)} {pred.dtype}, "
                         "expected one bool")
    if trips.dtype != torch.int32 or trips.numel() != 1:
        raise ValueError(f"trips: {tuple(trips.shape)} {trips.dtype}, "
                         "expected one int32")


def while_set(handle: int, pred: torch.Tensor, trips: torch.Tensor):
    """Set the while node of `handle` to `pred` and count a trip in `trips`
    where it holds: the kernel on CUDA tensors (inside the capture that
    owns the handle), the plain version on CPU tensors, which returns the
    predicate's value."""
    _check(pred, trips)
    devices = {pred.device, trips.device}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    kind = pred.device.type
    if kind == "cpu":
        return while_set_plain(pred, trips)
    if kind != "cuda":
        raise ValueError(f"no kernel route for device type {kind!r}")
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    _build.check(_build.entry("mg_while_set")(handle, pred.data_ptr(),
                                              trips.data_ptr(), stream),
                 "mg_while_set")
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
