"""Compiled programs: the counterpart of the JAX package's `jax.jit` for a
function whose shapes are fixed and whose body reads nothing back to the
host.

Each model entry point of the JAX package is one XLA program with no host
round trip (its `_jit_run`, `_jit_step`, `_jit_run_chunk` and Poisson's
`_jit_mg`).  Here that program is the launches the function makes,
captured once into a `torch.cuda.CUDAGraph` and replayed:

- The first call with a key copies the inputs into static buffers, warms
  up on a side stream with `warm` (a one-step call of the same
  configuration), which sets every piece of lazy state (the nvcc build and
  its ctypes load, the tower's occupancy query, the kernels' shared-memory
  attributes, cuBLAS's handle and workspace), then captures the call on
  those buffers on the same stream and instantiates the graph.
  `Program.seconds` is that time, the counterpart of JAX's compile.
- Every call copies its inputs into the buffers, replays the graph and
  returns clones of the graph's static outputs: fresh tensors, so a later
  call never overwrites what an earlier one returned, as a JAX array is
  never overwritten.
- The key holds what a JAX trace fixes: the caller's static part (the
  entry, the step count, the SolverConfig), the inputs' shapes, dtypes and
  devices, and the route and switches read at call time (`route_key`).
- `ops.cuda.LAUNCHES` is counted by the Python wrappers, which run at the
  capture and not on a replay.  The warm-up and the capture leave the
  counts as they found them; each replay adds the capture's counts, so a
  run's per-kernel counts are those of its eager run.
- All graphs of one `Programs` share one memory pool, and the warm-ups
  allocate in it too, so a capture reuses the blocks its warm-up freed: the
  pool holds the largest program's temporaries once, not a warm-up's and a
  capture's side by side (at n=16384 each is some 30 GB).  Dropping the
  `Programs` drops the graphs and their memory.

On the CPU the function is called directly: the CPU was asked for, and
nothing on the card is hidden.  On the card there is no fallback: a capture
or a replay that fails raises, and nothing retries eagerly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from hpcclassmultigridproject_tpu_torch.ops import cuda


def route_key() -> tuple:
    """The route and the five module switches, as a call reads them:
    `ops.cuda._plain_on_cuda` (entered by `routed` for backend "jnp", or by
    `plain_route()`), `mg.cycle._FUSE_CORR`, `_USE_TOWER`, `_RESTRICT_DEC`,
    `mg.delta._FUSE_OPEN` and `_FUSE_OPEN_SMOOTH`.  A graph captured under
    one setting replays that route only, so each is part of the key."""
    from hpcclassmultigridproject_tpu_torch.mg import cycle, delta

    return (cuda._plain_on_cuda, cycle._FUSE_CORR, cycle._USE_TOWER,
            cycle._RESTRICT_DEC, delta._FUSE_OPEN, delta._FUSE_OPEN_SMOOTH)


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a captured graph, by libcuda's cuGraphGetNodes."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                  None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {err}")
    return count.value


class CudaGraphs:
    """What captures on the card: torch's CUDA graph, a memory pool and a
    side stream.  A test may put a stand-in with the same methods in
    `CAPTURE` to run the bookkeeping on the CPU."""

    def __init__(self):
        # one side stream a device for every warm-up and capture: torch
        # keeps a cuBLAS workspace (32 MiB) for each stream that ever ran
        # a product, for the life of the process
        self._streams: dict = {}

    def on_card(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def pool(self, device: torch.device):
        """A memory pool and the side stream every warm-up and capture of
        it runs on (the allocator reuses a freed block on its own stream)."""
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        with torch.cuda.device(device):
            return torch.cuda.MemPool(), self._streams[device]

    def warm_up(self, fn, args, pool, device: torch.device) -> None:
        """`fn(*args)` on the pool's side stream, as torch requires before
        a capture, its allocations in the pool; then a synchronize."""
        mem, side = pool
        here = torch.cuda.current_stream(device)
        side.wait_stream(here)
        with torch.cuda.stream(side), torch.cuda.use_mem_pool(mem, device):
            fn(*args)
        here.wait_stream(side)
        torch.cuda.synchronize(device)

    def capture(self, fn, args, pool, device: torch.device):
        """Capture `fn(*args)` into a graph in the pool, on its side stream,
        and instantiate it; returns (graph, static outputs, node count)."""
        mem, side = pool
        with torch.cuda.device(device):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=mem.id, stream=side):
                out = fn(*args)
            nodes = _node_count(graph)
            graph.instantiate()
        return graph, out, nodes


CAPTURE = CudaGraphs()


def on_card(device) -> bool:
    """True where a call captures and replays (a CUDA device)."""
    return CAPTURE.on_card(torch.device(device))


@dataclasses.dataclass
class Program:
    """One captured call: its graph, static input and output buffers, the
    launch counts its capture made, the seconds the warm-up, capture and
    instantiation took, and the graph's node count.  `keep` holds the
    tensors the graph reads besides its inputs (a model's levels), so they
    outlive it."""

    graph: object
    inputs: list
    outputs: list
    spec: object
    launches: dict
    seconds: float
    nodes: int
    keep: tuple

    def __call__(self, args):
        for buf, x in zip(self.inputs, args, strict=True):
            buf.copy_(x)
        self.graph.replay()
        for name, count in self.launches.items():
            cuda.LAUNCHES[name] += count
        return tree_unflatten(
            [t.clone() if isinstance(t, torch.Tensor) else t
             for t in self.outputs], self.spec)


class Programs:
    """A model's compiled programs, one per key, in one memory pool.

    `programs(key, fn, args, warm, keep)` returns `fn(*args)`: on the
    card by replaying the graph captured for (key, `route_key()`, the
    args' shapes, dtypes and devices), captured at the first such call;
    on the CPU by calling `fn`.  `args` are tensors; `warm`, called like
    `fn`, warms up before the capture (default `fn`); `keep` are the
    objects the graph reads besides `args`.  `last` is the Program the
    last call replayed, None where it called `fn` directly."""

    def __init__(self):
        self._programs: dict = {}
        self._pool = None
        self.last: Program | None = None

    def __len__(self) -> int:
        return len(self._programs)

    def __call__(self, key, fn, args, warm=None, keep=()):
        device = args[0].device
        if not CAPTURE.on_card(device):
            self.last = None
            return fn(*args)
        full = (key, route_key(),
                tuple((tuple(a.shape), a.dtype, a.device) for a in args),
                tuple(id(k) for k in keep))
        program = self._programs.get(full)
        if program is None:
            program = self._capture(fn, args, warm or fn, keep, device)
            self._programs[full] = program
        self.last = program
        return program(args)

    def _capture(self, fn, args, warm, keep, device) -> Program:
        if self._pool is None:
            self._pool = CAPTURE.pool(device)
        t0 = time.perf_counter()
        inputs = [a.clone() for a in args]
        before = dict(cuda.LAUNCHES)
        try:
            CAPTURE.warm_up(warm, inputs, self._pool, device)
            cuda.LAUNCHES.update(before)
            graph, out, nodes = CAPTURE.capture(fn, inputs, self._pool,
                                                device)
            launches = {k: v - before[k] for k, v in cuda.LAUNCHES.items()
                        if v != before[k]}
        finally:
            cuda.LAUNCHES.update(before)
        outputs, spec = tree_flatten(out)
        return Program(graph, inputs, outputs, spec, launches,
                       time.perf_counter() - t0, nodes, tuple(keep))
