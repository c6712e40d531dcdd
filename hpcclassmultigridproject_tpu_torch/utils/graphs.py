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
  counts (and `ops.cuda.HOST_TESTS`) as they found them; each replay adds
  the capture's counts, so a run's per-kernel counts are those of its
  eager run.
- All graphs of one `Programs` share one memory pool, and the warm-ups
  allocate in it too, so a capture reuses the blocks its warm-up freed: the
  pool holds the largest program's temporaries once, not a warm-up's and a
  capture's side by side (at n=16384 each is some 30 GB).  Dropping the
  `Programs` drops the graphs and their memory.

A program may hold a partitioned run's collectives (parallel/
distributed.py), the counterpart of the JAX package's jitted
`distributed_run` and sharded `_jit_*` programs, whose halo exchanges and
norms are in the one XLA program.  The models capture such a run only
under NCCL with `parallel.distributed.CAPTURE_NCCL` on (off by default):

- Each rank captures and replays its own graph; NCCL's kernels in the
  graphs of the ranks meet across the cards.  So every rank captures the
  same keys, in the same order, the same number of times, and replays
  them in step: the callers key a partitioned program by its mesh (world,
  rank, shape, backend), layout and `min_local`, and decide to capture
  from nothing that differs between ranks (`parallel.distributed.
  capture_reason`).  A rank that captured while another replayed, or
  ran eagerly while the others replayed, would leave NCCL's calls
  unpaired: nothing here decides that per rank, and a failed capture
  raises on its rank.
- The warm-up makes every exchange the capture makes, with the same peers
  and shapes: NCCL sets up the communicator at the group's first call and
  connects each peer at its first message, host work that must not fall
  inside the capture.
- A collective forks onto NCCL's stream and its wait joins it back; a
  capture whose fork is never joined fails ("unjoined").  An `Exchange`
  posted inside a capture is recorded in `POSTED` until it is waited on,
  and a capture (or a WHILE body) that ends with one outstanding raises
  here, naming it.  A collective that would stage a CUDA tensor through
  the host (gloo) raises inside a capture: a graph holds no host copy.
- `ops.cuda.COLLECTIVES` (point-to-point batches and all-gathers) is
  counted by the collectives' wrappers at the capture, and a replay adds
  it as it adds LAUNCHES, WHILE bodies times their trips.
- Capture mode: "thread_local" (`CAPTURE_ERROR_MODE`, and the WHILE
  bodies' captures in csrc/loop.cu), not `torch.cuda.graph`'s default
  "global", which also refuses unsafe CUDA calls of other threads while a
  capture runs.  ProcessGroupNCCL's watchdog thread queries the events of
  collectives meanwhile.  Under "global", four NCCL ranks on four H100s
  (PyTorch 2.11, NCCL 2.28) did not get through the first capture
  probes of chip_smoke phase 19 (a): on ranks 0 and 2 the log said
  "ProcessGroupNCCL's watchdog got stuck for 480 seconds without making
  progress in monitoring enqueued collectives", and the run hung until
  it was killed.  Under "thread_local" the probes and the main path's
  rows and 2-D runs captured and replayed there.
- Memory, partly verified on the card: torch's allocator defers the
  free of a block that another stream (NCCL's) used while a capture is
  under way, so no later temporary of the same graph should take a
  receive buffer while NCCL may still write it.  On four H100s the two
  middle ranks' receive buffers were not taken by 16 later allocations
  of the capture; on the edge ranks one of the four buffers read was
  taken, but that reading also counted their zero sides (made locally,
  never NCCL's), so it does not say which.  chip_smoke phase 19 (a)
  reads the received buffers alone and fails if a later allocation of
  the capture takes one.

A body may hold data-dependent loops, `while_loop`, the counterpart of
`jax.lax.while_loop`: outside a capture it is a host loop that reads its
predicate once a test; inside one it becomes a CUDA conditional WHILE node
whose predicate the kernel `mg_while_set` (csrc/loop.cu) sets on the
device, so the adaptive solvers are one graph as their JAX programs are one
XLA program:

- The carry is copied into static buffers before the node; the node's body
  is captured once, on a body stream (one per nesting depth and device,
  created with the side stream and warmed with a product, so that torch's
  cuBLAS workspace for it exists before any capture), with its allocations
  routed to the programs' pool (`CudaGraphs._route_to_pool`); it ends by
  copying its results into the static carry and testing again.
- Each node's trip counter (an int32 on the device, counted up by
  `mg_while_set`) is zeroed by the replay itself (`Loops`) and read back
  after it (one read for the program, where the eager form reads once a
  test), and each replay adds every node's body launch counts times its
  trips: a replay's
  per-kernel counts are its eager run's, plus `while_set` once a test (the
  eager run's `ops.cuda.HOST_TESTS`).

On the CPU the function is called directly: the CPU was asked for, and
nothing on the card is hidden.  On the card there is no fallback: a capture
or a replay that fails raises, and nothing retries eagerly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import loop

# How deep captured loops may nest: a body stream each, made before any
# capture (the port's loops nest two deep: the GS coarse solve inside an
# adaptive solve).
MAX_DEPTH = 2

# torch.cuda.graph's capture_error_mode for every capture (module
# docstring: what a partitioned capture needs of it)
CAPTURE_ERROR_MODE = "thread_local"

# the Exchanges posted inside the capture under way and not yet waited on
POSTED: set = set()


def require_joined(where: str) -> None:
    """Raise if an Exchange posted inside the capture was never waited on:
    NCCL's stream would stay forked from the capture, which then fails as
    "unjoined"."""
    if POSTED:
        n = len(POSTED)
        POSTED.clear()
        raise RuntimeError(
            f"{n} halo exchange(s) posted inside {where} were never waited "
            "on: a capture must wait on every exchange it posts "
            "(Exchange.wait), or NCCL's stream is left unjoined")


def _joined(fn, *args):
    """`fn(*args)`, which must wait on every exchange it posts."""
    out = fn(*args)
    require_joined("the capture")
    return out


def counts() -> dict:
    """LAUNCHES and COLLECTIVES as they stand, in one dict (their names
    differ)."""
    return {**cuda.LAUNCHES, **cuda.COLLECTIVES}


def counts_since(before: dict) -> dict:
    """What LAUNCHES and COLLECTIVES gained since `before` (`counts()`),
    the counts that changed only."""
    return {k: v - before[k] for k, v in counts().items() if v != before[k]}


def restore_counts(before: dict) -> None:
    """LAUNCHES and COLLECTIVES set back to `before`."""
    for table in (cuda.LAUNCHES, cuda.COLLECTIVES):
        table.update({k: before[k] for k in table})


def add_counts(made: dict, times: int = 1) -> None:
    """Add `made` (launch and collective counts) `times` over to LAUNCHES
    and COLLECTIVES, each name to its own table."""
    for name, count in made.items():
        table = cuda.LAUNCHES if name in cuda.LAUNCHES else cuda.COLLECTIVES
        table[name] += count * times


def route_key() -> tuple:
    """The route and the five module switches, as a call reads them:
    `ops.cuda._plain_on_cuda` (entered by `routed` for backend "jnp", or by
    `plain_route()`), `mg.cycle._FUSE_CORR`, `_USE_TOWER`, `_RESTRICT_DEC`,
    `mg.delta._FUSE_OPEN` and `_FUSE_OPEN_SMOOTH`.  A graph captured under
    one setting replays that route only, so each is part of the key."""
    from hpcclassmultigridproject_tpu_torch.mg import cycle, delta

    return (cuda._plain_on_cuda, cycle._FUSE_CORR, cycle._USE_TOWER,
            cycle._RESTRICT_DEC, delta._FUSE_OPEN, delta._FUSE_OPEN_SMOOTH)


def _node_count(graph: int) -> int:
    """The nodes of a captured graph (a cudaGraph_t, as an int) at its top
    level, by libcuda's cuGraphGetNodes."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph), None,
                                  ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {err}")
    return count.value


class Loops:
    """The WHILE nodes of one capture: for each, the launches one trip of
    its body makes and its body graph; and a trip counter each, an int32
    in `trips` on the device.  `trips` is allocated and zeroed where the
    capture meets its first node, which is at the graph's top level: a
    buffer a capture allocates holds nothing before that point of the
    graph (the pool may lend its memory to earlier temporaries), so every
    replay zeroes it there, before any node counts.  `fold` after a
    replay gives LAUNCHES and COLLECTIVES each node's counts times its
    trips."""

    MAX_NODES = 1 << 18

    def __init__(self, device):
        self.device = device
        self.counts: list[dict] = []
        self.bodies: list = []
        self.body_nodes = 0
        self.trips: torch.Tensor | None = None

    def __len__(self) -> int:
        return len(self.counts)

    def node(self) -> tuple[int, torch.Tensor]:
        """A new node's index and trip counter (a 0-d view into `trips`),
        taken when its capture begins: a node nested in its body is taken
        after it and recorded before it."""
        k = len(self.counts)
        if self.trips is None:
            self.trips = torch.zeros(self.MAX_NODES, dtype=torch.int32,
                                     device=self.device)
        if k == self.MAX_NODES:
            raise RuntimeError(f"a captured program holds at most "
                               f"{self.MAX_NODES} WHILE nodes")
        self.counts.append({})
        self.bodies.append(None)
        return k, self.trips[k]

    def record(self, k: int, made: dict, body=None) -> None:
        """Node k's launches and collectives a trip and its body graph."""
        self.counts[k], self.bodies[k] = made, body

    def fold(self) -> None:
        """Add each node's body counts times its trips to LAUNCHES and
        COLLECTIVES: the one read of a replay."""
        if not self.counts:
            return
        trips = self.trips[:len(self.counts)].tolist()
        for made, t in zip(self.counts, trips, strict=True):
            add_counts(made, t)


def static_carry(carry):
    """(the carry with each tensor copied, the copies): the static buffers
    a node's body reads and writes."""
    flat, spec = tree_flatten(carry)
    if not all(isinstance(t, torch.Tensor) for t in flat):
        raise TypeError("a while_loop's carry holds tensors only")
    static = [t.clone() for t in flat]
    return tree_unflatten(static, spec), static


def capture_trip(cond, body, state, static, test) -> dict:
    """Capture one trip of a loop on its static carry: the body, its
    results copied into the carry, then `test(cond(carry))`.  Returns the
    launches and collectives this made, taken back out of LAUNCHES and
    COLLECTIVES (a replay adds them once a trip)."""
    before = counts()
    try:
        new = tree_flatten(body(state))[0]
        for buf, x in zip(static, new, strict=True):
            buf.copy_(x)
        test(cond(state))
        require_joined("a WHILE body")
        return counts_since(before)
    finally:
        restore_counts(before)


def while_loop(cond, body, carry):
    """`jax.lax.while_loop(cond, body, carry)`: `cond` is tested before
    each `body`, so zero trips are possible; `cond(carry)` is a bool
    tensor and `body(carry)` returns a carry of the same structure.

    Outside a capture (the CPU, an eager call on the card, a rank
    partitioned under gloo) a host loop that reads the predicate once a
    test.  Inside one, a
    conditional WHILE node (`CAPTURE.while_node`): the carry's tensors
    become static buffers, the body is captured once, and `mg_while_set`
    tests the same predicate on the device."""
    device = next(t for t in tree_flatten(carry)[0]
                  if isinstance(t, torch.Tensor)).device
    if CAPTURE.capturing(device):
        return CAPTURE.while_node(cond, body, carry, device)
    while True:
        cuda.HOST_TESTS["while_set"] += 1
        if not bool(cond(carry)):
            return carry
        carry = body(carry)


class CudaGraphs:
    """What captures on the card: torch's CUDA graph, a memory pool and a
    side stream.  A test may put a stand-in with the same methods in
    `CAPTURE` to run the bookkeeping on the CPU."""

    def __init__(self):
        # one side stream a device for every warm-up and capture, and one
        # body stream a nesting depth: torch keeps a cuBLAS workspace
        # (32 MiB) for each stream that ever ran a product, for the life
        # of the process
        self._streams: dict = {}
        self._bodies: dict = {}
        self._loops: Loops | None = None
        self._pool = None
        self._routed = None
        self._depth = 0

    def on_card(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def capturing(self, device: torch.device) -> bool:
        """True where a call on `device` is being captured."""
        return (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing())

    def pool(self, device: torch.device):
        """A memory pool and the side stream every warm-up and capture of
        it runs on (the allocator reuses a freed block on its own stream).
        The first call for a device also makes its body streams and runs a
        product on each, outside any capture."""
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
            self._bodies[device] = [torch.cuda.Stream(device)
                                    for _ in range(MAX_DEPTH)]
            a = torch.ones((2, 2), device=device)
            for body in self._bodies[device]:
                body.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(body):
                    a @ a, a @ a[0]
            torch.cuda.synchronize(device)
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
        and instantiate it; returns (graph, static outputs, top-level node
        count, its Loops with the body graphs' node count)."""
        mem, side = pool
        loops = Loops(device)
        self._loops, self._pool = loops, mem
        try:
            with torch.cuda.device(device):
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(graph, pool=mem.id, stream=side,
                                      capture_error_mode=CAPTURE_ERROR_MODE):
                    out = fn(*args)
                nodes = _node_count(graph.raw_cuda_graph())
                loops.body_nodes = sum(_node_count(b) for b in loops.bodies
                                       if b is not None)
                graph.instantiate()
        finally:
            if self._routed is not None:
                torch._C._cuda_releasePool(self._routed, mem.id)
            self._loops = self._pool = self._routed = None
        return graph, out, nodes, loops

    def _route_to_pool(self, device: torch.device) -> None:
        """Route this thread's allocations to the capture's pool for the
        rest of the capture.  torch's capture routes only those of its own
        stream, and a WHILE body is captured on another; the allocator
        keeps one filter a pool, so at a capture's first body the
        capture's filter is swapped for one of this thread (what
        `torch.cuda.use_mem_pool` installs), which the capture's end
        removes.  The reference it takes on the pool is released after the
        capture."""
        if self._routed is None:
            index = torch.cuda._utils._get_device_index(device, True)
            torch._C._cuda_endAllocateToPool(index, self._pool.id)
            torch._C._cuda_beginAllocateCurrentThreadToPool(index,
                                                            self._pool.id)
            self._routed = index

    def while_node(self, cond, body, carry, device: torch.device):
        """`while_loop`'s device form, inside `capture`: the static carry,
        the first test (mg_while_set), the WHILE node after the stream's
        work, and its body captured once on this depth's body stream with
        its allocations in the pool."""
        if self._loops is None:
            raise RuntimeError("a while_loop captured outside "
                               "CudaGraphs.capture: nothing would read its "
                               "trips back")
        if self._depth >= MAX_DEPTH:
            raise RuntimeError(f"captured while loops nest at most "
                               f"{MAX_DEPTH} deep")
        state, static = static_carry(carry)
        k, trips = self._loops.node()
        outer = torch.cuda.current_stream(device)
        handle = loop.while_handle(outer)
        loop.while_set(handle, cond(state), trips)
        inner = self._bodies[device][self._depth]
        self._route_to_pool(device)
        graph = loop.while_begin(outer, handle, inner)
        self._depth += 1
        try:
            with torch.cuda.stream(inner):
                counts = capture_trip(
                    cond, body, state, static,
                    lambda pred: loop.while_set(handle, pred, trips))
        finally:
            self._depth -= 1
            loop.while_end(inner)
        self._loops.record(k, counts, graph)
        return state


CAPTURE = CudaGraphs()


def on_card(device) -> bool:
    """True where a call captures and replays (a CUDA device)."""
    return CAPTURE.on_card(torch.device(device))


@dataclasses.dataclass
class Program:
    """One captured call: its graph, static input and output buffers, the
    launch and collective counts its capture made outside loop bodies
    (`launches`), the seconds the
    warm-up, capture and instantiation took, the graph's top-level node
    count, and its WHILE nodes (`loops`; `body_nodes` the nodes of their
    bodies).  `keep` holds the tensors the graph reads besides its inputs
    (a model's levels), so they outlive it."""

    graph: object
    inputs: list
    outputs: list
    spec: object
    launches: dict
    seconds: float
    nodes: int
    keep: tuple
    loops: Loops

    @property
    def body_nodes(self) -> int:
        return self.loops.body_nodes

    def __call__(self, args):
        for buf, x in zip(self.inputs, args, strict=True):
            buf.copy_(x)
        self.graph.replay()
        add_counts(self.launches)
        self.loops.fold()
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
        before = counts()
        tests = dict(cuda.HOST_TESTS)
        try:
            CAPTURE.warm_up(warm, inputs, self._pool, device)
            restore_counts(before)
            graph, out, nodes, loops = CAPTURE.capture(
                functools.partial(_joined, fn), inputs, self._pool, device)
            launches = counts_since(before)
        finally:
            POSTED.clear()
            restore_counts(before)
            cuda.HOST_TESTS.update(tests)
        outputs, spec = tree_flatten(out)
        return Program(graph, inputs, outputs, spec, launches,
                       time.perf_counter() - t0, nodes, tuple(keep), loops)
