"""Processes and collectives of a distributed run, the port of the JAX
package's `parallel/distributed.py`.

  * `initialize(backend, ...)`: `torch.distributed.init_process_group`
    from explicit arguments or the HPCMG_COORDINATOR /
    HPCMG_NUM_PROCESSES / HPCMG_PROCESS_ID environment variables (the JAX
    package's names);
  * `make_global(x, part)`: a host-built padded array to this rank's block
    (a row block or a 2-D block, parallel/sharding.py);
  * `fetch(x, part)`: the blocks of every rank gathered in rank order to
    the whole padded array, on every rank;
  * `all_sum`, `all_max`, `all_gather_rows`, `all_gather_blocks`: the
    collectives the SPMD program needs beyond the halo exchange;
  * `start_exchange(blocks, k, mesh, sides)`: the point-to-point exchange
    of k edge lines with the neighbours along one or both mesh axes, the
    JAX package's `ppermute` (a rank with no neighbour gets zeros);
  * `rank_device(device, rank, world, backend)`: the card a rank runs
    on (one card a rank under NCCL);
  * `capture_reason(mesh, device, solver)`: why a partitioned call on
    `device` runs eagerly, or None where it can be one captured program
    (under NCCL only with `CAPTURE_NCCL` on);
  * `launch_local(fn, world, ...)`: `world` spawned processes on this
    host, each in the process group on its own card, returning rank 0's
    result, optionally within a deadline; `note(line)`: what a rank works
    on, which a missed deadline names.

Under NCCL the collectives move device tensors, each on its rank's own
card, and nothing goes through host memory: a tensor elsewhere reaching
a collective raises.  Gloo has no CUDA send/recv, so under gloo a CUDA
tensor is copied to the host, exchanged there and copied back: that is
how several ranks share one card, for testing the program and not for
speed.  The group's backend picks the branch.

Every call that posts a collective counts it in `COLLECTIVES`
(`ops.cuda.COLLECTIVES`: `batch_isend_irecv` batches, `all_gather`
calls), which a captured program's replay adds as it adds the kernels'
launches (utils/graphs.py).  Under NCCL, with `CAPTURE_NCCL` on, the
collectives of a step are captured into a CUDA graph with its kernels;
an `Exchange` posted inside a capture must be waited on inside it, and a
collective that would stage through the host raises there.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.ops.cuda import COLLECTIVES
from hpcclassmultigridproject_tpu_torch.parallel.mesh import Mesh
from hpcclassmultigridproject_tpu_torch.utils import graphs


# process-group timeout of the ranks `launch_local` spawns
LOCAL_TIMEOUT = datetime.timedelta(seconds=300)
# in a rank `launch_local` spawned: the file `note` writes
_NOTE_FILE: pathlib.Path | None = None


def initialize(backend: str, coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group (idempotent).  Arguments default to the
    HPCMG_COORDINATOR / HPCMG_NUM_PROCESSES / HPCMG_PROCESS_ID environment
    variables; a coordinator "host:port" rendezvous over TCP, a URL
    ("tcp://…", "file://…") as it is.  With none of them set, torch's
    env:// rendezvous reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK.
    `backend` is "nccl" (one rank per GPU) or "gloo" (CPU tensors, or
    CUDA tensors staged through the host)."""
    if dist.is_initialized():
        return
    env = os.environ.get
    coordinator = coordinator or env("HPCMG_COORDINATOR")
    if num_processes is None and env("HPCMG_NUM_PROCESSES"):
        num_processes = int(env("HPCMG_NUM_PROCESSES"))
    if process_id is None and env("HPCMG_PROCESS_ID"):
        process_id = int(env("HPCMG_PROCESS_ID"))
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _single_rank(mesh: Mesh) -> bool:
    """True for a one-rank mesh, whose collectives are the identity; a
    mesh of several ranks with no process group (a view built by hand)
    raises rather than return this rank's part as the whole."""
    if mesh.world == 1:
        return True
    if not dist.is_initialized():
        raise RuntimeError(
            f"a collective over {mesh.world} ranks needs a process group")
    return False


def host_staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """True where a collective on `t` goes through host memory: a CUDA
    tensor under gloo.  Under NCCL nothing is staged: `t` must lie on this
    rank's card, and a tensor elsewhere (the CPU, another card) raises
    ValueError, a fault of the caller's.  Inside a capture a staged
    collective raises RuntimeError: a graph cannot hold the host's copy."""
    backend = mesh.backend
    if backend == "nccl" and t.device != torch.device(
            "cuda", torch.cuda.current_device()):
        raise ValueError(
            f"a tensor on {t.device} reached an NCCL collective of rank "
            f"{mesh.rank}, whose card is cuda:{torch.cuda.current_device()}"
            ": under NCCL every collective moves this card's tensors")
    staged = t.is_cuda and backend == "gloo"
    if staged and graphs.CAPTURE.capturing(t.device):
        raise RuntimeError(
            f"a collective of rank {mesh.rank} would stage a tensor on "
            f"{t.device} through the host under gloo inside a CUDA graph "
            "capture: a captured partitioned run needs NCCL")
    return staged


# Whether a call partitioned over NCCL ranks may be one captured program.
# Off: such a call runs eagerly, with the reason `capture_reason` gives.
# The captured form (each rank replaying its own graph, NCCL's kernels in
# it) has not yet run to its end on four cards: on four H100s its probes,
# the main path in both layouts (built whole and born, plain and
# overlapped) and the other configurations replayed equal to their eager
# runs to the bit, but the large grids (n=16384, n=32768) and `cli
# scaling`'s points have not run captured there (chip_smoke phase 19
# (d) and (e), which set it in their ranks, run them).
CAPTURE_NCCL = False


def capture_reason(mesh: Mesh, device, solver=None) -> str | None:
    """Why a call partitioned over `mesh` with tensors on `device` runs
    eagerly, or None where it can be one captured program: the CPU (called
    directly); CUDA tensors under gloo, whose collectives stage through
    the host; under NCCL, while `CAPTURE_NCCL` is off, every partitioned
    call; and with it on, an adaptive `solver` (cycle_mode neither "fixed"
    nor "fmg"), whose loop tests a norm, an all-gather, inside a CUDA
    WHILE body: on four H100s (PyTorch 2.11, NCCL 2.28) a probe of such a
    capture had not finished when its run was cut at 110 s.  On one rank
    (no collective), None.  It reads only what every rank shares (the
    device, the world, the backend, the solver and `CAPTURE_NCCL`), so
    the ranks decide alike."""
    if not graphs.on_card(torch.device(device)):
        return "the CPU was asked for: the function is called directly"
    if mesh.world == 1:
        return None
    if mesh.backend == "gloo":
        return (f"partitioned over {mesh.world} ranks under gloo: its "
                "collectives stage CUDA tensors through the host, which no "
                "graph can hold")
    if not CAPTURE_NCCL:
        return (f"partitioned over {mesh.world} ranks: the captured form "
                "under NCCL is off (parallel.distributed.CAPTURE_NCCL) "
                "until it has run to its end on four cards")
    if solver is not None and solver.cycle_mode not in ("fixed", "fmg"):
        return (f"an adaptive solve partitioned over {mesh.world} ranks "
                "under NCCL: its loop's norm, an NCCL all-gather, would sit "
                "in a CUDA WHILE body, and a probe of such a capture did not "
                "finish on four H100s (NCCL 2.28), so the run is eager")
    return None


def all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ over the ranks of the 0-d tensor x, the same bits on every rank:
    each rank gathers every rank's x and adds them in rank order (an
    all-reduce may add in another order on another rank, and the adaptive
    loops branch on the sum).  On one rank it is x."""
    if _single_rank(mesh):
        return x
    staged = host_staged(mesh, x)
    src = (x.cpu() if staged else x).reshape(1)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    COLLECTIVES["all_gather"] += 1
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.reshape(()).to(x.device)


def all_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """max over the ranks of the 0-d tensor x, on every rank (exact, so
    the same bits whatever the order).  On one rank it is x."""
    if _single_rank(mesh):
        return x
    return torch.stack(all_gather_blocks(x.reshape(1), mesh)).max().reshape(
        ())


def all_gather_blocks(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's block (all of one shape), in rank order, on every
    rank.  On one rank it is [x]."""
    if _single_rank(mesh):
        return [x]
    staged = host_staged(mesh, x)
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    COLLECTIVES["all_gather"] += 1
    return [p.to(x.device) for p in parts]


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block (all of one shape) stacked by rank along the
    rows, on every rank.  On one rank it is x."""
    return torch.cat(all_gather_blocks(x, mesh))


def fit(x: torch.Tensor, rows: int, cols: int | None = None) -> torch.Tensor:
    """x cut or zero-padded to `rows` rows and, given, `cols` columns."""
    cols = x.shape[1] if cols is None else cols
    x = x[:rows, :cols]
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def assemble(blocks, grid: tuple[int, int], shape) -> torch.Tensor:
    """The array of `shape` whose blocks, in rank order, tile a grid of
    `grid` = (block rows, block columns) row by row (rank k at
    (k // grid[1], k % grid[1])); cut or zero-padded to `shape`."""
    cols = grid[1]
    rows = [torch.cat(blocks[i:i + cols], dim=1)
            for i in range(0, len(blocks), cols)]
    return fit(torch.cat(rows), *shape)


def make_global(x: torch.Tensor, part) -> torch.Tensor:
    """This rank's block of the padded array x (the same on every rank):
    its rows [part.start, part.stop) and columns [part.col_start,
    part.col_stop), zero past the array.  `part` None (a replicated level)
    keeps x."""
    if part is None:
        return x
    return fit(x, part.span, part.col_span)[
        part.start:part.stop, part.col_start:part.col_stop].clone()


def fetch(x: torch.Tensor, part) -> torch.Tensor:
    """The whole padded array (part.rows x part.cols) from every rank's
    block, gathered in rank order, on every rank.  `part` None keeps x."""
    if part is None:
        return x
    return assemble(all_gather_blocks(x, part.mesh), part.grid,
                    (part.rows, part.cols))


class Exchange:
    """Edge lines of some blocks in flight: `wait()` returns a (before,
    after) pair per block and side, the lines of the neighbour before it
    and of the one after it.  One posted inside a capture stays in
    `graphs.POSTED` until it is waited on."""

    def __init__(self, pairs, reqs=(), device=None, sends=()):
        self._pairs, self._reqs, self._device = pairs, list(reqs), device
        self._sends = list(sends)  # alive until the receives are waited on

    @classmethod
    def given(cls, pairs):
        """Halos known already (a test, or a rank's view emulated)."""
        return cls(list(pairs))

    def wait(self):
        for req in self._reqs:
            req.wait()
        graphs.POSTED.discard(self)
        self._reqs, self._sends = [], []
        if self._device is not None:
            self._pairs = [(t.to(self._device), b.to(self._device))
                           for t, b in self._pairs]
            self._device = None
        return self._pairs


def _lines(x: torch.Tensor, axis: int, first: bool, k: int) -> torch.Tensor:
    """The first or last k lines of x along `axis`, contiguous (a column
    edge is a strided view)."""
    sl = slice(0, k) if first else slice(x.shape[axis] - k, None)
    return (x[sl] if axis == 0 else x[:, sl]).contiguous()


def start_exchange(blocks, k: int, mesh: Mesh, sides) -> Exchange:
    """Post the exchange of k edge lines of each block: for each side
    (axis, before, after) of `sides`, the block's first k lines along
    `axis` go to rank `before` and its last k lines to rank `after`, and
    theirs are received; a side whose rank is None receives zeros, as the
    JAX package's `ppermute` leaves a device that gets no message.
    `wait()` gives one (before, after) pair per side and block, sides
    outermost.  Every receive is posted in one `batch_isend_irecv`.

    Pairing.  NCCL ignores tags: it matches the sends from rank A to rank
    B with the receives B posts from A in the order each rank posts them.
    So the order is the contract.  Each rank posts, side by side and
    within a side block by block, its send and receive with `before`,
    then its send and receive with `after`.  If every rank passes the
    same sides in the same order, and blocks of the same shapes and
    dtypes in the same order, and B is A's `after` on a side exactly when
    A is B's `before` on it (the mesh's neighbours), then A's k-th send
    to B is B's k-th receive from A, of the same shape: on a side, A's
    tails go to B in block order, and B receives its tops from A in block
    order.  A peer appears on one side of a call only (the neighbours of
    a rank on a mesh are four distinct ranks).  Gloo pairs by the tags
    (2t to `before`, 2t+1 to `after`), which say the same.  A side whose
    axis holds one rank gives no rank a neighbour, so a batch is empty on
    every rank or on none, and the first batch of a group (which under
    NCCL sets up the communicator, and must include every rank) is
    posted by every rank.  tests/test_torch_multigpu.py holds the
    pairing on meshes of 2 to 8 ranks."""
    # under NCCL, host_staged raises for a block off this rank's card
    staged = [host_staged(mesh, b) for b in blocks][0]
    buf_dev = torch.device("cpu") if staged else blocks[0].device
    ops, pairs, sends = [], [], []
    for s, (axis, before, after) in enumerate(sides):
        for i, b in enumerate(blocks):
            if b.shape[axis] < k:
                raise ValueError(f"block of {b.shape[axis]} lines along "
                                 f"axis {axis}, halo of {k}")
            shape = (k, b.shape[1]) if axis == 0 else (b.shape[0], k)
            top = torch.zeros(shape, dtype=b.dtype, device=buf_dev)
            bot = torch.zeros_like(top)
            head, tail = _lines(b, axis, True, k), _lines(b, axis, False, k)
            if staged:
                head, tail = head.cpu(), tail.cpu()
            sends += [head, tail]
            # the order below is the pairing (docstring); gloo reads the
            # tags: 2t goes to `before`, 2t+1 to `after`
            t = s * len(blocks) + i
            if before is not None:
                ops += [dist.P2POp(dist.isend, head, before, tag=2 * t),
                        dist.P2POp(dist.irecv, top, before, tag=2 * t + 1)]
            if after is not None:
                ops += [dist.P2POp(dist.isend, tail, after, tag=2 * t + 1),
                        dist.P2POp(dist.irecv, bot, after, tag=2 * t)]
            pairs.append((top, bot))
    device = blocks[0].device if staged else None
    if not ops:
        return Exchange(pairs, device=device)
    reqs = dist.batch_isend_irecv(ops)
    COLLECTIVES["batch_isend_irecv"] += 1
    out = Exchange(pairs, reqs, device, sends)
    if graphs.CAPTURE.capturing(buf_dev):
        graphs.POSTED.add(out)
    return out


def rank_device(device, rank: int, world: int,
                backend: str | None) -> torch.device | None:
    """The device rank `rank` of `world` runs on: `device` (None stays
    None), and for a CUDA device with no index the card rank % the card
    count, so rank r takes cuda:r where there are cards enough.  NCCL
    takes one card a rank: under it, with more than one rank, more ranks
    than cards, or an explicit index (every rank on that one card), raise
    ValueError rather than share a card.  Under gloo ranks may share cards
    (all of them cuda:0 given "cuda:0")."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return device
    count = torch.cuda.device_count()
    if backend == "nccl" and world > 1:
        if device.index is not None:
            raise ValueError(
                f"NCCL takes one card a rank: {world} ranks cannot all run "
                f"on {device}; pass 'cuda' for cuda:rank")
        if world > count:
            raise ValueError(
                f"NCCL takes one card a rank: {world} ranks, {count} cards")
    if device.index is not None:
        return device
    if count == 0:
        raise RuntimeError("device 'cuda' but torch sees no CUDA device")
    return torch.device("cuda", rank % count)


def note(line: str) -> None:
    """In a rank that `launch_local` spawned, leave `line` (what the rank
    starts on) where a missed deadline reads it; elsewhere nothing."""
    if _NOTE_FILE is not None:
        _NOTE_FILE.write_text(line)


def _rank_main(rank: int, fn, world: int, args: tuple, backend: str,
               tmp: str, device) -> None:
    global _NOTE_FILE
    _NOTE_FILE = pathlib.Path(tmp) / "note"
    device = rank_device(device, rank, world, backend)
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{tmp}/pg",
                            world_size=world, rank=rank,
                            timeout=LOCAL_TIMEOUT)
    try:
        out = fn(*args)
        if rank == 0:
            with open(pathlib.Path(tmp) / "result.pkl", "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def launch_local(fn, world: int, args: tuple = (), *, backend: str = "gloo",
                 device=None, deadline: float | None = None):
    """Run fn(*args) in `world` spawned processes of one process group on
    this host (rendezvous through a file in a temporary directory) and
    return rank 0's result, which must pickle (numpy, not CUDA tensors).
    `fn` must be importable by name; each process finds its rank with
    `make_mesh()`.  With a CUDA `device`, each process selects its card
    (`rank_device`: "cuda" gives rank r cuda:r) before any CUDA work, and
    this process builds the kernel library first, so the ranks only load
    it.  A failed rank raises here, the others killed.

    With `deadline` (seconds), ranks still running that long after the
    spawn are killed and TimeoutError names the line a rank last gave
    `note`.  The process group's timeout does not reach a hung replay of
    a captured graph (its collectives were never enqueued), so a caller
    replaying one under NCCL sets a deadline."""
    import time

    import torch.multiprocessing as mp

    if device is not None and torch.device(device).type == "cuda":
        from hpcclassmultigridproject_tpu_torch.ops.cuda import _build

        rank_device(device, 0, world, backend)  # raises before spawning
        _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        spawn = dict(args=(fn, world, tuple(args), backend, tmp, device),
                     nprocs=world)
        if deadline is None:
            mp.spawn(_rank_main, **spawn, join=True)
        else:
            ctx = mp.spawn(_rank_main, **spawn, join=False)
            end = time.monotonic() + deadline
            try:
                while not ctx.join(timeout=max(0.0, end - time.monotonic())):
                    if time.monotonic() >= end:
                        noted = pathlib.Path(tmp) / "note"
                        raise TimeoutError(
                            f"{getattr(fn, '__name__', fn)}: {world} ranks "
                            f"still running {deadline} s after the spawn, "
                            "killed; last noted: " + (
                                noted.read_text() if noted.exists()
                                else "nothing"))
            finally:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                    proc.join()
        with open(pathlib.Path(tmp) / "result.pkl", "rb") as f:
            return pickle.load(f)
