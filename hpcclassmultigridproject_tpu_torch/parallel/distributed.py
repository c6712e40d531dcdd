"""Processes and collectives of a distributed run, the port of the JAX
package's `parallel/distributed.py`.

  * `initialize(backend, ...)`: `torch.distributed.init_process_group`
    from explicit arguments or the HPCMG_COORDINATOR /
    HPCMG_NUM_PROCESSES / HPCMG_PROCESS_ID environment variables (the JAX
    package's names);
  * `make_global(x, part)`: a host-built padded array to this rank's block
    (a row block or a 2-D block, parallel/sharding.py);
  * `fetch(x, part)`: the blocks of every rank gathered in rank order to
    the whole padded array, on every rank (`fetch_outputs`: a
    partitioned call's uT and stats, copied out of a program's outputs);
  * `all_sum`, `all_max`, `all_gather_rows`, `all_gather_blocks`: the
    collectives the SPMD program needs beyond the halo exchange;
  * `start_exchange(blocks, k, mesh, sides)`: the point-to-point exchange
    of k edge lines with the neighbours along one or both mesh axes, the
    JAX package's `ppermute` (a rank with no neighbour gets zeros);
  * `rank_device(device, rank, world, backend)`: the card a rank runs
    on (one card a rank under NCCL);
  * `capture_reason(mesh, device)`: why a partitioned call on `device`
    runs eagerly, or None where it is one captured program (under NCCL
    unless `CAPTURE_NCCL` is set off);
  * `connect(mesh, device, capacity)`: this rank's peer transport (below);
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
launches (utils/graphs.py).  Under NCCL (`CAPTURE_NCCL`, on by default)
the collectives of a step are captured into a CUDA graph with its kernels;
an `Exchange` posted inside a capture must be waited on inside it, and a
collective that would stage through the host raises there.

The peer transport.  An NCCL call captured inside a CUDA WHILE body (an
adaptive solve's loop, which tests a norm summed over the ranks) did not
finish on four H100s.  So the collectives of a `while_loop` body take
hand-written kernels instead (ops/cuda/peer.py, csrc/peer.cu), the
counterpart of the remote copies a TPU makes for the `ppermute` and
`psum` in the JAX package's jitted loop: each rank has a mailbox on its
card, mapped by every other rank over CUDA IPC, and a message is stored
straight into the receiver's mailbox over NVLink, under an epoch-tagged
flag.  The rule is the simplest that keeps the bits and the pairing:
inside a `while_loop` body of a program being compiled (its warm-up's
host loops as well as its WHILE nodes' captures, `graphs.compiling()`
and `graphs.in_body()`), every collective takes the peer transport, and
every other collective the process group's own.  The ranks run the same
program, so they meet every collective on the same transport at the same
point; the warm-up sets the transport up (`connect`, kept in the
program's `Programs.resources` and freed with its graphs), so nothing is
allocated or mapped inside a capture (it raises there).  An eager run
never takes it: the eager NCCL form is the reference a replay is held to.
`start_exchange` sends each neighbour one message holding its lines of
every block, `all_gather_blocks` one message to every rank, and
`all_sum` (the residual norm an adaptive loop tests) one flagged 16-byte
line to every rank, which the reduce kernel adds in rank order, so the
sum has the NCCL form's bits (`all_max` likewise, with a max);
`COLLECTIVES` counts each under its usual name, and the kernels count
their launches in `LAUNCHES`.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import pickle
import signal
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from hpcclassmultigridproject_tpu_torch.ops.cuda import COLLECTIVES, peer
from hpcclassmultigridproject_tpu_torch.parallel.mesh import Mesh
from hpcclassmultigridproject_tpu_torch.utils import graphs


# process-group timeout of the ranks `launch_local` spawns
LOCAL_TIMEOUT = datetime.timedelta(seconds=300)
# in a rank `launch_local` spawned: the file `note` writes
_NOTE_FILE: pathlib.Path | None = None
# seconds a rank that raised has to exit before SIGALRM ends it
EXIT_GRACE_S = 10


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


# Whether a call partitioned over NCCL ranks is one captured program, as
# the JAX package's partitioned run is one jitted program: on by default,
# so that `distributed_run`, a born-partitioned model's `run`, `step` and
# `run_chunk`, and `cli scaling`'s NCCL points each replay a graph a rank.
# Off (set in every rank, before any partitioned call), such a call runs
# eagerly with the reason `capture_reason` gives: the eager form that
# chip_smoke.py's phase 16 keeps as the reference its captured phases are
# held to.
CAPTURE_NCCL = True


def capture_reason(mesh: Mesh, device) -> str | None:
    """Why a call partitioned over `mesh` with tensors on `device` runs
    eagerly, or None where it can be one captured program: the CPU (called
    directly); CUDA tensors under gloo, whose collectives stage through
    the host; under NCCL, every partitioned call while `CAPTURE_NCCL` is
    set off.  Under NCCL at its default (on) every solver is captured,
    the adaptive ones too: the collectives inside their WHILE bodies take
    the peer transport (module docstring).  On one rank (no collective),
    None.  It reads only what every rank shares (the device, the world,
    the backend and `CAPTURE_NCCL`), so the ranks decide alike: no size,
    no solver and no failed capture sends a call to the eager form."""
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
                "under NCCL is off (parallel.distributed.CAPTURE_NCCL)")
    return None


# a new mailbox's bytes a slot, at least (main's deep halo at n=1024, two
# float64 blocks of 8 rows, takes 144 KiB)
PEER_MIN_CAPACITY = 1 << 20


def _card(device) -> torch.device:
    """`device` with its index: "cuda" is this rank's current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _peer_key(mesh: Mesh, device) -> tuple:
    return "peer", mesh.key, str(_card(device))


def connect(mesh: Mesh, device, capacity: int) -> peer.Links:
    """This rank's peer transport over `mesh`, with slots of `capacity`
    bytes: every rank calls it at the same point, outside any capture (it
    raises inside one).  On the card each rank allocates its mailbox
    (`peer.alloc`, outside torch's allocator and any graph pool), the
    ranks all-gather their (card, IPC handle) over the process group, and
    each maps every peer's mailbox (`peer.open_peer`, which raises for a
    pair of cards without peer access).  On the CPU (tests) the mailboxes
    are files of a directory rank 0 makes, each mapped by every rank and
    unlinked once all have mapped it."""
    device = _card(device)
    graphs.require_no_capture(device, "the peer transport's set-up")
    world, rank = mesh.world, mesh.rank
    capacity = peer.round_up(capacity, peer.ALIGN)
    if device.type == "cuda":
        address, err_host, err_device, hz = peer.alloc(world, capacity,
                                                       device)
        shared = [None] * world
        dist.all_gather_object(shared, (device.index,
                                        peer.handle(address)))
        remote = [address if r == rank else
                  peer.open_peer(h, device.index, card)
                  for r, (card, h) in enumerate(shared)]

        def release():
            for r, ptr in enumerate(remote):
                if r != rank:
                    peer.close(ptr, opened=True)
            peer.close(address, err_host)

        return peer.Links(world, rank, capacity, device, address, remote,
                          err_host, err_device,
                          int(peer.SPIN_SECONDS * hz), release)
    where = [tempfile.mkdtemp(prefix="mg-peer-") if rank == 0 else None]
    dist.broadcast_object_list(where, src=0)
    paths = [os.path.join(where[0], f"mailbox{r}") for r in range(world)]
    nbytes = peer.mailbox_bytes(world, capacity)
    with open(paths[rank], "wb") as f:
        f.truncate(nbytes)
    dist.barrier()
    boxes = [np.memmap(path, np.uint8, "r+", shape=(nbytes,))
             for path in paths]
    dist.barrier()
    os.remove(paths[rank])
    dist.barrier()
    if rank == 0:
        os.rmdir(where[0])
    return peer.Links(world, rank, capacity, device, boxes[rank], boxes)


def prepare_peer(programs: graphs.Programs, mesh: Mesh, device) -> None:
    """Set this rank's peer transport up for `programs` over `mesh`
    before their first capture, if it is not (a collective: every rank
    calls it at the same point).  The models call it for a solve whose
    loop bodies hold collectives (an adaptive one), so that a warm-up
    whose loops take no trip leaves nothing to set up inside the
    capture."""
    if mesh.world > 1:
        held = programs.resources.setdefault(_peer_key(mesh, device), [])
        if not held:
            held.append(connect(mesh, device, PEER_MIN_CAPACITY))


def _peer_links(mesh: Mesh, device, need: int) -> peer.Links | None:
    """The peer transport a collective of `need` bytes a message takes,
    or None for the process group's own (NCCL, gloo): the peer transport
    inside a `while_loop` body of a program being compiled (its warm-up's
    host loops and its WHILE nodes' captures alike, so that the set-up
    happens in the warm-up).  The links live in the program's
    `Programs.resources`; a message past their slots replaces them with
    larger ones (all ranks meet it at the same call: the shapes are the
    same on every rank), the old kept for the graphs that read them."""
    owner = graphs.compiling()
    if owner is None or not graphs.in_body():
        return None
    held = owner.resources.setdefault(_peer_key(mesh, device), [])
    if not held or held[-1].capacity < need:
        size = max(need, 2 * held[-1].capacity if held else
                   PEER_MIN_CAPACITY)
        held.append(connect(mesh, device, size))
    return held[-1]


def _peer_reduce(x: torch.Tensor, mesh: Mesh, op: str):
    """`all_sum` (op "sum") or `all_max` (op "max") of the 0-d x on the
    peer transport's reduce, one launch and no adds, where the collective
    takes that transport (inside a `while_loop` body of a program being
    compiled, `_peer_links`); counted as the all_gather of the NCCL form.
    None elsewhere."""
    if host_staged(mesh, x):
        return None
    links = _peer_links(mesh, x.device, peer.LINE_BYTES)
    if links is None:
        return None
    out = torch.empty((), dtype=x.dtype, device=x.device)
    peer.reduce(links, x, out, op)
    COLLECTIVES["all_gather"] += 1
    return out


def all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ over the ranks of the 0-d tensor x, the same bits on every rank:
    each rank gathers every rank's x (`all_gather_blocks`) and adds them
    in rank order (an all-reduce may add in another order on another
    rank, and the adaptive loops branch on the sum).  Inside a loop body
    of a program being compiled, the peer transport's reduce adds them in
    the same order in its one launch.  On one rank it is x."""
    if _single_rank(mesh):
        return x
    reduced = _peer_reduce(x, mesh, "sum")
    if reduced is not None:
        return reduced
    parts = all_gather_blocks(x.reshape(1), mesh)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.reshape(())


def all_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """max over the ranks of the 0-d tensor x, on every rank (exact, so
    the same bits whatever the order, but the sign of a zero and a NaN's
    payload; a NaN propagates).  Inside a loop body of a program being
    compiled, the peer transport's reduce.  On one rank it is x."""
    if _single_rank(mesh):
        return x
    reduced = _peer_reduce(x, mesh, "max")
    if reduced is not None:
        return reduced
    return torch.stack(all_gather_blocks(x.reshape(1), mesh)).max().reshape(
        ())


def all_gather_blocks(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's block (all of one shape), in rank order, on every
    rank.  On one rank it is [x]."""
    if _single_rank(mesh):
        return [x]
    staged = host_staged(mesh, x)
    src = (x.cpu() if staged else x).contiguous()
    links = None if staged else _peer_links(
        mesh, x.device, src.numel() * src.element_size())
    if links is not None:
        out = torch.empty((mesh.world, *src.shape), dtype=src.dtype,
                          device=src.device)
        peer.gather(links, src, out)
        COLLECTIVES["all_gather"] += 1
        return list(out.unbind(0))
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    COLLECTIVES["all_gather"] += 1
    return [p.to(x.device) for p in parts]


def _gathered(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block (all of one shape) stacked in rank order into
    one tensor of shape (world, *x.shape), on every rank.  Under NCCL,
    where no peer transport takes it, one `all_gather_into_tensor`
    straight into that tensor: a list's all_gather stages through a
    buffer of the same size and copies out of it, twice the memory (8 GiB
    a copy of uT at n=32768).  Otherwise `all_gather_blocks`, stacked
    (a copy, on one rank too)."""
    if mesh.world > 1 and mesh.backend == "nccl" and not host_staged(
            mesh, x) and _peer_links(mesh, x.device,
                                     x.numel() * x.element_size()) is None:
        out = torch.empty((mesh.world, *x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous())
        COLLECTIVES["all_gather"] += 1
        return out
    return torch.stack(all_gather_blocks(x, mesh))


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
    (k // grid[1], k % grid[1])); cut or zero-padded to `shape`.  Row
    blocks stacked in one tensor (`_gathered`) are tiled by a view, and an
    array with `shape`'s columns and at least its rows is cut by a view of
    its first rows (contiguous still): no copy of the whole where none is
    needed."""
    cols = grid[1]
    if cols == 1 and torch.is_tensor(blocks):
        whole = blocks.reshape(-1, *blocks.shape[2:])
    else:
        rows = [torch.cat(list(blocks[i:i + cols]), dim=1)
                for i in range(0, len(blocks), cols)]
        whole = torch.cat(rows)
    if whole.shape[1] == shape[1] and whole.shape[0] >= shape[0]:
        return whole[:shape[0]]
    return fit(whole, *shape)


def fetch_outputs(uT: torch.Tensor, stats: dict, part):
    """A partitioned call's (uT block, stats) as tensors of their own: uT
    whole (`fetch`, always a new tensor for a partitioned level) and the
    stats cloned.  The models call their program with `fresh=False`
    (utils/graphs.py), whose outputs its next replay overwrites, so that
    the gather copies the block straight out of the graph's static output
    and no clone of the block waits beside the whole field: at n=32768 on
    four H100s (rows) a rank lacked up to 1.5 GiB of the gather's 8.28,
    and that clone held 2.07."""
    return fetch(uT, part), {k: v.clone() for k, v in stats.items()}


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
    return assemble(_gathered(x, part.mesh), part.grid,
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


def _edge(x: torch.Tensor, axis: int, first: bool, k: int) -> torch.Tensor:
    """The first or last k lines of x along `axis`, a view (strided for a
    column edge)."""
    sl = slice(0, k) if first else slice(x.shape[axis] - k, None)
    return x[sl] if axis == 0 else x[:, sl]


def _lines(x: torch.Tensor, axis: int, first: bool, k: int) -> torch.Tensor:
    """The first or last k lines of x along `axis`, in a tensor of their
    own: a row edge's `contiguous()` would be a view of the whole block,
    and a send buffer is recorded on NCCL's stream, which inside a
    capture keeps its memory from reuse until the capture ends (a block
    a send: at n=16384 in the 2-D layout that filled the card)."""
    return _edge(x, axis, first, k).clone(
        memory_format=torch.contiguous_format)


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
    for axis, _, _ in sides:
        for b in blocks:
            if b.shape[axis] < k:
                raise ValueError(f"block of {b.shape[axis]} lines along "
                                 f"axis {axis}, halo of {k}")
    links = None if staged else _peer_links(
        mesh, blocks[0].device, max(_side_bytes(blocks, k, axis)
                                    for axis, _, _ in sides))
    if links is not None:
        return _peer_exchange(links, blocks, k, sides)
    buf_dev = torch.device("cpu") if staged else blocks[0].device
    ops, pairs, sends = [], [], []
    for s, (axis, before, after) in enumerate(sides):
        for i, b in enumerate(blocks):
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


def _side_bytes(blocks, k: int, axis: int) -> int:
    """The bytes of one side's message to a peer, in a mailbox's slot:
    every block's k lines along `axis` (the same on every rank)."""
    off = 0
    for b in blocks:
        lines = k * (b.shape[1] if axis == 0 else b.shape[0])
        off = peer.next_piece(off, lines * b.element_size())
    return off


def _peer_exchange(links: peer.Links, blocks, k: int, sides) -> Exchange:
    """`start_exchange` over the peer transport: one `peer.exchange` a
    call, whose message to each neighbour holds the lines of every block
    in block order (a neighbour is on one side of a call only), waited on
    inside it.  A side with no neighbour gets zeros."""
    msgs: dict = {}
    pairs = []
    for axis, before, after in sides:
        for b in blocks:
            b = b if b.stride(-1) == 1 else b.contiguous()
            head, tail = _edge(b, axis, True, k), _edge(b, axis, False, k)
            top = torch.zeros(head.shape, dtype=b.dtype, device=b.device)
            bot = torch.zeros_like(top)
            if before is not None:
                msgs.setdefault(before, []).append((head, top))
            if after is not None:
                msgs.setdefault(after, []).append((tail, bot))
            pairs.append((top, bot))
    if msgs:
        peer.exchange(links, list(msgs.items()))
        COLLECTIVES["batch_isend_irecv"] += 1
    return Exchange.given(pairs)


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


def _notes(tmp) -> str:
    """The line each rank last gave `note`, rank by rank."""
    found = sorted(pathlib.Path(tmp).glob("note*"),
                   key=lambda f: int(f.name[4:]))
    return "; ".join(f"{f.read_text()} (rank {f.name[4:]})"
                     for f in found) or "nothing"


def _rank_main(rank: int, fn, world: int, args: tuple, backend: str,
               tmp: str, device) -> None:
    global _NOTE_FILE
    _NOTE_FILE = pathlib.Path(tmp) / f"note{rank}"
    device = rank_device(device, rank, world, backend)
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{tmp}/pg",
                            world_size=world, rank=rank,
                            timeout=LOCAL_TIMEOUT)
    try:
        out = fn(*args)
    except BaseException as err:
        # said at once, with the rank: the others may be waiting on this
        # one in a collective (a replay's is never timed out), and leaving
        # the group could wait on them, so it is not left.  The exit may
        # still wait in NCCL's teardown (four NCCL ranks that ran out of
        # memory on four H100s sat there until their deadline), so SIGALRM
        # ends the process EXIT_GRACE_S after the raise: the spawn has the
        # error by then and kills the other ranks
        import traceback

        note(f"raised {type(err).__name__}: {err}")
        print(f"rank {rank} of {world} raised:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        signal.alarm(EXIT_GRACE_S)
        raise
    if rank == 0:
        with open(pathlib.Path(tmp) / "result.pkl", "wb") as f:
            pickle.dump(out, f)
    note("returned; leaving the process group")
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
    spawn are killed and TimeoutError names the line each rank last gave
    `note`.  The process group's timeout does not reach a hung replay of
    a captured graph (its collectives were never enqueued), so a caller
    replaying one under NCCL sets a deadline.  A rank that raises prints
    its exception with its rank at once, and is ended EXIT_GRACE_S later
    if its exit waits.  `fn` lets go of its models before it returns: on
    four H100s, NCCL ranks whose captured graphs a global object kept
    alive did not leave the process group until the deadline."""
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
                        raise TimeoutError(
                            f"{getattr(fn, '__name__', fn)}: {world} ranks "
                            f"still running {deadline} s after the spawn, "
                            f"killed; last noted: {_notes(tmp)}")
            finally:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                    proc.join()
        with open(pathlib.Path(tmp) / "result.pkl", "rb") as f:
            return pickle.load(f)
