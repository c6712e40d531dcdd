"""The peer transport's kernels, `csrc/peer.cu`: the halo exchange and the
gather that a partitioned run captured under NCCL makes inside a CUDA WHILE
body, where an NCCL call does not finish (parallel/distributed.py picks
them).  They replace no pl.pallas_call: they are the counterpart of the
`ppermute` and `psum` XLA places inside the JAX package's jitted loop.

Each rank has a mailbox on its card (`Links.local`) and maps every peer's
(`Links.remote`): a message is stored straight into the receiver's
mailbox, in the slot, chunk by chunk under each chunk's flag and at the
epoch that `csrc/peer.cuh` lays out and this module repeats function by
function.

  * `exchange(links, msgs)`: for each (peer, pieces) of `msgs`, send every
    piece's `src` to the peer and receive the peer's pieces into each
    `dst`: the kernel `mg_peer_exchange` on CUDA tensors (counted in
    `LAUNCHES["peer_exchange"]`), `exchange_plain` on CPU tensors;
  * `gather(links, x, out)`: every rank's x into out[rank], in rank
    order: `mg_peer_gather` (`LAUNCHES["peer_gather"]`), or
    `gather_plain`;
  * `reduce(links, x, out, op)`: the sum in rank order (op "sum") or the
    max (op "max") of one float32 or float64 value over the ranks, into
    the 0-d `out`, each rank's value a flagged 16-byte line
    (`csrc/peer.cuh`): `mg_peer_reduce` (`LAUNCHES["peer_reduce"]`), or
    `reduce_plain`.

The plain versions run the same slots, chunks, flags, counts, lines and
epochs on CPU mailboxes (numpy arrays) for ranks that are threads of one
process, or processes mapping one another's mailbox files: each sends
every chunk, then waits on each chunk's flag (a TimeoutError past
`SPIN_SECONDS`, where the kernel traps) and copies it out; the last
chunk counted advances the epoch.  A line's data words are stored
before its two tag words, and a reader waits for both tags, as the
kernel's lanes do.  `plain_route()` does not reach the
kernels: like `loop.while_set` they stand for XLA's own collectives,
which the JAX package's "jnp" backend keeps.  No path on the card calls
a plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.ops.cuda import _build

# csrc/peer.cuh's limits, chunks and alignments
MAX_WORLD, MAX_PEERS, MAX_PIECES = 8, 4, 4
MAX_CHUNKS, CHUNK_BYTES = 512, 4096
ALIGN, PIECE_ALIGN = 256, 16
ERROR_WORDS = 6
LINE_BYTES = 16
# ReduceArgs' op
REDUCE_OPS = {"sum": 0, "max": 1}
# a spin's budget, in seconds of the card's maximum SM clock (a slower
# clock waits longer), and the plain version's timeout
SPIN_SECONDS = 10.0
# cudaErrorPeerAccessUnsupported: mg_peer_open found no peer access
NO_PEER_ACCESS = 217


def div_up(x: int, to: int) -> int:
    return -(-x // to)


def round_up(x: int, to: int) -> int:
    return div_up(x, to) * to


def slot_of(epoch: int) -> int:
    return epoch & 1


def flag_value(epoch: int) -> int:
    return epoch + 1


def flag_offset(sender: int, slot: int, chunk: int) -> int:
    return ((2 * sender + slot) * MAX_CHUNKS + chunk) * 8


def epoch_offset(world: int, peer: int) -> int:
    return (2 * world * MAX_CHUNKS + peer) * 8


def count_offset(world: int, peer: int) -> int:
    return epoch_offset(world, world + peer)


def line_offset(world: int, sender: int, slot: int) -> int:
    return count_offset(world, world) + (2 * sender + slot) * LINE_BYTES


def line_tag(epoch: int) -> int:
    return (epoch + 1) & 0xFFFFFFFF


def header_bytes(world: int) -> int:
    return round_up(line_offset(world, world, 0), ALIGN)


def slot_offset(world: int, sender: int, slot: int, capacity: int) -> int:
    return header_bytes(world) + (2 * sender + slot) * capacity


def mailbox_bytes(world: int, capacity: int) -> int:
    return slot_offset(world, world, 0, capacity)


def next_piece(offset: int, nbytes: int) -> int:
    return round_up(offset + nbytes, PIECE_ALIGN)


def chunk_bytes(capacity: int) -> int:
    return max(CHUNK_BYTES, round_up(div_up(capacity, MAX_CHUNKS),
                                     PIECE_ALIGN))


def chunk_count(nbytes: int, chunk: int) -> int:
    return 1 if nbytes == 0 else div_up(nbytes, chunk)


def span(c0: int, c1: int, off: int, nbytes: int) -> tuple[int, int] | None:
    """The part (lo, hi) of the piece at [off, off + nbytes) of a message
    that falls in its bytes [c0, c1), counted from the piece's start, or
    None."""
    a, b = max(c0, off), min(c1, off + nbytes)
    return (a - off, b - off) if a < b else None


def exchange_word(msg: int, piece: int, field: int) -> int:
    """The word of ExchangeArgs holding a message's field (piece -1) or a
    piece's (csrc/peer.cuh::exchange_word)."""
    head, per_msg = 7, 3 + 5 * MAX_PIECES
    return head + msg * per_msg + (field if piece < 0
                                   else 3 + 5 * piece + field)


def message_bytes(pieces) -> int:
    """The bytes a message of these (src, dst) pieces takes in a slot."""
    off = 0
    for src, _ in pieces:
        off = next_piece(off, src.numel() * src.element_size())
    return off


@dataclasses.dataclass(eq=False)
class Links:
    """One rank's transport: its mailbox (`local`) and every rank's as
    this rank reaches it (`remote`, `remote[rank]` its own) with
    `capacity` bytes a slot, on `device`.  On the card each is an address
    (the peers' mapped by CUDA IPC), `error` the host-mapped error record
    and `budget` the spin's cycles; on the CPU each is a numpy array.
    `release` frees what this rank allocated or mapped, once."""

    world: int
    rank: int
    capacity: int
    device: torch.device
    local: object
    remote: list
    error: int = 0
    error_device: int = 0
    budget: int = 0
    release: object = None

    def close(self) -> None:
        release, self.release = self.release, None
        if release is not None:
            release()

    def __del__(self):
        try:
            self.close()
        except Exception:  # the runtime may be gone at exit
            pass

    def fault(self) -> list | None:
        """The error record after a spin ran past its budget on the card:
        [kind (0 exchange, 1 gather, 2 reduce), rank, peer, epoch, chunk],
        else None."""
        if not self.error:
            return None
        words = (ctypes.c_uint64 * ERROR_WORDS).from_address(self.error)
        return list(words[1:]) if words[0] else None


class _DeviceWords:
    """n int64 words of the card at `address`, for torch.as_tensor."""

    def __init__(self, address: int, n: int):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "<i8",
                                         "data": (address, False),
                                         "version": 3}


def epochs(links: Links) -> list[int]:
    """The messages this rank has exchanged with each rank so far, read
    from its mailbox (0 for itself)."""
    off, world = epoch_offset(links.world, 0), links.world
    if links.device.type == "cpu":
        return [int(v) for v in links.local[off:off + 8 * world].view(
            np.uint64)]
    words = torch.as_tensor(_DeviceWords(links.local + off, world),
                            device=links.device)
    return words.cpu().tolist()


def alloc(world: int, capacity: int, device: torch.device):
    """A zeroed mailbox on `device` (mg_peer_alloc): (address, error
    record's host and device addresses, SM cycles a second)."""
    if not 2 <= world <= MAX_WORLD:
        raise ValueError(f"a mailbox serves 2 to {MAX_WORLD} ranks, not "
                         f"{world}")
    ptrs = [ctypes.c_void_p(0) for _ in range(3)]
    hz = ctypes.c_double(0.0)
    with torch.cuda.device(device):
        _build.check(_build.entry("mg_peer_alloc")(
            world, capacity, *[ctypes.byref(p) for p in ptrs],
            ctypes.byref(hz)), "mg_peer_alloc")
    # the clock attribute in kHz; 2 GHz where the runtime gives none
    return ptrs[0].value, ptrs[1].value, ptrs[2].value, hz.value or 2e9


def handle(address: int) -> bytes:
    """The 64-byte CUDA IPC handle of a mailbox."""
    buf = ctypes.create_string_buffer(64)
    _build.check(_build.entry("mg_peer_handle")(address, buf),
                 "mg_peer_handle")
    return buf.raw


def open_peer(handle_bytes: bytes, device: int, peer_device: int) -> int:
    """Map the mailbox of an IPC handle made on card `peer_device` into
    this process on card `device`; raise, naming both cards, where the
    pair has no peer access (cudaDeviceCanAccessPeer)."""
    ptr = ctypes.c_void_p(0)
    buf = ctypes.create_string_buffer(handle_bytes, 64)
    err = _build.entry("mg_peer_open")(buf, device, peer_device,
                                       ctypes.byref(ptr))
    if err == NO_PEER_ACCESS:
        raise RuntimeError(
            f"cuda:{device} cannot reach cuda:{peer_device}'s memory "
            "(cudaDeviceCanAccessPeer): the peer transport of a captured "
            "partitioned run needs peer access between every pair of cards")
    _build.check(err, "mg_peer_open")
    return ptr.value


def close(address: int, error_host: int = 0, opened: bool = False) -> None:
    """Unmap a peer's mailbox (`opened`), or free this rank's own."""
    _build.check(_build.entry("mg_peer_close")(address, error_host,
                                               int(opened)), "mg_peer_close")


def local_links(world: int, device, capacity: int) -> list[Links]:
    """`world` ranks' links inside this process, each rank's mailbox
    reached directly by the others (no IPC): threads over CPU mailboxes,
    or streams of one card (chip_smoke.py's check of the kernels)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    capacity = round_up(capacity, ALIGN)
    nbytes = mailbox_bytes(world, capacity)
    if device.type == "cpu":
        boxes = [np.zeros(nbytes, np.uint8) for _ in range(world)]
        return [Links(world, r, capacity, device, boxes[r], boxes)
                for r in range(world)]
    made = [alloc(world, capacity, device) for _ in range(world)]
    remote = [m[0] for m in made]
    budget = int(SPIN_SECONDS * made[0][3])
    return [Links(world, r, capacity, device, m[0], remote, m[1], m[2],
                  budget, lambda m=m: close(m[0], m[1]))
            for r, m in enumerate(made)]


def _u64(box: np.ndarray, off: int) -> np.ndarray:
    return box[off:off + 8].view(np.uint64)


def _wait(box: np.ndarray, off: int, want: int, what: str) -> None:
    end = time.monotonic() + SPIN_SECONDS
    spins = 0
    while int(_u64(box, off)[0]) != want:
        spins += 1
        if time.monotonic() > end:
            raise TimeoutError(f"peer transport: {what} not received "
                               f"within {SPIN_SECONDS} s")
        time.sleep(0 if spins < 1000 else 1e-4)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bytes in row-major order, flat (a view where t is contiguous:
    a destination is)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _chunks(links: Links, pieces):
    """Each chunk of a message of these (src, dst) pieces in a slot of
    `links`: (chunk, [(piece, lo, hi, offset in the slot), ...]), the
    bytes [lo, hi) of each piece it holds (csrc/peer.cu's split)."""
    chunk = chunk_bytes(links.capacity)
    sizes = [src.numel() * src.element_size() for src, _ in pieces]
    total = message_bytes(pieces)
    for c in range(chunk_count(total, chunk)):
        c0, c1 = c * chunk, min((c + 1) * chunk, total)
        spans, off = [], 0
        for k, nbytes in enumerate(sizes):
            got = span(c0, c1, off, nbytes)
            if got is not None:
                spans.append((k, *got, off))
            off = next_piece(off, nbytes)
        yield c, spans


def _send(links: Links, peer: int, pieces, e: int) -> None:
    """Message e to `peer`, chunk by chunk: the chunk's bytes of each
    piece's src into the peer's slot e & 1 for this rank, then the
    chunk's flag."""
    world, rank = links.world, links.rank
    box = links.remote[peer]
    base = slot_offset(world, rank, slot_of(e), links.capacity)
    srcs = [_bytes(src) for src, _ in pieces]
    for c, spans in _chunks(links, pieces):
        for k, lo, hi, off in spans:
            torch.from_numpy(box[base + off + lo:base + off + hi]).copy_(
                srcs[k][lo:hi])
        _u64(box, flag_offset(rank, slot_of(e), c))[0] = flag_value(e)


def _receive(links: Links, peer: int, pieces, e: int) -> None:
    """Message e of `peer`, chunk by chunk: wait on the chunk's flag,
    copy its bytes of each piece out into the piece's dst and count it;
    the count reaching the message's chunks is reset and advances the
    pair's epoch (the kernel's last block)."""
    world, local = links.world, links.local
    base = slot_offset(world, peer, slot_of(e), links.capacity)
    dsts = [_bytes(dst) for _, dst in pieces]
    count = _u64(local, count_offset(world, peer))
    chunks = list(_chunks(links, pieces))
    for c, spans in chunks:
        _wait(local, flag_offset(peer, slot_of(e), c), flag_value(e),
              f"rank {links.rank}: chunk {c} of message {e} of rank {peer}")
        for k, lo, hi, off in spans:
            dsts[k][lo:hi].copy_(torch.from_numpy(
                local[base + off + lo:base + off + hi]))
        count[0] += 1
        if count[0] == len(chunks):
            count[0] = 0
            _u64(local, epoch_offset(world, peer))[0] = e + 1


def exchange_plain(links: Links, msgs) -> None:
    """`exchange` on CPU mailboxes and tensors: every message sent, then
    each received, at the pair's epoch (all sent first, as every block of
    the kernel sends all its chunks before it waits)."""
    epochs = [int(_u64(links.local, epoch_offset(links.world, peer))[0])
              for peer, _ in msgs]
    for (peer, pieces), e in zip(msgs, epochs):
        _send(links, peer, pieces, e)
    for (peer, pieces), e in zip(msgs, epochs):
        _receive(links, peer, pieces, e)


def gather_plain(links: Links, x: torch.Tensor, out: torch.Tensor) -> None:
    """`gather` on CPU mailboxes and tensors."""
    others = [r for r in range(links.world) if r != links.rank]
    exchange_plain(links, [(r, [(x, out[r])]) for r in others])
    out[links.rank].copy_(x)


def _wait_line(box: np.ndarray, off: int, tag: int, what: str) -> None:
    """Spin until both tag words of the line at `off` carry `tag`."""
    end = time.monotonic() + SPIN_SECONDS
    spins = 0
    words = box[off:off + LINE_BYTES].view(np.uint32)
    while int(words[1]) != tag or int(words[3]) != tag:
        spins += 1
        if time.monotonic() > end:
            raise TimeoutError(f"peer transport: {what} not received "
                               f"within {SPIN_SECONDS} s")
        time.sleep(0 if spins < 1000 else 1e-4)


def _send_line(links: Links, peer: int, x: torch.Tensor, e: int) -> None:
    """Message e to `peer` as a line in line slot e & 1 for this rank:
    x's low and high words (the high one 0 for a float32), then the two
    tag words.  The card's one 16-byte store keeps each 8-byte half
    whole; here the data is stored before the tags, which a reader checks
    both, so it reads whole values as the kernel's lanes do."""
    off = line_offset(links.world, links.rank, slot_of(e))
    box = links.remote[peer]
    data = _bytes(x)
    torch.from_numpy(box[off:off + 4]).copy_(data[:4])
    if data.numel() == 8:
        torch.from_numpy(box[off + 8:off + 12]).copy_(data[4:])
    else:
        box[off + 8:off + 12] = 0
    words = box[off:off + LINE_BYTES].view(np.uint32)
    words[3] = line_tag(e)
    words[1] = line_tag(e)


def _receive_line(links: Links, peer: int, e: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """Message e of `peer`, a line: waited on until both tag words carry
    its tag, its value read as a 0-d tensor of `dtype`, and the pair's
    epoch advanced."""
    world, local = links.world, links.local
    off = line_offset(world, peer, slot_of(e))
    _wait_line(local, off, line_tag(e),
               f"rank {links.rank}: line {e} of rank {peer}")
    line = torch.from_numpy(local[off:off + LINE_BYTES]).clone()
    size = torch.empty((), dtype=dtype).element_size()
    value = torch.cat([line[:4], line[8:12]])[:size].view(dtype).reshape(())
    _u64(local, epoch_offset(world, peer))[0] = e + 1
    return value


def reduce_plain(links: Links, x: torch.Tensor, out: torch.Tensor,
                 op: str) -> None:
    """`reduce` on CPU mailboxes and tensors: a line to every peer, then
    each peer's line waited on and read (the kernel's lanes); then
    all_sum's sum in rank order, or all_max's `torch.stack(...).max()`."""
    world, rank = links.world, links.rank
    others = [p for p in range(world) if p != rank]
    epochs = {p: int(_u64(links.local, epoch_offset(world, p))[0])
              for p in others}
    for p in others:
        _send_line(links, p, x, epochs[p])
    values = [None] * world
    values[rank] = x.detach().reshape(())
    for p in others:
        values[p] = _receive_line(links, p, epochs[p], x.dtype)
    if op == "max":
        total = torch.stack(values).max()
    else:
        total = values[0]
        for v in values[1:]:
            total = total + v
    out.copy_(total)


def _check_piece(src: torch.Tensor, dst: torch.Tensor) -> None:
    if src.dtype != dst.dtype or src.shape != dst.shape:
        raise ValueError(f"piece {tuple(src.shape)} {src.dtype} into "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if not dst.is_contiguous():
        raise ValueError("a piece's destination must be contiguous")
    if src.dim() == 2 and src.stride(1) != 1 or src.dim() != 2 and (
            not src.is_contiguous()):
        raise ValueError("a piece's rows must be contiguous")
    if (src.shape[-1] if src.dim() == 2 else src.numel()) * (
            src.element_size()) % 4:
        raise ValueError("a piece's rows must be whole 4-byte words")


def _check(links: Links, msgs, tensors) -> bool:
    """Validate a call; True for the kernel (CUDA tensors), False for the
    plain version (CPU tensors and mailboxes)."""
    devices = {t.device for t in tensors}
    if devices != {links.device}:
        raise ValueError(f"peer transport on {links.device}, tensors on "
                         f"{devices}")
    for peer, pieces in msgs:
        if not 0 <= peer < links.world or peer == links.rank:
            raise ValueError(f"rank {links.rank} cannot send to {peer}")
        if message_bytes(pieces) > links.capacity:
            raise ValueError(f"a message of {message_bytes(pieces)} bytes, "
                             f"slots of {links.capacity}")
        for src, dst in pieces:
            _check_piece(src, dst)
    kind = links.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel route for device type {kind!r}")
    return kind == "cuda"


def _row(src: torch.Tensor) -> tuple[int, int, int]:
    """(rows, bytes a row, bytes between rows) of a piece's source."""
    size = src.element_size()
    if src.dim() != 2:
        return 1, src.numel() * size, src.numel() * size
    return src.shape[0], src.shape[1] * size, src.stride(0) * size


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def exchange(links: Links, msgs) -> None:
    """Trade pieces with peers: for each (peer, [(src, dst), ...]) of
    `msgs` (at most MAX_PEERS, each peer once, at most MAX_PIECES pieces),
    send each src (a 2-D view whose rows are contiguous) to `peer` and
    receive the peer's pieces, in the same order and of the same shapes,
    into each dst (contiguous).  The kernel for CUDA tensors, the plain
    version for CPU tensors; either advances each pair's epoch by one."""
    if not msgs:
        return
    if len(msgs) > MAX_PEERS or any(len(p) > MAX_PIECES for _, p in msgs):
        raise ValueError(f"at most {MAX_PEERS} peers of {MAX_PIECES} "
                         "pieces each")
    tensors = [t for _, pieces in msgs for pair in pieces for t in pair]
    if not _check(links, msgs, tensors):
        exchange_plain(links, msgs)
        return
    args = np.zeros(exchange_word(MAX_PEERS, -1, 0), np.uint64)
    args[:7] = (links.local, links.error_device, links.budget, links.rank,
                links.world, links.capacity, len(msgs))
    for m, (peer, pieces) in enumerate(msgs):
        args[exchange_word(m, -1, 0):exchange_word(m, -1, 3)] = (
            peer, links.remote[peer], len(pieces))
        for p, (src, dst) in enumerate(pieces):
            start = exchange_word(m, p, 0)
            args[start:start + 5] = (src.data_ptr(), dst.data_ptr(),
                                     *_row(src))
    _build.check(_build.entry("mg_peer_exchange")(args.ctypes.data,
                                            _stream(links.device)),
                 "mg_peer_exchange")
    cuda.LAUNCHES["peer_exchange"] += 1


def gather(links: Links, x: torch.Tensor, out: torch.Tensor) -> None:
    """out[r] = rank r's x for every rank, in rank order (x contiguous,
    out of shape (world, *x.shape), contiguous): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if tuple(out.shape) != (links.world, *x.shape) or out.dtype != x.dtype:
        raise ValueError(f"gather of {tuple(x.shape)} {x.dtype} into "
                         f"{tuple(out.shape)} {out.dtype}")
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("a gather takes contiguous tensors")
    others = [(r, [(x, out[r])]) for r in range(links.world)
              if r != links.rank]
    if not _check(links, others, [x, out]):
        gather_plain(links, x, out)
        return
    args = np.zeros(9 + MAX_WORLD, np.uint64)
    args[:9] = (links.local, links.error_device, links.budget, links.rank,
                links.world, links.capacity, x.data_ptr(), out.data_ptr(),
                x.numel() * x.element_size())
    args[9:9 + links.world] = links.remote
    _build.check(_build.entry("mg_peer_gather")(args.ctypes.data,
                                          _stream(links.device)),
                 "mg_peer_gather")
    cuda.LAUNCHES["peer_gather"] += 1


def reduce(links: Links, x: torch.Tensor, out: torch.Tensor,
           op: str = "sum") -> None:
    """out = the sum in rank order (op "sum": ((x0 + x1) + x2) + ..., the
    bits of `distributed.all_sum`'s gathered form on every rank) or the
    max (op "max", a NaN propagated, as `distributed.all_max`'s) of every
    rank's x, one float32 or float64 value, into the 0-d `out` of its
    dtype: the kernel for CUDA tensors, the plain version for CPU
    tensors; either advances each pair's epoch by one."""
    if op not in REDUCE_OPS:
        raise ValueError(f"reduce op {op!r}, not one of {list(REDUCE_OPS)}")
    if x.numel() != 1 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"a reduce takes one float32 or float64 value, "
                         f"not {tuple(x.shape)} {x.dtype}")
    if out.shape != () or out.dtype != x.dtype:
        raise ValueError(f"reduce of {x.dtype} into {tuple(out.shape)} "
                         f"{out.dtype}")
    others = [(r, []) for r in range(links.world) if r != links.rank]
    if not _check(links, others, [x, out]):
        reduce_plain(links, x, out, op)
        return
    args = np.zeros(9 + MAX_WORLD, np.uint64)
    args[:9] = (links.local, links.error_device, links.budget, links.rank,
                links.world, x.data_ptr(), out.data_ptr(),
                x.element_size(), REDUCE_OPS[op])
    args[9:9 + links.world] = links.remote
    _build.check(_build.entry("mg_peer_reduce")(args.ctypes.data,
                                          _stream(links.device)),
                 "mg_peer_reduce")
    cuda.LAUNCHES["peer_reduce"] += 1
