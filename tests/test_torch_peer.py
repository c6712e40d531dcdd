"""PyTorch port: the peer transport (ops/cuda/peer.py, csrc/peer.cu), on
the CPU, with the ranks as threads of this process.

The kernels store a message straight into the receiver's mailbox, in the
slot, under the flag and at the epoch that csrc/peer.cuh lays out; their
plain versions run the same protocol on CPU mailboxes.  Here:

  * the arithmetic of peer.cuh, built by g++ against the stand-in CUDA
    runtime of tests/test_torch_probe_maps.py, equals the plain
    version's on every index (slots, chunk flags, epochs, counts, pieces,
    the chunks of a message and the part of each piece a chunk holds,
    access widths, the grid, the packed argument words), so the kernel
    and its twin cannot disagree unseen; and the C entry points' arities
    equal the ctypes table's;
  * messages of one chunk, of many, with a partial last chunk, and
    strided column edges of 8- and 12-byte rows, in f32 and f64, arrive
    bit for bit as the NCCL pairing delivers them, with every chunk
    count back at 0;
  * `start_exchange` over the peer transport gives every halo of
    tests/test_torch_multigpu.py's cases (the rows deep halo of two
    blocks in f32 and f64, one row, the 2-D four edges, both extensions)
    bit for bit as the NCCL pairing emulated there does, on meshes of 2
    to 8 ranks, with the same collective counts;
  * the gather gives every rank's block in rank order, and `all_sum`
    through it has the bits of the NCCL form (an emulated all-gather) in
    float32 and float64;
  * the line path: peer.cuh's line offsets and tags equal peer.py's, a
    line is read only once both its halves carry the tag, and the reduce
    of one value (`all_sum`, `all_max` inside a body) over 2 to 8 ranks
    has the NCCL form's bits, the sum in rank order, the max with a NaN
    propagated;
  * a rank held back before each receive, over reduces and exchanges
    mixed, never has a line or a slot overwritten before it reads it;
  * a rank held back before each of three consecutive receives never
    has a slot overwritten before it reads it: its peer runs ahead by one
    message at most, and every message arrives whole, of one chunk or of
    24;
  * the epochs and flags continue across calls, with no reset;
  * set-up (a mailbox made or mapped) inside a capture raises, and so
    does a message past the slots there; outside one such a message sets
    up larger links and keeps the old;
  * the wrappers refuse what the kernels do not take.

tests/test_torch_partitioned_compiled.py routes the adaptive partitioned
runs through the transport in spawned gloo ranks (the plain version over
mailbox files every rank maps), under the capture stand-in.
"""

import concurrent.futures
import ctypes
import re
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hpcclassmultigridproject_tpu_torch.ops.cuda import _build, peer
from hpcclassmultigridproject_tpu_torch.parallel import Mesh, distributed
from hpcclassmultigridproject_tpu_torch.utils import graphs

from capture_stand_in import StandIn
from test_torch_multigpu import (
    CASES,
    WORLDS,
    _global,
    _NcclEmulation,
    _p2p_op,
    _part,
)
from test_torch_probe_maps import SHIM

CAPACITY = 1 << 14

# extern "C" wrappers of peer.cuh's functions, built with the stand-in
# runtime header
HOST = r"""
#include <cuda_runtime.h>
#include <cstddef>
#include "peer.cuh"
using namespace mg::peer;
typedef unsigned long long u64;
extern "C" {
u64 h_slot_of(u64 e) { return slot_of(e); }
u64 h_flag_value(u64 e) { return flag_value(e); }
u64 h_flag_offset(int sender, u64 slot, u64 chunk) {
  return flag_offset(sender, slot, chunk);
}
u64 h_epoch_offset(int world, int p) { return epoch_offset(world, p); }
u64 h_count_offset(int world, int p) { return count_offset(world, p); }
u64 h_chunk_bytes(u64 cap) { return chunk_bytes(cap); }
u64 h_chunk_count(u64 bytes, u64 chunk) { return chunk_count(bytes, chunk); }
u64 h_span(u64 c0, u64 c1, u64 off, u64 bytes, u64* out) {
  uint64_t lo = 0, hi = 0;
  const bool some = span(c0, c1, off, bytes, &lo, &hi);
  out[0] = lo;
  out[1] = hi;
  return some;
}
u64 h_word_bytes(u64 mask) { return word_bytes(mask); }
u64 h_exchange_grid(u64 chunks, u64 sms) { return exchange_grid(chunks, sms); }
// message_bytes of a message of n pieces of (rows, row_bytes)
u64 h_message_bytes(const u64* shapes, int n) {
  PeerMsg m{};
  m.npieces = n;
  for (int p = 0; p < n; ++p) {
    m.pieces[p].rows = shapes[2 * p];
    m.pieces[p].row_bytes = shapes[2 * p + 1];
  }
  return message_bytes(m);
}
u64 h_header_bytes(int world) { return header_bytes(world); }
u64 h_line_offset(int world, int sender, u64 slot) {
  return line_offset(world, sender, slot);
}
u64 h_line_tag(u64 e) { return line_tag(e); }
u64 h_slot_offset(int world, int sender, u64 slot, u64 cap) {
  return slot_offset(world, sender, slot, cap);
}
u64 h_mailbox_bytes(int world, u64 cap) { return mailbox_bytes(world, cap); }
u64 h_next_piece(u64 off, u64 bytes) { return next_piece(off, bytes); }
int h_exchange_word(int m, int p, int f) { return exchange_word(m, p, f); }
// the word of ExchangeArgs a field lies at, from the struct itself
u64 h_field_word(int m, int p, int f) {
  ExchangeArgs a;
  const uint64_t* at =
      p < 0 ? &a.msgs[m].peer + f : &a.msgs[m].pieces[p].src + f;
  return at - reinterpret_cast<const uint64_t*>(&a);
}
u64 h_sizes(int which) {
  switch (which) {
    case 0: return sizeof(ExchangeArgs);
    case 1: return sizeof(GatherArgs);
    case 2: return offsetof(GatherArgs, remote);
    case 3: return sizeof(ReduceArgs);
    case 4: return offsetof(ReduceArgs, remote);
    case 5: return LINE_BYTES;
    default: return 0;
  }
}
u64 h_limits(int which) {
  const u64 v[] = {MAX_WORLD, MAX_PEERS, MAX_PIECES, ALIGN, PIECE_ALIGN,
                   ERROR_WORDS, MAX_CHUNKS, CHUNK_BYTES};
  return v[which];
}
}
"""


@pytest.fixture(scope="module")
def cuh(tmp_path_factory):
    """peer.cuh's functions built for the host."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds peer.cuh for the host"
    d = tmp_path_factory.mktemp("peer_cuh")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "host.cpp").write_text(HOST)
    lib = d / "libpeer_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(d), "-I", str(_build.CSRC), "-o", str(lib),
                    str(d / "host.cpp")], check=True, capture_output=True,
                   text=True)
    cdll = ctypes.CDLL(str(lib))
    u64, i = ctypes.c_ulonglong, ctypes.c_int
    p64 = ctypes.POINTER(u64)
    for name, args in {"h_slot_of": [u64], "h_flag_value": [u64],
                       "h_flag_offset": [i, u64, u64],
                       "h_epoch_offset": [i, i], "h_count_offset": [i, i],
                       "h_chunk_bytes": [u64], "h_chunk_count": [u64, u64],
                       "h_span": [u64, u64, u64, u64, p64],
                       "h_word_bytes": [u64], "h_exchange_grid": [u64, u64],
                       "h_message_bytes": [p64, i],
                       "h_header_bytes": [i],
                       "h_line_offset": [i, i, u64], "h_line_tag": [u64],
                       "h_slot_offset": [i, i, u64, u64],
                       "h_mailbox_bytes": [i, u64],
                       "h_next_piece": [u64, u64], "h_field_word": [i, i, i],
                       "h_sizes": [i], "h_limits": [i]}.items():
        getattr(cdll, name).argtypes = args
        getattr(cdll, name).restype = u64
    cdll.h_exchange_word.argtypes = [i, i, i]
    cdll.h_exchange_word.restype = i
    return cdll


def test_header_arithmetic_equals_the_plain_versions(cuh):
    assert [cuh.h_limits(k) for k in range(8)] == [
        peer.MAX_WORLD, peer.MAX_PEERS, peer.MAX_PIECES, peer.ALIGN,
        peer.PIECE_ALIGN, peer.ERROR_WORDS, peer.MAX_CHUNKS,
        peer.CHUNK_BYTES]
    for e in (0, 1, 2, 3, 37, 2**31 + 5, 2**40 + 2):
        assert cuh.h_slot_of(e) == peer.slot_of(e)
        assert cuh.h_flag_value(e) == peer.flag_value(e)
    for world in range(2, peer.MAX_WORLD + 1):
        assert cuh.h_header_bytes(world) == peer.header_bytes(world)
        for cap in (256, 4096, CAPACITY, 3 << 20):
            assert cuh.h_mailbox_bytes(world, cap) == peer.mailbox_bytes(
                world, cap)
        for r in range(world):
            assert cuh.h_epoch_offset(world, r) == peer.epoch_offset(world,
                                                                     r)
            assert cuh.h_count_offset(world, r) == peer.count_offset(world,
                                                                     r)
            for slot in (0, 1):
                for c in (0, 1, 37, peer.MAX_CHUNKS - 1):
                    assert cuh.h_flag_offset(r, slot, c) == (
                        peer.flag_offset(r, slot, c))
                assert cuh.h_slot_offset(world, r, slot, CAPACITY) == (
                    peer.slot_offset(world, r, slot, CAPACITY))
        # flags, epochs and counts fit the header in this order, each word
        # its own, and slots do not overlap it
        flags = {peer.flag_offset(r, s, c) for r in range(world)
                 for s in (0, 1) for c in range(peer.MAX_CHUNKS)}
        assert len(flags) == 2 * world * peer.MAX_CHUNKS
        assert max(flags) + 8 <= peer.epoch_offset(world, 0)
        assert peer.epoch_offset(world, world - 1) + 8 <= peer.count_offset(
            world, 0)
        assert peer.count_offset(world, world - 1) + 8 <= peer.header_bytes(
            world)
    for off in (0, 4, 16, 100):
        for nbytes in (0, 4, 8, 12, 44, 4096):
            assert cuh.h_next_piece(off, nbytes) == peer.next_piece(off,
                                                                    nbytes)


def test_chunk_arithmetic_equals_the_plain_versions(cuh):
    """The chunks of a message and the part of each piece a chunk holds:
    the kernel's formulas equal the plain version's, and the chunks cover
    every byte of every piece once; the kernel's access width and grid
    are the ones its design states."""
    out = (ctypes.c_ulonglong * 2)()
    for cap in (256, 4096, CAPACITY, 1 << 20, (1 << 21) + 256, 3 << 22):
        chunk = peer.chunk_bytes(cap)
        assert cuh.h_chunk_bytes(cap) == chunk
        assert chunk % peer.PIECE_ALIGN == 0 and chunk >= peer.CHUNK_BYTES
        # a message the slot holds has at most MAX_CHUNKS chunks
        assert peer.chunk_count(cap, chunk) <= peer.MAX_CHUNKS
        for nbytes in (0, 4, 16, chunk - 16, chunk, chunk + 16, 5 * chunk
                       + 1616, cap):
            assert cuh.h_chunk_count(nbytes, chunk) == peer.chunk_count(
                nbytes, chunk)
    shapes = [(1, 8), (700, 12), (8, 2400), (1000, 8)]  # (rows, row bytes)
    packed = (ctypes.c_ulonglong * 8)(*[v for sh in shapes for v in sh])
    for n in range(1, len(shapes) + 1):
        offs, off = [], 0
        for rows, row in shapes[:n]:
            offs.append(off)
            off = peer.next_piece(off, rows * row)
        assert cuh.h_message_bytes(packed, n) == off
        for chunk in (peer.CHUNK_BYTES, 16 * 7):
            covered = [[0] * (rows * row) for rows, row in shapes[:n]]
            for c in range(peer.chunk_count(off, chunk)):
                c0, c1 = c * chunk, min((c + 1) * chunk, off)
                for k, (rows, row) in enumerate(shapes[:n]):
                    got = peer.span(c0, c1, offs[k], rows * row)
                    assert cuh.h_span(c0, c1, offs[k], rows * row, out) == (
                        got is not None)
                    if got is None:
                        continue
                    assert tuple(out) == got
                    lo, hi = got
                    # a split at 16 bytes or at the piece's end
                    assert lo % 16 == 0 and (hi % 16 == 0 or hi == rows * row)
                    for b in range(lo, hi):
                        covered[k][b] += 1
            assert all(v == 1 for piece in covered for v in piece)
    # the kernel's access width (the widest dividing every address, row
    # and pitch) and grid (a block a chunk, one a multiprocessor at most)
    for mask, width in ((0, 16), (4, 4), (8, 8), (12, 4), (16, 16),
                        (24, 8), (32, 16), (0x7f0c, 4), (0x1008, 8),
                        (0x1010, 16)):
        assert cuh.h_word_bytes(mask) == width
    for chunks in (1, 2, 36, 72, 132, 133, 1000):
        assert cuh.h_exchange_grid(chunks, 132) == min(chunks, 132)


def test_packed_arguments_match_the_structs(cuh):
    """The words the wrappers pack are the structs' fields, and the
    arrays have the structs' sizes."""
    words = peer.exchange_word(peer.MAX_PEERS, -1, 0)
    assert cuh.h_sizes(0) == 8 * words
    assert cuh.h_sizes(1) == 8 * (9 + peer.MAX_WORLD)
    assert cuh.h_sizes(2) == 8 * 9
    for m in range(peer.MAX_PEERS):
        for f in range(3):
            assert cuh.h_exchange_word(m, -1, f) == peer.exchange_word(m, -1,
                                                                       f)
            assert cuh.h_field_word(m, -1, f) == peer.exchange_word(m, -1, f)
        for p in range(peer.MAX_PIECES):
            for f in range(5):
                assert cuh.h_field_word(m, p, f) == peer.exchange_word(m, p,
                                                                       f)


def test_c_entry_points_match_the_ctypes_table():
    text = (_build.CSRC / "peer.cu").read_text()
    found = {name: len([p for p in params.split(",") if p.strip()])
             for name, params in re.findall(
                 r'extern "C" \w+\*? (\w+)\(([^)]*)\)', text, flags=re.S)}
    assert found == {k: len(v) for k, v in _build._PEER_SIGNATURES.items()}


def _threads(world: int, fn):
    """fn(rank) in one thread a rank; the results in rank order."""
    with concurrent.futures.ThreadPoolExecutor(world) as pool:
        return [f.result() for f in [pool.submit(fn, r)
                                     for r in range(world)]]


class _ThreadLinks:
    """`distributed._peer_links` for thread ranks: rank r's links."""

    def __init__(self, world: int, capacity: int = CAPACITY):
        self.links = peer.local_links(world, "cpu", capacity)
        self.local = threading.local()

    def __call__(self, mesh, device, need):
        assert need <= self.links[0].capacity
        return self.links[self.local.rank]

    def run(self, world: int, fn):
        def as_rank(rank):
            self.local.rank = rank
            return fn(rank)

        return _threads(world, as_rank)


def _flat(xs):
    return [t for x in xs for t in (x if isinstance(x, tuple) else (x,))]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_exchange_equals_the_nccl_pairing(monkeypatch, world, case):
    layout, run_case = CASES[case]
    shape = _part(layout, Mesh(world, 0))
    fields = [_global((shape.rows, shape.cols), torch.float32),
              _global((shape.rows, shape.cols), torch.float64, sign=-1.0)]
    one = lambda r: run_case(_part(layout, Mesh(world, r)), fields)

    nccl = _NcclEmulation(world)
    with monkeypatch.context() as m:
        m.setattr(dist, "batch_isend_irecv", nccl.batch)
        m.setattr(dist, "P2POp", _p2p_op)
        distributed.COLLECTIVES["batch_isend_irecv"] = 0
        want = nccl.run(world, one)
        nccl_batches = distributed.COLLECTIVES["batch_isend_irecv"]

    links = _ThreadLinks(world)
    monkeypatch.setattr(distributed, "_peer_links", links)
    monkeypatch.setattr(dist, "batch_isend_irecv", None)  # not reached
    distributed.COLLECTIVES["batch_isend_irecv"] = 0
    got = links.run(world, one)
    assert distributed.COLLECTIVES["batch_isend_irecv"] == nccl_batches
    for (g, expect), (w, _) in zip(got, want):
        g, w, expect = _flat(g), _flat(w), _flat(expect)
        assert len(g) == len(w) == len(expect)
        for a, b, c in zip(g, w, expect):
            assert a.dtype == b.dtype == c.dtype
            assert torch.equal(a, b) and torch.equal(a, c)


# (blocks' (rows, cols, dtype), k, axis, the message's chunks) of an
# exchange with one neighbour on each side of a line of ranks
CHUNKED = {
    "one chunk, f64 rows": ([(16, 12, torch.float64)], 8, 0, 1),
    "many chunks, f64 rows": ([(16, 512, torch.float64)] * 2, 8, 0, 16),
    "partial last chunk, f32 and f64 rows": (
        [(8, 300, torch.float32), (8, 300, torch.float64)], 5, 0, 5),
    "8-byte column edges, f64": ([(1000, 6, torch.float64)], 1, 1, 2),
    "12-byte column edges, f32": ([(700, 9, torch.float32)], 3, 1, 3),
}
CHUNKED_CAPACITY = 1 << 17


def _numbered(r: int, shapes):
    """Rank r's blocks: every value distinct across ranks and blocks."""
    return [torch.arange(rows * cols, dtype=dt).reshape(rows, cols)
            + 1.0 + 1e5 * r + 2e4 * i
            for i, (rows, cols, dt) in enumerate(shapes)]


@pytest.mark.parametrize("case", list(CHUNKED))
@pytest.mark.parametrize("world", WORLDS)
def test_chunked_exchange_equals_the_nccl_pairing(monkeypatch, world, case):
    """Messages of one chunk, of many, with a partial last chunk, and
    strided column edges of 8- and 12-byte rows, in f32 and f64: the
    plain chunked protocol gives every halo bit for bit as the NCCL
    pairing does, and as the neighbours' blocks hold it."""
    shapes, k, axis, nchunks = CHUNKED[case]
    nbytes = distributed._side_bytes(_numbered(0, shapes), k, axis)
    assert peer.chunk_count(nbytes, peer.chunk_bytes(
        CHUNKED_CAPACITY)) == nchunks

    def one(r):
        sides = [(axis, r - 1 if r > 0 else None,
                  r + 1 if r < world - 1 else None)]
        return distributed.start_exchange(_numbered(r, shapes), k,
                                          Mesh(world, r), sides).wait()

    nccl = _NcclEmulation(world)
    with monkeypatch.context() as m:
        m.setattr(dist, "batch_isend_irecv", nccl.batch)
        m.setattr(dist, "P2POp", _p2p_op)
        want = nccl.run(world, one)
    links = _ThreadLinks(world, CHUNKED_CAPACITY)
    monkeypatch.setattr(distributed, "_peer_links", links)
    monkeypatch.setattr(dist, "batch_isend_irecv", None)  # not reached
    got = links.run(world, one)
    for r in range(world):
        assert len(got[r]) == len(want[r]) == len(shapes)
        for i, ((top, bot), (wtop, wbot)) in enumerate(zip(got[r],
                                                           want[r])):
            edge = lambda x, first: distributed._edge(x, axis, first, k)
            above = (edge(_numbered(r - 1, shapes)[i], False) if r > 0
                     else torch.zeros_like(top))
            below = (edge(_numbered(r + 1, shapes)[i], True)
                     if r < world - 1 else torch.zeros_like(bot))
            for a, b, c in ((top, wtop, above), (bot, wbot, below)):
                assert a.dtype == b.dtype == c.dtype == shapes[i][2]
                assert torch.equal(a, b) and torch.equal(a, c)
    for lk in links.links:
        for p in range(world):
            assert int(peer._u64(lk.local, peer.count_offset(world, p))[0]
                       ) == 0


class _AllGatherEmulation:
    """`dist.all_gather` for thread ranks (NCCL's all-gather: every rank's
    tensor, in rank order)."""

    def __init__(self, world: int, local):
        self.barrier = threading.Barrier(world, timeout=20)
        self.posted, self.local = {}, local

    def __call__(self, parts, src):
        self.posted[self.local.rank] = src
        self.barrier.wait()
        for r, p in enumerate(parts):
            p.copy_(self.posted[r])
        self.barrier.wait()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("world", WORLDS)
def test_gather_in_rank_order_and_all_sum_bits(monkeypatch, world, dtype):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(Mesh, "backend", property(lambda self: "gloo"))
    rng = np.random.default_rng(world)
    # terms whose sum depends on the order of addition
    scalars = [torch.tensor(v, dtype=dtype) for v in
               rng.standard_normal(world) * 10.0 ** rng.integers(-6, 6,
                                                                 world)]
    blocks_ = [torch.tensor(rng.standard_normal((3, 5)), dtype=dtype)
               for _ in range(world)]

    def rank(r):
        mesh = Mesh(world, r)
        return (distributed.all_sum(scalars[r], mesh),
                distributed.all_gather_blocks(blocks_[r], mesh))

    links = _ThreadLinks(world)
    with monkeypatch.context() as m:
        m.setattr(dist, "all_gather", _AllGatherEmulation(world,
                                                          links.local))
        want = links.run(world, rank)  # _peer_links not patched: NCCL form
    monkeypatch.setattr(distributed, "_peer_links", links)
    monkeypatch.setattr(dist, "all_gather", None)  # not reached
    distributed.COLLECTIVES["all_gather"] = 0
    got = links.run(world, rank)
    assert distributed.COLLECTIVES["all_gather"] == 2 * world
    in_order = scalars[0]
    for s in scalars[1:]:
        in_order = in_order + s
    for (total, parts), (want_total, want_parts) in zip(got, want):
        assert total.dtype == dtype and total.shape == ()
        assert torch.equal(total, want_total)
        assert torch.equal(total, in_order)
        for p, w, b in zip(parts, want_parts, blocks_):
            assert torch.equal(p, w) and torch.equal(p, b)


def test_line_arithmetic_equals_the_plain_versions(cuh):
    """The lines' offsets and tags, and ReduceArgs' words: the kernel's
    formulas equal the plain version's; the lines lie after the counts,
    16-byte aligned, one a (sender, slot), inside the header."""
    assert cuh.h_sizes(5) == peer.LINE_BYTES == 16
    assert cuh.h_sizes(3) == 8 * (9 + peer.MAX_WORLD)
    assert cuh.h_sizes(4) == 8 * 9
    for e in (0, 1, 2, 37, 2**32 - 2, 2**32 - 1, 2**32, 2**40 + 2):
        assert cuh.h_line_tag(e) == peer.line_tag(e) == (e + 1) % 2**32
        # a line two messages older in the slot never carries the tag
        assert e < 2 or peer.line_tag(e - 2) != peer.line_tag(e)
    for world in range(2, peer.MAX_WORLD + 1):
        lines = []
        for r in range(world):
            for slot in (0, 1):
                off = peer.line_offset(world, r, slot)
                assert cuh.h_line_offset(world, r, slot) == off
                assert off % 16 == 0
                lines.append(off)
        assert len(set(lines)) == 2 * world
        assert min(lines) >= peer.count_offset(world, world - 1) + 8
        assert max(lines) + 16 <= peer.header_bytes(world)


def test_a_line_is_read_only_whole(monkeypatch):
    """A reader waits until both halves carry the message's tag: a line
    whose halves are of two messages (the store's halves landed apart) is
    not read; a float32 and a float64 value arrive whole."""
    monkeypatch.setattr(peer, "SPIN_SECONDS", 0.2)
    links = peer.local_links(2, "cpu", 256)
    x = torch.tensor(-3.0e-7, dtype=torch.float64)
    peer._send_line(links[1], 0, x, 0)  # message 0, in line slot 0
    off = peer.line_offset(2, 1, peer.slot_of(2))
    words = links[0].local[off:off + 16].view(np.uint32)
    assert list(words[[1, 3]]) == [peer.line_tag(0)] * 2
    words[3] = peer.line_tag(2)  # the high half of message 2 landed
    with pytest.raises(TimeoutError, match="line 2 of rank 1"):
        peer._receive_line(links[0], 1, 2, torch.float64)
    words[1] = peer.line_tag(2)
    got = peer._receive_line(links[0], 1, 2, torch.float64)
    assert got.dtype == torch.float64 and got.shape == ()
    assert torch.equal(got, x)
    assert peer.epochs(links[0]) == [0, 3]
    f32 = torch.tensor(1.5e-3, dtype=torch.float32)
    peer._send_line(links[0], 1, f32, 5)
    assert int(links[1].local[peer.line_offset(2, 0, 1) + 8:][:4].view(
        np.uint32)[0]) == 0  # a float32's high word
    assert torch.equal(peer._receive_line(links[1], 0, 5, torch.float32),
                       f32)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("world", WORLDS)
def test_reduce_equals_the_nccl_form(monkeypatch, world, dtype, op):
    """all_sum and all_max inside a compiled body take the reduce: every
    rank's result has the bits of the NCCL form (an emulated all-gather,
    then the adds in rank order or the stack's max), over three calls
    (the epochs and line slots advancing), a NaN propagated by the max;
    one all_gather counted a call either way."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(Mesh, "backend", property(lambda self: "gloo"))
    rng = np.random.default_rng(10 * world + (op == "max"))
    calls = []
    for c in range(3):
        v = rng.standard_normal(world) * 10.0 ** rng.integers(-6, 6, world)
        if op == "max" and c == 2:
            v[world // 2] = np.nan
        calls.append([torch.tensor(x, dtype=dtype) for x in v])
    fn = distributed.all_sum if op == "sum" else distributed.all_max

    def rank(r):
        mesh = Mesh(world, r)
        return [fn(values[r], mesh) for values in calls]

    links = _ThreadLinks(world)
    with monkeypatch.context() as m:
        m.setattr(dist, "all_gather", _AllGatherEmulation(world,
                                                          links.local))
        want = links.run(world, rank)  # _peer_links not patched: NCCL form
    monkeypatch.setattr(distributed, "_peer_links", links)
    monkeypatch.setattr(dist, "all_gather", None)  # not reached
    distributed.COLLECTIVES["all_gather"] = 0
    got = links.run(world, rank)
    assert distributed.COLLECTIVES["all_gather"] == 3 * world
    for c, values in enumerate(calls):
        if op == "sum":
            expect = values[0]
            for v in values[1:]:
                expect = expect + v
        else:
            expect = torch.stack(values).max()
        for r in range(world):
            g, w = got[r][c], want[r][c]
            assert g.dtype == dtype and g.shape == ()
            assert torch.equal(g, w) or (g.isnan() and w.isnan())
            assert torch.equal(g, expect) or (g.isnan() and expect.isnan())
    for lk in links.links:
        assert peer.epochs(lk) == [0 if p == lk.rank else 3
                                   for p in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_held_back_rank_never_loses_a_line(monkeypatch, world):
    """Rank 1 stops before each receive, over a mix of reduces (a line to
    every rank) and exchanges (chunked messages to the neighbours), which
    share each pair's epochs: no peer runs more than one message ahead of
    it, no line or slot of message e reaches it before it has read
    message e - 2 of that peer, and every value arrives whole."""
    import queue

    held, kinds = 1, ["reduce", "reduce", "exchange", "reduce", "exchange",
                      "reduce"]
    log, lock, holds = [], threading.Lock(), queue.Queue()
    originals = {name: getattr(peer, name) for name in
                 ("_send", "_receive", "_send_line", "_receive_line")}

    def sending(name):
        def call(links, p, payload, e):
            originals[name](links, p, payload, e)
            with lock:
                log.append(("send", links.rank, p, e))
        return call

    def receiving(name):
        def call(links, p, *args):
            e = args[1] if name == "_receive" else args[0]
            if links.rank == held:
                go = threading.Event()
                holds.put((p, e, go))
                assert go.wait(20)
            out = originals[name](links, p, *args)
            with lock:
                log.append(("receive", links.rank, p, e))
            return out
        return call

    for name in ("_send", "_send_line"):
        monkeypatch.setattr(peer, name, sending(name))
    for name in ("_receive", "_receive_line"):
        monkeypatch.setattr(peer, name, receiving(name))
    links = peer.local_links(world, "cpu", CAPACITY)
    neighbours = lambda r: [p for p in (r - 1, r + 1) if 0 <= p < world]

    def rank(r):
        out = []
        for call, kind in enumerate(kinds):
            if kind == "reduce":
                x = torch.tensor(1.0 + 10.0 ** call * (r + 1),
                                 dtype=torch.float64)
                total = torch.empty((), dtype=torch.float64)
                peer.reduce(links[r], x, total)
                out.append(total)
            else:
                msgs = [(p, _pieces(world, r, p, call)[0])
                        for p in neighbours(r)]
                peer.exchange(links[r], msgs)
                out.append([pieces[0][1] for _, pieces in msgs])
        return out

    with concurrent.futures.ThreadPoolExecutor(world) as pool:
        futures = [pool.submit(rank, r) for r in range(world)]
        while not all(f.done() for f in futures):
            try:
                p, e, go = holds.get(timeout=0.05)
            except queue.Empty:
                continue
            time.sleep(0.1)  # the others run as far as the protocol lets
            with lock:
                for q in range(world):
                    sent = [m for op, r, to, m in log
                            if op == "send" and r == q and to == held]
                    read = sum(1 for op, r, frm, _ in log
                               if op == "receive" and r == held
                               and frm == q)
                    assert not sent or max(sent) <= read + 1, (q, sent,
                                                              read)
            go.set()
        results = [f.result() for f in futures]
    for r, per_rank in enumerate(results):
        for call, kind in enumerate(kinds):
            got = per_rank[call]
            if kind == "reduce":
                want = torch.tensor(1.0 + 10.0 ** call, dtype=torch.float64)
                for q in range(1, world):
                    want = want + torch.tensor(1.0 + 10.0 ** call * (q + 1),
                                               dtype=torch.float64)
                assert torch.equal(got, want)
            else:
                for p, dst in zip(neighbours(r), got):
                    assert torch.equal(dst, _pieces(world, r, p, call)[1])
    for i, (op, r, p, e) in enumerate(log):
        if op == "send" and p == held and e >= 2:
            assert ("receive", held, r, e - 2) in log[:i], (r, e)


def test_reduce_refuses_what_the_kernel_does_not_take():
    links = peer.local_links(2, "cpu", 256)[0]
    one = torch.zeros(())
    with pytest.raises(ValueError, match="reduce op"):
        peer.reduce(links, one, torch.zeros(()), "min")
    with pytest.raises(ValueError, match="one float32 or float64 value"):
        peer.reduce(links, torch.zeros(2), torch.zeros(()))
    with pytest.raises(ValueError, match="one float32 or float64 value"):
        peer.reduce(links, torch.zeros((), dtype=torch.int32),
                    torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="into"):
        peer.reduce(links, one, torch.zeros((), dtype=torch.float64))
    with pytest.raises(ValueError, match="peer transport on"):
        peer.reduce(links, one.to("meta"), torch.zeros((), device="meta"))


def _pieces(world, r, peer_rank, call, rows=3, cols=4):
    """(src, dst) pieces rank r trades with peer_rank at `call`: values
    naming the call, the sender and the receiver."""
    def value(sender, receiver):
        return (1000.0 * call + 10.0 * sender + receiver
                + torch.arange(rows * cols, dtype=torch.float64)
                .reshape(rows, cols) / 100.0)

    src = value(r, peer_rank)
    return [(src, torch.zeros_like(src))], value(peer_rank, r)


def _held_back(monkeypatch, world: int, rows: int, cols: int,
               capacity: int) -> None:
    """Rank 1 stops before each receive until its neighbours have run as
    far ahead as they can: each then has sent at most the next message
    (two slots suffice), and every message arrives whole."""
    calls, held = 3, 1
    log, lock = [], threading.Lock()
    release = [threading.Event() for _ in range(calls)]
    holding = [threading.Event() for _ in range(calls)]
    send, receive = peer._send, peer._receive

    def logged_send(links, p, pieces, e):
        send(links, p, pieces, e)
        with lock:
            log.append(("send", links.rank, p, e))

    def held_receive(links, p, pieces, e):
        if links.rank == held:
            holding[e].set()
            assert release[e].wait(20)
        receive(links, p, pieces, e)
        with lock:
            log.append(("receive", links.rank, p, e))

    monkeypatch.setattr(peer, "_send", logged_send)
    monkeypatch.setattr(peer, "_receive", held_receive)
    links = peer.local_links(world, "cpu", capacity)
    neighbours = lambda r: [p for p in (r - 1, r + 1) if 0 <= p < world]

    def rank(r):
        out = []
        for call in range(calls):
            msgs, want = [], []
            for p in neighbours(r):
                pieces, expect = _pieces(world, r, p, call, rows, cols)
                msgs.append((p, pieces))
                want.append(expect)
            peer.exchange(links[r], msgs)
            out.append([(pieces[0][1], expect) for (_, pieces), expect
                        in zip(msgs, want)])
        return out

    with concurrent.futures.ThreadPoolExecutor(world) as pool:
        futures = [pool.submit(rank, r) for r in range(world)]
        for call in range(calls):
            assert holding[call].wait(20)
            time.sleep(0.2)  # the others run as far as the protocol lets
            with lock:
                sent = [e for op, r, p, e in log
                        if op == "send" and p == held]
            assert max(sent) <= call + 1, (call, sent)
            release[call].set()
        results = [f.result() for f in futures]
    for per_rank in results:
        for per_call in per_rank:
            for got, expect in per_call:
                assert torch.equal(got, expect)
    # no message e reached the held rank's slot before message e - 2 was
    # read out of it
    for i, (op, r, p, e) in enumerate(log):
        if op == "send" and p == held and e >= 2:
            assert ("receive", held, r, e - 2) in log[:i], (r, e)


@pytest.mark.parametrize("world", [2, 4])
def test_held_back_rank_never_loses_a_message(monkeypatch, world):
    """`_held_back` with messages of one chunk."""
    _held_back(monkeypatch, world, 3, 4, CAPACITY)


@pytest.mark.parametrize("world", [2, 4])
def test_held_back_rank_never_loses_a_chunked_message(monkeypatch, world):
    """`_held_back` with messages of 24 chunks, the last partial: no
    chunk of a message is overwritten before it is read."""
    rows, cols = 40, 301
    assert peer.chunk_count(peer.next_piece(0, rows * cols * 8),
                            peer.CHUNK_BYTES) == 24
    _held_back(monkeypatch, world, rows, cols, CHUNKED_CAPACITY)


def test_epochs_continue_across_calls():
    world = 4
    links = peer.local_links(world, "cpu", CAPACITY)
    x = [torch.full((2, 3), float(r)) for r in range(world)]

    def batch(r, n):
        for _ in range(n):
            out = torch.empty(world, 2, 3)
            peer.gather(links[r], x[r], out)
            assert torch.equal(out, torch.stack(x))
            pieces, _ = _pieces(world, r, r ^ 1, 0)
            peer.exchange(links[r], [(r ^ 1, pieces)])

    for done in (3, 8):
        _threads(world, lambda r: batch(r, 3 if done == 3 else 5))
        for r, lk in enumerate(links):
            for p in range(world):
                if p == r:
                    continue
                e = int(peer._u64(lk.local, peer.epoch_offset(world, p))[0])
                # a gather a call with every rank, an exchange with r ^ 1
                assert e == done * (2 if p == r ^ 1 else 1)
                flags = [int(peer._u64(lk.local,
                                       peer.flag_offset(p, s, 0))[0])
                         for s in (0, 1)]
                # every message's chunks counted out, the count reset
                assert int(peer._u64(lk.local,
                                     peer.count_offset(world, p))[0]) == 0
                assert flags[peer.slot_of(e - 1)] == peer.flag_value(e - 1)
                assert flags[peer.slot_of(e - 2)] == peer.flag_value(e - 2)


def test_setup_inside_a_capture_raises(monkeypatch):
    monkeypatch.setattr(graphs, "CAPTURE", StandIn())
    mesh = Mesh(2, 0)

    def connect_in_capture(x):
        if graphs.CAPTURE.capturing(x.device):
            distributed.connect(mesh, x.device, CAPACITY)
        return x + 1.0

    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        graphs.Programs()("setup", connect_in_capture, (torch.ones(2),))

    programs = graphs.Programs()
    small = peer.local_links(2, "cpu", 256)[0]
    programs.resources[("peer", mesh.key, "cpu")] = [small]

    def grow_in_capture(x):
        if graphs.CAPTURE.capturing(x.device):
            with graphs.loop_body():
                distributed._peer_links(mesh, x.device, 4096)
        return x + 1.0

    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        programs("grow", grow_in_capture, (torch.ones(2),))


def test_outside_a_compiled_body_the_group_carries_it():
    """An eager call, and a compiled program's collectives outside its
    loop bodies, take the process group's transport."""
    mesh = Mesh(2, 0)
    assert distributed._peer_links(mesh, "cpu", 8) is None
    with graphs.loop_body():
        assert distributed._peer_links(mesh, "cpu", 8) is None
    graphs._COMPILING.append(graphs.Programs())
    try:
        assert distributed._peer_links(mesh, "cpu", 8) is None
    finally:
        graphs._COMPILING.pop()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    links = peer.local_links(2, "cpu", 256)[0]
    src = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="slots of"):
        peer.exchange(links, [(1, [(torch.zeros(16, 16),
                                    torch.zeros(16, 16))])])
    with pytest.raises(ValueError, match="contiguous"):
        peer.exchange(links, [(1, [(src, torch.zeros(8, 4).t())])])
    with pytest.raises(ValueError, match="rows must be contiguous"):
        peer.exchange(links, [(1, [(src.t(), torch.zeros(8, 4))])])
    with pytest.raises(ValueError, match="cannot send"):
        peer.exchange(links, [(0, [(src, torch.zeros(4, 8))])])
    with pytest.raises(ValueError, match="4-byte words"):
        peer.exchange(links, [(1, [(torch.zeros(2, 3, dtype=torch.int16),
                                    torch.zeros(2, 3, dtype=torch.int16))])])
    with pytest.raises(ValueError, match="gather of"):
        peer.gather(links, torch.zeros(3), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="serves 2 to"):
        peer.alloc(9, 256, torch.device("cpu"))


def test_a_larger_message_grows_the_mailbox_in_the_warm_up(monkeypatch):
    """Outside a capture, a message past the slots sets up larger links
    (every rank meets it at the same call) and keeps the old ones, which
    graphs captured earlier read."""
    made = []

    def connect(mesh, device, capacity):
        made.append(capacity)
        return peer.local_links(2, device, capacity)[mesh.rank]

    monkeypatch.setattr(distributed, "connect", connect)
    mesh, programs = Mesh(2, 0), graphs.Programs()
    graphs._COMPILING.append(programs)
    try:
        with graphs.loop_body():
            first = distributed._peer_links(mesh, "cpu", 64)
            assert distributed._peer_links(mesh, "cpu", 64) is first
            big = distributed.PEER_MIN_CAPACITY + 1
            grown = distributed._peer_links(mesh, "cpu", big)
    finally:
        graphs._COMPILING.pop()
    assert made == [distributed.PEER_MIN_CAPACITY,
                    2 * distributed.PEER_MIN_CAPACITY]
    assert grown.capacity >= big and grown is not first
    assert programs.resources[distributed._peer_key(mesh, "cpu")] == [
        first, grown]
