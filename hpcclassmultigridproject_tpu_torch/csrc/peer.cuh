// The mailbox of the peer transport (csrc/peer.cu): where a rank's card
// keeps the messages the other ranks store into it over NVLink, and the
// arithmetic of slots, chunks, flags, epochs and message pieces.  The
// functions are __host__ __device__, so that the kernels, their host entry
// points and a host build of this header (tests/test_torch_peer.py) share
// one formula, and the plain version in ops/cuda/peer.py repeats it name by
// name.
//
// A mailbox, one cudaMalloc a rank, bytes from its start:
//
//   flag(sender, slot, chunk)  8 bytes each, world x 2 x MAX_CHUNKS: the
//                        last message of `sender` in `slot` whose chunk
//                        `chunk` has arrived, as e + 1 (0: none yet); the
//                        sender stores it, with st.release.sys, into the
//                        receiver's mailbox
//   epoch(peer)          8 bytes each, world: the messages this rank has
//                        exchanged with `peer` so far; only this rank's
//                        kernels read and advance it
//   count(peer)          8 bytes each, world: the chunks of the current
//                        message from `peer` this rank's blocks have copied
//                        out (0 between calls); the block that brings it to
//                        the message's chunk count resets it and advances
//                        epoch(peer)
//   line(sender, slot)   16 bytes each, world x 2: the last one-value
//                        message of `sender` in `slot` (the reduce of
//                        mg_peer_reduce), {lo word, tag, hi word, tag}
//                        with tag = line_tag(e), stored by the sender with
//                        one 16-byte store
//   slot(sender, slot)   `capacity` bytes each, world x 2, from
//                        header_bytes(world) on: message e of `sender`
//                        lies in slot e & 1
//
// A message (the pieces of one peer, laid out by next_piece) is cut into
// chunks of chunk_bytes(capacity) bytes, the last one partial: a multiple
// of 16 bytes, at least CHUNK_BYTES, and large enough that a message the
// slot holds has at most MAX_CHUNKS of them.  Each chunk has its own flag,
// so a receiving block waits for its chunk only.
//
// Each ordered pair of ranks meets once a call in each direction (a halo
// exchange with a neighbour is symmetric, a gather or a reduce reaches
// every rank), so the two ranks of a pair advance their epochs of each
// other in the same post order: the same contract as NCCL's pairing in
// start_exchange.  The three kinds of call share the pair's epoch: message
// e of a pair is a chunked message in slot e & 1 or a line in line slot
// e & 1, whichever call the two ranks make e-th.
//
// A line (NCCL's "LL" protocol) carries one 4- or 8-byte value and its own
// flag: the value's low word and the tag, then its high word (0 for a
// 4-byte value) and the tag again.  The sender stores the 16 bytes with one
// st.volatile.global.v4.u32; NVLink and the memory keep each aligned 8-byte
// half whole, though the halves may land in either order.  So a reader
// that sees the tag in both halves has both words of message e, with no
// fence between data and flag and no flag of its own: one store a peer and
// one trip over NVLink.  A tag is 32 bits; an older line in the slot has
// tag e - 1 (message e - 2), never e + 1, and a zeroed mailbox holds 0.
//
// Why two slots suffice.  A launch's blocks first store all their chunks
// of the outgoing messages, then wait for the same chunks of the incoming
// ones and copy them out, so the launch ends only once every chunk of
// every incoming message has been received and copied out; a rank's
// launches run in order, one after another.  So the argument holds at the
// granularity of a launch, whatever the number of its blocks.  When rank A
// stores any chunk of message e into B's slot e & 1, A's previous launch
// has ended, so A has received all of B's message e - 1.  B stored that in
// its launch e - 1, which began after its launch e - 2 had ended, and so
// after it had copied out every chunk of A's message e - 2: the last
// message that slot held.  So no slot is overwritten before it is read; a
// flag of slot e & 1 goes from e - 1 to e + 1, so a wait for e + 1 cannot
// be met by an older message; and nothing is reset between calls, WHILE
// trips or replays.
//
// The same holds for lines, whose reduce launch also first stores, then
// waits and reads (a lane a peer).  A line of message e + 2 overwrites
// line slot e & 1 only once A's launch of message e + 1 has ended, so once
// A has read B's message e + 1; B stored that in its launch e + 1, which
// began after its launch e had read A's line e out of that slot.  A rank
// that runs ahead is held at most one message ahead of each peer, and its
// line of e + 1 goes to the other slot.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#endif
#ifndef __device__
#define __device__
#endif
#endif

namespace mg {
namespace peer {

// ranks a mailbox serves, peers of one exchange (two a side, two sides)
// and pieces (blocks) of one message
constexpr int MAX_WORLD = 8;
constexpr int MAX_PEERS = 4;
constexpr int MAX_PIECES = 4;
// chunks of one message at most, and a chunk's least bytes (a block of
// 256 threads stores it in one 16-byte store a thread)
constexpr uint64_t MAX_CHUNKS = 512;
constexpr uint64_t CHUNK_BYTES = 4096;
// bytes the header and every slot are rounded to, and a piece's alignment
constexpr uint64_t ALIGN = 256;
constexpr uint64_t PIECE_ALIGN = 16;

__host__ __device__ inline uint64_t div_up(uint64_t x, uint64_t to) {
  return (x + to - 1) / to;
}

__host__ __device__ inline uint64_t round_up(uint64_t x, uint64_t to) {
  return div_up(x, to) * to;
}

__host__ __device__ inline uint64_t slot_of(uint64_t epoch) {
  return epoch & 1u;
}

__host__ __device__ inline uint64_t flag_value(uint64_t epoch) {
  return epoch + 1;
}

__host__ __device__ inline uint64_t flag_offset(int sender, uint64_t slot,
                                                uint64_t chunk) {
  return ((2 * static_cast<uint64_t>(sender) + slot) * MAX_CHUNKS + chunk) *
         8;
}

__host__ __device__ inline uint64_t epoch_offset(int world, int peer) {
  return (2 * static_cast<uint64_t>(world) * MAX_CHUNKS + peer) * 8;
}

__host__ __device__ inline uint64_t count_offset(int world, int peer) {
  return epoch_offset(world, world + peer);
}

// a line's bytes, and where line(sender, slot) lies: after the counts
constexpr uint64_t LINE_BYTES = 16;

__host__ __device__ inline uint64_t line_offset(int world, int sender,
                                                uint64_t slot) {
  return count_offset(world, world) +
         (2 * static_cast<uint64_t>(sender) + slot) * LINE_BYTES;
}

// the tag both halves of message e's line carry
__host__ __device__ inline uint32_t line_tag(uint64_t epoch) {
  return static_cast<uint32_t>(epoch + 1);
}

__host__ __device__ inline uint64_t header_bytes(int world) {
  return round_up(line_offset(world, world, 0), ALIGN);
}

__host__ __device__ inline uint64_t slot_offset(int world, int sender,
                                                uint64_t slot,
                                                uint64_t capacity) {
  return header_bytes(world) +
         (2 * static_cast<uint64_t>(sender) + slot) * capacity;
}

__host__ __device__ inline uint64_t mailbox_bytes(int world,
                                                  uint64_t capacity) {
  return slot_offset(world, world, 0, capacity);
}

// where the piece after one of `bytes` at `offset` starts in a message
__host__ __device__ inline uint64_t next_piece(uint64_t offset,
                                               uint64_t bytes) {
  return round_up(offset + bytes, PIECE_ALIGN);
}

// the bytes of a chunk in a mailbox of slots of `capacity` bytes
__host__ __device__ inline uint64_t chunk_bytes(uint64_t capacity) {
  const uint64_t least = round_up(div_up(capacity, MAX_CHUNKS), PIECE_ALIGN);
  return least > CHUNK_BYTES ? least : CHUNK_BYTES;
}

// the chunks of a message of `bytes` (one at least: an empty message still
// raises its flag)
__host__ __device__ inline uint64_t chunk_count(uint64_t bytes,
                                                uint64_t chunk) {
  return bytes == 0 ? 1 : div_up(bytes, chunk);
}

// The part of the piece at [off, off + bytes) of a message that falls in
// its bytes [c0, c1): true and [*lo, *hi) counted from the piece's start,
// or false for none.
__host__ __device__ inline bool span(uint64_t c0, uint64_t c1, uint64_t off,
                                     uint64_t bytes, uint64_t* lo,
                                     uint64_t* hi) {
  const uint64_t a = c0 > off ? c0 : off;
  const uint64_t b = c1 < off + bytes ? c1 : off + bytes;
  if (a >= b) return false;
  *lo = a - off;
  *hi = b - off;
  return true;
}

// the widest access, 16, 8 or 4 bytes, that divides every bit of `mask`
// (addresses, row lengths and pitches or'ed together)
__host__ __device__ inline uint64_t word_bytes(uint64_t mask) {
  return (mask & 15) == 0 ? 16 : (mask & 7) == 0 ? 8 : 4;
}

// the blocks of an exchange launch of `chunks` chunks on a card of `sms`
// multiprocessors: a block a chunk, at most one a multiprocessor, so that
// every block of the launch is resident at once (a block spins on the
// peer's blocks)
__host__ __device__ inline uint64_t exchange_grid(uint64_t chunks,
                                                  uint64_t sms) {
  return chunks < sms ? chunks : sms;
}

// One piece of a message: `rows` rows of `row_bytes` (a multiple of 4),
// read from `src` at a pitch of `src_pitch` bytes (a column edge is
// strided) and received into `dst`, contiguous.
struct Piece {
  uint64_t src, dst, rows, row_bytes, src_pitch;
};

// The message of one peer: its rank, its mailbox as this rank maps it,
// and the pieces, sent from `src` and received into `dst` in this order.
struct PeerMsg {
  uint64_t peer, remote, npieces;
  Piece pieces[MAX_PIECES];
};

// the bytes a message takes in a slot
__host__ __device__ inline uint64_t message_bytes(const PeerMsg& m) {
  uint64_t off = 0;
  for (uint64_t p = 0; p < m.npieces; ++p)
    off = next_piece(off, m.pieces[p].rows * m.pieces[p].row_bytes);
  return off;
}

// One exchange: this rank's mailbox and error record (host-mapped), the
// spin's budget in clock64 cycles, and the messages of its peers.  All
// words are 64-bit, so the host packs it as an array of uint64.
struct ExchangeArgs {
  uint64_t local, error, budget, rank, world, capacity, npeers;
  PeerMsg msgs[MAX_PEERS];
};

// One gather: `bytes` of `src` from every rank into dst + rank * bytes,
// in rank order; remote[r] is rank r's mailbox as this rank maps it.
struct GatherArgs {
  uint64_t local, error, budget, rank, world, capacity, src, dst, bytes;
  uint64_t remote[MAX_WORLD];
};

// One reduce of a value of `bytes` (4 or 8: float32 or float64) at `src`
// over every rank into the 0-d `dst`: op 0 the sum in rank order, op 1 the
// max (a NaN propagated).
struct ReduceArgs {
  uint64_t local, error, budget, rank, world, src, dst, bytes, op;
  uint64_t remote[MAX_WORLD];
};

// the words of a message's field, as the host packs ExchangeArgs
__host__ __device__ inline int exchange_word(int msg, int piece, int field) {
  const int head = 7, per_msg = 3 + 5 * MAX_PIECES;
  return head + msg * per_msg + (piece < 0 ? field : 3 + 5 * piece + field);
}

// what the error record holds after a spin ran past its budget
constexpr int ERROR_WORDS = 6;  // timed out, kind (0 exchange, 1 gather,
                                // 2 reduce), rank, peer, epoch, chunk

}  // namespace peer
}  // namespace mg
