// The mailbox of the peer transport (csrc/peer.cu): where a rank's card
// keeps the messages the other ranks store into it over NVLink, and the
// arithmetic of slots, flags, epochs and message pieces.  The functions are
// __host__ __device__, so that the kernels, their host entry points and a
// host build of this header (tests/test_torch_peer.py) share one formula,
// and the plain version in ops/cuda/peer.py repeats it name by name.
//
// A mailbox, one cudaMalloc a rank, bytes from its start:
//
//   flag(sender, slot)   8 bytes each, world x 2: the last message of
//                        `sender` in `slot`, as e + 1 (0: none yet); the
//                        sender stores it, with st.release.sys, into the
//                        receiver's mailbox
//   epoch(peer)          8 bytes each, world: the messages this rank has
//                        exchanged with `peer` so far; only this rank's
//                        kernels read and advance it
//   slot(sender, slot)   `capacity` bytes each, world x 2, from
//                        header_bytes(world) on: message e of `sender`
//                        lies in slot e & 1
//
// Each ordered pair of ranks meets once a call in each direction (a halo
// exchange with a neighbour is symmetric, a gather reaches every rank), so
// the two ranks of a pair advance their epochs of each other in the same
// post order: the same contract as NCCL's pairing in start_exchange.
//
// Why two slots suffice.  A kernel stores its outgoing message, then waits
// for the incoming one, then copies it out; a rank's kernels run in order.
// When rank A stores message e into B's slot e & 1, A has received B's
// message e - 1.  B stored that message in its call e - 1, which began
// after its call e - 2 had copied out A's message e - 2: the last message
// that slot held.  So no slot is overwritten before it is read, and
// nothing is reset between calls, WHILE trips or replays.

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
// bytes the header and every slot are rounded to, and a piece's alignment
constexpr uint64_t ALIGN = 256;
constexpr uint64_t PIECE_ALIGN = 16;

__host__ __device__ inline uint64_t round_up(uint64_t x, uint64_t to) {
  return (x + to - 1) / to * to;
}

__host__ __device__ inline uint64_t slot_of(uint64_t epoch) {
  return epoch & 1u;
}

__host__ __device__ inline uint64_t flag_value(uint64_t epoch) {
  return epoch + 1;
}

__host__ __device__ inline uint64_t flag_offset(int sender, uint64_t slot) {
  return (2 * static_cast<uint64_t>(sender) + slot) * 8;
}

__host__ __device__ inline uint64_t epoch_offset(int world, int peer) {
  return (2 * static_cast<uint64_t>(world) + peer) * 8;
}

__host__ __device__ inline uint64_t header_bytes(int world) {
  return round_up(3 * static_cast<uint64_t>(world) * 8, ALIGN);
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

// the words of a message's field, as the host packs ExchangeArgs
__host__ __device__ inline int exchange_word(int msg, int piece, int field) {
  const int head = 7, per_msg = 3 + 5 * MAX_PIECES;
  return head + msg * per_msg + (piece < 0 ? field : 3 + 5 * piece + field);
}

// what the error record holds after a spin ran past its budget
constexpr int ERROR_WORDS = 5;  // timed out, kind (0 exchange, 1 gather),
                                // rank, peer, epoch

}  // namespace peer
}  // namespace mg
