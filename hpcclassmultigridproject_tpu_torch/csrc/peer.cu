// The peer transport: the halo exchange and the gather of a partitioned run
// as kernels that store into the other ranks' cards over NVLink, for the
// collectives inside a captured WHILE body (parallel/distributed.py).  No
// Pallas kernel corresponds to them: they replace the `ppermute` and `psum`
// that XLA places inside the jitted loop of the JAX package's adaptive
// distributed run (hpcclassmultigridproject_tpu/parallel/halo.py:31 and
// :210, `mg/cycle.py:457`), which the TPU carries out as remote copies.  An
// NCCL call captured in a WHILE body did not finish on four H100s, so the
// port stores into the neighbour's memory itself.
//
// mg_peer_exchange does what start_exchange and Exchange.wait do.  Each
// peer's message (the first or last k lines of each block, a column edge
// strided) is cut into chunks (peer.cuh), and the launch has a block a
// chunk of all its messages, at most one a multiprocessor; a block with
// more than one chunk loops.  A block first sends each of its chunks:
// stores the chunk's bytes into the peer's slot, makes them visible (a
// barrier, then one __threadfence_system by thread 0, cumulative over the
// block's stores) and raises that chunk's flag with a release store at
// system scope.  Then, for each of its chunks, it waits with acquire
// loads for the same chunk of the peer's message and copies it out.  So
// the copy-out is spread over the blocks and starts chunk by chunk, not
// behind one wait.  A block never waits before it has sent all it sends,
// so no wait depends on a send behind another wait, whichever blocks of
// the two ranks hold which chunks.
//
// Accesses are 16 bytes a thread (uint4 stores to the peer, `__ldcg` uint4
// loads from the mailbox) where a piece's addresses and rows allow it, else
// 8 or 4 (peer.cuh::word_bytes); words are indexed from the piece's start,
// a strided piece by row and word (a 32-bit divide only where a row holds
// more than one word; a column edge of one value a row has none).
//
// Co-residency.  A block spins on a block of the peer, so every block of
// both launches must be resident at once: the grid is at most one block a
// multiprocessor (peer.cuh::exchange_grid), 256 threads with no shared
// memory to speak of, so a card holds it beside another rank's launch (two
// ranks on one card, chip_smoke.py's check) and beside any kernel of its
// own stream's past, which has ended before it starts.
//
// The epoch.  Every block reads the pair's epoch (its chunks' slot and
// flag value) when it starts, before it counts anything.  After its
// copy-outs, a block adds the chunks it received from a peer to that
// peer's count in this rank's header (atomicAdd, after a fence); the block
// whose addition brings the count to the message's chunk count is the last
// of that peer's, resets the count and advances the epoch (after a fence).
// No race: every chunk of the message has been received and counted by
// then, so every block that reads the epoch for that message has read it
// (its read precedes its own count, and the fences order the read before
// the last block's store); the new epoch and count are read by the next
// launch only, which starts after this one ends.  mg_peer_gather keeps one
// block a rank, which reads and advances its own pair's epoch itself.
//
// mg_peer_gather does what all_gather_blocks does: one block a rank,
// storing this rank's block into slot `rank` of that rank's mailbox and
// copying that rank's block out of this one's (its own block copied
// locally), chunk by chunk with the same flags.  The slots, flags and
// epochs are peer.cuh's; a rank of no neighbour on a side gets the zeros
// the wrapper allocated.  Inside a body it carries the blocks a partitioned
// level gathers into the first replicated one.
//
// mg_peer_reduce does what all_sum (and all_max) do with one float32 or
// float64 value: the psum of a WHILE body, the residual norm the loop's
// test reads.  The chunk protocol above spends, on one 8-byte value, the
// stores, a barrier, a system-scope fence, a separate flag store over
// NVLink, the spin and the copy-out, and all_sum then adds the parts in
// world - 1 torch launches.  The reduce is one warp: lane p serves peer p.
// It stores this rank's value as a flagged line (peer.cuh: NCCL's LL
// protocol) into line slot e & 1 of peer p's mailbox with one 16-byte
// volatile store, with no fence, then spins with 16-byte volatile loads on
// peer p's line in its own mailbox until both halves carry message e's
// tag, and advances the pair's epoch.  Lane 0 then gathers the values with
// warp shuffles and adds them in rank order, ((x0 + x1) + x2) + x3, as
// all_sum's loop does (the max: a NaN propagated, as torch.stack(...).max()
// does), so every rank has the same bits, and writes the 0-d result.
//
// Bound: the bytes a rank sends to a neighbour over NVLink, 450 GB/s a
// direction on the H100 SXM: main's level-0 deep halo at n=1024 by rows,
// (u, rhs) of 8 rows of 1152 float64, is 147,456 B, 0.33 µs.  Above it
// lies the protocol's latency: the launch, the fence of the remote stores,
// one flag's trip over NVLink, the copy-out.  The gather of one 8-byte
// value, which has no payload to speak of, took 7.8-8.3 µs a call in a
// graph on four H100 SXM (700 W): the floor an exchange of any size
// approaches.  That deep halo takes 16.2-16.5 µs there (NCCL's captured
// call 31-32 µs); one fence a thread in place of one a block cost ~2 µs
// more on both.  The reduce's floor is a graph node and one line's trip
// over NVLink.
//
// A spin has a budget of clock64 cycles.  Past it the block writes which
// wait ran out into a host-mapped error record, then __trap()s: the hang
// becomes an error at the next synchronise.  There is no fallback.
//
// The host entry points set the transport up: a mailbox outside torch's
// allocator and any graph pool (mg_peer_alloc), its IPC handle
// (mg_peer_handle), a peer's mailbox mapped into this process
// (mg_peer_open, after cudaDeviceCanAccessPeer) and its release
// (mg_peer_close).

#include <cuda_runtime.h>

#include <cstring>

#include "peer.cuh"

namespace {

using mg::peer::ExchangeArgs;
using mg::peer::GatherArgs;
using mg::peer::PeerMsg;
using mg::peer::Piece;

constexpr int THREADS = 256;
// cudaDeviceCanAccessPeer said no: the host names the two cards
constexpr int NO_PEER_ACCESS =
    static_cast<int>(cudaErrorPeerAccessUnsupported);

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

template <int W>
struct Word;
template <>
struct Word<16> {
  using T = uint4;
};
template <>
struct Word<8> {
  using T = uint2;
};
template <>
struct Word<4> {
  using T = unsigned int;
};

// Words [first, last) of W bytes of a piece: word i is read from src (flat
// when wpr is 0, else row i / wpr at `pitch` bytes, its word i % wpr) and
// stored at dst + i * W.  Loads bypass L1 (`cg`): a mailbox's slots are
// written by other cards.
template <int W>
__device__ __forceinline__ void copy_words(char* dst, const char* src,
                                           uint64_t pitch, uint32_t wpr,
                                           uint64_t first, uint64_t last) {
  using T = typename Word<W>::T;
  for (uint64_t i = first + threadIdx.x; i < last; i += THREADS) {
    const char* from = src + i * W;
    if (wpr == 1) {
      from = src + i * pitch;
    } else if (wpr > 1) {
      const uint32_t r = static_cast<uint32_t>(i) / wpr;
      from = src + r * pitch + (static_cast<uint32_t>(i) - r * wpr) * W;
    }
    reinterpret_cast<T*>(dst)[i] = __ldcg(reinterpret_cast<const T*>(from));
  }
}

// Bytes [lo, hi) of a piece of `rows` rows of `row_bytes` at a pitch of
// `pitch` bytes from src, stored flat at dst + lo, in the widest words the
// addresses, the rows and the pitch allow (lo and hi are multiples of 16 or
// the piece's end, so of that width too).
__device__ void copy_span(char* dst, const char* src, uint64_t rows,
                          uint64_t row_bytes, uint64_t pitch, uint64_t lo,
                          uint64_t hi) {
  const bool flat = rows == 1 || pitch == row_bytes;
  const uint64_t w = mg::peer::word_bytes(
      reinterpret_cast<uint64_t>(dst) | reinterpret_cast<uint64_t>(src) |
      (flat ? rows * row_bytes : row_bytes | pitch));
  const uint32_t wpr = flat ? 0 : static_cast<uint32_t>(row_bytes / w);
  if (w == 16) {
    copy_words<16>(dst, src, pitch, wpr, lo / 16, hi / 16);
  } else if (w == 8) {
    copy_words<8>(dst, src, pitch, wpr, lo / 8, hi / 8);
  } else {
    copy_words<4>(dst, src, pitch, wpr, lo / 4, hi / 4);
  }
}

// thread 0: wait until *flag holds `want`, or write the error record and
// trap once `budget` cycles have passed
__device__ void wait_flag(const uint64_t* flag, uint64_t want,
                          uint64_t budget, volatile uint64_t* error,
                          uint64_t kind, uint64_t rank, uint64_t peer,
                          uint64_t epoch, uint64_t chunk) {
  const long long start = clock64();
  while (load_acquire(flag) != want) {
    if (static_cast<uint64_t>(clock64() - start) > budget) {
      error[1] = kind;
      error[2] = rank;
      error[3] = peer;
      error[4] = epoch;
      error[5] = chunk;
      error[0] = 1;
      __threadfence_system();
      __trap();
    }
  }
}

// One side of a pair at epoch e: this rank's and the peer's mailboxes, the
// slot, and the messages' pieces (the same shapes both ways).
struct Pair {
  char* local;
  char* remote;
  int world, rank, peer;
  uint64_t capacity, e;
  const Piece* pieces;
  int npieces;
};

// Chunk c, bytes [c0, c1) of the message: the pieces' bytes stored into the
// peer's slot, made visible, then the chunk's flag raised in the peer's
// mailbox.
__device__ void send_chunk(const Pair& p, uint64_t c, uint64_t c0,
                           uint64_t c1) {
  using namespace mg::peer;
  const uint64_t slot = slot_of(p.e);
  char* out = p.remote + slot_offset(p.world, p.rank, slot, p.capacity);
  uint64_t off = 0, lo, hi;
  for (int k = 0; k < p.npieces; ++k) {
    const Piece& pc = p.pieces[k];
    const uint64_t bytes = pc.rows * pc.row_bytes;
    if (span(c0, c1, off, bytes, &lo, &hi)) {
      copy_span(out + off, reinterpret_cast<const char*>(pc.src), pc.rows,
                pc.row_bytes, pc.src_pitch, lo, hi);
    }
    off = next_piece(off, bytes);
  }
  // the block's stores precede thread 0's fence (the barrier), and the
  // fence is cumulative: one system-scope fence a chunk, not one a thread
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    store_release(reinterpret_cast<uint64_t*>(
                      p.remote + flag_offset(p.rank, slot, c)),
                  flag_value(p.e));
  }
}

// Chunk c of the peer's message: wait for its flag, then copy its bytes of
// each piece out into the piece's dst.
__device__ void receive_chunk(const Pair& p, uint64_t c, uint64_t c0,
                              uint64_t c1, uint64_t budget,
                              volatile uint64_t* error, uint64_t kind) {
  using namespace mg::peer;
  const uint64_t slot = slot_of(p.e);
  if (threadIdx.x == 0) {
    wait_flag(reinterpret_cast<const uint64_t*>(
                  p.local + flag_offset(p.peer, slot, c)),
              flag_value(p.e), budget, error, kind, p.rank, p.peer, p.e, c);
  }
  __syncthreads();
  const char* in = p.local + slot_offset(p.world, p.peer, slot, p.capacity);
  uint64_t off = 0, lo, hi;
  for (int k = 0; k < p.npieces; ++k) {
    const Piece& pc = p.pieces[k];
    const uint64_t bytes = pc.rows * pc.row_bytes;
    if (span(c0, c1, off, bytes, &lo, &hi)) {
      copy_span(reinterpret_cast<char*>(pc.dst), in + off, 1, bytes, bytes,
                lo, hi);
    }
    off = next_piece(off, bytes);
  }
}

__device__ __forceinline__ uint64_t lesser(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t read_epoch(const char* local, int world,
                                               int peer) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(
      local + mg::peer::epoch_offset(world, peer)));
}

__global__ void __launch_bounds__(THREADS)
    exchange_kernel(const __grid_constant__ ExchangeArgs a) {
  using namespace mg::peer;
  __shared__ uint64_t epoch_s[MAX_PEERS];
  char* local = reinterpret_cast<char*>(a.local);
  const int world = static_cast<int>(a.world);
  const int npeers = static_cast<int>(a.npeers);
  const uint64_t chunk = chunk_bytes(a.capacity);
  // message m's chunks are [first[m], first[m + 1]) of the launch's list
  uint64_t first[MAX_PEERS + 1], bytes[MAX_PEERS];
  first[0] = 0;
  for (int m = 0; m < npeers; ++m) {
    bytes[m] = message_bytes(a.msgs[m]);
    first[m + 1] = first[m] + chunk_count(bytes[m], chunk);
  }
  if (threadIdx.x < npeers) {
    epoch_s[threadIdx.x] =
        read_epoch(local, world, static_cast<int>(a.msgs[threadIdx.x].peer));
  }
  __syncthreads();
  auto pair = [&](int m) {
    const PeerMsg& msg = a.msgs[m];
    return Pair{local, reinterpret_cast<char*>(msg.remote), world,
                static_cast<int>(a.rank), static_cast<int>(msg.peer),
                a.capacity, epoch_s[m], msg.pieces,
                static_cast<int>(msg.npieces)};
  };
  const uint64_t total = first[npeers];
  for (uint64_t j = blockIdx.x; j < total; j += gridDim.x) {
    int m = 0;
    while (j >= first[m + 1]) ++m;
    const uint64_t c = j - first[m], c0 = c * chunk;
    send_chunk(pair(m), c, c0, lesser(c0 + chunk, bytes[m]));
  }
  uint64_t done[MAX_PEERS] = {};
  for (uint64_t j = blockIdx.x; j < total; j += gridDim.x) {
    int m = 0;
    while (j >= first[m + 1]) ++m;
    const uint64_t c = j - first[m], c0 = c * chunk;
    receive_chunk(pair(m), c, c0, lesser(c0 + chunk, bytes[m]), a.budget,
                  reinterpret_cast<volatile uint64_t*>(a.error), 0);
    ++done[m];
  }
  if (threadIdx.x != 0) return;
  for (int m = 0; m < npeers; ++m) {
    if (done[m] == 0) continue;
    const int peer = static_cast<int>(a.msgs[m].peer);
    auto* count = reinterpret_cast<unsigned long long*>(
        local + count_offset(world, peer));
    __threadfence();
    const unsigned long long n = done[m];
    if (atomicAdd(count, n) + n == first[m + 1] - first[m]) {
      __threadfence();
      *count = 0;
      *reinterpret_cast<uint64_t*>(local + epoch_offset(world, peer)) =
          epoch_s[m] + 1;
    }
  }
}

// One line: a 16-byte volatile store into a peer's mailbox, and a 16-byte
// volatile load of this rank's own (written by a peer over NVLink).
__device__ __forceinline__ void store_line(char* p, uint32_t lo,
                                           uint32_t tag, uint32_t hi) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(lo), "r"(tag), "r"(hi), "r"(tag)
               : "memory");
}

__device__ __forceinline__ uint4 load_line(const char* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void words_of(float x, uint32_t* lo,
                                         uint32_t* hi) {
  *lo = __float_as_uint(x);
  *hi = 0;
}

__device__ __forceinline__ void words_of(double x, uint32_t* lo,
                                         uint32_t* hi) {
  *lo = static_cast<uint32_t>(__double2loint(x));
  *hi = static_cast<uint32_t>(__double2hiint(x));
}

template <typename T>
__device__ __forceinline__ T value_of(uint32_t lo, uint32_t hi);

template <>
__device__ __forceinline__ float value_of<float>(uint32_t lo, uint32_t) {
  return __uint_as_float(lo);
}

template <>
__device__ __forceinline__ double value_of<double>(uint32_t lo,
                                                   uint32_t hi) {
  return __hiloint2double(static_cast<int>(hi), static_cast<int>(lo));
}

constexpr int REDUCE_THREADS = 32;

// One warp; lane p < world serves peer p (design: the head comment).
template <typename T, bool MAX>
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_kernel(const __grid_constant__ mg::peer::ReduceArgs a) {
  using namespace mg::peer;
  const int p = static_cast<int>(threadIdx.x);
  const int rank = static_cast<int>(a.rank), world = static_cast<int>(a.world);
  char* local = reinterpret_cast<char*>(a.local);
  T v = T(0);
  if (p < world) {
    const T x = *reinterpret_cast<const T*>(a.src);
    if (p == rank) {
      v = x;
    } else {
      const uint64_t e = read_epoch(local, world, p);
      const uint32_t tag = line_tag(e);
      uint32_t lo, hi;
      words_of(x, &lo, &hi);
      store_line(reinterpret_cast<char*>(a.remote[p]) +
                     line_offset(world, rank, slot_of(e)),
                 lo, tag, hi);
      const char* in = local + line_offset(world, p, slot_of(e));
      const long long start = clock64();
      uint4 got = load_line(in);
      while (got.y != tag || got.w != tag) {
        if (static_cast<uint64_t>(clock64() - start) > a.budget) {
          volatile uint64_t* error =
              reinterpret_cast<volatile uint64_t*>(a.error);
          error[1] = 2;
          error[2] = a.rank;
          error[3] = p;
          error[4] = e;
          error[5] = 0;
          error[0] = 1;
          __threadfence_system();
          __trap();
        }
        got = load_line(in);
      }
      v = value_of<T>(got.x, got.z);
      *reinterpret_cast<uint64_t*>(local + epoch_offset(world, p)) = e + 1;
    }
  }
  // rank order, every lane taking part in each shuffle
  T acc = __shfl_sync(0xffffffffu, v, 0);
  for (int q = 1; q < world; ++q) {
    const T y = __shfl_sync(0xffffffffu, v, q);
    if constexpr (MAX) {
      acc = (acc != acc || acc > y) ? acc : y;
    } else {
      acc = acc + y;
    }
  }
  if (p == 0) *reinterpret_cast<T*>(a.dst) = acc;
}

__global__ void __launch_bounds__(THREADS)
    gather_kernel(const __grid_constant__ GatherArgs a) {
  using namespace mg::peer;
  __shared__ uint64_t epoch_s;
  const int r = blockIdx.x, rank = static_cast<int>(a.rank);
  const int world = static_cast<int>(a.world);
  char* dst = reinterpret_cast<char*>(a.dst) + r * a.bytes;
  const char* src = reinterpret_cast<const char*>(a.src);
  if (r == rank) {  // this rank's own block
    copy_span(dst, src, 1, a.bytes, a.bytes, 0, a.bytes);
    return;
  }
  char* local = reinterpret_cast<char*>(a.local);
  if (threadIdx.x == 0) epoch_s = read_epoch(local, world, r);
  __syncthreads();
  const Piece piece = {a.src, reinterpret_cast<uint64_t>(dst), 1, a.bytes,
                       a.bytes};
  const Pair p{local, reinterpret_cast<char*>(a.remote[r]), world, rank, r,
               a.capacity, epoch_s, &piece, 1};
  const uint64_t chunk = chunk_bytes(a.capacity);
  const uint64_t total = next_piece(0, a.bytes);
  const uint64_t n = chunk_count(total, chunk);
  for (uint64_t c = 0; c < n; ++c) {
    send_chunk(p, c, c * chunk, lesser((c + 1) * chunk, total));
  }
  for (uint64_t c = 0; c < n; ++c) {
    receive_chunk(p, c, c * chunk, lesser((c + 1) * chunk, total), a.budget,
                  reinterpret_cast<volatile uint64_t*>(a.error), 1);
  }
  if (threadIdx.x == 0) {
    *reinterpret_cast<uint64_t*>(local + epoch_offset(world, r)) =
        epoch_s + 1;
  }
}

// this card's multiprocessors, read once a card
cudaError_t multiprocessors(int* sms) {
  static int known[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && known[device] > 0) {
    *sms = known[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < 64) known[device] = *sms;
  return err;
}

}  // namespace

extern "C" int mg_peer_exchange(const void* args, void* stream) {
  using namespace mg::peer;
  ExchangeArgs a;
  std::memcpy(&a, args, sizeof(a));
  if (a.npeers == 0) return 0;
  const uint64_t chunk = chunk_bytes(a.capacity);
  uint64_t chunks = 0;
  for (uint64_t m = 0; m < a.npeers; ++m) {
    chunks += chunk_count(message_bytes(a.msgs[m]), chunk);
  }
  int sms = 0;
  const cudaError_t err = multiprocessors(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  exchange_kernel<<<static_cast<unsigned>(exchange_grid(chunks, sms)),
                    THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_peer_gather(const void* args, void* stream) {
  GatherArgs a;
  std::memcpy(&a, args, sizeof(a));
  gather_kernel<<<static_cast<unsigned>(a.world), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_peer_reduce(const void* args, void* stream) {
  mg::peer::ReduceArgs a;
  std::memcpy(&a, args, sizeof(a));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.bytes == 8) {
    if (a.op == 1) {
      reduce_kernel<double, true><<<1, REDUCE_THREADS, 0, st>>>(a);
    } else {
      reduce_kernel<double, false><<<1, REDUCE_THREADS, 0, st>>>(a);
    }
  } else if (a.op == 1) {
    reduce_kernel<float, true><<<1, REDUCE_THREADS, 0, st>>>(a);
  } else {
    reduce_kernel<float, false><<<1, REDUCE_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_peer_alloc(int world, unsigned long long capacity,
                             void** mailbox, void** error_host,
                             void** error_device, double* cycles_per_s) {
  const size_t bytes = mg::peer::mailbox_bytes(world, capacity);
  cudaError_t err = cudaMalloc(mailbox, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*mailbox, 0, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaHostAlloc(error_host, mg::peer::ERROR_WORDS * sizeof(uint64_t),
                      cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::memset(*error_host, 0, mg::peer::ERROR_WORDS * sizeof(uint64_t));
  err = cudaHostGetDevicePointer(error_device, *error_host, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, khz = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cycles_per_s = 1e3 * khz;
  return static_cast<int>(cudaDeviceSynchronize());
}

// The IPC handle of a mailbox: 64 bytes into `handle`.
extern "C" int mg_peer_handle(void* mailbox, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, mailbox);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

// Map the mailbox of `handle`, made on card `peer_device`, into this
// process on card `device`; a pair of cards without peer access fails with
// cudaErrorPeerAccessUnsupported before anything is opened.
extern "C" int mg_peer_open(const void* handle, int device, int peer_device,
                            void** ptr) {
  if (device != peer_device) {
    int can = 0;
    const cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer_device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!can) return NO_PEER_ACCESS;
  }
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

// Release a mailbox: a peer's mapping (`opened`), or this rank's own with
// its error record.
extern "C" int mg_peer_close(void* ptr, void* error_host, int opened) {
  if (opened) return static_cast<int>(cudaIpcCloseMemHandle(ptr));
  cudaError_t err = cudaFree(ptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFreeHost(error_host));
}
