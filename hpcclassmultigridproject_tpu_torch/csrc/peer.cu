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
// mg_peer_exchange does what start_exchange and Exchange.wait do: for each
// peer of the call, one block stores the peer's pieces (the first or last
// k lines of each block, a column edge strided) into the peer's mailbox,
// makes them visible (__threadfence_system), raises the flag with a release
// store at system scope, then spins on its own flag for the peer's message
// with acquire loads and copies the received lines out.  mg_peer_gather
// does what all_gather_blocks does: one block a rank, storing this rank's
// block into slot `rank` of that rank's mailbox and copying that rank's
// block out of this one's (its own block copied locally).  The slots,
// flags and epochs are peer.cuh's; a rank of no neighbour on a side gets
// the zeros the wrapper allocated.
//
// Bound: the bytes a rank sends over NVLink, 450 GB/s a direction on the
// H100 SXM: a deep halo of main's rows layout at n=1024 is tens of KB, a
// norm 8 bytes, so each call is bound by the latency of a flag's round trip
// and the launch, not by the link.  One block of 256 threads a peer, four
// bytes a thread a step: enough for this slice (P8 in ROADMAP.md times it
// against NCCL).
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

// `rows` rows of `row_bytes` from src (pitch src_pitch) to dst, packed at
// dst_pitch, four bytes a thread a step; loads bypass L1 (`cg`), since a
// mailbox's slots are written by other cards
__device__ void copy_rows(char* dst, uint64_t dst_pitch, const char* src,
                          uint64_t src_pitch, uint64_t rows,
                          uint64_t row_bytes) {
  const uint64_t words = row_bytes / 4, total = rows * words;
  for (uint64_t i = threadIdx.x; i < total; i += blockDim.x) {
    const uint64_t r = i / words, w = i - r * words;
    const uint32_t v = __ldcg(
        reinterpret_cast<const uint32_t*>(src + r * src_pitch) + w);
    reinterpret_cast<uint32_t*>(dst + r * dst_pitch)[w] = v;
  }
}

// thread 0: wait until *flag holds `want`, or write the error record and
// trap once `budget` cycles have passed
__device__ void wait_flag(const uint64_t* flag, uint64_t want,
                          uint64_t budget, volatile uint64_t* error,
                          uint64_t kind, uint64_t rank, uint64_t peer,
                          uint64_t epoch) {
  const long long start = clock64();
  while (load_acquire(flag) != want) {
    if (static_cast<uint64_t>(clock64() - start) > budget) {
      error[1] = kind;
      error[2] = rank;
      error[3] = peer;
      error[4] = epoch;
      error[0] = 1;
      __threadfence_system();
      __trap();
    }
  }
}

// one message: send this rank's pieces to `remote`'s slot, flag it, wait
// for the peer's message in `local` and copy its pieces out
__device__ void trade(char* local, char* remote, int world, int rank,
                      int peer, uint64_t capacity, const Piece* pieces,
                      int npieces, uint64_t budget,
                      volatile uint64_t* error, uint64_t kind) {
  using namespace mg::peer;
  __shared__ uint64_t epoch_s;
  uint64_t* epoch = reinterpret_cast<uint64_t*>(local +
                                                epoch_offset(world, peer));
  if (threadIdx.x == 0) epoch_s = *epoch;
  __syncthreads();
  const uint64_t e = epoch_s, slot = slot_of(e);
  char* out = remote + slot_offset(world, rank, slot, capacity);
  uint64_t off = 0;
  for (int p = 0; p < npieces; ++p) {
    const Piece& pc = pieces[p];
    copy_rows(out + off, pc.row_bytes, reinterpret_cast<const char*>(pc.src),
              pc.src_pitch, pc.rows, pc.row_bytes);
    off = next_piece(off, pc.rows * pc.row_bytes);
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    char* flag_out = remote + flag_offset(rank, slot);
    const char* flag_in = local + flag_offset(peer, slot);
    store_release(reinterpret_cast<uint64_t*>(flag_out), flag_value(e));
    wait_flag(reinterpret_cast<const uint64_t*>(flag_in), flag_value(e),
              budget, error, kind, rank, peer, e);
  }
  __syncthreads();
  const char* in = local + slot_offset(world, peer, slot, capacity);
  off = 0;
  for (int p = 0; p < npieces; ++p) {
    const Piece& pc = pieces[p];
    copy_rows(reinterpret_cast<char*>(pc.dst), pc.row_bytes, in + off,
              pc.row_bytes, pc.rows, pc.row_bytes);
    off = next_piece(off, pc.rows * pc.row_bytes);
  }
  if (threadIdx.x == 0) *epoch = e + 1;
}

__global__ void __launch_bounds__(THREADS)
    exchange_kernel(const __grid_constant__ ExchangeArgs a) {
  const auto& m = a.msgs[blockIdx.x];
  trade(reinterpret_cast<char*>(a.local), reinterpret_cast<char*>(m.remote),
        static_cast<int>(a.world), static_cast<int>(a.rank),
        static_cast<int>(m.peer), a.capacity, m.pieces,
        static_cast<int>(m.npieces), a.budget,
        reinterpret_cast<volatile uint64_t*>(a.error), 0);
}

__global__ void __launch_bounds__(THREADS)
    gather_kernel(const __grid_constant__ GatherArgs a) {
  const int r = blockIdx.x, rank = static_cast<int>(a.rank);
  char* dst = reinterpret_cast<char*>(a.dst) + r * a.bytes;
  const char* src = reinterpret_cast<const char*>(a.src);
  if (r == rank) {  // this rank's own block
    copy_rows(dst, a.bytes, src, a.bytes, 1, a.bytes);
    return;
  }
  const Piece piece = {a.src, reinterpret_cast<uint64_t>(dst), 1, a.bytes,
                       a.bytes};
  trade(reinterpret_cast<char*>(a.local), reinterpret_cast<char*>(a.remote[r]),
        static_cast<int>(a.world), rank, r, a.capacity, &piece, 1, a.budget,
        reinterpret_cast<volatile uint64_t*>(a.error), 1);
}

}  // namespace

extern "C" int mg_peer_exchange(const void* args, void* stream) {
  ExchangeArgs a;
  std::memcpy(&a, args, sizeof(a));
  if (a.npeers == 0) return 0;
  exchange_kernel<<<static_cast<unsigned>(a.npeers), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_peer_gather(const void* args, void* stream) {
  GatherArgs a;
  std::memcpy(&a, args, sizeof(a));
  gather_kernel<<<static_cast<unsigned>(a.world), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A zeroed mailbox for `world` ranks of `capacity` bytes a slot, and a
// host-mapped error record (its host and device addresses); the cycles a
// second of this card's SM clock at its maximum go to `cycles_per_s`.
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
