// K3 and K4: the coarse tower of the V-cycle, one cooperative launch each.
//
// Replaces the TPU kernels of hpcclassmultigridproject_tpu/ops/pallas/
// tower.py::tower_vcycle: the descent (_descend_kernel, launched at :326)
// and the ascent (_ascend_kernel, launched at :349), each one program over
// every level below n = 512.
//
// What bounds it on the H100: the chain of dependent level phases, not
// bytes.  The main path's levels 512 .. 64 hold 1.3 MB an array at the top
// and a few hundred KB below, a few microseconds of traffic in all, and
// each level needs the whole of the one before it.  So each half is one
// persistent kernel, launched with cudaLaunchCooperativeKernel, whose blocks
// walk the levels in order with a grid-wide barrier between level phases:
// the host issues one launch a half instead of one a level.  Each level
// runs the from_v block (common.cuh::smooth_from_v) over its tiles,
// grid-stride, with the level's transfer as a compile-time variant:
//
//   descent, for each level 512 .. 64: red-black cascade from zero, and the
//     residual at even nodes injected straight into the next coarser rhs
//     (coarse[I, J] = res[2I, 2J]); the coarse cells whose fine node lies
//     past the array are written 0 in the same phase (zero_past);
//   ascent, for each level 64 .. 512: the bilinear prolongation of the
//     coarser solution (the previous phase's output) added to the level's
//     stored descent iterate as the window is loaded, then the cascade.
//
// A level with more sweeps than the window keeps a tile for (FV_MAX_SWEEPS)
// runs as a chain of links with a barrier between them.  Each link reads the
// last link's iterate from device memory and writes the other of two
// buffers (the level's output and one scratch array), so no block
// overwrites cells that another block's halo still reads; only the first
// link prolongs and only the last injects, as ops/cuda/smoother.py::
// in_launches chains K2's launches, so the chain is exact.
//
// One block an SM, in float32 too (launch bounds): there the block keeps
// its cells in 96 registers without spilling, where two blocks an SM (64
// registers) spilled the ascent's prolongation and ran slower on the card,
// the 512 level's extra tiles included.  The grid is what the card holds
// at once (blocks per SM by the occupancy calculator, times the SMs; cached
// per device and kernel), capped at the largest phase's tile count: 132
// blocks on the H100, so at nsweeps 3 the 512 level's 11 x 14 = 154 tiles
// take two rounds on 22 of them.  Every block reaches every barrier, with a
// tile or without one.  A device without cooperative launch, or a grid it
// refuses, returns the error; there is no per-level fallback.

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <utility>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// The levels one launch takes: the tower's gate (n <= 512) leaves at most
// nine levels above a coarsest one.
constexpr int TOWER_MAX_LEVELS = 10;

// A launch's levels, fine to coarse, passed by value and read in place from
// the parameter space (__grid_constant__).  Descent: lv[l] smooths from
// zero with rhs lv[l].rhs and injects into lv[l].res_out, which is
// lv[l + 1].rhs.  Ascent: lv[l] adds the prolongation of lv[l].src (lv[l +
// 1].u_out, or the coarse solution at the last level) to lv[l].u.
template <typename T>
struct TowerArgs {
  mg::SmoothArgs<T> lv[TOWER_MAX_LEVELS];
  T* scratch;  // the second buffer of a chained level, else nullptr
  int nlev, nsweeps;
};
static_assert(sizeof(TowerArgs<double>) <= 4096,
              "a launch's parameters must fit in 4 KB");

template <typename T>
using TowerKernel = void (*)(TowerArgs<T>);

// The links of a level at nsweeps, the sweeps of link k, and the tiles of a
// rows x cols level at ns sweeps.
__host__ __device__ inline int tower_links(int nsweeps) {
  return nsweeps > mg::FV_MAX_SWEEPS ? (nsweeps - 1) / mg::FV_MAX_SWEEPS + 1
                                     : 1;
}
__host__ __device__ inline int link_sweeps(int nsweeps, int k, int links) {
  return k < links - 1 ? mg::FV_MAX_SWEEPS
                       : nsweeps - (links - 1) * mg::FV_MAX_SWEEPS;
}
__host__ __device__ inline int tiles_x(int cols, int ns) {
  return (cols + mg::fv_tile_cols(ns) - 1) / mg::fv_tile_cols(ns);
}
__host__ __device__ inline int tiles_of(int rows, int cols, int ns) {
  return tiles_x(cols, ns) *
         ((rows + mg::fv_tile_rows(ns) - 1) / mg::fv_tile_rows(ns));
}

// The buffer link k of `links` writes: the last writes the level's output
// and the links before it alternate with the scratch array.
template <typename T>
__device__ __forceinline__ T* link_target(T* out, T* scratch, int k,
                                          int links) {
  return ((links - 1 - k) & 1) ? scratch : out;
}

// One link of a level: the from_v block over its tiles, grid-stride.
template <typename T, int ACCESS, int XFER>
__device__ void run_link(const mg::SmoothArgs<T>& a,
                         const mg::FvRun<T>& run) {
  const int nx = tiles_x(a.cols, run.nsweeps);
  const int tiles = tiles_of(a.rows, a.cols, run.nsweeps);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    mg::smooth_from_v<T, ACCESS, XFER>(a, run, t / nx, t % nx);
    __syncthreads();  // the next tile reuses the window
  }
}

// The coarse cells of a descent level whose fine node (2I, 2J) lies past
// the fine array, 0: whole rows from r0 = ceil(rows / 2) on, and in the rows
// above them the columns from c0 = ceil(cols / 2) on.  The tiles inject
// every other cell, so each coarse cell is written once.
template <typename T>
__device__ void zero_past(const mg::SmoothArgs<T>& a) {
  const int r0 = min((a.rows + 1) / 2, a.res_rows);
  const int c0 = min((a.cols + 1) / 2, a.res_cols);
  const int wide = a.res_cols - c0;
  const int below = (a.res_rows - r0) * a.res_cols;
  const int total = below + r0 * wide;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += gridDim.x * blockDim.x) {
    size_t at;
    if (q < below) {
      at = static_cast<size_t>(r0) * a.res_cols + q;
    } else {
      const int e = q - below, i = e / wide;
      at = static_cast<size_t>(i) * a.res_cols + c0 + (e - i * wide);
    }
    a.res_out[at] = T(0);
  }
}

template <typename T, int ACCESS>
__global__ void __launch_bounds__(mg::FV_THREADS, 1)
    descend_kernel(const __grid_constant__ TowerArgs<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int links = tower_links(p.nsweeps);
  for (int l = 0; l < p.nlev; ++l) {
    const mg::SmoothArgs<T>& a = p.lv[l];
    const T* from = nullptr;
    for (int k = 0; k < links; ++k) {
      const bool last = k == links - 1;
      const mg::FvRun<T> run{from, link_target(a.u_out, p.scratch, k, links),
                             link_sweeps(p.nsweeps, k, links),
                             k == 0 ? mg::LOAD_ZERO : mg::LOAD_U,
                             last ? mg::RES_INJECT : mg::RES_NONE};
      run_link<T, ACCESS, mg::FV_INJECT>(a, run);
      if (last) zero_past(a);
      from = run.u_out;
      if (!last || l + 1 < p.nlev) grid.sync();
    }
  }
}

template <typename T, int ACCESS>
__global__ void __launch_bounds__(mg::FV_THREADS, 1)
    ascend_kernel(const __grid_constant__ TowerArgs<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int links = tower_links(p.nsweeps);
  for (int l = p.nlev - 1; l >= 0; --l) {
    const mg::SmoothArgs<T>& a = p.lv[l];
    const T* from = a.u;
    for (int k = 0; k < links; ++k) {
      const bool last = k == links - 1;
      const mg::FvRun<T> run{from, link_target(a.u_out, p.scratch, k, links),
                             link_sweeps(p.nsweeps, k, links),
                             k == 0 ? mg::LOAD_U_PROLONG : mg::LOAD_U,
                             mg::RES_NONE};
      run_link<T, ACCESS, mg::FV_PROLONG>(a, run);
      from = run.u_out;
      if (!last || l > 0) grid.sync();
    }
  }
}

// Blocks per SM that `kernel` runs at and the device's SM count, found once
// per device and kernel.  A device without cooperative launch is refused.
template <typename T>
cudaError_t residency(TowerKernel<T> kernel, int& blocks_per_sm, int& sms) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, std::pair<int, int>> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, int> key{reinterpret_cast<const void*>(kernel),
                                        dev};
  std::lock_guard<std::mutex> hold(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    blocks_per_sm = hit->second.first;
    sms = hit->second.second;
    return cudaSuccess;
  }
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel,
                                                      mg::FV_THREADS, 0);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  cache[key] = {blocks_per_sm, sms};
  return cudaSuccess;
}

// Launch `paired` where every array the block moves in pairs starts aligned
// to a pair (and every row has an even length), else `singles`, on a grid
// of min(blocks per SM x SMs, the largest phase's tiles).  `info`, unless
// null, receives (blocks per SM, SMs, grid).  Returns the launch error.
template <typename T>
cudaError_t launch_tower(TowerKernel<T> paired, TowerKernel<T> singles,
                         const TowerArgs<T>& p, int* info,
                         cudaStream_t stream) {
  const int links = tower_links(p.nsweeps);
  if (links > 1 && p.scratch == nullptr) return cudaErrorInvalidValue;
  const auto pair_aligned = [](const T* x) {
    return reinterpret_cast<size_t>(x) % (2 * sizeof(T)) == 0;
  };
  bool aligned = pair_aligned(p.scratch);
  int max_tiles = 1;
  for (int l = 0; l < p.nlev; ++l) {
    const mg::SmoothArgs<T>& a = p.lv[l];
    const T* arrays[] = {a.u, a.rhs, a.v1, a.v2, a.u_out};
    for (const T* x : arrays) aligned = aligned && pair_aligned(x);
    aligned = aligned && a.cols % 2 == 0;
    const int ends[] = {0, links - 1};  // the first and the last link
    for (const int k : ends) {
      const int tiles =
          tiles_of(a.rows, a.cols, link_sweeps(p.nsweeps, k, links));
      max_tiles = tiles > max_tiles ? tiles : max_tiles;
    }
  }
  const TowerKernel<T> kernel = aligned ? paired : singles;
  int blocks_per_sm = 0, sms = 0;
  cudaError_t err = residency(kernel, blocks_per_sm, sms);
  if (err != cudaSuccess) return err;
  const int grid =
      blocks_per_sm * sms < max_tiles ? blocks_per_sm * sms : max_tiles;
  if (info != nullptr) {
    info[0] = blocks_per_sm;
    info[1] = sms;
    info[2] = grid;
  }
  void* args[] = {const_cast<TowerArgs<T>*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(mg::FV_THREADS), args, 0,
                                    stream);
  const cudaError_t last = cudaGetLastError();  // clears what err recorded
  return err != cudaSuccess ? err : last;
}

// The levels' fields from the entry's three arrays, `per` of each a level.
template <typename T>
bool fill_levels(TowerArgs<T>& p, int nlev, int nsweeps, T* scratch,
                 const double* consts) {
  if (nlev < 1 || nlev > TOWER_MAX_LEVELS || nsweeps < 0) return false;
  p.nlev = nlev;
  p.nsweeps = nsweeps;
  p.scratch = scratch;
  for (int l = 0; l < nlev; ++l) {
    const double* c = consts + 5 * l;
    mg::set_constants(p.lv[l], c[0], c[1], c[2], c[3], c[4]);
  }
  return true;
}

// ptrs per level: rhs, v1, v2, u_out, rhs_c (the next coarser rhs); dims per
// level: rows, cols, n, rows_c, cols_c; consts per level: rr, h/2, nu, diag,
// 1/diag (ops/cuda/smoother.py::cn_constants).
template <typename T>
int descend(void* const* ptrs, const int* dims, const double* consts,
            int nlev, int nsweeps, T* scratch, int* info,
            cudaStream_t stream) {
  TowerArgs<T> p{};
  if (!fill_levels(p, nlev, nsweeps, scratch, consts))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < nlev; ++l) {
    mg::SmoothArgs<T>& a = p.lv[l];
    void* const* q = ptrs + 5 * l;
    const int* d = dims + 5 * l;
    a.rhs = static_cast<const T*>(q[0]);
    a.v1 = static_cast<const T*>(q[1]);
    a.v2 = static_cast<const T*>(q[2]);
    a.u_out = static_cast<T*>(q[3]);
    a.res_out = static_cast<T*>(q[4]);
    a.rows = d[0];
    a.cols = d[1];
    a.n = d[2];
    a.res_rows = d[3];
    a.res_cols = d[4];
  }
  return static_cast<int>(
      launch_tower<T>(descend_kernel<T, mg::FV_PAIRED>,
                      descend_kernel<T, mg::FV_SINGLES>, p, info, stream));
}

// ptrs per level: src (the coarser solution), u, rhs, v1, v2, u_out; dims
// per level: rows, cols, n, src_rows, src_cols; consts as for descend.
template <typename T>
int ascend(void* const* ptrs, const int* dims, const double* consts,
           int nlev, int nsweeps, T* scratch, int* info,
           cudaStream_t stream) {
  TowerArgs<T> p{};
  if (!fill_levels(p, nlev, nsweeps, scratch, consts))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < nlev; ++l) {
    mg::SmoothArgs<T>& a = p.lv[l];
    void* const* q = ptrs + 6 * l;
    const int* d = dims + 5 * l;
    a.src = static_cast<const T*>(q[0]);
    a.u = static_cast<const T*>(q[1]);
    a.rhs = static_cast<const T*>(q[2]);
    a.v1 = static_cast<const T*>(q[3]);
    a.v2 = static_cast<const T*>(q[4]);
    a.u_out = static_cast<T*>(q[5]);
    a.rows = d[0];
    a.cols = d[1];
    a.n = d[2];
    a.src_rows = d[3];
    a.src_cols = d[4];
  }
  return static_cast<int>(
      launch_tower<T>(ascend_kernel<T, mg::FV_PAIRED>,
                      ascend_kernel<T, mg::FV_SINGLES>, p, info, stream));
}

}  // namespace

#define MG_TOWER_ENTRIES(SUFFIX, T)                                           \
  extern "C" int mg_tower_descend_##SUFFIX(                                  \
      void* const* ptrs, const int* dims, const double* consts, int nlev,   \
      int nsweeps, void* scratch, int* info, cudaStream_t stream) {          \
    return descend<T>(ptrs, dims, consts, nlev, nsweeps,                     \
                      static_cast<T*>(scratch), info, stream);               \
  }                                                                          \
  extern "C" int mg_tower_ascend_##SUFFIX(                                   \
      void* const* ptrs, const int* dims, const double* consts, int nlev,   \
      int nsweeps, void* scratch, int* info, cudaStream_t stream) {          \
    return ascend<T>(ptrs, dims, consts, nlev, nsweeps,                      \
                     static_cast<T*>(scratch), info, stream);                \
  }

MG_TOWER_ENTRIES(f32, float)
MG_TOWER_ENTRIES(f64, double)
