// K1 and K8: the delta step's opening.
//
// K1 replaces the TPU kernel hpcclassmultigridproject_tpu/ops/pallas/
// delta_step.py (_kernel, launched by _fused_open at :131, through
// fused_accumulate_open).  Per node it folds the pending correction d into
// the float32 state pair (hi, lo) by TwoSum with a Fast2Sum renormalization,
// then forms the difference-form delta rhs of the new pair,
//   rhs = -2 r nu lap(hi' + lo') - r h (v1 D_i + v2 D_j),
// masked to the open interior, with the operation order of
// mg/delta.py::_accumulate and ::delta_rhs (mg::delta_open_at, common.cuh).
//
// What bounds K1 on the H100: device-memory traffic, 5 arrays read and 3
// written, with a few dozen flops per node.  One thread per output node; a
// neighbour's (hi', lo') is a pointwise function of that neighbour's
// (hi, lo, d), so each thread recomputes it from the loads of the four
// neighbours, which L1 and L2 serve, and no shared memory is needed.
// TwoSum is exact only under IEEE ordering: the library is built without
// fast math and with -fmad=false.
//
// K8, the whole-step opening, replaces _kernel_open_smooth (launched by
// _fused_open_smooth at :329, through fused_open_presmooth): K1 and the top
// level's zero-init pre-smooth block (K2) with its trailing residual, full
// or row-decimated, in one pass.  It is the from_v block
// (mg::smooth_from_v, common.cuh) with the opening as a compile-time
// variant, FV_OPEN: each thread loads hi, lo, d, v1 and v2 of its cells
// together, folds each cell once and stores (hi', lo') at the tile's
// cells; the window's planes hold hi', then lo', and each cell's rhs is
// formed from its neighbours there with K1's mg::dform and mg::delta_rhs;
// then the cascade from u = 0 and the residual run as K2's.  Bound: 5
// arrays read, 4 written plus the residual (half an array when
// row-decimated), against K1 + K2's 8 + 4.5; the opening is computed once a
// window cell, 1.71x the tile at nsweeps 3.  Every expression is K1's or
// K2's, so K8 equals K1 followed by K2 to the bit.  A launch takes nsweeps
// up to 13; the wrapper chains K2 launches from K8's iterate for more.

#include "common.cuh"

namespace {

template <typename T>
__global__ void delta_open_kernel(const T* hi, const T* lo, const T* d,
                                  const T* v1, const T* v2, T* hi_out,
                                  T* lo_out, T* rhs_out, int rows, int cols,
                                  int n, T two_rnu, T r_h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= rows || j >= cols) return;
  const mg::Opened<T> o =
      mg::delta_open_at(hi, lo, d, v1, v2, rows, cols, i, j, n, two_rnu, r_h);
  const size_t g = static_cast<size_t>(i) * cols + j;
  rhs_out[g] = o.rhs;
  hi_out[g] = o.hi;
  lo_out[g] = o.lo;
}

template <typename T>
int delta_open(const T* hi, const T* lo, const T* d, const T* v1, const T* v2,
               T* hi_out, T* lo_out, T* rhs_out, int rows, int cols, int n,
               double two_rnu, double r_h, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((cols + block.x - 1) / block.x,
                  (rows + block.y - 1) / block.y);
  delta_open_kernel<T><<<grid, block, 0, stream>>>(
      hi, lo, d, v1, v2, hi_out, lo_out, rhs_out, rows, cols, n,
      static_cast<T>(two_rnu), static_cast<T>(r_h));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACCESS>
__global__ void __launch_bounds__(mg::FV_THREADS, mg::fv_min_blocks<T>())
    open_smooth_kernel(mg::SmoothArgs<T> a) {
  mg::smooth_from_v<T, ACCESS, mg::FV_OPEN>(a, a, blockIdx.y, blockIdx.x);
}

// res_mode: mg::RES_NONE, RES_FULL or RES_ROWS_DEC.
template <typename T>
int open_smooth(const T* hi, const T* lo, const T* d, const T* v1,
                const T* v2, T* hi_out, T* lo_out, T* rhs_out, T* u_out,
                T* res_out, int rows, int cols, int n, int nsweeps, double rr,
                double hh, double nu, double diag, double inv_diag,
                double two_rnu, double r_h, int res_mode,
                cudaStream_t stream) {
  if (res_mode != mg::RES_NONE && res_mode != mg::RES_FULL &&
      res_mode != mg::RES_ROWS_DEC)
    return static_cast<int>(cudaErrorInvalidValue);
  mg::SmoothArgs<T> a{};
  a.hi = hi;
  a.lo = lo;
  a.d = d;
  a.v1 = v1;
  a.v2 = v2;
  a.hi_out = hi_out;
  a.lo_out = lo_out;
  a.rhs_out = rhs_out;
  a.u_out = u_out;
  a.res_out = res_out;
  a.rows = rows;
  a.cols = a.res_cols = cols;
  a.n = n;
  a.nsweeps = nsweeps;
  a.load_mode = mg::LOAD_ZERO;
  a.res_mode = res_mode;
  a.res_rows = res_mode == mg::RES_ROWS_DEC ? rows / 2 : rows;
  mg::set_constants(a, rr, hh, nu, diag, inv_diag);
  a.two_rnu = static_cast<T>(two_rnu);
  a.r_h = static_cast<T>(r_h);
  return static_cast<int>(mg::launch_smooth_from_v(
      open_smooth_kernel<T, mg::FV_PAIRED>,
      open_smooth_kernel<T, mg::FV_SINGLES>, a, stream));
}

}  // namespace

#define MG_DELTA_OPEN_ENTRIES(SUFFIX, T)                                      \
  extern "C" int mg_delta_open_##SUFFIX(                                     \
      const T* hi, const T* lo, const T* d, const T* v1, const T* v2,        \
      T* hi_out, T* lo_out, T* rhs_out, int rows, int cols, int n,           \
      double two_rnu, double r_h, cudaStream_t stream) {                     \
    return delta_open<T>(hi, lo, d, v1, v2, hi_out, lo_out, rhs_out, rows,   \
                         cols, n, two_rnu, r_h, stream);                     \
  }                                                                          \
  extern "C" int mg_open_smooth_##SUFFIX(                                    \
      const T* hi, const T* lo, const T* d, const T* v1, const T* v2,        \
      T* hi_out, T* lo_out, T* rhs_out, T* u_out, T* res_out, int rows,      \
      int cols, int n, int nsweeps, double rr, double hh, double nu,         \
      double diag, double inv_diag, double two_rnu, double r_h,              \
      int res_mode, cudaStream_t stream) {                                   \
    return open_smooth<T>(hi, lo, d, v1, v2, hi_out, lo_out, rhs_out, u_out, \
                          res_out, rows, cols, n, nsweeps, rr, hh, nu, diag, \
                          inv_diag, two_rnu, r_h, res_mode, stream);         \
  }

MG_DELTA_OPEN_ENTRIES(f32, float)
MG_DELTA_OPEN_ENTRIES(f64, double)

extern "C" const char* mg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
