// K1: the delta step's opening -- state accumulation and delta rhs in one
// pass.
//
// Replaces the TPU kernel hpcclassmultigridproject_tpu/ops/pallas/
// delta_step.py (_kernel, launched by _fused_open at :131, through
// fused_accumulate_open).  Per node it folds the pending correction d into
// the float32 state pair (hi, lo) by TwoSum with a Fast2Sum renormalization,
// then forms the difference-form delta rhs of the new pair,
//   rhs = -2 r nu lap(hi' + lo') - r h (v1 D_i + v2 D_j),
// masked to the open interior, with the operation order of
// mg/delta.py::_accumulate and ::delta_rhs.
//
// What bounds it on the H100: device-memory traffic, 5 arrays read and 3
// written, with a few dozen flops per node.  One thread per output node; a
// neighbour's (hi', lo') is a pointwise function of that neighbour's
// (hi, lo, d), so each thread recomputes it from the loads of the four
// neighbours, which L1 and L2 serve, and no shared memory is needed.
// TwoSum is exact only under IEEE ordering: the library is built without
// fast math and with -fmad=false.

#include "common.cuh"

namespace {

template <typename T>
struct Pair {
  T hi, lo;
};

// (hi, lo) + d at node (i, j), or (0, 0) past the array.
template <typename T>
__device__ __forceinline__ Pair<T> accumulate_at(const T* hi, const T* lo,
                                                 const T* d, int rows,
                                                 int cols, int i, int j) {
  if (i < 0 || i >= rows || j < 0 || j >= cols) return {T(0), T(0)};
  const size_t g = static_cast<size_t>(i) * cols + j;
  const T h = hi[g], l = lo[g], x = d[g];
  const T t = h + x;
  const T bv = t - h;
  const T err = (h - (t - bv)) + (x - bv);
  const T lo2 = l + err;
  const T hi2 = t + lo2;
  const T lo3 = lo2 - (hi2 - t);
  return {hi2, lo3};
}

template <typename T>
__global__ void delta_open_kernel(const T* hi, const T* lo, const T* d,
                                  const T* v1, const T* v2, T* hi_out,
                                  T* lo_out, T* rhs_out, int rows, int cols,
                                  int n, T two_rnu, T r_h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= rows || j >= cols) return;
  const Pair<T> x = accumulate_at(hi, lo, d, rows, cols, i, j);
  const Pair<T> up = accumulate_at(hi, lo, d, rows, cols, i - 1, j);
  const Pair<T> dn = accumulate_at(hi, lo, d, rows, cols, i + 1, j);
  const Pair<T> lf = accumulate_at(hi, lo, d, rows, cols, i, j - 1);
  const Pair<T> rt = accumulate_at(hi, lo, d, rows, cols, i, j + 1);

  T lap = (up.hi - x.hi) + (dn.hi - x.hi) + (lf.hi - x.hi) + (rt.hi - x.hi);
  T di = dn.hi - up.hi;
  T dj = rt.hi - lf.hi;
  const T lap_l =
      (up.lo - x.lo) + (dn.lo - x.lo) + (lf.lo - x.lo) + (rt.lo - x.lo);
  const T di_l = dn.lo - up.lo;
  const T dj_l = rt.lo - lf.lo;
  lap = lap + lap_l;
  di = di + di_l;
  dj = dj + dj_l;

  const size_t g = static_cast<size_t>(i) * cols + j;
  const T m = mg::interior_at<T>(i, j, n);
  rhs_out[g] = (-(two_rnu * lap) - r_h * (v1[g] * di + v2[g] * dj)) * m;
  hi_out[g] = x.hi;
  lo_out[g] = x.lo;
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

}  // namespace

#define MG_DELTA_OPEN_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* hi, const T* lo, const T* d, const T* v1,     \
                      const T* v2, T* hi_out, T* lo_out, T* rhs_out,         \
                      int rows, int cols, int n, double two_rnu, double r_h, \
                      cudaStream_t stream) {                                 \
    return delta_open<T>(hi, lo, d, v1, v2, hi_out, lo_out, rhs_out, rows,   \
                         cols, n, two_rnu, r_h, stream);                     \
  }

MG_DELTA_OPEN_ENTRY(mg_delta_open_f32, float)
MG_DELTA_OPEN_ENTRY(mg_delta_open_f64, double)

extern "C" const char* mg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
