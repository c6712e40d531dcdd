// K3 and K4: the coarse tower of the V-cycle, one launch per level.
//
// Replaces the TPU kernels of hpcclassmultigridproject_tpu/ops/pallas/
// tower.py::tower_vcycle: the descent (_descend_kernel, launched at :326)
// and the ascent (_ascend_kernel, launched at :349).  On the TPU each is a
// single program that holds every level below n = 512 in VMEM at once.
//
// What bounds it on the H100: launch latency and the serial chain of
// levels, not bandwidth: the 512 level is 520x640 (1.3 MB per array in
// float32), more than one SM's shared memory, and the levels below it are
// a few hundred KB in all.  So the host issues one launch per level, each
// the smoothing block of smoother.cu with the level's transfer fused in:
//
//   descent, for each level 512 .. 64: red-black cascade from zero, the
//     residual, and injection written straight into the next coarser rhs
//     (coarse[I, J] = res[2I, 2J], 0 past the fine array), so neither the
//     residual nor a separate restriction touches device memory;
//   ascent, for each level 64 .. 512: the bilinear prolongation of the
//     coarser solution computed per point as the window is loaded, added to
//     the level's stored descent iterate, then the cascade.
//
// Eight launches per V-cycle instead of the TPU's two; one launch for the
// whole tower, or a CUDA graph of the step, is later work.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(mg::SMOOTH_THREADS)
    descend_kernel(mg::SmoothArgs<T> a) {
  mg::smooth_tile(a);
}

template <typename T>
__global__ void __launch_bounds__(mg::SMOOTH_THREADS)
    ascend_kernel(mg::SmoothArgs<T> a) {
  mg::smooth_tile(a);
}

template <typename T>
int descend(const T* rhs, const T* v1, const T* v2, T* u_out, T* rhs_c_out,
            int rows, int cols, int rows_c, int cols_c, int n, int nsweeps,
            double rr, double hh, double nu, double diag, double inv_diag,
            cudaStream_t stream) {
  mg::SmoothArgs<T> a{};
  a.rhs = rhs;
  a.v1 = v1;
  a.v2 = v2;
  a.u_out = u_out;
  a.res_out = rhs_c_out;
  a.rows = rows;
  a.cols = cols;
  a.n = n;
  a.nsweeps = nsweeps;
  a.res_rows = rows_c;
  a.res_cols = cols_c;
  // cover every coarse cell, also those whose fine node lies past the array
  a.dom_rows = rows > 2 * rows_c ? rows : 2 * rows_c;
  a.dom_cols = cols > 2 * cols_c ? cols : 2 * cols_c;
  a.load_mode = mg::LOAD_ZERO;
  a.res_mode = mg::RES_INJECT;
  mg::set_constants(a, rr, hh, nu, diag, inv_diag);
  return static_cast<int>(mg::launch_smooth(descend_kernel<T>, a, stream));
}

template <typename T>
int ascend(const T* src, int src_rows, int src_cols, const T* u,
           const T* rhs, const T* v1, const T* v2, T* u_out, int rows,
           int cols, int n, int nsweeps, double rr, double hh, double nu,
           double diag, double inv_diag, cudaStream_t stream) {
  mg::SmoothArgs<T> a{};
  a.src = src;
  a.src_rows = src_rows;
  a.src_cols = src_cols;
  a.u = u;
  a.rhs = rhs;
  a.v1 = v1;
  a.v2 = v2;
  a.u_out = u_out;
  a.rows = a.dom_rows = rows;
  a.cols = a.dom_cols = cols;
  a.n = n;
  a.nsweeps = nsweeps;
  a.load_mode = mg::LOAD_U_PROLONG;
  a.res_mode = mg::RES_NONE;
  mg::set_constants(a, rr, hh, nu, diag, inv_diag);
  return static_cast<int>(mg::launch_smooth(ascend_kernel<T>, a, stream));
}

}  // namespace

#define MG_TOWER_ENTRIES(SUFFIX, T)                                           \
  extern "C" int mg_tower_descend_##SUFFIX(                                  \
      const T* rhs, const T* v1, const T* v2, T* u_out, T* rhs_c_out,        \
      int rows, int cols, int rows_c, int cols_c, int n, int nsweeps,        \
      double rr, double hh, double nu, double diag, double inv_diag,         \
      cudaStream_t stream) {                                                 \
    return descend<T>(rhs, v1, v2, u_out, rhs_c_out, rows, cols, rows_c,     \
                      cols_c, n, nsweeps, rr, hh, nu, diag, inv_diag,        \
                      stream);                                               \
  }                                                                          \
  extern "C" int mg_tower_ascend_##SUFFIX(                                   \
      const T* src, int src_rows, int src_cols, const T* u, const T* rhs,    \
      const T* v1, const T* v2, T* u_out, int rows, int cols, int n,         \
      int nsweeps, double rr, double hh, double nu, double diag,             \
      double inv_diag, cudaStream_t stream) {                                \
    return ascend<T>(src, src_rows, src_cols, u, rhs, v1, v2, u_out, rows,   \
                     cols, n, nsweeps, rr, hh, nu, diag, inv_diag, stream);  \
  }

MG_TOWER_ENTRIES(f32, float)
MG_TOWER_ENTRIES(f64, double)
