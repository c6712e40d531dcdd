// K2: fused red-black Gauss-Seidel smoothing block, from_v form.
//
// Replaces the TPU kernel hpcclassmultigridproject_tpu/ops/pallas/smoother.py
// (_kernel, launched by _fused at :437, through fused_rb_sweeps), in the
// form that recomputes the CN coefficients from the two velocity fields.
// One launch runs `nsweeps` red-black sweeps and the trailing residual of a
// whole level.
//
// What bounds it on the H100: device-memory traffic.  A plain version
// reads and writes the field once per color pass and per elementwise op;
// this kernel reads (u [+ corr], rhs, v1, v2) once and writes u and the
// residual once.  The TPU kernel cut the grid into row bands with a row
// halo; a Hopper block's shared memory holds far less than the TPU's VMEM,
// so here each block owns a 32x32 tile and carries the halo on all four
// sides (smooth_tile in common.cuh): 46x46 cells x 4 planes = 34 KB in
// float32 at nsweeps = 3.  The halo is recomputed work: about 2x the tile's
// cells per pass, paid in shared-memory arithmetic instead of traffic.
// The residual's even rows can be written alone (res_rows_dec), the row
// half of the injection that follows.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(mg::SMOOTH_THREADS)
    smooth_kernel(mg::SmoothArgs<T> a) {
  mg::smooth_tile(a);
}

constexpr int ZERO_INIT = 1, ADD_CORR = 2, WANT_RES = 4, RES_ROWS_DEC = 8;

template <typename T>
int smooth(const T* u, const T* corr, const T* rhs, const T* v1, const T* v2,
           T* u_out, T* res_out, int rows, int cols, int n, int nsweeps,
           double rr, double hh, double nu, double diag, double inv_diag,
           int flags, cudaStream_t stream) {
  mg::SmoothArgs<T> a{};
  a.u = u;
  a.corr = corr;
  a.rhs = rhs;
  a.v1 = v1;
  a.v2 = v2;
  a.u_out = u_out;
  a.res_out = res_out;
  a.rows = a.dom_rows = rows;
  a.cols = a.dom_cols = a.res_cols = cols;
  a.n = n;
  a.nsweeps = nsweeps;
  a.load_mode = (flags & ZERO_INIT)  ? mg::LOAD_ZERO
                : (flags & ADD_CORR) ? mg::LOAD_U_CORR
                                     : mg::LOAD_U;
  a.res_mode = !(flags & WANT_RES)     ? mg::RES_NONE
               : (flags & RES_ROWS_DEC) ? mg::RES_ROWS_DEC
                                        : mg::RES_FULL;
  a.res_rows = a.res_mode == mg::RES_ROWS_DEC ? rows / 2 : rows;
  mg::set_constants(a, rr, hh, nu, diag, inv_diag);
  return static_cast<int>(mg::launch_smooth(smooth_kernel<T>, a, stream));
}

}  // namespace

#define MG_SMOOTH_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* u, const T* corr, const T* rhs, const T* v1,  \
                      const T* v2, T* u_out, T* res_out, int rows, int cols, \
                      int n, int nsweeps, double rr, double hh, double nu,   \
                      double diag, double inv_diag, int flags,               \
                      cudaStream_t stream) {                                 \
    return smooth<T>(u, corr, rhs, v1, v2, u_out, res_out, rows, cols, n,    \
                     nsweeps, rr, hh, nu, diag, inv_diag, flags, stream);    \
  }

MG_SMOOTH_ENTRY(mg_smooth_f32, float)
MG_SMOOTH_ENTRY(mg_smooth_f64, double)
