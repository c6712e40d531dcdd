// K2, K5, K6, K7: the fused red-black Gauss-Seidel smoothing block.
//
// Replaces the TPU kernel hpcclassmultigridproject_tpu/ops/pallas/smoother.py
// (_kernel, launched by _fused at :437) in four of its forms:
//
//   K2 mg_smooth:  the CN coefficients recomputed from the two velocity
//                  fields (cn set; the rediscretized advection-diffusion
//                  levels), row_off 0;
//   K7 mg_smooth:  the same on a rank's extended block of a row-partitioned
//                  level, with the block's global row offset (with_row_off,
//                  reached from parallel/pallas_halo.py::fused_smooth_sharded);
//                  the interior mask reads global rows, all else is K2;
//   K5 mg_smooth5: four stored bands aa..dd and the scalar diagonal (cn None;
//                  the Poisson levels);
//   K6 mg_smooth9: eight stored bands and a diagonal that varies in space
//                  (nine; the Galerkin R.A.P levels).
//
// One launch runs `nsweeps` red-black sweeps and the trailing residual of a
// whole level, or (K7) of a rank's block extended by h = 8 halo rows above
// and below; K7 costs what K2 costs on those rows, and the 2h extra rows
// are the price of exchanging one deep halo per smoothing block instead of
// one row per color pass.  The block's start and h are even, so the
// block's row parity is the global one and red stays red.
//
// Each kernel reads (u [+ corr], rhs, coefficients) once and writes u and
// the residual once, where a plain version reads and writes the field once
// per color pass and per elementwise op.  The TPU kernel cut the grid into
// row bands with a row halo; a Hopper block's shared memory holds far less
// than the TPU's VMEM, so here each block owns a tile and carries the halo
// on all four sides.  The residual's even rows can be written alone
// (res_rows_dec), the row half of the injection that follows.
//
// All four launch one block, common.cuh::smooth_from_v, bound by
// instruction issue once its bytes are read once: it runs the color passes
// on a 64x64 window stored as its even and odd columns (50x48 tile at
// nsweeps 3), 512 threads that each own a column pair in four rows and
// issue their global loads together before using any, forming each cell's
// rhs and edge coefficients once a launch in registers, two blocks per SM
// in float32 (64 registers, no spill) and one in float64, moving pairs of
// values as one access where the rows are aligned (an FV_PAIRED instance;
// FV_SINGLES otherwise).  The
// coefficient source is a compile-time variant: K2 and K7 recompute them
// from (v1, v2) (smooth_v_kernel), K5 and K6 load the stored bands
// (smooth_bands_kernel, FORM_FIVE and FORM_NINE).  K6 also keeps each
// cell's four corner bands and its 1/diag, formed once a launch, in 80 KB
// of dynamic shared memory (160 KB in float64), and forms a pass's updates
// into registers before it stores them, since the corners it reads share
// the pass's color.  A launch takes nsweeps up to 13 (the wrapper runs more
// as several launches, each exact, so any nsweeps runs).

#include "common.cuh"

namespace {

template <typename T, int ACCESS>
__global__ void __launch_bounds__(mg::FV_THREADS, mg::fv_min_blocks<T>())
    smooth_v_kernel(mg::SmoothArgs<T> a) {
  mg::smooth_from_v<T, ACCESS>(a, a, blockIdx.y, blockIdx.x);
}

template <typename T, int ACCESS, int FORM>
__global__ void __launch_bounds__(mg::FV_THREADS, mg::fv_min_blocks<T>())
    smooth_bands_kernel(mg::SmoothArgs<T> a) {
  mg::smooth_from_v<T, ACCESS, mg::FV_SMOOTH, FORM>(a, a, blockIdx.y,
                                                    blockIdx.x);
}

constexpr int ZERO_INIT = 1, ADD_CORR = 2, WANT_RES = 4, RES_ROWS_DEC = 8;

// The fields every form shares: the iterate, the rhs, the outputs, the
// extent and the flags.
template <typename T>
mg::SmoothArgs<T> smooth_args(const T* u, const T* corr, const T* rhs,
                              T* u_out, T* res_out, int rows, int cols,
                              int nsweeps, int flags) {
  mg::SmoothArgs<T> a{};
  a.u = u;
  a.corr = corr;
  a.rhs = rhs;
  a.u_out = u_out;
  a.res_out = res_out;
  a.rows = rows;
  a.cols = a.res_cols = cols;
  a.nsweeps = nsweeps;
  a.load_mode = (flags & ZERO_INIT)  ? mg::LOAD_ZERO
                : (flags & ADD_CORR) ? mg::LOAD_U_CORR
                                     : mg::LOAD_U;
  a.res_mode = !(flags & WANT_RES)     ? mg::RES_NONE
               : (flags & RES_ROWS_DEC) ? mg::RES_ROWS_DEC
                                        : mg::RES_FULL;
  a.res_rows = a.res_mode == mg::RES_ROWS_DEC ? rows / 2 : rows;
  return a;
}

template <typename T>
int smooth(const T* u, const T* corr, const T* rhs, const T* v1, const T* v2,
           T* u_out, T* res_out, int rows, int cols, int n, int row_off,
           int nsweeps, double rr, double hh, double nu, double diag,
           double inv_diag, int flags, cudaStream_t stream) {
  mg::SmoothArgs<T> a =
      smooth_args(u, corr, rhs, u_out, res_out, rows, cols, nsweeps, flags);
  a.v1 = v1;
  a.v2 = v2;
  a.n = n;
  a.row_off = row_off;
  mg::set_constants(a, rr, hh, nu, diag, inv_diag);
  return static_cast<int>(
      mg::launch_smooth_from_v(smooth_v_kernel<T, mg::FV_PAIRED>,
                               smooth_v_kernel<T, mg::FV_SINGLES>, a, stream));
}

template <typename T>
int smooth5(const T* u, const T* corr, const T* rhs, const T* aa,
            const T* bb, const T* cc, const T* dd, T* u_out, T* res_out,
            int rows, int cols, int nsweeps, double diag, double inv_diag,
            int flags, cudaStream_t stream) {
  mg::SmoothArgs<T> a =
      smooth_args(u, corr, rhs, u_out, res_out, rows, cols, nsweeps, flags);
  const T* bands[4] = {aa, bb, cc, dd};
  for (int q = 0; q < 4; ++q) a.bands[q] = bands[q];
  a.diag = static_cast<T>(diag);
  a.inv_diag = static_cast<T>(inv_diag);
  return static_cast<int>(mg::launch_smooth_from_v(
      smooth_bands_kernel<T, mg::FV_PAIRED, mg::FORM_FIVE>,
      smooth_bands_kernel<T, mg::FV_SINGLES, mg::FORM_FIVE>, a, stream));
}

template <typename T>
int smooth9(const T* u, const T* corr, const T* rhs, const T* aa,
            const T* bb, const T* cc, const T* dd, const T* ne, const T* nw,
            const T* se, const T* sw, const T* diag, T* u_out, T* res_out,
            int rows, int cols, int nsweeps, int flags,
            cudaStream_t stream) {
  mg::SmoothArgs<T> a =
      smooth_args(u, corr, rhs, u_out, res_out, rows, cols, nsweeps, flags);
  const T* bands[9] = {aa, bb, cc, dd, ne, nw, se, sw, diag};
  for (int q = 0; q < 9; ++q) a.bands[q] = bands[q];
  return static_cast<int>(mg::launch_smooth_from_v(
      smooth_bands_kernel<T, mg::FV_PAIRED, mg::FORM_NINE>,
      smooth_bands_kernel<T, mg::FV_SINGLES, mg::FORM_NINE>, a, stream,
      mg::fv_nine_smem_bytes<T>()));
}

}  // namespace

#define MG_SMOOTH_ENTRIES(SUFFIX, T)                                          \
  extern "C" int mg_smooth_##SUFFIX(                                         \
      const T* u, const T* corr, const T* rhs, const T* v1, const T* v2,     \
      T* u_out, T* res_out, int rows, int cols, int n, int row_off,          \
      int nsweeps, double rr, double hh, double nu, double diag,             \
      double inv_diag, int flags, cudaStream_t stream) {                     \
    return smooth<T>(u, corr, rhs, v1, v2, u_out, res_out, rows, cols, n,    \
                     row_off, nsweeps, rr, hh, nu, diag, inv_diag, flags,    \
                     stream);                                                \
  }                                                                          \
  extern "C" int mg_smooth5_##SUFFIX(                                        \
      const T* u, const T* corr, const T* rhs, const T* aa, const T* bb,     \
      const T* cc, const T* dd, T* u_out, T* res_out, int rows, int cols,    \
      int nsweeps, double diag, double inv_diag, int flags,                  \
      cudaStream_t stream) {                                                 \
    return smooth5<T>(u, corr, rhs, aa, bb, cc, dd, u_out, res_out, rows,    \
                      cols, nsweeps, diag, inv_diag, flags, stream);         \
  }                                                                          \
  extern "C" int mg_smooth9_##SUFFIX(                                        \
      const T* u, const T* corr, const T* rhs, const T* aa, const T* bb,     \
      const T* cc, const T* dd, const T* ne, const T* nw, const T* se,       \
      const T* sw, const T* diag, T* u_out, T* res_out, int rows, int cols,  \
      int nsweeps, int flags, cudaStream_t stream) {                         \
    return smooth9<T>(u, corr, rhs, aa, bb, cc, dd, ne, nw, se, sw, diag,    \
                      u_out, res_out, rows, cols, nsweeps, flags, stream);   \
  }

MG_SMOOTH_ENTRIES(f32, float)
MG_SMOOTH_ENTRIES(f64, double)
