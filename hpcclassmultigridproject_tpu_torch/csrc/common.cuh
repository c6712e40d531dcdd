// Device code shared by the port's kernels: the CN coefficient recompute,
// the delta step's opening at one node (K1, K8), the red-black Gauss-Seidel
// cascade on a shared-memory window (for the three coefficient sources:
// recomputed from (v1, v2), five stored bands, nine stored bands with a
// varying diagonal), and the per-point bilinear prolongation.
//
// Every expression keeps the operation order of the JAX package's Pallas
// kernels and of the port's plain PyTorch versions (ops/padded.py), and the
// library is built with -fmad=false, so a kernel can be compared with its
// plain version on the card to the bit or near it.  Never build this with
// --use_fast_math: the TwoSum of delta_step.cu depends on IEEE ordering.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace mg {

// Output tile of one smooth_tile block, and its thread count.
constexpr int TILE_H = 32;
constexpr int TILE_W = 32;
constexpr int SMOOTH_THREADS = 256;

// How a smoothing block forms the starting iterate of each window cell.
enum LoadMode {
  LOAD_ZERO = 0,       // u = 0 (correction solves, the delta opening)
  LOAD_U = 1,          // u
  LOAD_U_CORR = 2,     // u + corr (the prolonged correction, post-smooth)
  LOAD_U_PROLONG = 3,  // u + bilinear prolongation of a coarser field
                       // (the tower's ascent, smooth_from_v<FV_PROLONG>)
};

// What it writes of the trailing residual rhs - A u.
enum ResMode {
  RES_NONE = 0,
  RES_FULL = 1,      // (rows, cols)
  RES_ROWS_DEC = 2,  // even global rows only, (rows / 2, cols)
  RES_INJECT = 3,    // coarse[I, J] = res[2I, 2J] (the tower's descent,
                     // smooth_from_v<FV_INJECT>; tower.cu's zero_past
                     // writes the coarse cells past the fine array)
};

// Where a smoothing block takes the stencil coefficients from.
enum CoefForm {
  FORM_FROM_V = 0,  // recomputed from (v1, v2): the CN levels (K8; K2, K3,
                    // K4 and K7 take smooth_from_v below)
  FORM_FIVE = 1,    // stored aa, bb, cc, dd; scalar diagonal (K5)
  FORM_NINE = 2,    // stored aa..dd, ne, nw, se, sw and diag (K6)
};

// Stored planes: FORM_FIVE reads bands[0..3] = aa, bb, cc, dd; FORM_NINE
// also bands[4..7] = ne, nw, se, sw and bands[8] = diag.
constexpr int MAX_BANDS = 9;

template <typename T>
struct SmoothArgs {
  const T* u;       // LOAD_U, LOAD_U_CORR, LOAD_U_PROLONG
  const T* corr;    // LOAD_U_CORR
  const T* src;     // LOAD_U_PROLONG: the coarser field, (src_rows, src_cols)
  const T* rhs;     // unless OPEN
  const T* hi;      // OPEN: the state pair and the pending correction
  const T* lo;
  const T* d;
  const T* v1;      // FORM_FROM_V
  const T* v2;
  const T* bands[MAX_BANDS];  // FORM_FIVE, FORM_NINE
  T* u_out;         // (rows, cols)
  T* res_out;       // (res_rows, res_cols), unless RES_NONE
  T* hi_out;        // OPEN: (hi', lo', rhs_delta) at the tile's cells
  T* lo_out;
  T* rhs_out;
  int rows, cols, n, nsweeps;
  int row_off;      // FORM_FROM_V: global row of array row 0 (K7's block
                    // of a row-partitioned level; 0 on a whole level)
  int src_rows, src_cols, res_rows, res_cols;
  int load_mode, res_mode;
  T rr, hh, nu, diag, inv_diag;  // constants, rounded to T on the host
                                 // (FORM_NINE reads none of them)
  T two_rnu, r_h;                // OPEN: 2 r nu and r h, likewise
};

template <typename T>
__device__ __forceinline__ T interior_at(int gi, int gj, int n) {
  return (gi >= 1 && gi <= n - 1 && gj >= 1 && gj <= n - 1) ? T(1) : T(0);
}

template <typename T>
struct Pair {
  T hi, lo;
};

// (hi, lo) + d at node (i, j) by TwoSum with a Fast2Sum renormalization
// (mg/delta.py::_accumulate), or (0, 0) past the array.
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
struct Opened {
  T hi, lo, rhs;
};

// The delta step's opening at node (i, j) of the array: the accumulated
// pair (hi', lo') and the difference-form delta rhs of the new pair,
//   rhs = -2 r nu lap(hi' + lo') - r h (v1 D_i + v2 D_j),
// masked to the open interior, in the operation order of
// mg/delta.py::delta_rhs.  A neighbour's (hi', lo') is a pointwise function
// of that neighbour's (hi, lo, d), so it is recomputed from their loads.
// K1 and K8 both call this, so their rhs agree to the bit.
template <typename T>
__device__ __forceinline__ Opened<T> delta_open_at(
    const T* hi, const T* lo, const T* d, const T* v1, const T* v2, int rows,
    int cols, int i, int j, int n, T two_rnu, T r_h) {
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
  const T m = interior_at<T>(i, j, n);
  return {x.hi, x.lo,
          (-(two_rnu * lap) - r_h * (v1[g] * di + v2[g] * dj)) * m};
}

template <typename T>
struct Coefs {
  T aa, bb, cc, dd;
};

// aa -> u[i,j-1], bb -> u[i,j+1], cc -> u[i-1,j], dd -> u[i+1,j], zero
// outside the open interior (m = 0).
template <typename T>
__device__ __forceinline__ Coefs<T> coefs_at(T v1, T v2, T m, T rr, T hh,
                                             T nu) {
  Coefs<T> k;
  k.aa = rr * (-v2 * hh + nu) * m;
  k.bb = rr * (v2 * hh + nu) * m;
  k.cc = rr * (-v1 * hh + nu) * m;
  k.dd = rr * (v1 * hh + nu) * m;
  return k;
}

// cc*u_N + dd*u_S + aa*u_W + bb*u_E at window cell (r, c) of an (wh, ww)
// window; reads past the window edge are 0.
template <typename T>
__device__ __forceinline__ T nb_at(const T* s, int r, int c, int wh, int ww,
                                   const Coefs<T>& k) {
  const int idx = r * ww + c;
  const T up = r > 0 ? s[idx - ww] : T(0);
  const T dn = r < wh - 1 ? s[idx + ww] : T(0);
  const T lf = c > 0 ? s[idx - 1] : T(0);
  const T rt = c < ww - 1 ? s[idx + 1] : T(0);
  return k.cc * up + k.dd * dn + k.aa * lf + k.bb * rt;
}

// The nine-point neighbour sum: nb_at plus ne*u_NE + nw*u_NW + se*u_SE +
// sw*u_SW, in the operation order of ops/padded.py::neighbor_sum.
template <typename T>
__device__ __forceinline__ T nb9_at(const T* s, int r, int c, int wh, int ww,
                                    const Coefs<T>& k, T ne, T nw, T se,
                                    T sw) {
  const int idx = r * ww + c;
  const bool has_up = r > 0, has_dn = r < wh - 1;
  const bool has_lf = c > 0, has_rt = c < ww - 1;
  const T ur = has_up && has_rt ? s[idx - ww + 1] : T(0);
  const T ul = has_up && has_lf ? s[idx - ww - 1] : T(0);
  const T dr = has_dn && has_rt ? s[idx + ww + 1] : T(0);
  const T dl = has_dn && has_lf ? s[idx + ww - 1] : T(0);
  return nb_at(s, r, c, wh, ww, k) + ne * ur + nw * ul + se * dr + sw * dl;
}

template <typename T>
__device__ __forceinline__ T at_or_zero(const T* x, int rows, int cols, int i,
                                        int j) {
  return (i < rows && j < cols) ? x[static_cast<size_t>(i) * cols + j] : T(0);
}

// Bilinear prolongation of the coarse field c at the fine nodes (i, j) and
// (i, j + 1), j even: rows first, then columns, as
// ops/padded.py::prolong_bilinear interleaves them (an odd row's odd
// column is half the sum of its even neighbour's value and the next
// column's row average).
template <typename T>
__device__ __forceinline__ void prolong_pair(const T* c, int rows_c,
                                             int cols_c, int i, int j, T& p0,
                                             T& p1) {
  const int I = i >> 1, J = j >> 1;
  const T half = T(0.5);
  const T c00 = at_or_zero(c, rows_c, cols_c, I, J);
  const T c01 = at_or_zero(c, rows_c, cols_c, I, J + 1);
  if (!(i & 1)) {
    p0 = c00;
    p1 = half * (c00 + c01);
    return;
  }
  const T c10 = at_or_zero(c, rows_c, cols_c, I + 1, J);
  const T c11 = at_or_zero(c, rows_c, cols_c, I + 1, J + 1);
  p0 = half * (c00 + c10);
  p1 = half * (p0 + half * (c01 + c11));
}

// Shared-memory planes of one smoothing block's window: u and rhs, the
// coefficient source, and for FORM_NINE one plane of pending updates.
template <int FORM>
constexpr int smooth_planes() {
  return FORM == FORM_FROM_V ? 4 : FORM == FORM_FIVE ? 6 : 12;
}

inline size_t smooth_smem_bytes(int nsweeps, size_t elem, int planes) {
  const int halo = 2 * nsweeps + 1;
  return planes * static_cast<size_t>(TILE_H + 2 * halo) * (TILE_W + 2 * halo) *
         elem;
}

// One block: `nsweeps` red-black sweeps and the trailing residual for one
// TILE_H x TILE_W output tile.  The block loads a window with a halo of
// 2*nsweeps+1 cells on every side, runs all 2*nsweeps color passes in
// shared memory, and writes the tile.  A window cell whose neighbour lies
// past the window reads 0 there; the error that makes moves in one cell per
// pass (corners included: the nine-point stencil also has radius 1), so
// after the cascade and the residual it has not reached the tile, which
// therefore holds exactly what a global barrier between colors would give.
// With OPEN (K8, a compile-time flag, so the other kernels carry none of
// it) the window starts from u = 0 and the rhs of every window cell is the
// delta opening, computed from global memory (its neighbours too), so the
// window's rhs is exact to its edge and the argument holds unchanged; the
// write-back also writes (hi', lo', rhs_delta) at the tile's cells.  Cells
// past the array are 0 and stay 0, since their coefficients and rhs
// are 0 (and a nine-band diagonal loads 1 there, so 1/diag stays finite):
// that is the truth at the array's edges, and on a rank's extended block of
// a row-partitioned level (K7) the artificial edge whose error the center
// rows never see.  Red is (i+j) even in array indices, which are the
// global ones on a whole level and on a block whose row_off is even (the
// wrapper refuses an odd one).  A five-point color pass reads only the
// other color, so it updates in place; a nine-point pass also reads its
// own color at the corners, so it computes every update of the pass first
// and writes them after a barrier.
template <typename T, int FORM, bool OPEN = false>
__device__ void smooth_tile(const SmoothArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char mg_smem[];
  constexpr int NCOEF = FORM == FORM_FROM_V ? 2 : FORM == FORM_FIVE ? 4 : 9;
  const int halo = 2 * a.nsweeps + 1;
  const int wh = TILE_H + 2 * halo, ww = TILE_W + 2 * halo;
  const int wsize = wh * ww;
  T* su = reinterpret_cast<T*>(mg_smem);
  T* srhs = su + wsize;
  T* sco = srhs + wsize;  // NCOEF coefficient planes: v1, v2 or the bands
  T* spend = sco + NCOEF * wsize;  // FORM_NINE: the pass's pending updates
  const int ti0 = blockIdx.y * TILE_H, tj0 = blockIdx.x * TILE_W;
  const int gi0 = ti0 - halo, gj0 = tj0 - halo;
  const int tid = threadIdx.x, nth = blockDim.x;

  for (int k = tid; k < wsize; k += nth) {
    const int r = k / ww, c = k - r * ww;
    const int gi = gi0 + r, gj = gj0 + c;
    const bool in = gi >= 0 && gi < a.rows && gj >= 0 && gj < a.cols;
    const size_t g = in ? static_cast<size_t>(gi) * a.cols + gj : 0;
    T u = T(0), rhs = T(0);
    if constexpr (OPEN) {
      if (in)
        rhs = delta_open_at(a.hi, a.lo, a.d, a.v1, a.v2, a.rows, a.cols, gi,
                            gj, a.n, a.two_rnu, a.r_h)
                  .rhs;
    } else if (in) {
      rhs = a.rhs[g];
      if (a.load_mode == LOAD_U) {
        u = a.u[g];
      } else if (a.load_mode == LOAD_U_CORR) {
        u = a.u[g] + a.corr[g];
      }
    }
    su[k] = u;
    srhs[k] = rhs;
    if (FORM == FORM_FROM_V) {
      sco[k] = in ? a.v1[g] : T(0);
      sco[wsize + k] = in ? a.v2[g] : T(0);
    } else {
      for (int q = 0; q < NCOEF; ++q) {
        // the nine-band diagonal is 1 past the array, as outside the
        // interior, or 0/0 would poison the cascade through the corners
        const T fill = (FORM == FORM_NINE && q == 8) ? T(1) : T(0);
        sco[q * wsize + k] = in ? a.bands[q][g] : fill;
      }
    }
  }
  __syncthreads();

  // the stencil at window cell idx (array (gi, gj)): its four edge bands.
  // The from_v interior mask reads the global row gi + row_off, and is 0
  // past the array: on a K7 block the rows past it can be interior rows
  // of the grid, whose cells must stay 0 there as the plain version's
  // zero fill keeps them (on a whole level they lie outside the interior)
  auto coefs = [&](int idx, int gi, int gj) {
    if (FORM == FORM_FROM_V) {
      const bool in = gi >= 0 && gi < a.rows && gj >= 0 && gj < a.cols;
      return coefs_at(sco[idx], sco[wsize + idx],
                      in ? interior_at<T>(gi + a.row_off, gj, a.n) : T(0),
                      a.rr, a.hh, a.nu);
    }
    Coefs<T> k;
    k.aa = sco[idx];
    k.bb = sco[wsize + idx];
    k.cc = sco[2 * wsize + idx];
    k.dd = sco[3 * wsize + idx];
    return k;
  };
  // the neighbour sum of su at window cell (r, c)
  auto nb = [&](int r, int c, int idx, const Coefs<T>& k) {
    if (FORM != FORM_NINE) return nb_at(su, r, c, wh, ww, k);
    return nb9_at(su, r, c, wh, ww, k, sco[4 * wsize + idx],
                  sco[5 * wsize + idx], sco[6 * wsize + idx],
                  sco[7 * wsize + idx]);
  };

  const int half = (ww + 1) / 2;  // cells of one color in a window row, at most
  for (int p = 0; p < 2 * a.nsweeps; ++p) {
    const int color = p & 1;
    for (int k = tid; k < wh * half; k += nth) {
      const int r = k / half;
      const int c = 2 * (k - r * half) + ((gi0 + r + gj0 + color) & 1);
      if (c >= ww) continue;
      const int idx = r * ww + c;
      const Coefs<T> co = coefs(idx, gi0 + r, gj0 + c);
      const T inv = FORM == FORM_NINE ? T(1) / sco[8 * wsize + idx]
                                      : a.inv_diag;
      const T upd = (srhs[idx] - nb(r, c, idx, co)) * inv;
      if (FORM == FORM_NINE) {
        spend[idx] = upd;
      } else {
        su[idx] = upd;
      }
    }
    __syncthreads();
    if (FORM == FORM_NINE) {
      for (int k = tid; k < wh * half; k += nth) {
        const int r = k / half;
        const int c = 2 * (k - r * half) + ((gi0 + r + gj0 + color) & 1);
        if (c < ww) su[r * ww + c] = spend[r * ww + c];
      }
      __syncthreads();
    }
  }

  for (int k = tid; k < TILE_H * TILE_W; k += nth) {
    const int tr = k / TILE_W, tc = k - tr * TILE_W;
    const int gi = ti0 + tr, gj = tj0 + tc;
    const int r = tr + halo, c = tc + halo, idx = r * ww + c;
    const bool in = gi < a.rows && gj < a.cols;
    const size_t g = static_cast<size_t>(gi) * a.cols + gj;
    if (in) a.u_out[g] = su[idx];
    if constexpr (OPEN) {
      if (in) {
        const Pair<T> x =
            accumulate_at(a.hi, a.lo, a.d, a.rows, a.cols, gi, gj);
        a.hi_out[g] = x.hi;
        a.lo_out[g] = x.lo;
        a.rhs_out[g] = srhs[idx];
      }
    }
    if (a.res_mode == RES_NONE) continue;
    T res = T(0);
    if (in) {
      const Coefs<T> co = coefs(idx, gi, gj);
      const T diag = FORM == FORM_NINE ? sco[8 * wsize + idx] : a.diag;
      res = srhs[idx] - diag * su[idx] - nb(r, c, idx, co);
    }
    if (a.res_mode == RES_FULL) {
      if (in) a.res_out[g] = res;
    } else if (a.res_mode == RES_ROWS_DEC) {
      if (in && !(gi & 1))
        a.res_out[static_cast<size_t>(gi >> 1) * a.cols + gj] = res;
    }
  }
}

// Launch one smoothing pass over the tiles of a.rows x a.cols with
// `kernel`, a __global__ wrapper of smooth_tile<T, FORM>.  Returns the
// launch error (a window past the 227 KB of shared memory a block may
// have is refused here, by cudaFuncSetAttribute).
template <int FORM, typename T>
cudaError_t launch_smooth(void (*kernel)(SmoothArgs<T>), const SmoothArgs<T>& a,
                          cudaStream_t stream) {
  const size_t smem =
      smooth_smem_bytes(a.nsweeps, sizeof(T), smooth_planes<FORM>());
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.cols + TILE_W - 1) / TILE_W,
                  (a.rows + TILE_H - 1) / TILE_H);
  kernel<<<grid, SMOOTH_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The from_v smoothing block of K2 and K7 (mg_smooth), and of every level
// of the tower (K3, K4: tower.cu, with their transfers as compile-time
// variants): the cascade of smooth_tile with the CN coefficients
// recomputed from (v1, v2), redesigned for Hopper.  What bounds smooth_tile
// is instruction issue, not bytes: at
// every window cell each color pass recomputes its window index (a
// division), its parity, its masks and its four coefficients, and reads its
// neighbours through bounds tests; the window is 2.07x the 32x32 tile; and a
// color pass touches every second word of a row.  This block:
//
//  - has a window of fixed shape, FV_WIN_H x FV_WIN_W = 64 x 64, whose
//    halo follows nsweeps: hr = 2*nsweeps+1 rows and hc = hr rounded up to
//    FV_COL_ALIGN columns on each side, so the output tile is
//    (64 - 2 hr) x (64 - 2 hc): 50 x 48 at nsweeps 3 (the window 1.71x
//    the tile), 58 x 56 at nsweeps 1;
//  - stores the window as two planes, its even and its odd columns (32
//    cells a row each).  In a row one plane holds the red cells and the
//    other the black, so a color pass reads and writes whole warps of
//    consecutive words: no bank conflict.  A zero border (row -1 and
//    FV_WIN_H, pair -1 and FV_PAIRS) gives a cell whose neighbour lies past
//    the window 0 there, with no bounds test;
//  - maps threads to cells once: warp g owns window rows g, g+16, g+32 and
//    g+48, lane k the pair of columns (2k, 2k+1) of each.  The thread
//    loads its pairs (two values at a time where the rows are aligned),
//    forms their rhs and coefficients once, and keeps them in registers
//    (FV_ROWS x 2 x 5 values), so a color pass is, per cell, four shared
//    loads, the neighbour sum, the update and one shared store.  A warp's
//    rows share a parity, so which column of its pairs is red is fixed per
//    warp, and a pass branches on it once;
//  - runs two blocks of 512 threads per SM in float32 (64 registers).
//
// Every expression keeps the operation order of smooth_tile (coefs_at,
// cc*up + dd*dn + aa*lf + bb*rt, (rhs - nb)*inv, rhs - diag*u - nb), and
// the validity argument of smooth_tile holds unchanged: each side's halo
// is at least 2*nsweeps+1 cells, and a cell whose neighbour lies past the
// window reads 0 there.  The from_v mask is 0 past the array, as there.
constexpr int FV_WIN_H = 64;
constexpr int FV_WIN_W = 64;
constexpr int FV_COL_ALIGN = 4;
constexpr int FV_PAIRS = FV_WIN_W / 2;  // one warp's lanes
constexpr int FV_WARPS = 16;
constexpr int FV_THREADS = FV_WARPS * FV_PAIRS;
constexpr int FV_ROWS = FV_WIN_H / FV_WARPS;  // window rows a thread owns
constexpr int FV_STRIDE = FV_PAIRS + 2;       // a plane row, with its border
static_assert(FV_PAIRS == 32 && FV_WARPS % 2 == 0 && FV_WIN_H % FV_WARPS == 0,
              "a warp owns one half-row; a thread's rows share a parity");

// Halo of the from_v block on each side: rows, and columns (rounded up),
// and the output tile they leave in the window.
__host__ __device__ constexpr int fv_halo_rows(int nsweeps) {
  return 2 * nsweeps + 1;
}
__host__ __device__ constexpr int fv_halo_cols(int nsweeps) {
  return (2 * nsweeps + FV_COL_ALIGN) / FV_COL_ALIGN * FV_COL_ALIGN;
}
__host__ __device__ constexpr int fv_tile_rows(int nsweeps) {
  return FV_WIN_H - 2 * fv_halo_rows(nsweeps);
}
__host__ __device__ constexpr int fv_tile_cols(int nsweeps) {
  return FV_WIN_W - 2 * fv_halo_cols(nsweeps);
}

// The most sweeps one run of the block takes (a tile of at least 2 x 2
// left); more run as a chain of runs, each from the last one's iterate.
constexpr int FV_MAX_SWEEPS = 13;
static_assert(fv_tile_rows(FV_MAX_SWEEPS) >= 2 &&
                  fv_tile_cols(FV_MAX_SWEEPS) >= 2 &&
                  fv_tile_cols(FV_MAX_SWEEPS + 1) < 2,
              "FV_MAX_SWEEPS is the last nsweeps that leaves a tile");

// Blocks per SM the register budget is set for: two in float32 (64
// registers a thread); in float64 the coefficient registers double.
template <typename T>
constexpr int fv_min_blocks() {
  return sizeof(T) == 4 ? 2 : 1;
}

// A cell's rhs and coefficients, formed once a launch.
template <typename T>
struct FvCell {
  T rhs, aa, bb, cc, dd;
};

// Two adjacent values: one load or store where they are aligned as a pair.
template <typename T>
struct FvPair;
template <>
struct FvPair<float> {
  using type = float2;
};
template <>
struct FvPair<double> {
  using type = double2;
};

// How the block moves a thread's two values of a row: as one aligned pair
// (every row of every array starts aligned to a pair), or one by one.
enum FvAccess { FV_SINGLES = 0, FV_PAIRED = 1 };

// (p[at], p[at + 1]), each 0 where it lies past the array (!in0, !in1).
// FV_PAIRED: the two are one aligned pair, inside or past the array alike.
template <int ACCESS, typename T>
__device__ __forceinline__ void fv_load(const T* p, size_t at, bool in0,
                                        bool in1, T& x, T& y) {
  if constexpr (ACCESS == FV_PAIRED) {
    using T2 = typename FvPair<T>::type;
    const T2 v = in0 ? *reinterpret_cast<const T2*>(p + at) : T2{T(0), T(0)};
    x = v.x;
    y = v.y;
  } else {
    x = in0 ? p[at] : T(0);
    y = in1 ? p[at + 1] : T(0);
  }
}

template <int ACCESS, typename T>
__device__ __forceinline__ void fv_store(T* p, size_t at, bool in0, bool in1,
                                         T x, T y) {
  if constexpr (ACCESS == FV_PAIRED) {
    if (in0) *reinterpret_cast<typename FvPair<T>::type*>(p + at) = {x, y};
  } else {
    if (in0) p[at] = x;
    if (in1) p[at + 1] = y;
  }
}

// One color pass over the thread's cells of one column parity: they lie
// in `self` (the plane of that parity), whose rows above and below hold
// the other color, and their left and right neighbours in `other`, at
// offsets `lf` and `lf + 1` from the thread's first cell `cell`.
template <typename T>
__device__ __forceinline__ void fv_pass(T* self, const T* __restrict__ other,
                                        const FvCell<T> (&c)[FV_ROWS],
                                        int cell, int lf, T inv) {
#pragma unroll
  for (int j = 0; j < FV_ROWS; ++j) {
    const int at = cell + j * FV_WARPS * FV_STRIDE;
    const int side = lf + j * FV_WARPS * FV_STRIDE;
    const T nb = c[j].cc * self[at - FV_STRIDE] +
                 c[j].dd * self[at + FV_STRIDE] + c[j].aa * other[side] +
                 c[j].bb * other[side + 1];
    self[at] = (c[j].rhs - nb) * inv;
  }
}

// What a from_v block does besides smoothing, fixed at compile time so that
// K2 and K7 carry none of the tower's code: nothing (K2, K7); the descent's
// injection of the residual into the next coarser rhs (K3, RES_INJECT); or
// the ascent's bilinear prolongation of the coarser solution, added to u as
// it is loaded (K4, LOAD_U_PROLONG).
enum FvXfer { FV_SMOOTH = 0, FV_INJECT = 1, FV_PROLONG = 2 };

// What changes between the runs of the block on one level: the iterate it
// starts from and the one it writes, the sweeps, the load and residual
// modes, under SmoothArgs' names.  The tower changes them from link to link
// of a level chained past FV_MAX_SWEEPS; K2 and K7 pass their SmoothArgs.
template <typename T>
struct FvRun {
  const T* u;
  T* u_out;
  int nsweeps, load_mode, res_mode;
};

// One run of the block on tile (ty, tx) of the level `a`, with the iterate,
// sweeps and modes of `run` (a's own for K2 and K7, an FvRun for a link of
// the tower).  Every global array the tower writes in one level phase and
// reads in a later one (the coarser rhs, the coarser solution, a chain's
// iterate) is read by plain loads: nothing here takes the read-only path
// (no __ldg, no const __restrict__ on a global pointer), whose cache does
// not see those writes.
template <typename T, int ACCESS, int XFER = FV_SMOOTH, typename Run>
__device__ void smooth_from_v(const SmoothArgs<T>& a, const Run& run, int ty,
                              int tx) {
  __shared__ T plane[2][(FV_WIN_H + 2) * FV_STRIDE];  // even, odd columns
  const int hr = fv_halo_rows(run.nsweeps), hc = fv_halo_cols(run.nsweeps);
  const int gi0 = ty * (FV_WIN_H - 2 * hr) - hr;
  const int gj0 = tx * (FV_WIN_W - 2 * hc) - hc;
  const int k = threadIdx.x % FV_PAIRS, g = threadIdx.x / FV_PAIRS;
  const int gj = gj0 + 2 * k;  // the thread's columns: gj and gj + 1
  const int cell = (g + 1) * FV_STRIDE + k + 1;
  // the odd column of the thread's pairs is red: rows of g's parity
  const bool odd_red = (gi0 + gj0 + g) & 1;

  for (int q = threadIdx.x; q < 2 * (FV_WIN_H + 2); q += FV_THREADS) {
    T* row = plane[q & 1] + (q >> 1) * FV_STRIDE;
    row[0] = row[FV_STRIDE - 1] = T(0);
  }
  for (int q = threadIdx.x; q < 2 * FV_STRIDE; q += FV_THREADS) {
    plane[q & 1][q >> 1] = plane[q & 1][(FV_WIN_H + 1) * FV_STRIDE + (q >> 1)] =
        T(0);
  }

  // Every global load of the thread is issued before any is used, so
  // they are in flight together: rhs, v1, v2, u and corr (or the
  // prolongation) land in the five slots of the cell, which the
  // coefficients then take over.
  const bool col_in0 = gj >= 0 && gj < a.cols;
  const bool col_in1 = gj + 1 >= 0 && gj + 1 < a.cols;
  FvCell<T> c0[FV_ROWS], c1[FV_ROWS];  // columns gj, gj + 1
#pragma unroll
  for (int j = 0; j < FV_ROWS; ++j) {
    const int gi = gi0 + g + j * FV_WARPS;
    const bool row_in = gi >= 0 && gi < a.rows;
    const bool in0 = row_in && col_in0, in1 = row_in && col_in1;
    const size_t at = row_in ? static_cast<size_t>(gi) * a.cols + gj : 0;
    fv_load<ACCESS>(a.rhs, at, in0, in1, c0[j].rhs, c1[j].rhs);
    fv_load<ACCESS>(a.v1, at, in0, in1, c0[j].aa, c1[j].aa);
    fv_load<ACCESS>(a.v2, at, in0, in1, c0[j].bb, c1[j].bb);
    const bool load_u = run.load_mode != LOAD_ZERO;
    fv_load<ACCESS>(run.u, at, in0 && load_u, in1 && load_u, c0[j].cc,
                   c1[j].cc);
    if constexpr (XFER == FV_SMOOTH) {
      const bool load_corr = run.load_mode == LOAD_U_CORR;
      fv_load<ACCESS>(a.corr, at, in0 && load_corr, in1 && load_corr,
                     c0[j].dd, c1[j].dd);
    } else if constexpr (XFER == FV_PROLONG) {
      // 0 past the array, as u is there (in1 implies in0: gj is even)
      c0[j].dd = c1[j].dd = T(0);
      if (in0 && run.load_mode == LOAD_U_PROLONG) {
        prolong_pair(a.src, a.src_rows, a.src_cols, gi, gj, c0[j].dd,
                     c1[j].dd);
        if (!in1) c1[j].dd = T(0);
      }
    }
  }
  // u + corr (K2, K7) or u + the prolongation (K4), in that order
  const bool add = XFER == FV_PROLONG ? run.load_mode == LOAD_U_PROLONG
                   : XFER == FV_SMOOTH && run.load_mode == LOAD_U_CORR;
  // the interior mask at (gi + row_off, gj), 0 past the array
  const bool col_int0 = col_in0 && gj >= 1 && gj <= a.n - 1;
  const bool col_int1 = col_in1 && gj + 1 >= 1 && gj + 1 <= a.n - 1;
#pragma unroll
  for (int j = 0; j < FV_ROWS; ++j) {
    const int gi = gi0 + g + j * FV_WARPS, row = gi + a.row_off;
    const bool row_int = gi >= 0 && gi < a.rows && row >= 1 && row <= a.n - 1;
    auto form = [&](FvCell<T>& x, bool col_int, T* to) {
      *to = add ? x.cc + x.dd : x.cc;
      const Coefs<T> co = coefs_at(x.aa, x.bb,
                                   row_int && col_int ? T(1) : T(0), a.rr,
                                   a.hh, a.nu);
      x = {x.rhs, co.aa, co.bb, co.cc, co.dd};
    };
    form(c0[j], col_int0, &plane[0][cell + j * FV_WARPS * FV_STRIDE]);
    form(c1[j], col_int1, &plane[1][cell + j * FV_WARPS * FV_STRIDE]);
  }
  __syncthreads();

  // an even-column cell's left neighbour is odd pair k - 1, an odd-column
  // cell's even pair k
  for (int s = 0; s < run.nsweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      if (odd_red != (color == 1)) {
        fv_pass(plane[1], plane[0], c1, cell, cell, a.inv_diag);
      } else {
        fv_pass(plane[0], plane[1], c0, cell, cell - 1, a.inv_diag);
      }
      __syncthreads();
    }
  }

  // write back the tile (window rows [hr, FV_WIN_H - hr), columns [hc,
  // FV_WIN_W - hc): a thread's pair lies inside or outside it whole) and
  // the residual where it is written
  if (2 * k < hc || 2 * k >= FV_WIN_W - hc) return;
  const auto residual = [&](const FvCell<T>& co, const T* self,
                            const T* other, int at, int side) {
    return co.rhs - a.diag * self[at] -
           (co.cc * self[at - FV_STRIDE] + co.dd * self[at + FV_STRIDE] +
            co.aa * other[side] + co.bb * other[side + 1]);
  };
#pragma unroll
  for (int j = 0; j < FV_ROWS; ++j) {
    const int r = g + j * FV_WARPS, gi = gi0 + r;
    if (r < hr || r >= FV_WIN_H - hr || gi >= a.rows) continue;
    const int at = cell + j * FV_WARPS * FV_STRIDE;
    const size_t out = static_cast<size_t>(gi) * a.cols + gj;
    fv_store<ACCESS>(run.u_out, out, col_in0, col_in1, plane[0][at],
                    plane[1][at]);
    if constexpr (XFER == FV_INJECT) {
      // at even (gi, gj) alone, into coarse cell (gi/2, gj/2): neighbouring
      // lanes write neighbouring cells
      const int I = gi >> 1, J = gj >> 1;
      if (run.res_mode != RES_INJECT || (gi & 1) || !col_in0 ||
          I >= a.res_rows || J >= a.res_cols)
        continue;
      a.res_out[static_cast<size_t>(I) * a.res_cols + J] =
          residual(c0[j], plane[0], plane[1], at, at - 1);
    } else if constexpr (XFER == FV_SMOOTH) {
      // every row, or the even rows alone
      if (run.res_mode == RES_NONE ||
          (run.res_mode == RES_ROWS_DEC &&
           ((gi & 1) || (gi >> 1) >= a.res_rows)))
        continue;
      const T res0 = residual(c0[j], plane[0], plane[1], at, at - 1);
      const T res1 = residual(c1[j], plane[1], plane[0], at, at);
      fv_store<ACCESS>(a.res_out,
                      run.res_mode == RES_FULL
                          ? out
                          : static_cast<size_t>(gi >> 1) * a.cols + gj,
                      col_in0, col_in1, res0, res1);
    }
  }
}

// Launch the from_v block over a.rows x a.cols, one block per tile, with
// `paired` (smooth_from_v<T, FV_PAIRED>) where every row of every array
// starts aligned to a pair of values (the window's columns start even),
// else with `singles` (smooth_from_v<T, FV_SINGLES>).  An nsweeps whose
// halo leaves no tile is refused with cudaErrorInvalidValue; returns the
// launch error.
template <typename T>
cudaError_t launch_smooth_from_v(void (*paired)(SmoothArgs<T>),
                                 void (*singles)(SmoothArgs<T>),
                                 const SmoothArgs<T>& a, cudaStream_t stream) {
  if (a.nsweeps < 0) return cudaErrorInvalidValue;
  const int th = fv_tile_rows(a.nsweeps), tw = fv_tile_cols(a.nsweeps);
  if (th < 2 || tw < 2) return cudaErrorInvalidValue;
  const T* arrays[] = {a.u, a.corr, a.rhs, a.v1, a.v2, a.u_out, a.res_out};
  bool aligned = a.cols % 2 == 0;
  for (const T* x : arrays)
    aligned = aligned && reinterpret_cast<size_t>(x) % (2 * sizeof(T)) == 0;
  const dim3 grid((a.cols + tw - 1) / tw, (a.rows + th - 1) / th);
  void (*kernel)(SmoothArgs<T>) = aligned ? paired : singles;
  kernel<<<grid, FV_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// Fill the CN constants of a SmoothArgs from the host's double values.
template <typename T>
void set_constants(SmoothArgs<T>& a, double rr, double hh, double nu,
                   double diag, double inv_diag) {
  a.rr = static_cast<T>(rr);
  a.hh = static_cast<T>(hh);
  a.nu = static_cast<T>(nu);
  a.diag = static_cast<T>(diag);
  a.inv_diag = static_cast<T>(inv_diag);
}

}  // namespace mg
