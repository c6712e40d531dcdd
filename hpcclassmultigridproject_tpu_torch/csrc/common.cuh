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

// Output tile of one smoothing block, and its thread count.
constexpr int TILE_H = 32;
constexpr int TILE_W = 32;
constexpr int SMOOTH_THREADS = 256;

// How a smoothing block forms the starting iterate of each window cell.
enum LoadMode {
  LOAD_ZERO = 0,       // u = 0 (correction solves, the delta opening)
  LOAD_U = 1,          // u
  LOAD_U_CORR = 2,     // u + corr (the prolonged correction, post-smooth)
  LOAD_U_PROLONG = 3,  // u + bilinear prolongation of a coarser field
};

// What it writes of the trailing residual rhs - A u.
enum ResMode {
  RES_NONE = 0,
  RES_FULL = 1,      // (rows, cols)
  RES_ROWS_DEC = 2,  // even global rows only, (rows / 2, cols)
  RES_INJECT = 3,    // coarse[I, J] = res[2I, 2J], 0 past the fine array
};

// Where a smoothing block takes the stencil coefficients from.
enum CoefForm {
  FORM_FROM_V = 0,  // recomputed from (v1, v2): the CN levels (K2, K3, K4)
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
  int dom_rows, dom_cols;  // extent the tiles cover: the array, or more
                           // where RES_INJECT has coarse cells past it
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

// Bilinear prolongation of the coarse field c at fine node (i, j): rows
// first, then columns, as ops/padded.py::prolong_bilinear interleaves them.
template <typename T>
__device__ __forceinline__ T prolong_at(const T* c, int rows_c, int cols_c,
                                        int i, int j) {
  const int I = i >> 1, J = j >> 1;
  const T half = T(0.5);
  const T c00 = at_or_zero(c, rows_c, cols_c, I, J);
  if (!(i & 1) && !(j & 1)) return c00;
  const T c10 = at_or_zero(c, rows_c, cols_c, I + 1, J);
  if (!(j & 1)) return half * (c00 + c10);
  const T c01 = at_or_zero(c, rows_c, cols_c, I, J + 1);
  if (!(i & 1)) return half * (c00 + c01);
  const T c11 = at_or_zero(c, rows_c, cols_c, I + 1, J + 1);
  return half * (half * (c00 + c10) + half * (c01 + c11));
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
      } else if (a.load_mode == LOAD_U_PROLONG) {
        u = a.u[g] + prolong_at(a.src, a.src_rows, a.src_cols, gi, gj);
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
    } else if (a.res_mode == RES_INJECT) {
      const int I = gi >> 1, J = gj >> 1;
      if (!(gi & 1) && !(gj & 1) && I < a.res_rows && J < a.res_cols)
        a.res_out[static_cast<size_t>(I) * a.res_cols + J] = res;
    }
  }
}

// Launch one smoothing pass over the tiles of a.dom_rows x a.dom_cols with
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
  const dim3 grid((a.dom_cols + TILE_W - 1) / TILE_W,
                  (a.dom_rows + TILE_H - 1) / TILE_H);
  kernel<<<grid, SMOOTH_THREADS, smem, stream>>>(a);
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
