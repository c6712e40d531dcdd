// Device code shared by the port's kernels: the CN coefficient recompute,
// the red-black Gauss-Seidel cascade on a shared-memory window, and the
// per-point bilinear prolongation.
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

template <typename T>
struct SmoothArgs {
  const T* u;       // LOAD_U, LOAD_U_CORR, LOAD_U_PROLONG
  const T* corr;    // LOAD_U_CORR
  const T* src;     // LOAD_U_PROLONG: the coarser field, (src_rows, src_cols)
  const T* rhs;
  const T* v1;
  const T* v2;
  T* u_out;         // (rows, cols)
  T* res_out;       // (res_rows, res_cols), unless RES_NONE
  int rows, cols, n, nsweeps;
  int src_rows, src_cols, res_rows, res_cols;
  int dom_rows, dom_cols;  // extent the tiles cover: the array, or more
                           // where RES_INJECT has coarse cells past it
  int load_mode, res_mode;
  T rr, hh, nu, diag, inv_diag;  // CN constants, rounded to T on the host
};

template <typename T>
__device__ __forceinline__ T interior_at(int gi, int gj, int n) {
  return (gi >= 1 && gi <= n - 1 && gj >= 1 && gj <= n - 1) ? T(1) : T(0);
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

// Shared memory of one smoothing block: four (wh, ww) planes of T.
inline size_t smooth_smem_bytes(int nsweeps, size_t elem) {
  const int halo = 2 * nsweeps + 1;
  return 4 * static_cast<size_t>(TILE_H + 2 * halo) * (TILE_W + 2 * halo) *
         elem;
}

// One block: `nsweeps` red-black sweeps and the trailing residual for one
// TILE_H x TILE_W output tile.  The block loads a window with a halo of
// 2*nsweeps+1 cells on every side, runs all 2*nsweeps color passes in
// shared memory, and writes the tile.  A window cell whose neighbour lies
// past the window reads 0 there; the error that makes moves in one cell per
// pass, so after the cascade and the residual it has not reached the tile,
// which therefore holds exactly what a global barrier between colors would
// give.  Cells past the array are 0 and stay 0, since their coefficients
// and rhs are 0: that is the truth at the array's edges.  Red is (i+j) even
// in global indices; a color pass reads only the other color, so it updates
// in place.
template <typename T>
__device__ void smooth_tile(const SmoothArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char mg_smem[];
  const int halo = 2 * a.nsweeps + 1;
  const int wh = TILE_H + 2 * halo, ww = TILE_W + 2 * halo;
  const int wsize = wh * ww;
  T* su = reinterpret_cast<T*>(mg_smem);
  T* srhs = su + wsize;
  T* sv1 = srhs + wsize;
  T* sv2 = sv1 + wsize;
  const int ti0 = blockIdx.y * TILE_H, tj0 = blockIdx.x * TILE_W;
  const int gi0 = ti0 - halo, gj0 = tj0 - halo;
  const int tid = threadIdx.x, nth = blockDim.x;

  for (int k = tid; k < wsize; k += nth) {
    const int r = k / ww, c = k - r * ww;
    const int gi = gi0 + r, gj = gj0 + c;
    T u = T(0), rhs = T(0), v1 = T(0), v2 = T(0);
    if (gi >= 0 && gi < a.rows && gj >= 0 && gj < a.cols) {
      const size_t g = static_cast<size_t>(gi) * a.cols + gj;
      rhs = a.rhs[g];
      v1 = a.v1[g];
      v2 = a.v2[g];
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
    sv1[k] = v1;
    sv2[k] = v2;
  }
  __syncthreads();

  const int half = (ww + 1) / 2;  // cells of one color in a window row, at most
  for (int p = 0; p < 2 * a.nsweeps; ++p) {
    const int color = p & 1;
    for (int k = tid; k < wh * half; k += nth) {
      const int r = k / half;
      const int c = 2 * (k - r * half) + ((gi0 + r + gj0 + color) & 1);
      if (c >= ww) continue;
      const int idx = r * ww + c;
      const Coefs<T> co = coefs_at(sv1[idx], sv2[idx],
                                   interior_at<T>(gi0 + r, gj0 + c, a.n),
                                   a.rr, a.hh, a.nu);
      su[idx] = (srhs[idx] - nb_at(su, r, c, wh, ww, co)) * a.inv_diag;
    }
    __syncthreads();
  }

  for (int k = tid; k < TILE_H * TILE_W; k += nth) {
    const int tr = k / TILE_W, tc = k - tr * TILE_W;
    const int gi = ti0 + tr, gj = tj0 + tc;
    const int r = tr + halo, c = tc + halo, idx = r * ww + c;
    const bool in = gi < a.rows && gj < a.cols;
    const size_t g = static_cast<size_t>(gi) * a.cols + gj;
    if (in) a.u_out[g] = su[idx];
    if (a.res_mode == RES_NONE) continue;
    T res = T(0);
    if (in) {
      const Coefs<T> co = coefs_at(sv1[idx], sv2[idx],
                                   interior_at<T>(gi, gj, a.n), a.rr, a.hh,
                                   a.nu);
      res = srhs[idx] - a.diag * su[idx] - nb_at(su, r, c, wh, ww, co);
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
// `kernel`, a __global__ wrapper of smooth_tile.  Returns the launch error.
template <typename T>
cudaError_t launch_smooth(void (*kernel)(SmoothArgs<T>), const SmoothArgs<T>& a,
                          cudaStream_t stream) {
  const size_t smem = smooth_smem_bytes(a.nsweeps, sizeof(T));
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
