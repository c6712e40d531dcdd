// P: the Hopper feature probe, six small float32 kernels.
//
// Replaces the TPU probe scripts/mosaic_probe_tpu.py (run_probe at :39 and
// the six kernels it launches at :58-135), which checked that Mosaic could
// compile the in-kernel primitives a single-launch coarse tower needs:
//
//   stride2_rows       out = x[::2, :]                  (restriction rows)
//   dot_decimate       out = x @ D, D 0/1 (C, C/2)      (restriction columns)
//   interleave_rows    out = stack([x, x + 1], 1).reshape(2R, C) (prolongation)
//   flatten            out = x.reshape(R*C, 1)          (dense coarse solve)
//   dot_decimate_rows  out = Dr @ x, Dr 0/1 (R/2, R)    (rows by a product)
//   dot_prolong_rows   out = P @ x, P (2R, R), 1 and 0.5 weights
//
// On Hopper each is a kernel of its own (never cuBLAS: the probe is of the
// kernel's own arithmetic).  What bounds them: launch latency; at the
// probe's (64, 256) shape every array is under 128 KB.  The two index maps
// give each output element one thread; flatten is a 16-byte copy into a
// buffer of its own; the three products share dot_kernel, which stages its
// operands in shared memory and splits k over eight lanes an output (its
// note below).  The products' operands have one or two nonzeros per row,
// so with -fmad=false and no TF32 every output is exact or one rounding of
// a sum of two exact products, whatever the order of the sum.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__global__ void stride2_rows_kernel(const float* x, float* out, int rows_out,
                                    int cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= rows_out || j >= cols) return;
  out[static_cast<size_t>(i) * cols + j] =
      x[static_cast<size_t>(2 * i) * cols + j];
}

__global__ void interleave_rows_kernel(const float* x, float* out, int rows,
                                       int cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;  // output row
  if (i >= 2 * rows || j >= cols) return;
  const float v = x[static_cast<size_t>(i >> 1) * cols + j];
  out[static_cast<size_t>(i) * cols + j] = (i & 1) ? v + 1.0f : v;
}

// flatten: a copy of x's count values into a buffer of their own (the TPU
// kernel writes a fresh (R*C, 1) output; run_probe gives its pallas_call no
// input_output_aliases).  Bound by bytes, and at the probe's 64 KB by the
// launch: one 16-byte copy a thread (4,096 for the probe) where both
// pointers are 16-byte aligned, then one scalar copy a thread for the
// count % 4 values left (or for every value of an unaligned pointer).
__global__ void flatten_kernel(const float4* __restrict__ x4,
                               float4* __restrict__ out4,
                               const float* __restrict__ x,
                               float* __restrict__ out, int n4, int count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n4) {
    out4[t] = x4[t];
  } else {
    const int e = 4 * n4 + (t - n4);
    if (e < count) out[e] = x[e];
  }
}

// dot: c (m x n) = a (m x k) @ b (k x n), row-major, float32 on the CUDA
// cores.  No TF32 and no tensor cores: TF32 keeps 10 bits of x's mantissa,
// so x @ D would no longer be x's columns; a three-way TF32 split would be
// exact but buys nothing at the probe's 4.2 MFLOP, where the launch is the
// floor.  Built with -fmad=false: every product is rounded, then added.
//
// A block computes a DOT_TM x DOT_TN tile of c with DOT_THREADS threads:
// warp w holds row i0 + w; lane g * DOT_CW + t is lane g of the DOT_CV
// columns j0 + DOT_CV t .. j0 + DOT_CV t + DOT_CV - 1, so each output has
// DOT_G lanes of one warp and each lane keeps DOT_CV sums, one a column.
//
// The order of each output's sum, fixed: with L = ceil(k / DOT_G), lane g
// sums a[i, q] * b[q, j] over its contiguous range q in
// [g L, min((g+1) L, k)) in increasing q, from +0; the DOT_G = 8 partial
// sums s_0..s_7 are then combined by __shfl_xor_sync at lane distances
// 16, 8, 4 (g distances 4, 2, 1), which gives
// ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7)) (float addition
// commutes, so every lane of the group holds that value).  No atomics and
// no split across blocks: the result is the same in every run.
// ops/cuda/probe.py::dot_in_kernel_order repeats this order in PyTorch.
//
// Staging: a pass copies, for every lane g, the next DOT_LC values of its
// range from the block's DOT_TM rows of a and DOT_TN columns of b into
// shared memory; each thread issues all its loads of the pass (16-byte
// where k % 32 == 0, n % 4 == 0 and both pointers are 16-byte aligned,
// else 4-byte) before it stores any, and no value is used before the
// whole tile is in (one barrier).  k <= 256 takes one pass: 21,504 bytes of
// static shared memory, under the 48 KB past which a launch would need
// cudaFuncAttributeMaxDynamicSharedMemorySize.  Each lane's range is a
// padded row of the tile (as: DOT_LC + 4 floats, bs: DOT_LC + 1 float4 of
// DOT_CV columns), so the staging stores and the reads of a pass are free
// of bank conflicts: a warp reads one a value per g (broadcast over its
// columns) and eight distinct 16-byte groups of b per quarter-warp.
constexpr int DOT_G = 8;    // lanes per output
constexpr int DOT_TM = 4;   // output rows per block, one warp each
constexpr int DOT_CW = 4;   // column groups per warp
constexpr int DOT_CV = 4;   // columns per lane (one float4)
constexpr int DOT_TN = DOT_CW * DOT_CV;  // 16 output columns per block
constexpr int DOT_LC = 32;  // values of each lane's range staged per pass
constexpr int DOT_THREADS = DOT_TM * 32;  // 128
constexpr int DOT_AP = DOT_LC + 4;  // padded a row of one lane, in floats
constexpr int DOT_BP = DOT_LC + 1;  // padded b rows of one lane, in float4
static_assert(DOT_G * DOT_CW == 32 && DOT_CV == 4, "a warp holds a row");

struct DotTile {
  float as[DOT_TM][DOT_G][DOT_AP];       // a[i0 + r, g L + base + jj]
  float4 bs[DOT_G][DOT_BP][DOT_CW];      // b[g L + base + jj, j0 + 4 t ..]
};

// Stage pass `base` (the values base .. base + DOT_LC - 1 of every lane's
// range) of the block's tile; zero where the tile runs past a or b.
template <bool VEC>
__device__ __forceinline__ void dot_stage(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          DotTile& tile, int m, int k, int n,
                                          int L, int base, int i0, int j0) {
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (VEC) {
    // a: DOT_TM x DOT_G x DOT_LC / 4 float4; b: DOT_G x DOT_LC x DOT_CW
    // float4.  L % 4 == 0, k % 4 == 0 and n % 4 == 0, so a float4 lies
    // wholly inside or outside a range and the array.
    constexpr int A4 = DOT_TM * DOT_G * DOT_LC / 4 / DOT_THREADS;
    constexpr int B4 = DOT_G * DOT_LC * DOT_CW / DOT_THREADS;
    float4 ra[A4], rb[B4];
#pragma unroll
    for (int e = 0; e < A4; ++e) {
      const int f = tid + e * DOT_THREADS;
      const int jj = 4 * (f % (DOT_LC / 4)), g = (f / (DOT_LC / 4)) % DOT_G;
      const int r = f / (DOT_G * DOT_LC / 4);
      const int q = g * L + base + jj;
      ra[e] = (i0 + r < m && base + jj < L && q < k)
                  ? *reinterpret_cast<const float4*>(
                        a + static_cast<size_t>(i0 + r) * k + q)
                  : zero;
    }
#pragma unroll
    for (int e = 0; e < B4; ++e) {
      const int f = tid + e * DOT_THREADS;
      const int t = f % DOT_CW, jj = (f / DOT_CW) % DOT_LC;
      const int g = f / (DOT_CW * DOT_LC);
      const int q = g * L + base + jj;
      rb[e] = (base + jj < L && q < k && j0 + DOT_CV * t < n)
                  ? *reinterpret_cast<const float4*>(
                        b + static_cast<size_t>(q) * n + j0 + DOT_CV * t)
                  : zero;
    }
#pragma unroll
    for (int e = 0; e < A4; ++e) {
      const int f = tid + e * DOT_THREADS;
      const int jj = 4 * (f % (DOT_LC / 4)), g = (f / (DOT_LC / 4)) % DOT_G;
      *reinterpret_cast<float4*>(&tile.as[f / (DOT_G * DOT_LC / 4)][g][jj]) =
          ra[e];
    }
#pragma unroll
    for (int e = 0; e < B4; ++e) {
      const int f = tid + e * DOT_THREADS;
      tile.bs[f / (DOT_CW * DOT_LC)][(f / DOT_CW) % DOT_LC][f % DOT_CW] =
          rb[e];
    }
  } else {
    constexpr int AS = DOT_TM * DOT_G * DOT_LC / DOT_THREADS;
    constexpr int BS = DOT_G * DOT_LC * DOT_TN / DOT_THREADS;
    float ra[AS], rb[BS];
#pragma unroll
    for (int e = 0; e < AS; ++e) {
      const int f = tid + e * DOT_THREADS;
      const int jj = f % DOT_LC, g = (f / DOT_LC) % DOT_G;
      const int r = f / (DOT_G * DOT_LC);
      const int q = g * L + base + jj;
      ra[e] = (i0 + r < m && base + jj < L && q < k)
                  ? a[static_cast<size_t>(i0 + r) * k + q]
                  : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BS; ++e) {
      const int f = tid + e * DOT_THREADS;
      const int col = f % DOT_TN, jj = (f / DOT_TN) % DOT_LC;
      const int g = f / (DOT_TN * DOT_LC);
      const int q = g * L + base + jj;
      rb[e] = (base + jj < L && q < k && j0 + col < n)
                  ? b[static_cast<size_t>(q) * n + j0 + col]
                  : 0.f;
    }
#pragma unroll
    for (int e = 0; e < AS; ++e) {
      const int f = tid + e * DOT_THREADS;
      tile.as[f / (DOT_G * DOT_LC)][(f / DOT_LC) % DOT_G][f % DOT_LC] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < BS; ++e) {
      const int f = tid + e * DOT_THREADS;
      const int col = f % DOT_TN;
      reinterpret_cast<float*>(
          &tile.bs[f / (DOT_TN * DOT_LC)][(f / DOT_TN) % DOT_LC]
                  [col / DOT_CV])[col % DOT_CV] = rb[e];
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(DOT_THREADS)
    dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int m, int k, int n) {
  __shared__ DotTile tile;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane / DOT_CW, t = lane % DOT_CW;
  const int i0 = blockIdx.y * DOT_TM, j0 = blockIdx.x * DOT_TN;
  const int L = (k + DOT_G - 1) / DOT_G;
  float s[DOT_CV] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = 0; base < L; base += DOT_LC) {
    if (base > 0) __syncthreads();  // the last pass's reads are done
    dot_stage<VEC>(a, b, tile, m, k, n, L, base, i0, j0);
    __syncthreads();
    const int len = min(DOT_LC, L - base);
    for (int jj = 0; jj < len; ++jj) {
      const float av = tile.as[w][g][jj];
      const float4 bv = tile.bs[g][jj][t];
      s[0] = s[0] + av * bv.x;
      s[1] = s[1] + av * bv.y;
      s[2] = s[2] + av * bv.z;
      s[3] = s[3] + av * bv.w;
    }
  }
#pragma unroll
  for (int d = 16; d >= DOT_CW; d /= 2)
#pragma unroll
    for (int e = 0; e < DOT_CV; ++e)
      s[e] = s[e] + __shfl_xor_sync(0xffffffffu, s[e], d);
  // every lane g of a column group holds its four sums; lane g < 4 writes
  // column g of the group
  const int i = i0 + w, j = j0 + DOT_CV * t + g;
  if (g < DOT_CV && i < m && j < n) {
    float v = s[0];
#pragma unroll
    for (int e = 1; e < DOT_CV; ++e)
      if (g == e) v = s[e];
    c[static_cast<size_t>(i) * n + j] = v;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

dim3 grid_for(int rows, int cols, dim3 block) {
  return dim3((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
}

}  // namespace

extern "C" int mg_probe_stride2_rows(const float* x, float* out, int rows,
                                     int cols, cudaStream_t stream) {
  const dim3 block(32, 8);
  stride2_rows_kernel<<<grid_for(rows / 2, cols, block), block, 0, stream>>>(
      x, out, rows / 2, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_probe_interleave_rows(const float* x, float* out, int rows,
                                        int cols, cudaStream_t stream) {
  const dim3 block(32, 8);
  interleave_rows_kernel<<<grid_for(2 * rows, cols, block), block, 0,
                           stream>>>(x, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_probe_flatten(const float* x, float* out, int count,
                                cudaStream_t stream) {
  if (count <= 0) return 0;
  const int n4 = aligned16(x) && aligned16(out) ? count / 4 : 0;
  const int items = n4 + (count - 4 * n4);
  flatten_kernel<<<(items + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), x,
      out, n4, count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_probe_dot(const float* a, const float* b, float* c, int m,
                            int k, int n, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + DOT_TN - 1) / DOT_TN, (m + DOT_TM - 1) / DOT_TM);
  if (k % (4 * DOT_G) == 0 && n % 4 == 0 && aligned16(a) && aligned16(b))
    dot_kernel<true><<<grid, DOT_THREADS, 0, stream>>>(a, b, c, m, k, n);
  else
    dot_kernel<false><<<grid, DOT_THREADS, 0, stream>>>(a, b, c, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
