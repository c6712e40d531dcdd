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
// On Hopper each is an index map or a product computed by a per-thread dot
// loop (never cuBLAS: the probe is of the kernel's own arithmetic): one
// thread per output element.  What bounds them: launch latency; at the
// probe's (64, 256) shape every array is under 128 KB.  The products'
// operands have one or two nonzeros per row, so with -fmad=false and no
// TF32 every output is exact or one rounding of a sum of two exact products,
// whatever the order of the sum.

#include <cuda_runtime.h>

#include <cstddef>

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

__global__ void flatten_kernel(const float* x, float* out, int count) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < count) out[k] = x[k];
}

// c (m x n) = a (m x k) @ b (k x n), row-major; the sum runs over k in order
__global__ void dot_kernel(const float* a, const float* b, float* c, int m,
                           int k, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= m || j >= n) return;
  float s = 0.0f;
  for (int q = 0; q < k; ++q)
    s += a[static_cast<size_t>(i) * k + q] * b[static_cast<size_t>(q) * n + j];
  c[static_cast<size_t>(i) * n + j] = s;
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
  flatten_kernel<<<(count + 255) / 256, 256, 0, stream>>>(x, out, count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_probe_dot(const float* a, const float* b, float* c, int m,
                            int k, int n, cudaStream_t stream) {
  const dim3 block(32, 8);
  dot_kernel<<<grid_for(m, n, block), block, 0, stream>>>(a, b, c, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
