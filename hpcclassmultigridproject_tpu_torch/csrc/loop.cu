// The device half of the port's while loop (utils/graphs.py::while_loop):
// a CUDA conditional WHILE node in a captured graph, the counterpart of the
// `while` that XLA makes of the JAX package's `lax.while_loop` (the
// adaptive solvers: mg/cycle.py mg_solve and coarse_solve_gs, mg/refine.py,
// models/poisson.py _jit_gs).  It replaces no pl.pallas_call: on the TPU
// the loop is XLA's own, with its predicate read on the device.
//
// One kernel, `while_set_kernel`, launched by the wrapper
// ops/cuda/loop.py::while_set once before the node (the first test) and
// once at the end of the node's body (each later test): one thread reads
// the loop's predicate, a device bool that the loop's cond computed with the
// same torch expression as the host form, sets the node's condition to it
// (cudaGraphSetConditional), and where it holds counts one trip, so that a
// replay's data-dependent launch counts can be read back after it.  It
// moves one byte in and four out and does one add: it is bound by the
// launch, and the design keeps it to one block of one thread with no shared
// memory.
//
// The host half, plain C called through ctypes with torch's stream handle
// (as utils/graphs.py already calls libcuda): mg_while_handle creates the
// node's handle on the graph the stream is capturing into; mg_while_begin
// adds the conditional node after the stream's current dependencies, moves
// the stream past it, and begins capturing the node's body graph on a
// second stream; mg_while_end ends that capture.  Nested loops nest: the
// inner node goes into the graph the body stream is capturing into.

#include <cuda_runtime.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12040
#error "nested conditional WHILE nodes built by stream capture need CUDA 12.4"
#endif

namespace {

__global__ void while_set_kernel(cudaGraphConditionalHandle handle,
                                 const bool* pred, int* trips) {
  const bool go = *pred;
  cudaGraphSetConditional(handle, go ? 1u : 0u);
  if (go) *trips += 1;
}

// The graph `stream` is capturing into, and the capture's current
// dependencies; cudaErrorStreamCaptureImplicit where it is not capturing.
cudaError_t capturing_into(cudaStream_t stream, cudaGraph_t* graph,
                           const cudaGraphNode_t** deps, size_t* count) {
  cudaStreamCaptureStatus status;
  const cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr,
                                                   graph, deps, count);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int mg_while_set(unsigned long long handle, const void* pred,
                            void* trips, void* stream) {
  while_set_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const bool*>(pred), static_cast<int*>(trips));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_while_handle(void* stream, unsigned long long* handle) {
  cudaGraph_t graph;
  cudaError_t err = capturing_into(static_cast<cudaStream_t>(stream), &graph,
                                   nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle made;
  err = cudaGraphConditionalHandleCreate(&made, graph, 0, 0);
  *handle = made;
  return static_cast<int>(err);
}

extern "C" int mg_while_begin(void* stream, unsigned long long handle,
                              void* body_stream, void** body_graph) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t count = 0;
  cudaError_t err = capturing_into(st, &graph, &deps, &count);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, count, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  *body_graph = body;
  // thread-local, as utils/graphs.py's captures: a global capture would
  // also refuse the CUDA calls of ProcessGroupNCCL's watchdog thread
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

extern "C" int mg_while_end(void* body_stream) {
  cudaGraph_t graph = nullptr;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph));
}
