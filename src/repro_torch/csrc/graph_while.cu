// A device-side while loop inside a CUDA graph: a conditional WHILE node
// (CUDA 12.4+) added to the graph a stream is capturing, whose body is
// captured from a second stream.  The body runs again while a one-byte
// device flag is nonzero; the host never reads the flag.
//
// This is the counterpart of the `lax.while_loop` that the JAX package's
// DAGSA greedy runs inside its fused round (src/repro/core/dagsa_jit.py):
// the port's host loop syncs once a greedy step on `live.any()`, which a
// captured round cannot do.  It computes nothing itself: the one-thread
// kernel below copies the flag into the node's condition.
//
//     graph_while_begin(flag, body_stream, &handle, stream)
//         stream is capturing.  Creates the condition handle, captures a
//         kernel setting it from *flag (the loop's entry test), adds the
//         WHILE node after the stream's current dependencies, makes the
//         node the stream's only dependency and begins capturing
//         body_stream into the node's body graph.
//     graph_while_end(flag, handle, body_stream)
//         captures a kernel setting the condition from *flag (the test
//         after each pass) at the end of the body and ends the body's
//         capture.
//
// The body's allocations and kernels must be issued on body_stream between
// the two calls (the Python side makes it the current stream).
#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// The capture-info and dependency calls gained an edge-data argument in
// CUDA 13 (the 12.x `_v3` / `_v2` forms became the only ones).
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr,
                                  n_deps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n_deps);
#endif
}

}  // namespace

extern "C" int graph_while_begin(const unsigned char* flag, void* body_stream,
                                 unsigned long long* handle_out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition_kernel<<<1, 1, 0, s>>>(handle, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = capture_info(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

extern "C" int graph_while_end(const unsigned char* flag,
                               unsigned long long handle, void* body_stream) {
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  set_condition_kernel<<<1, 1, 0, b>>>(
      static_cast<cudaGraphConditionalHandle>(handle), flag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body;
  err = cudaStreamEndCapture(b, &body);
  return static_cast<int>(err);
}
