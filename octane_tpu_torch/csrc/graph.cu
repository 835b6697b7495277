// CUDA-graph IF nodes for the captured pair (flow.variational.FlowProgram).
//
// The counterpart of the device-side stopping tests of the JAX package:
// lax.while_loop's condition in octane_tpu/ops/pallas/cg.py:306-320 and
// lax.while_loop + lax.cond in octane_tpu/ops/pallas/sor.py:512-525.  A
// relaxer's iteration runs in the body of an IF node whose condition a
// one-thread kernel sets from a device bool (resid > tol) when the graph
// replays, so no host read stands between the first launch of a pair and
// its result.  This is not the port of a Pallas kernel: it is launch
// machinery, one 1-thread launch per guarded iteration.
//
// octane_if_begin(stream, pred, body_stream): ``stream`` is capturing a
// graph.  Capture on it the kernel that sets the condition from *pred, add
// an IF node after it, make the node the stream's only capture dependency,
// and start capturing ``body_stream`` (not capturing) into the node's body.
// octane_if_end(body_stream) ends the body's capture.  Both return a
// cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, ndeps);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, ndeps);
#endif
  if (e == cudaSuccess && status != cudaStreamCaptureStatusActive) {
    e = cudaErrorStreamCaptureImplicit;
  }
  return e;
}

}  // namespace

extern "C" int octane_if_begin(void* stream, const void* pred, void* body_stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = capture_info(s, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_if<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = capture_info(s, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int octane_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
