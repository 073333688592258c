// IF conditional nodes for the superstep loop captured into a CUDA graph
// (the runtime's fused and chunked modes).
//
// Replaces no TPU kernel. The JAX package's device loop puts each
// superstep under `lax.cond(stop, skip, do)`; on the card that is a CUDA
// graph in which each captured superstep is the body of an IF node whose
// condition a one-thread kernel sets from a device flag just before it.
// CUDA 12.4 and later build such graphs from stream capture. PyTorch
// exposes them only from release 2.13 on (CUDAGraph.begin_capture_to_if_
// node); this file is the same few runtime calls, with a plain C
// interface, so the port does not depend on the PyTorch release.
//
// graph_if_begin(stream, pred, body): `stream` is capturing a graph. It
// captures set_condition (reads the bool at `pred` when the graph runs and
// sets the node's condition), adds an IF node after it, makes the node the
// capture's only dependency, and starts capturing the node's body graph on
// `body`, a stream that captures nothing. Work issued to `body` until
// graph_if_end(body) runs only when *pred was true. Both return a
// cudaError_t.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int graph_if_begin(void* stream, const void* pred, void* body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the dependencies now end in set_condition's node
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeGlobal);
}

extern "C" int graph_if_end(void* body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}
