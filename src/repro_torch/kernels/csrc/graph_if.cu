// IF and WHILE conditional nodes for the superstep loop captured into a
// CUDA graph (the runtime's fused and chunked modes).
//
// Replaces no TPU kernel. The JAX package's device loop puts each
// superstep under `lax.cond(stop, skip, do)`, and the inner loops of a
// superstep (pointer jumping, label propagation, the Propagation
// channel's fixpoints) are `lax.while_loop`s. On the card each captured
// superstep is the body of an IF node, and each inner loop the body of a
// WHILE node nested inside it (or inside another WHILE node), whose
// condition a one-thread kernel sets from a device flag. CUDA 12.4 and
// later build such graphs from stream capture. PyTorch exposes them only
// from release 2.13 on (CUDAGraph.begin_capture_to_if_node); this file is
// the same few runtime calls, with a plain C interface, so the port does
// not depend on the PyTorch release.
//
// graph_if_begin(stream, pred, body): `stream` is capturing a graph (the
// loop's graph, or the body graph of an enclosing node). It captures
// set_condition (reads the bool at `pred` when the graph runs and sets the
// node's condition), adds an IF node after it, makes the node the
// capture's only dependency, and starts capturing the node's body graph on
// `body`, a stream that captures nothing. Work issued to `body` until
// graph_if_end(body) runs only when *pred was true.
//
// graph_while_begin(stream, pred, body, &handle) does the same with a
// WHILE node, and graph_while_end(body, pred, handle) ends the body with
// set_condition from `pred` again before it ends the capture: the body
// runs while *pred holds true, read as the graph reaches the node and at
// the end of each run of the body, which updates *pred. The condition is
// set each time the node is entered, never left to a default, because
// the graph replays many times. All four return a cudaError_t.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

int begin_node(void* stream, const void* pred, void* body,
               cudaGraphConditionalNodeType type,
               cudaGraphConditionalHandle* handle) {
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
  err = cudaGraphConditionalHandleCreate(handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition<<<1, 1, 0, s>>>(*handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the dependencies now end in set_condition's node
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = *handle;
  params.conditional.type = type;
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

}  // namespace

extern "C" int graph_if_begin(void* stream, const void* pred, void* body) {
  cudaGraphConditionalHandle handle;
  return begin_node(stream, pred, body, cudaGraphCondTypeIf, &handle);
}

extern "C" int graph_if_end(void* body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

extern "C" int graph_while_begin(void* stream, const void* pred, void* body,
                                 unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  int err = begin_node(stream, pred, body, cudaGraphCondTypeWhile, &h);
  *handle = h;
  return err;
}

extern "C" int graph_while_end(void* body, const void* pred,
                               unsigned long long handle) {
  cudaStream_t b = static_cast<cudaStream_t>(body);
  set_condition<<<1, 1, 0, b>>>(handle, static_cast<const bool*>(pred));
  cudaError_t launch = cudaGetLastError();
  cudaGraph_t graph;
  cudaError_t err = cudaStreamEndCapture(b, &graph);
  return (int)(launch != cudaSuccess ? launch : err);
}
