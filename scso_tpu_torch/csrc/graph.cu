// Conditional nodes in a CUDA graph that PyTorch is capturing: the device
// side of ops/cuda/graph.py::device_if and device_loop. Not a port of any
// TPU kernel: it is what the JAX package's lax.while_loop and lax.cond
// compile to, a branch or a loop taken on the device.
//
// scso_graph_cond_begin, with `parent` capturing: launch a one-thread
// kernel that sets a new conditional handle from the bool at `pred`, add
// an IF node (or a WHILE node) on that handle after it, make the node the
// parent's capture dependency, and start capturing `child` into the
// node's body graph. The caller then enqueues the body on `child` and
// calls scso_graph_cond_end, which ends that capture; for a WHILE node it
// first appends the same one-thread kernel on the body's `pred`, so that
// the body runs again while `pred` holds. Nested calls nest: a body
// captured on one child stream may begin a conditional of its own.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorIllegalState;
}

}  // namespace

extern "C" int scso_graph_cond_begin(void* parent, const void* pred,
                                     void* child, int is_while,
                                     uint64_t* handle_out) {
  auto p = static_cast<cudaStream_t>(parent);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(p, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = static_cast<uint64_t>(handle);
  set_conditional<<<1, 1, 0, p>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies now end at the kernel just captured
  err = capture_info(p, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      p, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(p, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(child), body,
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeGlobal);
  return static_cast<int>(err);
}

// End the body's capture; `nodes` gets the body graph's node count (a
// nested conditional counts once here, its own body at its own end). A
// non-null `pred` (a WHILE node's) is read into `handle` at the body's
// end.
extern "C" int scso_graph_cond_end(void* child, uint64_t handle,
                                   const void* pred, int64_t* nodes) {
  auto c = static_cast<cudaStream_t>(child);
  *nodes = 0;
  if (pred != nullptr) {
    set_conditional<<<1, 1, 0, c>>>(
        static_cast<cudaGraphConditionalHandle>(handle),
        static_cast<const bool*>(pred));
    cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) {
      cudaGraph_t dropped = nullptr;
      cudaStreamEndCapture(c, &dropped);
      return static_cast<int>(launched);
    }
  }
  cudaGraph_t body = nullptr;
  cudaError_t err = cudaStreamEndCapture(c, &body);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (body == nullptr) return static_cast<int>(cudaErrorIllegalState);
  size_t n = 0;
  err = cudaGraphGetNodes(body, nullptr, &n);
  *nodes = static_cast<int64_t>(n);
  return static_cast<int>(err);
}

// The node count of a graph's top level (a conditional counts once).
extern "C" int scso_graph_nodes(void* graph, int64_t* nodes) {
  size_t n = 0;
  cudaError_t err =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *nodes = static_cast<int64_t>(n);
  return static_cast<int>(err);
}
