// CUDA graph conditional nodes for Hopper (sm_90a): the device branch of
// `core/graph.py:cond` and of the planners' guarded block chains.
//
// Counterpart of JAX's `lax.cond` / `lax.while_loop` inside one compiled
// program (slam_tpu/ops/edt.py:365, slam_tpu/models/mcl.py:331, the
// planners' while loops): under a stream capture, `graph_cond_begin` adds
// to the graph being captured
//
//   1. a one-thread kernel that reads a device bool and sets the node's
//      conditional handle from it (`cudaGraphSetConditional`), and
//   2. a conditional node behind it: IF runs its body graph once when the
//      handle is nonzero at that point of the replay; WHILE runs it while
//      the handle is nonzero, the body setting the handle again at its
//      end (`graph_cond_set`, captured into the body),
//
// then makes the node the capture's only dependency, so whatever the
// stream captures next runs after it. The body is filled by capturing a
// second stream into it (`cudaStreamBeginCaptureToGraph`; ended by
// `graph_cond_end`).
//
// A body may hold kernels, copies and memsets on device memory, and other
// conditional nodes; no event nodes and no allocation nodes, so the
// caller keeps every buffer in the enclosing graph's memory pool. CUDA
// 12.8 refuses a child-graph node in a body (cudaErrorNotSupported), so a
// body cannot be a copy of another: each is captured.
//
// The launchers return a cudaError_t code (0 on success); a stream that
// is not capturing returns cudaErrorStreamCaptureUnmatched.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const bool* pred, int invert) {
  const bool v = *pred;
  cudaGraphSetConditional(handle, (invert ? !v : v) ? 1u : 0u);
}

}  // namespace

// Add [set kernel] -> [conditional node on *pred (or on !*pred with
// invert); IF with loop 0, WHILE with loop 1] to the graph `parent` is
// capturing. *body receives the node's body graph and *handle its
// conditional handle; `child` then captures into that body until
// `graph_cond_end(child)`.
extern "C" int graph_cond_begin(void* parent, const void* pred, int invert, int loop,
                                void* child, void** body, unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureUnmatched;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred), invert);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The set kernel is now the capture's dependency: the node follows it.
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  cudaGraph_t b = params.conditional.phGraph_out[0];
  *body = b;
  *handle_out = handle;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(child), b, nullptr, nullptr,
                                       0, cudaStreamCaptureModeRelaxed);
}

// Launch the set kernel for `handle` from *pred on `stream`: captured at
// the end of a WHILE body, it decides whether the body runs again.
extern "C" int graph_cond_set(unsigned long long handle, const void* pred, void* stream) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const bool*>(pred), 0);
  return cudaGetLastError();
}

// A stream of its own for capturing bodies (*out): torch hands out its
// pooled streams round robin, so a pooled one may be the stream whose
// capture the body belongs to. Never destroyed: a process keeps one a
// nesting depth.
extern "C" int graph_cond_stream(void** out) {
  cudaStream_t s = nullptr;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return err;
}

// End `child`'s capture into the body `graph_cond_begin` gave it.
extern "C" int graph_cond_end(void* child) {
  cudaGraph_t g = nullptr;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &g);
}
