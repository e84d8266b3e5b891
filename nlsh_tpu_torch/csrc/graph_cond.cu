// CUDA-graph conditional nodes for a stream capture: the port's
// counterpart of jax.lax.cond inside a compiled program.
//
// torch.cuda.CUDAGraph gained begin_capture_to_if_node in later releases;
// this file gives the same three steps through CUDA's own API, for a torch
// that lacks them.  The caller (nlsh_tpu_torch/utils/graphs.py `cond`) is
// inside a capture on `stream`:
//   1. nlsh_cond_handles: two conditional handles on the graph `stream`
//      captures into, and a one-thread kernel, captured on `stream`, that
//      sets them from the device bool *pred at every replay: the first to
//      pred, the second to !pred.
//   2. nlsh_cond_begin: an IF node on a handle, after `stream`'s current
//      dependencies, made its only dependency; `body` then captures into
//      the node's body graph (thread-local mode), so the kernels and torch
//      ops the caller launches on `body` run only where the handle is set.
//   3. nlsh_cond_end: ends `body`'s capture and gives the body graph's
//      node count.  The next node on `stream` follows the IF node.
// nlsh_graph_nodes gives the node count of the graph `stream` captures
// into so far (conditional bodies not included): utils/graphs.py `capture`
// reads it as the capture's last step, since a replay's host launch time
// grows with the nodes.
// nlsh_cond_stream makes the `body` stream: one of its own, never one of
// torch's pool, which hands its streams round and could hand out the
// capturing stream itself.
// Two IF nodes on (pred, !pred) stand for one IF-ELSE node, which needs
// CUDA 12.8 everywhere; IF nodes need 12.4.  Every entry returns a
// cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditionals(cudaGraphConditionalHandle when_true,
                                 cudaGraphConditionalHandle when_false,
                                 const bool* pred) {
  const bool p = *pred;
  cudaGraphSetConditional(when_true, p ? 1u : 0u);
  cudaGraphSetConditional(when_false, p ? 0u : 1u);
}

cudaError_t capturing_graph(cudaStream_t stream, cudaGraph_t* graph,
                            const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureInvalidated;
}

}  // namespace

extern "C" {

int nlsh_cond_handles(cudaStream_t stream, const void* pred,
                      unsigned long long* handles) {
  cudaGraph_t graph;
  cudaError_t err = capturing_graph(stream, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle h[2];
  for (int i = 0; i < 2; ++i) {
    err = cudaGraphConditionalHandleCreate(&h[i], graph, 0, 0);
    if (err != cudaSuccess) return err;
    handles[i] = h[i];
  }
  set_conditionals<<<1, 1, 0, stream>>>(h[0], h[1],
                                        static_cast<const bool*>(pred));
  return cudaGetLastError();
}

int nlsh_cond_begin(cudaStream_t stream, unsigned long long handle,
                    cudaStream_t body) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capturing_graph(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

int nlsh_cond_stream(cudaStream_t* body) {
  return cudaStreamCreateWithFlags(body, cudaStreamNonBlocking);
}

int nlsh_cond_end(cudaStream_t body, unsigned long long* nodes) {
  cudaGraph_t graph;
  cudaError_t err = cudaStreamEndCapture(body, &graph);
  if (err != cudaSuccess) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = n;
  return err;
}

int nlsh_graph_nodes(cudaStream_t stream, unsigned long long* nodes) {
  cudaGraph_t graph;
  cudaError_t err = capturing_graph(stream, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = n;
  return err;
}

}  // extern "C"
