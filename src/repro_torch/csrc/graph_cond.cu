// Conditional execution inside one CUDA graph, for Hopper (sm_90a): the
// counterpart of the reference's `jax.lax.cond` in a single-dispatch round.
//
// Replaces: the runtime skips of src/repro/core/engine.py (the draft scan in
// `chain_round`, l.1083, and `tree_round`, l.1200; `prefill_chunk_stage`,
// l.1000). XLA lowers each to a predicated branch of one executable; here a
// round is assembled from segment graphs that PyTorch captured (each a
// `cudaGraph_t`), and a segment that the reference runs under `lax.cond`
// sits behind an IF node of the assembled graph:
//
//   child(segment 0) -> set_cond(h, pred) -> IF h { child(segment 1) } -> child(segment 2) ...
//
// `set_cond` is the one kernel of this file: one thread reads the device
// predicate that the previous segment wrote (a bool or an int32 scalar) and
// sets the IF node's condition with `cudaGraphSetConditional`. The handle is
// created with `cudaGraphCondAssignDefault` and default 0, so every launch
// starts from "skip" and a launch that wrote no value skips.
//
// Bound on the H100: one byte read and one scalar write; what it costs is a
// kernel node's launch latency (a few microseconds), against the tens of
// milliseconds of device time a skipped draft body saves.
//
// Body rules (CUDA >= 12.4): a conditional body holds kernel, memset,
// device-to-device memcpy, child-graph, empty and conditional nodes only; the
// segments PyTorch captures are kernels (cuBLAS included) and device copies
// from one stream into its private memory pool. `cudaGraphAddChildGraphNode`
// clones a segment, so the caller's segment graph may be destroyed after the
// assembly is instantiated; the memory the segments address stays owned by
// the PyTorch graphs that captured them, which the caller keeps alive.
//
// Plain C entry points returning cudaError_t, loaded with ctypes.
#include <cuda_runtime.h>

namespace {

__global__ void set_cond(cudaGraphConditionalHandle handle, const void* pred, int is_int32) {
  const unsigned int v = is_int32 ? (*static_cast<const int*>(pred) != 0)
                                  : (*static_cast<const unsigned char*>(pred) != 0);
  cudaGraphSetConditional(handle, v);
}

// A graph under assembly: its nodes form one chain, each after the last.
struct Assembly {
  cudaGraph_t graph = nullptr;
  cudaGraphNode_t last = nullptr;
  cudaGraphExec_t exec = nullptr;
};

}  // namespace

extern "C" {

// A new empty assembly in *out.
int cg_create(void** out) {
  Assembly* a = new Assembly();
  const cudaError_t err = cudaGraphCreate(&a->graph, 0);
  if (err != cudaSuccess) {
    delete a;
    return err;
  }
  *out = a;
  return cudaSuccess;
}

// Append segment graph `child` (a cudaGraph_t) after the last node.
int cg_add_child(void* h, void* child) {
  Assembly* a = static_cast<Assembly*>(h);
  cudaGraphNode_t node;
  const cudaError_t err = cudaGraphAddChildGraphNode(&node, a->graph, a->last ? &a->last : nullptr,
                                                     a->last ? 1 : 0, static_cast<cudaGraph_t>(child));
  if (err == cudaSuccess) a->last = node;
  return err;
}

// Append `set_cond` on the device scalar `pred` (is_int32: int32, else bool)
// and an IF node whose body runs segment graph `body` when it is non-zero.
int cg_add_if(void* h, const void* pred, int is_int32, void* body) {
  Assembly* a = static_cast<Assembly*>(h);
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, a->graph, 0,
                                                     cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;

  void* args[] = {&handle, (void*)&pred, &is_int32};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_cond);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t set_node;
  err = cudaGraphAddKernelNode(&set_node, a->graph, a->last ? &a->last : nullptr,
                               a->last ? 1 : 0, &kp);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  cudaGraphNode_t if_node;
  err = cudaGraphAddNode(&if_node, a->graph, &set_node, 1, &cp);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t inner;
  err = cudaGraphAddChildGraphNode(&inner, cp.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err == cudaSuccess) a->last = if_node;
  return err;
}

// Instantiate the assembled graph (once, after the last append).
int cg_instantiate(void* h) {
  Assembly* a = static_cast<Assembly*>(h);
  return cudaGraphInstantiate(&a->exec, a->graph, 0);
}

// Launch the instantiated graph on `stream` (PyTorch's current stream).
int cg_launch(void* h, void* stream) {
  Assembly* a = static_cast<Assembly*>(h);
  if (a->exec == nullptr) return cudaErrorInvalidValue;
  return cudaGraphLaunch(a->exec, static_cast<cudaStream_t>(stream));
}

// Free the executable, the graph and the assembly.
int cg_destroy(void* h) {
  Assembly* a = static_cast<Assembly*>(h);
  cudaError_t err = cudaSuccess;
  if (a->exec) err = cudaGraphExecDestroy(a->exec);
  if (a->graph) {
    const cudaError_t e2 = cudaGraphDestroy(a->graph);
    if (err == cudaSuccess) err = e2;
  }
  delete a;
  return err;
}

}  // extern "C"
