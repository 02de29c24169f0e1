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
// Inspection (`cg_walk`, `gw_walk`): a walk of an assembled round, or of any
// graph PyTorch kept, that lists every node with its kind, its depth of
// nesting, whether it lies inside an IF body, and for a kernel node its
// function's name (`cuFuncGetName`, reached through
// `cudaGetDriverEntryPoint`, so nothing links libcuda; then
// `cudaFuncGetName`; a kernel neither resolves is listed as `<unresolved>`)
// and for a memcpy node its direction (`DtoH`, ...) from the pointers'
// attributes, with the addresses it reads and writes and its bytes. `repro_torch.analysis.contracts` holds the list to the round's
// dispatch contract.
//
// Plain C entry points returning cudaError_t, loaded with ctypes.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cxxabi.h>

#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

__global__ void set_cond(cudaGraphConditionalHandle handle, const void* pred, int is_int32) {
  const unsigned int v = is_int32 ? (*static_cast<const int*>(pred) != 0)
                                  : (*static_cast<const unsigned char*>(pred) != 0);
  cudaGraphSetConditional(handle, v);
}

// A graph under assembly: its nodes form one chain, each after the last.
// `bodies` keeps each IF node's body graph for the walk.
struct Assembly {
  cudaGraph_t graph = nullptr;
  cudaGraphNode_t last = nullptr;
  cudaGraphExec_t exec = nullptr;
  std::vector<std::pair<cudaGraphNode_t, cudaGraph_t>> bodies;
};

using Bodies = std::vector<std::pair<cudaGraphNode_t, cudaGraph_t>>;

void* cu_entry(const char* symbol) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(symbol, &fn, CUDART_VERSION,
                                                           cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(symbol, &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  return fn;
}

std::string demangle(const char* name) {
  int status = 0;
  char* out = abi::__cxa_demangle(name, nullptr, nullptr, &status);
  std::string s = (status == 0 && out) ? out : name;
  std::free(out);
  for (char& c : s)
    if (c == '\t' || c == '\n') c = ' ';
  return s;
}

std::string kernel_name(cudaGraphNode_t node) {
  using GetParams = CUresult (*)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
  using FuncName = CUresult (*)(const char**, CUfunction);
  using KernelFunc = CUresult (*)(CUfunction*, CUkernel);
  static const auto get_params =
      reinterpret_cast<GetParams>(cu_entry("cuGraphKernelNodeGetParams"));
  static const auto func_name = reinterpret_cast<FuncName>(cu_entry("cuFuncGetName"));
  static const auto kernel_func =
      reinterpret_cast<KernelFunc>(cu_entry("cuKernelGetFunction"));
  const char* name = nullptr;
  CUDA_KERNEL_NODE_PARAMS p;
  std::memset(&p, 0, sizeof(p));
  if (get_params && func_name && get_params(node, &p) == CUDA_SUCCESS) {
    CUfunction f = p.func;
    if (f == nullptr && p.kern != nullptr && kernel_func) kernel_func(&f, p.kern);
    if (f != nullptr && func_name(&name, f) == CUDA_SUCCESS && name) return demangle(name);
  }
  cudaKernelNodeParams rp;
  std::memset(&rp, 0, sizeof(rp));
  if (cudaGraphKernelNodeGetParams(node, &rp) == cudaSuccess && rp.func != nullptr &&
      cudaFuncGetName(&name, rp.func) == cudaSuccess && name)
    return demangle(name);
  cudaGetLastError();
  return "<unresolved>";
}

// 'H' host (pinned or pageable), 'D' device, 'M' managed, '?' unknown.
char memory_side(const void* ptr, cudaArray_t array) {
  if (array != nullptr) return 'D';
  cudaPointerAttributes a;
  if (ptr == nullptr || cudaPointerGetAttributes(&a, ptr) != cudaSuccess) {
    cudaGetLastError();
    return '?';
  }
  switch (a.type) {
    case cudaMemoryTypeDevice: return 'D';
    case cudaMemoryTypeManaged: return 'M';
    default: return 'H';
  }
}

// A memcpy node's first byte read and written, and the bytes it copies.
struct Copy {
  unsigned long long src = 0, dst = 0, bytes = 0;
};

unsigned long long address(const cudaPitchedPtr& p, const cudaPos& pos) {
  return reinterpret_cast<unsigned long long>(p.ptr) + pos.x + pos.y * p.pitch +
         pos.z * p.pitch * p.ysize;
}

// A memcpy node's direction (`DtoD`, `DtoH`, ...) and, in `*copy`, where
// it reads and writes and how many bytes.
std::string memcpy_direction(cudaGraphNode_t node, Copy* copy) {
  cudaMemcpy3DParms p;
  std::memset(&p, 0, sizeof(p));
  if (cudaGraphMemcpyNodeGetParams(node, &p) != cudaSuccess) {
    cudaGetLastError();
    return "?to?";
  }
  char src = memory_side(p.srcPtr.ptr, p.srcArray), dst = memory_side(p.dstPtr.ptr, p.dstArray);
  if (p.kind == cudaMemcpyDeviceToHost || p.kind == cudaMemcpyHostToHost) dst = 'H';
  if (p.kind == cudaMemcpyHostToDevice || p.kind == cudaMemcpyHostToHost) src = 'H';
  if (p.srcArray == nullptr && p.dstArray == nullptr) {
    copy->src = address(p.srcPtr, p.srcPos);
    copy->dst = address(p.dstPtr, p.dstPos);
    copy->bytes = static_cast<unsigned long long>(p.extent.width) * p.extent.height *
                  p.extent.depth;
  }
  return std::string(1, src) + "to" + std::string(1, dst);
}

const char* kind_name(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event_wait";
    case cudaGraphNodeTypeEventRecord: return "event_record";
    case cudaGraphNodeTypeExtSemaphoreSignal: return "sem_signal";
    case cudaGraphNodeTypeExtSemaphoreWait: return "sem_wait";
    case cudaGraphNodeTypeMemAlloc: return "mem_alloc";
    case cudaGraphNodeTypeMemFree: return "mem_free";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "unknown";
  }
}

void emit(std::string* out, int top, int depth, int gated, const char* kind,
          const std::string& name, const Copy& copy = Copy()) {
  *out += std::to_string(top) + "\t" + std::to_string(depth) + "\t" + std::to_string(gated) +
          "\t" + kind + "\t" + std::to_string(copy.src) + "\t" + std::to_string(copy.dst) +
          "\t" + std::to_string(copy.bytes) + "\t" + name + "\n";
}

std::string failed(const char* call, cudaError_t err) {
  cudaGetLastError();
  return std::string(call) + " returned " + std::to_string(static_cast<int>(err));
}

// The nodes of `g` in an order that respects its edges (Kahn's algorithm);
// where the edges cannot be read, in the order `cudaGraphGetNodes` gives,
// with `*note` saying why.
cudaError_t topo_nodes(cudaGraph_t g, std::vector<cudaGraphNode_t>* out, std::string* note) {
  size_t n = 0, m = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  if ((err = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> from, to;
  err = cudaGraphGetEdges(g, nullptr, nullptr, &m);
  if (err == cudaSuccess && m) {
    from.resize(m);
    to.resize(m);
    err = cudaGraphGetEdges(g, from.data(), to.data(), &m);
  }
  if (err != cudaSuccess) {
    *note = failed("cudaGraphGetEdges", err);
    *out = nodes;
    return cudaSuccess;
  }
  std::unordered_map<cudaGraphNode_t, size_t> index;
  for (size_t i = 0; i < n; ++i) index[nodes[i]] = i;
  std::vector<size_t> indeg(n, 0);
  std::vector<std::vector<size_t>> next(n);
  for (size_t e = 0; e < m; ++e) {
    const auto a = index.find(from[e]), b = index.find(to[e]);
    if (a == index.end() || b == index.end()) continue;
    next[a->second].push_back(b->second);
    ++indeg[b->second];
  }
  std::vector<size_t> ready;
  for (size_t i = 0; i < n; ++i)
    if (indeg[i] == 0) ready.push_back(i);
  for (size_t r = 0; r < ready.size(); ++r) {
    out->push_back(nodes[ready[r]]);
    for (size_t b : next[ready[r]])
      if (--indeg[b] == 0) ready.push_back(b);
  }
  if (out->size() != n) {
    *note = "the graph's edges hold a cycle";
    *out = nodes;
  }
  return cudaSuccess;
}

// One line a node: top-level index, depth, inside an IF body (0/1), kind,
// a memcpy's source, destination and bytes (0 0 0 for other kinds), name. A call that fails is listed as an `error` record, named by the call
// and its code, and the walk goes on.
void walk(cudaGraph_t g, const Bodies& bodies, int depth, int gated, int top, std::string* out) {
  std::vector<cudaGraphNode_t> nodes;
  std::string note;
  cudaError_t err = topo_nodes(g, &nodes, &note);
  if (err != cudaSuccess) {
    emit(out, top, depth, gated, "error", failed("cudaGraphGetNodes", err));
    return;
  }
  if (!note.empty()) emit(out, top, depth, gated, "error", note);
  int index = -1;
  for (cudaGraphNode_t node : nodes) {
    ++index;
    const int here = depth == 0 ? index : top;
    cudaGraph_t body = nullptr;
    for (const auto& b : bodies)
      if (b.first == node) body = b.second;
    cudaGraphNodeType t;
    if (body != nullptr) {
      t = cudaGraphNodeTypeConditional;          // an IF node of the assembly
    } else if ((err = cudaGraphNodeGetType(node, &t)) != cudaSuccess) {
      emit(out, here, depth, gated, "error", failed("cudaGraphNodeGetType", err));
      continue;
    }
    std::string name;
    Copy copy;
    cudaGraph_t inner = nullptr;
    if (t == cudaGraphNodeTypeKernel) {
      name = kernel_name(node);
    } else if (t == cudaGraphNodeTypeMemcpy) {
      name = memcpy_direction(node, &copy);
    } else if (t == cudaGraphNodeTypeGraph) {
      if ((err = cudaGraphChildGraphNodeGetGraph(node, &inner)) != cudaSuccess) {
        emit(out, here, depth, gated, "error", failed("cudaGraphChildGraphNodeGetGraph", err));
        continue;
      }
    } else if (t == cudaGraphNodeTypeConditional) {
      inner = body;
      if (body == nullptr) name = "body unknown";
    }
    emit(out, here, depth, gated, kind_name(t), name, copy);
    if (inner != nullptr) walk(inner, bodies, depth + 1, body != nullptr ? 1 : gated, here, out);
  }
}

// Copy the walk's text into `buf` (at most `cap` bytes); `*len` gets its size.
int walk_into(cudaGraph_t g, const Bodies& bodies, char* buf, size_t cap, size_t* len) {
  std::string out;
  walk(g, bodies, 0, 0, 0, &out);
  *len = out.size();
  std::memcpy(buf, out.data(), out.size() < cap ? out.size() : cap);
  return cudaSuccess;
}

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
  if (err == cudaSuccess) {
    a->last = if_node;
    a->bodies.emplace_back(if_node, cp.conditional.phGraph_out[0]);
  }
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

// The walk of the assembled graph, IF bodies included.
int cg_walk(void* h, char* buf, size_t cap, size_t* len) {
  Assembly* a = static_cast<Assembly*>(h);
  return walk_into(a->graph, a->bodies, buf, cap, len);
}

// The walk of any graph (a `cudaGraph_t`); an IF node's body is not known.
int gw_walk(void* graph, char* buf, size_t cap, size_t* len) {
  return walk_into(static_cast<cudaGraph_t>(graph), Bodies(), buf, cap, len);
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
