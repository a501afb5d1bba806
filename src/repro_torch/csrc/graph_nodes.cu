// The kernel nodes of a captured CUDA graph, by function name.
//
// No kernel: a host function that reads what one replay of a graph
// launches from the graph itself (engine/aot.py::graph_kernel_names), so
// a replayed step's kernels are counted without a profiler and apart from
// the wrappers' launch counters (which a replay adds to by the count its
// capture recorded).
//
// It walks cuGraphGetNodes, descends into child-graph nodes, and names
// each kernel node's function with cuKernelGetName (a CUkernel, what the
// runtime launches under lazy loading) or cuFuncGetName (a CUfunction).
// The entry points come through cudaGetDriverEntryPoint, so the
// library links nothing beyond the runtime, as the other sources do.
// Returns 0 or the first CUresult that was not CUDA_SUCCESS.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstring>
#include <vector>

namespace {

typedef CUresult (*GetNodesFn)(CUgraph, CUgraphNode*, size_t*);
typedef CUresult (*NodeTypeFn)(CUgraphNode, CUgraphNodeType*);
typedef CUresult (*KernelParamsFn)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
typedef CUresult (*ChildGraphFn)(CUgraphNode, CUgraph*);
typedef CUresult (*FuncNameFn)(const char**, CUfunction);
typedef CUresult (*KernelNameFn)(const char**, CUkernel);

struct Api {
  GetNodesFn get_nodes = nullptr;
  NodeTypeFn node_type = nullptr;
  KernelParamsFn kernel_params = nullptr;
  ChildGraphFn child_graph = nullptr;
  FuncNameFn func_name = nullptr;
  KernelNameFn kernel_name = nullptr;
};

template <class F>
CUresult lookup(const char* symbol, F* fn) {
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(symbol, reinterpret_cast<void**>(fn), cudaEnableDefault,
                              &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return CUDA_ERROR_NOT_FOUND;
  return CUDA_SUCCESS;
}

CUresult load(Api* d) {
  CUresult r;
  if ((r = lookup("cuGraphGetNodes", &d->get_nodes)) != CUDA_SUCCESS) return r;
  if ((r = lookup("cuGraphNodeGetType", &d->node_type)) != CUDA_SUCCESS) return r;
  if ((r = lookup("cuGraphKernelNodeGetParams", &d->kernel_params)) != CUDA_SUCCESS) return r;
  if ((r = lookup("cuGraphChildGraphNodeGetGraph", &d->child_graph)) != CUDA_SUCCESS) return r;
  if ((r = lookup("cuFuncGetName", &d->func_name)) != CUDA_SUCCESS) return r;
  return lookup("cuKernelGetName", &d->kernel_name);
}

struct Out {
  char* names;
  long long cap;
  long long used;
  int count;
};

CUresult append(Out* out, const char* name) {
  const long long n = (long long)std::strlen(name);
  if (out->used + n + 2 > out->cap) return CUDA_ERROR_INVALID_VALUE;  // no room
  std::memcpy(out->names + out->used, name, n);
  out->used += n;
  out->names[out->used++] = '\n';
  out->names[out->used] = '\0';
  ++out->count;
  return CUDA_SUCCESS;
}

CUresult walk(const Api& d, CUgraph graph, Out* out) {
  size_t n = 0;
  CUresult r = d.get_nodes(graph, nullptr, &n);
  if (r != CUDA_SUCCESS) return r;
  std::vector<CUgraphNode> nodes(n);
  if (n > 0 && (r = d.get_nodes(graph, nodes.data(), &n)) != CUDA_SUCCESS) return r;
  for (CUgraphNode node : nodes) {
    CUgraphNodeType type;
    if ((r = d.node_type(node, &type)) != CUDA_SUCCESS) return r;
    if (type == CU_GRAPH_NODE_TYPE_GRAPH) {
      CUgraph child;
      if ((r = d.child_graph(node, &child)) != CUDA_SUCCESS) return r;
      if ((r = walk(d, child, out)) != CUDA_SUCCESS) return r;
      continue;
    }
    if (type != CU_GRAPH_NODE_TYPE_KERNEL) continue;
    CUDA_KERNEL_NODE_PARAMS p;
    std::memset(&p, 0, sizeof(p));
    if ((r = d.kernel_params(node, &p)) != CUDA_SUCCESS) return r;
    const char* name = nullptr;
    r = p.kern != nullptr ? d.kernel_name(&name, p.kern) : d.func_name(&name, p.func);
    if (r != CUDA_SUCCESS) return r;
    if ((r = append(out, name != nullptr ? name : "?")) != CUDA_SUCCESS) return r;
  }
  return CUDA_SUCCESS;
}

}  // namespace

extern "C" const char* tao_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// graph: a cudaGraph_t (CUgraph).  Writes each kernel node's function
// name and a '\n' into names (names_len bytes, '\0'-terminated) and the
// number of kernel nodes into *count.  The stream argument, which every
// entry point of the port takes, is not used.
extern "C" int tao_graph_kernel_names(void* graph, char* names, long long names_len, int* count,
                                      void* /*stream*/) {
  if (graph == nullptr || names == nullptr || names_len < 1 || count == nullptr)
    return (int)CUDA_ERROR_INVALID_VALUE;
  static Api api;
  static const CUresult loaded = load(&api);
  if (loaded != CUDA_SUCCESS) return (int)loaded;
  Out out{names, names_len, 0, 0};
  names[0] = '\0';
  const CUresult r = walk(api, static_cast<CUgraph>(graph), &out);
  *count = out.count;
  return (int)r;
}
