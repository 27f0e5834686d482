// graph_nodes: which nodes of a CUDA graph capture each stage span added
// (utils/profiling.py::stage), read from the capture through the CUDA driver's
// graph API. Host code only: no kernel.
//
// Replaces no TPU kernel. A replayed graph runs no Python, so the
// record_function labels of the trainers' stages never reach the card; this
// file lets the capture remember them instead. It is the walk of upstream
// torch's torch.cuda._graph_annotations.mark_kernels without its two needs
// (the cuda.bindings package, and the toolsId of driver 13.1): a node is
// told apart by its handle while the capture is open, and the replay order
// is the order the nodes were added along the captured chain.
//
// A recorder is opened before a capture. Each stage boundary calls gn_mark
// with the stage that starts there: every node added to the capture since
// the previous mark (the nodes reachable from the capture's frontier at that
// mark) goes to the stage that was current until now. gn_finish, still
// inside the capture (the graph is destroyed once it is instantiated),
// keeps the device-work nodes (kernel, memcpy, memset) in that order with
// their stage and, for a kernel, its demangled name where the CUDA driver
// gives one (cuFuncGetName, cuKernelGetName).
//
// The CUDA driver's functions are looked up by their ABI names in the loaded
// libcuda (the toolkit's headers change these signatures across releases;
// the exported symbols do not). The queries are the ones that also return
// edge data (CUDA 12.3 on): a capture with a programmatic edge (a kernel
// launched for programmatic dependent launch, as cuDNN's are on Hopper)
// answers the older ones with CUDA_ERROR_LOSSY_QUERY. A driver without them
// gives no map (kNoDriver). Cost: two or three driver queries a node, and a
// hash lookup.

#include <cxxabi.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

typedef int CUresult;
typedef void* CUstream;
typedef void* CUgraph;
typedef void* CUgraphNode;
typedef void* CUfunction;
typedef void* CUkernel;

// CUDA_KERNEL_NODE_PARAMS_v2
struct KernelNodeParams {
  CUfunction func;
  unsigned int grid[3];
  unsigned int block[3];
  unsigned int shared_mem_bytes;
  void** kernel_params;
  void** extra;
  CUkernel kern;
  void* ctx;
};

// CUgraphEdgeData
struct EdgeData {
  unsigned char from_port, to_port, type, reserved[5];
};

// CUgraphNodeType, CUstreamCaptureStatus
constexpr int kKernel = 0, kMemcpy = 1, kMemset = 2;
constexpr int kCaptureActive = 1;
// the recorder's own errors (CUresult codes are positive)
constexpr int kNoDriver = -1, kNotCapturing = -2, kOtherGraph = -3;

typedef CUresult (*CaptureInfoFn)(CUstream, int*, unsigned long long*,
                                  CUgraph*, const CUgraphNode**,
                                  const EdgeData**, size_t*);
typedef CUresult (*RootsFn)(CUgraph, CUgraphNode*, size_t*);
typedef CUresult (*DependentsFn)(CUgraphNode, CUgraphNode*, EdgeData*,
                                 size_t*);
typedef CUresult (*TypeFn)(CUgraphNode, int*);
typedef CUresult (*KernelParamsFn)(CUgraphNode, KernelNodeParams*);
typedef CUresult (*NameFn)(const char**, void*);

struct Driver {
  CaptureInfoFn capture_info = nullptr;  // cuStreamGetCaptureInfo_v3
  RootsFn roots = nullptr;               // cuGraphGetRootNodes
  DependentsFn dependents = nullptr;     // cuGraphNodeGetDependentNodes_v2
  TypeFn type = nullptr;
  KernelParamsFn kernel_params = nullptr;
  NameFn func_name = nullptr;
  NameFn kernel_name = nullptr;
  bool ok = false;
};

const Driver& driver() {
  static const Driver d = [] {
    Driver d;
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return d;
    d.capture_info = reinterpret_cast<CaptureInfoFn>(
        dlsym(lib, "cuStreamGetCaptureInfo_v3"));
    d.roots = reinterpret_cast<RootsFn>(dlsym(lib, "cuGraphGetRootNodes"));
    d.dependents = reinterpret_cast<DependentsFn>(
        dlsym(lib, "cuGraphNodeGetDependentNodes_v2"));
    d.type = reinterpret_cast<TypeFn>(dlsym(lib, "cuGraphNodeGetType"));
    d.kernel_params = reinterpret_cast<KernelParamsFn>(
        dlsym(lib, "cuGraphKernelNodeGetParams_v2"));
    d.func_name = reinterpret_cast<NameFn>(dlsym(lib, "cuFuncGetName"));
    d.kernel_name = reinterpret_cast<NameFn>(dlsym(lib, "cuKernelGetName"));
    d.ok = d.capture_info && d.roots && d.dependents && d.type &&
           d.kernel_params;
    return d;
  }();
  return d;
}

// The nodes `query(nodes, edges, &n)` lists (a graph's roots, or a node's
// dependents): asked with the room `out` has, at least 8, then, where that
// may not have held them all, for the count first.
template <typename Query>
CUresult list_nodes(Query query, std::vector<CUgraphNode>* out,
                    std::vector<EdgeData>* edges) {
  size_t n = out->size() < 8 ? 8 : out->size();
  out->resize(n);
  edges->resize(n);
  CUresult e = query(out->data(), edges->data(), &n);
  if (e == 0 && n >= out->size()) {
    n = 0;
    e = query(nullptr, nullptr, &n);
    out->resize(n);
    edges->resize(n);
    if (e == 0 && n > 0) e = query(out->data(), edges->data(), &n);
  }
  if (e == 0) out->resize(n);
  return e;
}

std::string demangle(const char* name) {
  int status = 0;
  char* d = abi::__cxa_demangle(name, nullptr, nullptr, &status);
  std::string out = (status == 0 && d != nullptr) ? d : name;
  std::free(d);
  return out;
}

struct Recorder {
  CUgraph graph = nullptr;
  bool started = false;
  int current = 0;
  std::vector<CUgraphNode> last;  // the frontier at the last mark
  std::unordered_map<CUgraphNode, int> stage_of;
  std::vector<CUgraphNode> order;  // the nodes in the order they were added
  // gn_finish's output: device-work nodes in order, their stage, name id
  std::vector<int32_t> out_stage, out_name;
  std::vector<std::string> names;
};

int name_id(Recorder& r, std::unordered_map<std::string, int>* ids,
            const std::string& name) {
  auto it = ids->find(name);
  if (it != ids->end()) return it->second;
  int id = static_cast<int>(r.names.size());
  r.names.push_back(name);
  (*ids)[name] = id;
  return id;
}

}  // namespace

extern "C" {

void* gn_open() { return new Recorder(); }

void gn_close(void* rec) { delete static_cast<Recorder*>(rec); }

// Give every node added to the capture on `stream` since the last mark to
// the stage current until now, and make `stage` current. 0 or an error.
int gn_mark(void* rec, void* stream, int stage) {
  Recorder& r = *static_cast<Recorder*>(rec);
  const Driver& d = driver();
  if (!d.ok) return kNoDriver;
  int status = 0;
  CUgraph graph = nullptr;
  const CUgraphNode* deps = nullptr;
  size_t n_deps = 0;
  unsigned long long id = 0;
  const EdgeData* dep_edges = nullptr;
  CUresult e = d.capture_info(stream, &status, &id, &graph, &deps, &dep_edges,
                              &n_deps);
  if (e != 0) return e;
  if (status != kCaptureActive) return kNotCapturing;
  if (r.graph != nullptr && graph != r.graph) return kOtherGraph;
  r.graph = graph;
  if (r.started) {
    std::vector<CUgraphNode> queue, next;
    std::vector<EdgeData> edges;
    if (r.last.empty()) {
      // nothing was captured at the last mark: every node is new
      e = list_nodes(
          [&](CUgraphNode* nodes, EdgeData*, size_t* n) {
            return d.roots(graph, nodes, n);
          },
          &queue, &edges);
      if (e != 0) return e;
      for (CUgraphNode node : queue) {
        r.stage_of.emplace(node, r.current);
        r.order.push_back(node);
      }
    } else {
      queue = r.last;
    }
    for (size_t i = 0; i < queue.size(); ++i) {
      const CUgraphNode from = queue[i];
      e = list_nodes(
          [&](CUgraphNode* nodes, EdgeData* data, size_t* n) {
            return d.dependents(from, nodes, data, n);
          },
          &next, &edges);
      if (e != 0) return e;
      for (CUgraphNode node : next) {
        if (r.stage_of.emplace(node, r.current).second) {
          r.order.push_back(node);
          queue.push_back(node);
        }
      }
    }
  }
  r.started = true;
  r.last.assign(deps, deps + n_deps);
  r.current = stage;
  return 0;
}

// Keep the device-work nodes found so far, in order, with their stage and
// name. Call inside the capture, after the last mark. 0 or an error.
int gn_finish(void* rec) {
  Recorder& r = *static_cast<Recorder*>(rec);
  const Driver& d = driver();
  if (!d.ok) return kNoDriver;
  std::unordered_map<std::string, int> ids;
  std::unordered_map<void*, int> by_function;
  const int memcpy_id = name_id(r, &ids, "memcpy");
  const int memset_id = name_id(r, &ids, "memset");
  const int unknown_id = name_id(r, &ids, "");
  r.out_stage.clear();
  r.out_name.clear();
  for (CUgraphNode node : r.order) {
    int type = -1;
    CUresult e = d.type(node, &type);
    if (e != 0) return e;
    int name = unknown_id;
    if (type == kMemcpy) {
      name = memcpy_id;
    } else if (type == kMemset) {
      name = memset_id;
    } else if (type != kKernel) {
      continue;
    } else {
      // room beyond the struct, should a driver write a longer one
      union {
        KernelNodeParams p;
        char room[256];
      } u;
      std::memset(&u, 0, sizeof(u));
      const KernelNodeParams& p = u.p;
      if (d.kernel_params(node, &u.p) == 0) {
        void* f = p.func != nullptr ? p.func : p.kern;
        auto it = by_function.find(f);
        if (it != by_function.end()) {
          name = it->second;
        } else {
          const char* raw = nullptr;
          if (p.func != nullptr && d.func_name != nullptr)
            d.func_name(&raw, p.func);
          else if (p.kern != nullptr && d.kernel_name != nullptr)
            d.kernel_name(&raw, p.kern);
          name = raw != nullptr ? name_id(r, &ids, demangle(raw))
                                : unknown_id;
          by_function[f] = name;
        }
      }
    }
    r.out_stage.push_back(r.stage_of[node]);
    r.out_name.push_back(name);
  }
  return 0;
}

int64_t gn_count(void* rec) {
  return static_cast<int64_t>(static_cast<Recorder*>(rec)->out_stage.size());
}

// Copy gn_finish's stage and name id of each node into two int32 arrays of
// gn_count entries.
void gn_nodes(void* rec, int32_t* stage, int32_t* name) {
  Recorder& r = *static_cast<Recorder*>(rec);
  std::memcpy(stage, r.out_stage.data(), r.out_stage.size() * 4);
  std::memcpy(name, r.out_name.data(), r.out_name.size() * 4);
}

int gn_name_count(void* rec) {
  return static_cast<int>(static_cast<Recorder*>(rec)->names.size());
}

// Name `i` of gn_finish's table: "memcpy", "memset", "" (a kernel the
// driver gave no name for), or a kernel's demangled name.
const char* gn_name(void* rec, int i) {
  return static_cast<Recorder*>(rec)->names[i].c_str();
}

}  // extern "C"
