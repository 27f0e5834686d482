// compose_image_b: the sprite composite of the image observation, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel marlgrid_tpu/ops/sprite.py::compose_image_b
// (_compose / _make_kernel), which renders every agent's egocentric view
// from per-view-cell ids. For view cell (vi, vj) of agent n in env b, with
// ids batch-minor (N, vs, vs, B) int32:
//   base  in [0, 297]: sprite row of the cell's object, 297 = black
//                      (invisible), the last row of the padded base table;
//   agent in [0, 36] : 0 = none, else 1 + color * 4 + relative dir;
//   lvl   in [0, 7]  : the observed agent's prestige level;
// every byte (pixel (ty, tx) of the cell's T x T tile, channel c) is
//   alpha(agent) ? trunc_u8(agent_rgb * PRESTIGE_DIM[lvl]) : base_rgb.
// The image puts cell (vi, vj) at rows vj*T.., columns vi*T..; the s2d
// layout moves pixel (r, q, c) to channel (r%4)*12 + (q%4)*3 + c of
// spatial block (r/4, q/4), the input of the cnn_s2d torso.
//
// Bound on an H100 SXM: memory. The kernel must write every output byte
// once and read the three id arrays once: at the update's shape (262,144
// images of 56 x 56 x 3) that is 2.47 GB + 154 MB, about 0.78 ms at
// 3.35 TB/s. There is no arithmetic to speak of.
//
// What held the earlier design back: it built each 16-byte store one byte
// at a time, finding the cell, the pixel and the channel of every byte and
// reading the agent's alpha and then an agent or base byte, some 20-30
// instructions per output byte. That bound it by instructions and
// shared-memory accesses at 5.06 ms at the update's shape, 6.5x the bound
// (PERF.md's kernel table, the time before the redesign).
//
// Design: copy words, not bytes. The wrapper (ops/sprite.py) re-lays the
// tables once, in the order the image stores a tile's bytes: per base row
// the T*T*3 bytes as the s2d layout stores them (each 4 x 4 x 3 block's 48
// bytes together) or as the standard layout does (each tile row's T*3
// bytes together); per prestige level and agent row the overlay already
// multiplied and truncated, trunc_u8(rgb * dim[lvl]) (the plain version's
// own float32 product, so the result stays bit-exact); per agent row a
// byte mask of its alpha. It also maps each granule of an image to the
// view cell it shows and to its offset in a re-laid row: in s2d a 16-byte
// piece lies inside one 48-byte block, so inside one cell; in the standard
// layout an 8-byte granule lies inside one tile row when T % 8 == 0. So a
// granule is one aligned vector load of the base row, and where the cell
// has an agent, one load of the level's overlay and one of the mask and a
// word-wise select (over & mask) | (base & ~mask). Each thread writes a
// 16-byte piece (two 8-byte granules in the standard layout) with one
// store, neighbouring threads on neighbouring pieces. A T whose tile rows
// are not a multiple of 8 bytes takes single-byte granules (the byte
// path), with 16-byte stores where the image is a multiple of 16 bytes.
//
// Shared memory and occupancy, at T = 8: the re-laid base table (57.2 KB)
// and the masks (7.1 KB) stay in shared memory; the overlays (56.8 KB) are
// read through the read-only cache, since agents cover a few percent of
// the cells (all three tables in shared memory would leave one block per
// SM). With the granule map (2.3 KB s2d, 4.7 KB standard) and the id words
// of one work item (6.3 KB) a block takes 71-74 KB. Blocks have 512
// threads; at 64 registers a thread, two blocks (1024 threads, 146 KB of
// shared memory) fit on an SM, and the rest of its 256 KB is L1 for the
// overlays (on the card, 512 threads a block ran faster than 256, and 32
// envs a work item faster than 16 or 64). A block stages the tables once
// and walks work items (one agent, a run of 32 envs): it packs the run's
// ids into one word per (env, cell) (range-checked; a bad id traps, so the
// next synchronisation raises), then writes the run's images. The output
// layout is an index map: image (n, b) is image n * stride_n + b *
// stride_b, so (B, N, ...) and (N, B, ...) are written in place. Where the
// tables do not fit in shared memory (T >= 16) the kernel reads them
// through the read-only cache.

#include <cstdint>
#include <cstdio>
#include <map>
#include <mutex>
#include <set>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kEnvs = 32;          // envs of one agent per work item
constexpr int kBaseRows = 298;     // N_BASE_APPEAR + the black row
constexpr int kAgentRows = 37;     // N_AGENT_APPEAR
constexpr int kLevels = 8;         // N_PRESTIGE_LEVELS

struct Geometry {
  int N, B, cells;
  int row_bytes;                   // T * T * 3: one re-laid table row
  int img_bytes;                   // (vs * T)^2 * 3
  long long stride_n, stride_b;    // image (n, b) -> n*stride_n + b*stride_b
};

// The vector that holds one granule of kG bytes.
template <int kG> struct Grain;
template <> struct Grain<16> { using V = uint4; };
template <> struct Grain<8> { using V = uint2; };
template <> struct Grain<1> { using V = uint8_t; };

__device__ __forceinline__ uint4 blend(uint4 a, uint4 m, uint4 b) {
  return make_uint4((a.x & m.x) | (b.x & ~m.x), (a.y & m.y) | (b.y & ~m.y),
                    (a.z & m.z) | (b.z & ~m.z), (a.w & m.w) | (b.w & ~m.w));
}
__device__ __forceinline__ uint2 blend(uint2 a, uint2 m, uint2 b) {
  return make_uint2((a.x & m.x) | (b.x & ~m.x), (a.y & m.y) | (b.y & ~m.y));
}
__device__ __forceinline__ uint8_t blend(uint8_t a, uint8_t m, uint8_t b) {
  return static_cast<uint8_t>((a & m) | (b & ~m));
}

template <typename V, bool kShared>
__device__ __forceinline__ V load(const uint8_t* p) {
  if constexpr (kShared) return *reinterpret_cast<const V*>(p);
  else return __ldg(reinterpret_cast<const V*>(p));
}

// Granule `e` of the current env's image: e holds the view cell (low 16
// bits) and the byte offset in a re-laid row (high 16); `words` the env's
// packed ids, one per cell.
template <int kG, bool kSmemLut>
__device__ __forceinline__ typename Grain<kG>::V grain(
    uint32_t e, const uint32_t* words, const uint8_t* blut,
    const uint8_t* mlut, const uint8_t* __restrict__ over, int rb) {
  using V = typename Grain<kG>::V;
  const uint32_t w = words[e & 0xffff];
  const int off = static_cast<int>(e >> 16);
  const int base = w & 511, agent = (w >> 9) & 63;
  V v = load<V, kSmemLut>(blut + base * rb + off);
  if (agent != 0) {   // row 0 (no agent) has an all-zero mask
    const V m = load<V, kSmemLut>(mlut + agent * rb + off);
    const V a = load<V, false>(
        over + ((w >> 15) * kAgentRows + agent) * rb + off);
    v = blend(a, m, v);
  }
  return v;
}

__device__ void copy_bytes(uint8_t* dst, const uint8_t* __restrict__ src,
                           int n) {
  if (n % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = threadIdx.x; i < n / 16; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// kG: granule bytes (16 s2d, 8 standard with T % 8 == 0, else 1); kP: the
// bytes each thread stores at once (16, or 1 where the image is not a
// multiple of 16 bytes); kSmemLut: base table and masks in shared memory.
template <int kG, int kP, bool kSmemLut>
__global__ void __launch_bounds__(kThreads) compose_kernel(
    const int32_t* __restrict__ base_id, const int32_t* __restrict__ agent_id,
    const int32_t* __restrict__ alvl, const uint8_t* __restrict__ base_t,
    const uint8_t* __restrict__ over, const uint8_t* __restrict__ mask,
    const uint32_t* __restrict__ gmap, uint8_t* __restrict__ out,
    Geometry g) {
  static_assert(kP % kG == 0, "a piece holds whole granules");
  extern __shared__ __align__(16) uint8_t smem[];
  const int rb = g.row_bytes, cells = g.cells;
  const int grains = g.img_bytes / kG, pieces = g.img_bytes / kP;
  // shared memory: the granule map, one packed word per (env, cell) of the
  // work item, then (kSmemLut) the base table and the masks
  uint32_t* map = reinterpret_cast<uint32_t*>(smem);
  uint32_t* words = reinterpret_cast<uint32_t*>(
      smem + round16(static_cast<size_t>(grains) * 4));
  const uint8_t* blut = base_t;
  const uint8_t* mlut = mask;
  for (int i = threadIdx.x; i < grains; i += kThreads) map[i] = gmap[i];
  if (kSmemLut) {
    uint8_t* lut_s = reinterpret_cast<uint8_t*>(words) +
                     round16(static_cast<size_t>(kEnvs) * cells * 4);
    const size_t base_bytes = round16(static_cast<size_t>(kBaseRows) * rb);
    copy_bytes(lut_s, base_t, kBaseRows * rb);
    copy_bytes(lut_s + base_bytes, mask, kAgentRows * rb);
    blut = lut_s;
    mlut = lut_s + base_bytes;
  }

  const int runs = (g.B + kEnvs - 1) / kEnvs;
  const long long items = static_cast<long long>(g.N) * runs;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int n = static_cast<int>(item / runs);
    const int b0 = static_cast<int>(item % runs) * kEnvs;
    const int nb = min(kEnvs, g.B - b0);
    __syncthreads();   // the previous item's words are read; tables staged
    // global reads coalesced over the envs of one cell; the shared-memory
    // stride (cells, odd for odd vs) spreads one warp's writes over banks
    for (int i = threadIdx.x; i < cells * kEnvs; i += kThreads) {
      const int cell = i / kEnvs, j = i - cell * kEnvs;
      if (j >= nb) continue;
      const size_t src = (static_cast<size_t>(n) * cells + cell) * g.B + b0 + j;
      const int base = base_id[src], agent = agent_id[src], lvl = alvl[src];
      if (base < 0 || base >= kBaseRows || agent < 0 || agent >= kAgentRows ||
          lvl < 0 || lvl >= kLevels) {
        printf("compose_image_b: id out of range at agent %d, cell %d, env "
               "%d: base %d, agent %d, level %d\n", n, cell, b0 + j, base,
               agent, lvl);
        __trap();
      }
      words[j * cells + cell] = static_cast<uint32_t>(base) |
                                (static_cast<uint32_t>(agent) << 9) |
                                (static_cast<uint32_t>(lvl) << 15);
    }
    __syncthreads();

    // thread k of the item takes piece pi of env j's image, k = j*pieces+pi
    int j = threadIdx.x / pieces;
    int pi = threadIdx.x - j * pieces;
    while (j < nb) {
      const uint32_t* env_words = words + j * cells;
      const long long img = n * g.stride_n + (b0 + j) * g.stride_b;
      uint8_t* dst = out + img * g.img_bytes + static_cast<long long>(pi) * kP;
      if constexpr (kG == kP) {
        *reinterpret_cast<typename Grain<kG>::V*>(dst) =
            grain<kG, kSmemLut>(map[pi], env_words, blut, mlut, over, rb);
      } else if constexpr (kG == 8) {
        const uint2 lo = grain<8, kSmemLut>(map[2 * pi], env_words, blut,
                                            mlut, over, rb);
        const uint2 hi = grain<8, kSmemLut>(map[2 * pi + 1], env_words, blut,
                                            mlut, over, rb);
        *reinterpret_cast<uint4*>(dst) = make_uint4(lo.x, lo.y, hi.x, hi.y);
      } else {   // single-byte granules, 16-byte stores
        uint32_t packed[4] = {0, 0, 0, 0};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const uint32_t v = grain<1, kSmemLut>(map[pi * 16 + e], env_words,
                                                blut, mlut, over, rb);
          packed[e / 4] |= v << (8 * (e % 4));
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      pi += kThreads;
      while (pi >= pieces) {
        pi -= pieces;
        ++j;
      }
    }
  }
}

// The device's SM count and opt-in shared memory per block, queried once
// per device.
struct DeviceInfo {
  int sms = 0, optin = 0;
};

std::mutex cache_mutex;   // guards the caches below and in launch()

cudaError_t device_info(int device, DeviceInfo* info) {
  static std::map<int, DeviceInfo> cache;
  std::lock_guard<std::mutex> lock(cache_mutex);
  auto it = cache.find(device);
  if (it == cache.end()) {
    DeviceInfo d;
    cudaError_t err = cudaDeviceGetAttribute(
        &d.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    it = cache.emplace(device, d).first;
  }
  *info = it->second;
  return cudaSuccess;
}

struct Args {
  const int32_t *base_id, *agent_id, *alvl;
  const uint8_t *base_t, *over, *mask;
  const uint32_t* gmap;
  uint8_t* out;
};

// Launches one variant on a grid capped at the blocks that fit on the card
// at once. Per (variant, device) the dynamic shared-memory limit is raised
// to the opt-in maximum once; the occupancy is computed once per (device,
// shared-memory size), so a launch after the first makes no query.
template <int kG, int kP, bool kSmemLut>
cudaError_t launch(const Args& a, const Geometry& g, size_t smem, int device,
                   const DeviceInfo& info, cudaStream_t stream) {
  auto kernel = compose_kernel<kG, kP, kSmemLut>;
  static std::set<int> raised;
  static std::map<std::pair<int, size_t>, int> blocks_per_sm;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(cache_mutex);
    if (!raised.count(device)) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, info.optin);
      if (err != cudaSuccess) return err;
      raised.insert(device);
    }
    const auto key = std::make_pair(device, smem);
    auto it = blocks_per_sm.find(key);
    if (it == blocks_per_sm.end()) {
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem);
      if (err != cudaSuccess) return err;
      it = blocks_per_sm.emplace(key, per_sm).first;
    }
    per_sm = it->second;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items =
      static_cast<long long>(g.N) * ((g.B + kEnvs - 1) / kEnvs);
  const long long cap = static_cast<long long>(per_sm) * info.sms;
  const int grid = static_cast<int>(items < cap ? items : cap);
  kernel<<<grid, kThreads, smem, stream>>>(a.base_id, a.agent_id, a.alvl,
                                           a.base_t, a.over, a.mask, a.gmap,
                                           a.out, g);
  return cudaGetLastError();
}

template <int kG, int kP>
cudaError_t dispatch(const Args& a, const Geometry& g, int device,
                     cudaStream_t stream) {
  DeviceInfo info;
  cudaError_t err = device_info(device, &info);
  if (err != cudaSuccess) return err;
  const size_t optin = static_cast<size_t>(info.optin);
  const size_t small = round16(static_cast<size_t>(g.img_bytes) / kG * 4) +
                       round16(static_cast<size_t>(kEnvs) * g.cells * 4);
  const size_t tables =
      round16(static_cast<size_t>(kBaseRows) * g.row_bytes) +
      static_cast<size_t>(kAgentRows) * g.row_bytes;
  if (small > optin) return cudaErrorInvalidValue;
  if (small + tables <= optin)
    return launch<kG, kP, true>(a, g, small + tables, device, info, stream);
  return launch<kG, kP, false>(a, g, small, device, info, stream);
}

}  // namespace

// base_id, agent_id, alvl: (N, vs, vs, B) int32 contiguous; base_t (298,
// T*T*3), over (8, 37, T*T*3) and mask (37, T*T*3) uint8: the tables
// re-laid in the image's byte order for this layout, mask row 0 all zero;
// gmap: one int32 per granule of G bytes of an image, the view cell in
// its low 16 bits and the granule's offset in a re-laid row in its high
// 16. G is 16 (s2d, T % 4 == 0), 8 (standard, T % 8 == 0) or 1. out:
// N * B images of (vs*T)^2 * 3 bytes, image (n, b) at n * stride_n +
// b * stride_b. All on `device`, 16-byte aligned. Launches on `stream`;
// returns the launch's cudaError (0 on success).
extern "C" int compose_image_b(const void* base_id, const void* agent_id,
                               const void* alvl, const void* base_t,
                               const void* over, const void* mask,
                               const void* gmap, void* out, int N, int B,
                               int vs, int T, int s2d, int G,
                               long long stride_n, long long stride_b,
                               int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const long long rb = 3LL * T * T;
  const long long img = rb * vs * vs;
  const bool ok_g = s2d ? (G == 16 && T % 4 == 0)
                        : (G == 8 ? T % 8 == 0 : G == 1);
  if (vs <= 0 || T <= 0 || !ok_g || rb >= 65536 || vs * vs > 65536 ||
      img >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{N, B, vs * vs, static_cast<int>(rb),
                   static_cast<int>(img), stride_n, stride_b};
  const Args a{static_cast<const int32_t*>(base_id),
               static_cast<const int32_t*>(agent_id),
               static_cast<const int32_t*>(alvl),
               static_cast<const uint8_t*>(base_t),
               static_cast<const uint8_t*>(over),
               static_cast<const uint8_t*>(mask),
               static_cast<const uint32_t*>(gmap),
               static_cast<uint8_t*>(out)};
  const auto st = static_cast<cudaStream_t>(stream);
  if (G == 16) err = dispatch<16, 16>(a, g, device, st);
  else if (G == 8) err = dispatch<8, 16>(a, g, device, st);
  else if (img % 16 == 0) err = dispatch<1, 16>(a, g, device, st);
  else err = dispatch<1, 1>(a, g, device, st);
  return static_cast<int>(err);
}
