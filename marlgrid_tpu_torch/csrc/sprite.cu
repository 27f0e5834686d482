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
// 3.35 TB/s. The arithmetic (one float multiply per agent-covered byte) is
// negligible.
//
// Design against that bound. The TPU kernel turns the lookup into two
// one-hot bf16 matmuls against constant right-hand sides built from a
// compact per-scenario palette, because only the matrix unit is fast
// there. On Hopper it is a table lookup: the FULL tables (298 x T x T x 3
// base bytes and 37 x T x T x 4 agent bytes, 66.7 KB at T = 8) sit in one
// block's shared memory, so no palette is needed and every scenario takes
// the same path. A block stages the tables once and then walks work items
// (one agent, a run of 32 envs): it packs the run's ids into one word per
// (env, cell) in shared memory (range-checked; a bad id traps, so the
// next synchronisation raises), then each thread writes 16 consecutive
// bytes of one image with one 16-byte store, walking the pixels of those
// bytes incrementally, so neighbouring threads store neighbouring 16-byte
// pieces. The output layout is an index map: image (n, b) is image
// n * stride_n + b * stride_b, so (B, N, ...) and (N, B, ...) are written
// in place with no copy after. Where the tables do not fit in shared memory
// (T >= 16) the same kernel reads them through the read-only cache; where
// an image is not a multiple of 16 bytes each thread stores single bytes.
// Bit-exact: bytes <= 255 times PRESTIGE_DIM values with 8-bit mantissas
// are exact in float32, truncated toward zero as JAX's astype(uint8).

#include <cstdint>
#include <cstdio>
#include <map>
#include <mutex>
#include <set>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEnvs = 32;          // envs of one agent per work item
constexpr int kBaseRows = 298;     // N_BASE_APPEAR + the black row
constexpr int kAgentRows = 37;     // N_AGENT_APPEAR
constexpr int kLevels = 8;         // N_PRESTIGE_LEVELS

struct Geometry {
  int N, B, vs, T;
  long long stride_n, stride_b;    // image (n, b) -> n*stride_n + b*stride_b
};

__device__ void copy_bytes(uint8_t* dst, const uint8_t* __restrict__ src,
                           int n) {
  if (n % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = threadIdx.x; i < n / 16; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

// Walks the bytes of one image in output order, keeping the view cell
// (vi, vj), the pixel (ty, tx) inside its tile and the channel c.
template <bool kS2d>
struct Walker {
  int vs, T, W, side;
  int c, vi, vj, ty, tx;
  int q;                 // standard: pixel column
  int dx, dy, bq, br;    // s2d: pixel in the 4 x 4 block, block column/row

  __device__ void locate_block() {   // s2d: the tile of block (br, bq)
    const int r0 = br * 4, q0 = bq * 4;
    vj = r0 / T;
    vi = q0 / T;
    ty = r0 - vj * T + dy;   // T % 4 == 0: a block lies inside one tile
    tx = q0 - vi * T + dx;
  }

  __device__ Walker(int vs_, int T_, int o) : vs(vs_), T(T_), W(vs_ * T_) {
    side = W / 4;
    if (kS2d) {
      const int blk = o / 48, ch = o - blk * 48;
      br = blk / side;
      bq = blk - br * side;
      dy = ch / 12;
      dx = (ch - dy * 12) / 3;
      c = ch % 3;
      locate_block();
    } else {
      const int p = o / 3;
      c = o - p * 3;
      const int r = p / W;
      q = p - r * W;
      vj = r / T;
      ty = r - vj * T;
      vi = q / T;
      tx = q - vi * T;
    }
  }

  __device__ void next() {
    if (++c < 3) return;
    c = 0;
    if (kS2d) {
      if (++dx < 4) { ++tx; return; }
      dx = 0;
      if (++dy < 4) { tx -= 3; ++ty; return; }
      dy = 0;
      if (++bq == side) { bq = 0; ++br; }
      locate_block();
    } else {
      if (++tx == T) { tx = 0; ++vi; }
      if (++q == W) {
        q = 0; vi = 0; tx = 0;
        if (++ty == T) { ty = 0; ++vj; }
      }
    }
  }
};

template <bool kS2d, bool kSmemLut, int kVec>
__global__ void __launch_bounds__(kThreads) compose_kernel(
    const int32_t* __restrict__ base_id, const int32_t* __restrict__ agent_id,
    const int32_t* __restrict__ alvl, const uint8_t* __restrict__ base_lut,
    const uint8_t* __restrict__ agent_lut, const float* __restrict__ dim_table,
    uint8_t* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int vs = g.vs, T = g.T, cells = vs * vs, TT = T * T;
  const int img_bytes = vs * T * vs * T * 3;
  const int chunks = img_bytes / kVec;
  // shared memory: one packed word per (env, cell) of the work item, the
  // eight dim factors, then (kSmemLut) the base and agent tables
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* dims = reinterpret_cast<float*>(words + kEnvs * cells);
  const uint8_t* blut = base_lut;
  const uint8_t* alut = agent_lut;
  if (kSmemLut) {
    uint8_t* lut_s = reinterpret_cast<uint8_t*>(dims + kLevels);
    const int base_bytes = kBaseRows * TT * 3;
    copy_bytes(lut_s, base_lut, base_bytes);
    copy_bytes(lut_s + base_bytes, agent_lut, kAgentRows * TT * 4);
    blut = lut_s;
    alut = lut_s + base_bytes;
  }
  if (threadIdx.x < kLevels) dims[threadIdx.x] = dim_table[threadIdx.x];

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

    for (int k = threadIdx.x; k < nb * chunks; k += kThreads) {
      const int j = k / chunks;
      const int o = (k - j * chunks) * kVec;
      const uint32_t* env_words = words + j * cells;
      Walker<kS2d> w(vs, T, o);
      const long long img = n * g.stride_n + (b0 + j) * g.stride_b;
      uint8_t* dst = out + img * img_bytes + o;
      uint32_t packed[4] = {0, 0, 0, 0};
      int cur = -1;
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int cell = w.vi * vs + w.vj;
        if (cell != cur) {
          cur = cell;
          word = env_words[cell];
        }
        const int base = word & 511, agent = (word >> 9) & 63;
        const int pix = w.ty * T + w.tx;
        const uint8_t* a = alut + (agent * TT + pix) * 4;
        uint32_t v;
        if (agent != 0 && a[3] != 0) {
          v = static_cast<uint32_t>(static_cast<int>(
              static_cast<float>(a[w.c]) * dims[word >> 15]));
        } else {
          v = blut[(base * TT + pix) * 3 + w.c];
        }
        if (kVec == 16) {
          packed[e / 4] |= v << (8 * (e % 4));
        } else {
          dst[e] = static_cast<uint8_t>(v);
        }
        w.next();
      }
      if (kVec == 16) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
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

// Launches one variant on a grid capped at the blocks that fit on the card
// at once. Per (variant, device) the dynamic shared-memory limit is raised
// to the opt-in maximum once; the occupancy is computed once per (device,
// shared-memory size), so a launch after the first makes no query.
template <bool kS2d, bool kSmemLut, int kVec>
cudaError_t launch(const int32_t* base_id, const int32_t* agent_id,
                   const int32_t* alvl, const uint8_t* base_lut,
                   const uint8_t* agent_lut, const float* dims, uint8_t* out,
                   const Geometry& g, size_t smem, int device,
                   const DeviceInfo& info, cudaStream_t stream) {
  auto kernel = compose_kernel<kS2d, kSmemLut, kVec>;
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
  kernel<<<grid, kThreads, smem, stream>>>(base_id, agent_id, alvl, base_lut,
                                           agent_lut, dims, out, g);
  return cudaGetLastError();
}

template <bool kS2d>
cudaError_t dispatch(const int32_t* base_id, const int32_t* agent_id,
                     const int32_t* alvl, const uint8_t* base_lut,
                     const uint8_t* agent_lut, const float* dims,
                     uint8_t* out, const Geometry& g, int device,
                     cudaStream_t stream) {
  DeviceInfo info;
  cudaError_t err = device_info(device, &info);
  if (err != cudaSuccess) return err;
  const int optin = info.optin;
  const size_t TT = static_cast<size_t>(g.T) * g.T;
  const size_t words = static_cast<size_t>(kEnvs) * g.vs * g.vs * 4 +
                       kLevels * 4;
  const size_t tables = kBaseRows * TT * 3 + kAgentRows * TT * 4;
  const bool vec = (TT * g.vs * g.vs * 3) % 16 == 0;
  if (words > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (words + tables <= static_cast<size_t>(optin)) {
    return vec ? launch<kS2d, true, 16>(base_id, agent_id, alvl, base_lut,
                                         agent_lut, dims, out, g,
                                         words + tables, device, info, stream)
               : launch<kS2d, true, 1>(base_id, agent_id, alvl, base_lut,
                                        agent_lut, dims, out, g,
                                        words + tables, device, info, stream);
  }
  return vec ? launch<kS2d, false, 16>(base_id, agent_id, alvl, base_lut,
                                        agent_lut, dims, out, g, words,
                                        device, info, stream)
             : launch<kS2d, false, 1>(base_id, agent_id, alvl, base_lut,
                                       agent_lut, dims, out, g, words, device,
                                       info, stream);
}

}  // namespace

// base_id, agent_id, alvl: (N, vs, vs, B) int32 contiguous; base_lut
// (298, T, T, 3) and agent_lut (37, T, T, 4) uint8 contiguous; dims 8
// float32; out: N * B images of (vs*T)^2 * 3 bytes, image (n, b) at
// n * stride_n + b * stride_b; s2d needs T % 4 == 0. All on `device`.
// Launches on `stream`; returns the launch's cudaError (0 on success).
extern "C" int compose_image_b(const void* base_id, const void* agent_id,
                               const void* alvl, const void* base_lut,
                               const void* agent_lut, const void* dims,
                               void* out, int N, int B, int vs, int T, int s2d,
                               long long stride_n, long long stride_b,
                               int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  if (vs <= 0 || T <= 0 || (s2d && T % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{N, B, vs, T, stride_n, stride_b};
  const auto* b = static_cast<const int32_t*>(base_id);
  const auto* a = static_cast<const int32_t*>(agent_id);
  const auto* l = static_cast<const int32_t*>(alvl);
  const auto* bl = static_cast<const uint8_t*>(base_lut);
  const auto* al = static_cast<const uint8_t*>(agent_lut);
  const auto* d = static_cast<const float*>(dims);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  err = s2d ? dispatch<true>(b, a, l, bl, al, d, o, g, device, st)
            : dispatch<false>(b, a, l, bl, al, d, o, g, device, st);
  return static_cast<int>(err);
}
