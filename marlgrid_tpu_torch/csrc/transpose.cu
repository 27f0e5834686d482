// transpose_bk: (B, K) -> (K, B) for 4-byte elements, on Hopper (sm_90a).
//
// Replaces the TPU kernel marlgrid_tpu/ops/transpose.py::transpose_bk
// (_pallas_t / _tkernel), which swaps the per-view-cell values of the
// encode observation from batch-major to batch-minor once per observation
// (core/obs.py::extract_views_b).
//
// Bound on an H100 SXM: pure data movement, 2 * 4 * B * K bytes (each
// element read once and written once) at 3.35 TB/s; at B = 4096, K = 196
// that is 6.4 MB, about 1.9 us. No arithmetic.
//
// Design against that bound: a classic tiled shared-memory transpose. A
// block of 32 x 8 threads moves one 32 x 32 tile: each warp reads 32
// consecutive elements of a row of x (one 128-byte transaction) and writes
// 32 consecutive elements of a row of y, so both sides are coalesced. The
// tile row is padded to 33 words so the column-wise reads from shared
// memory hit 32 different banks. Ragged edges (any B, any K) are masked;
// the TPU kernel's 256-row blocking was a TPU tiling rule and is not kept.
// The batch dim rides gridDim.x (up to 2^31 - 1 tiles).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

__global__ void transpose_bk_kernel(const int32_t* __restrict__ x,
                                    int32_t* __restrict__ y, int B, int K) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const int b0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
#pragma unroll
  for (int r = ty; r < kTile; r += kRows) {
    const int b = b0 + r;
    const int k = k0 + tx;
    if (b < B && k < K) tile[r][tx] = x[static_cast<size_t>(b) * K + k];
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < kTile; r += kRows) {
    const int k = k0 + r;
    const int b = b0 + tx;
    if (k < K && b < B) y[static_cast<size_t>(k) * B + b] = tile[tx][r];
  }
}

}  // namespace

// x: (B, K) contiguous, y: (K, B) contiguous, both 4-byte elements on
// `device`. Launches on `stream`; returns cudaGetLastError().
extern "C" int transpose_bk_b32(const void* x, void* y, int B, int K,
                                int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B > 0 && K > 0) {
    const dim3 block(kTile, kRows);
    const dim3 grid((B + kTile - 1) / kTile, (K + kTile - 1) / kTile);
    transpose_bk_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(y), B, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// transpose_traj: (T, N, F, B) -> (N, T, B, F), for 1-byte and 4-byte
// elements.
//
// Replaces the TPU kernel marlgrid_tpu/ops/transpose.py::transpose_traj
// (_pallas_t4 / _tkernel4): the bulk swap of a batch-minor trajectory
// (feature-major PPO observations, uint8) into sample-major rows.
//
// Bound on an H100 SXM: pure data movement, each element read once and
// written once. At the encode trajectory's shape (T, N, F, B) =
// (64, 4, 147, 4096) uint8 that is 2 * 154.1 MB = 308.3 MB, about 92 us at
// 3.35 TB/s. No arithmetic.
//
// Design against that bound. Each plane x[t, n] is an (F, B) matrix of F
// rows of B contiguous elements, and its transpose y[n, t] is a contiguous
// (B, F) block. So the S columns b0 .. b0+S-1 of one plane map to ONE
// contiguous run of S*F output elements, starting at element b0*F of that
// block. One unit of work is (plane, column tile); units are flattened onto
// blockIdx.x and walked with a grid stride, so the number of planes has no
// grid limit. A tile row is `vecs` 16-byte vectors (S = 128 bytes' worth
// of columns at vecs = 8: 128 uint8 or 32 int32, an 18,816-byte chunk at
// F = 147); the wrapper halves vecs for wide F so that the chunk fits.
//  1. load: each thread issues kTrajBatch 16-byte loads (row f, vector c)
//     before it stores any, so a block keeps about 16 KB in flight; a warp
//     reads whole 128-byte lines of four rows;
//  2. rearrange: each loaded element goes straight to its output place in
//     the shared chunk, chunk[s*F + f] = x[f][b0+s] (byte stores for uint8,
//     word stores for int32). F is odd in the encode trajectories (147 at
//     7x7 views, 75 at 5x5), so the warp's eight vectors c land on eight
//     distinct banks (4F mod 32 is an odd multiple of 4) and its four rows
//     f on neighbouring bytes: no bank conflict. The odd, unaligned F-runs stay
//     in shared memory;
//  3. store: the chunk goes to global memory as one linear copy of 16-byte
//     vectors, a warp writing 512 contiguous bytes.
// A ragged last tile, a B that is not a multiple of 16 bytes, or a pointer
// off 16-byte alignment takes a masked element-wise path of the same three
// steps inside the same kernel (coalesced loads and stores, one element a
// thread); nothing falls back to the host.

namespace {

constexpr int kTrajThreads = 256;
constexpr int kTrajBatch = 4;      // 16-byte loads a thread keeps in flight
constexpr int kVecBytes = 16;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;   // 227 KB, an H100 block's opt-in limit

// element i of a 16-byte vector, i a compile-time constant after unrolling
__device__ __forceinline__ uint8_t lane_of(const uint4& r, int i,
                                           uint8_t) {
  const unsigned w = i < 4 ? r.x : i < 8 ? r.y : i < 12 ? r.z : r.w;
  return static_cast<uint8_t>(w >> (8 * (i & 3)));
}

__device__ __forceinline__ int32_t lane_of(const uint4& r, int i, int32_t) {
  return static_cast<int32_t>(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z
                                                                   : r.w);
}

template <typename Elem>
__global__ void __launch_bounds__(kTrajThreads)
transpose_traj_kernel(const Elem* __restrict__ x, Elem* __restrict__ y,
                      int T, int N, int F, int B, int log_vecs,
                      long long units) {
  extern __shared__ __align__(16) unsigned char smem[];
  Elem* chunk = reinterpret_cast<Elem*>(smem);
  constexpr int kPerVec = kVecBytes / sizeof(Elem);
  const int vecs = 1 << log_vecs;
  const int S = vecs * kPerVec;                // columns per tile
  const int tiles = (B + S - 1) / S;
  const size_t plane_size = static_cast<size_t>(F) * B;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
       kVecBytes) == 0 && B % kPerVec == 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long plane = u / tiles;         // t * N + n
    const int j = static_cast<int>(u - plane * tiles);
    const int t = static_cast<int>(plane / N);
    const int n = static_cast<int>(plane - static_cast<long long>(t) * N);
    const int b0 = j * S;
    const int w = min(S, B - b0);
    // row f of the tile at xs + f * B; the output chunk, w * F contiguous
    const Elem* xs = x + plane * plane_size + b0;
    Elem* yc = y + (static_cast<size_t>(n) * T + t) * plane_size +
               static_cast<size_t>(b0) * F;
    if (aligned && w == S) {
      const int nvec = F << log_vecs;          // 16-byte vectors per tile
      for (int v0 = threadIdx.x; v0 < nvec;
           v0 += kTrajBatch * kTrajThreads) {
        uint4 r[kTrajBatch];
#pragma unroll
        for (int k = 0; k < kTrajBatch; ++k) {
          const int v = v0 + k * kTrajThreads;
          if (v < nvec) {
            const int f = v >> log_vecs;
            const int c = v & (vecs - 1);
            r[k] = __ldg(reinterpret_cast<const uint4*>(
                xs + static_cast<size_t>(f) * B + c * kPerVec));
          }
        }
#pragma unroll
        for (int k = 0; k < kTrajBatch; ++k) {
          const int v = v0 + k * kTrajThreads;
          if (v < nvec) {
            const int f = v >> log_vecs;
            const int c = v & (vecs - 1);
            Elem* dst = chunk + c * kPerVec * F + f;
#pragma unroll
            for (int i = 0; i < kPerVec; ++i) {
              dst[i * F] = lane_of(r[k], i, Elem());
            }
          }
        }
      }
      __syncthreads();
      const uint4* src = reinterpret_cast<const uint4*>(chunk);
      uint4* dst = reinterpret_cast<uint4*>(yc);
      for (int v = threadIdx.x; v < nvec; v += kTrajThreads) dst[v] = src[v];
    } else {
      const int n_el = F * w;
      for (int e = threadIdx.x; e < n_el; e += kTrajThreads) {
        const int f = e / w;
        const int s = e - f * w;
        chunk[s * F + f] = xs[static_cast<size_t>(f) * B + s];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n_el; e += kTrajThreads) yc[e] = chunk[e];
    }
    __syncthreads();                           // the chunk is reused
  }
}

template <typename Elem>
int launch_transpose_traj(const void* x, void* y, int T, int N, int F, int B,
                          int log_vecs, int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (T <= 0 || N <= 0 || F <= 0 || B <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const long long smem = static_cast<long long>(kVecBytes << log_vecs) * F;
  if (log_vecs < 0 || log_vecs > 3 || smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int S = (kVecBytes << log_vecs) / static_cast<int>(sizeof(Elem));
  const long long units =
      static_cast<long long>(T) * N * ((B + S - 1) / S);
  const unsigned grid =
      static_cast<unsigned>(units < 0x7fffffffLL ? units : 0x7fffffffLL);
  if (smem > kSmemDefault) {
    const cudaError_t attr = cudaFuncSetAttribute(
        transpose_traj_kernel<Elem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  transpose_traj_kernel<Elem><<<grid, kTrajThreads,
                                static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Elem*>(x), static_cast<Elem*>(y), T, N, F, B,
      log_vecs, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (T, N, F, B) contiguous, y: (N, T, B, F) contiguous, on `device`.
// A tile row is 2^log_vecs 16-byte vectors (0 <= log_vecs <= 3), the
// wrapper's plan (ops/transpose.py::traj_plan); its chunk, 16 << log_vecs
// bytes times F, must fit in 227 KB of shared memory. Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernel
// cannot take.
extern "C" int transpose_traj_b8(const void* x, void* y, int T, int N, int F,
                                 int B, int log_vecs, int device,
                                 void* stream) {
  return launch_transpose_traj<uint8_t>(x, y, T, N, F, B, log_vecs, device,
                                        stream);
}

extern "C" int transpose_traj_b32(const void* x, void* y, int T, int N,
                                  int F, int B, int log_vecs, int device,
                                  void* stream) {
  return launch_transpose_traj<int32_t>(x, y, T, N, F, B, log_vecs, device,
                                        stream);
}
