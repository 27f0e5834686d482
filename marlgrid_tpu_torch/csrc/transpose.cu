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
// Design: K1's tiled shared-memory transpose applied to every (t, n) plane
// of the trajectory, one plane per blockIdx.z: the plane x[t, n] is an
// (F, B) matrix and its transpose is y[n, t], a (B, F) matrix. A block of
// 32 x 8 threads moves one 32 x 32 tile; a warp reads 32 consecutive
// elements of a row (one 32-byte sector for bytes, a 128-byte line for
// words) and writes 32 consecutive elements of an output row, so both sides
// are coalesced into whole sectors. The tile row is padded by one element,
// so the column-wise shared-memory reads spread over the banks. Ragged edges
// (F = 147, any B) are masked.

namespace {

template <typename Elem>
__global__ void transpose_traj_kernel(const Elem* __restrict__ x,
                                      Elem* __restrict__ y, int T, int N,
                                      int F, int B) {
  __shared__ Elem tile[kTile][kTile + 1];
  const int plane = blockIdx.z;              // t * N + n
  const int t = plane / N;
  const int n = plane - t * N;
  const size_t size = static_cast<size_t>(F) * B;
  const Elem* xp = x + static_cast<size_t>(plane) * size;
  Elem* yp = y + (static_cast<size_t>(n) * T + t) * size;
  const int b0 = blockIdx.x * kTile;
  const int f0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
#pragma unroll
  for (int r = ty; r < kTile; r += kRows) {
    const int f = f0 + r;
    const int b = b0 + tx;
    if (f < F && b < B) tile[r][tx] = xp[static_cast<size_t>(f) * B + b];
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < kTile; r += kRows) {
    const int b = b0 + r;
    const int f = f0 + tx;
    if (b < B && f < F) yp[static_cast<size_t>(b) * F + f] = tile[tx][r];
  }
}

template <typename Elem>
int launch_transpose_traj(const void* x, void* y, int T, int N, int F, int B,
                          int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (T <= 0 || N <= 0 || F <= 0 || B <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const long long planes = static_cast<long long>(T) * N;
  if (planes > 65535 || (F + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTile, kRows);
  const dim3 grid((B + kTile - 1) / kTile, (F + kTile - 1) / kTile,
                  static_cast<unsigned>(planes));
  transpose_traj_kernel<Elem><<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Elem*>(x), static_cast<Elem*>(y), T, N, F, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (T, N, F, B) contiguous, y: (N, T, B, F) contiguous, on `device`;
// T * N <= 65535 and F <= 65535 * 32. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the grid cannot
// hold.
extern "C" int transpose_traj_b8(const void* x, void* y, int T, int N, int F,
                                 int B, int device, void* stream) {
  return launch_transpose_traj<uint8_t>(x, y, T, N, F, B, device, stream);
}

extern "C" int transpose_traj_b32(const void* x, void* y, int T, int N,
                                  int F, int B, int device, void* stream) {
  return launch_transpose_traj<int32_t>(x, y, T, N, F, B, device, stream);
}
