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
