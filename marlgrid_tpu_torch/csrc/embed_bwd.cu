// onehot_embed backward (the weight gradient): the encode-obs torso's first
// layer, on Hopper (sm_90a).
//
// Replaces the backward TPU kernel marlgrid_tpu/ops/embed.py::onehot_embed
// (_bwd_w / _kernel(bwd=True)). It computes, over every row r, sample s,
// plane p and view cell j,
//   dW[j, slot_p(codes[r, p*cells + j, s]), :] += dout[r, s, :]
// where slot_p maps plane p's code to its row in the cell's (cw, H) table or
// to "no row" (out-of-vocabulary; the full vocabulary clips state codes at
// 19), dout is bf16 and the sums are float32. dW is (cells, cw, H) float32.
//
// Bound on an H100 SXM, at the PPO update's shapes (R = 2048 blocks,
// F = 147, S = 128 samples, H = 128, goal_cycle palette cw = 14): bytes are
// the codes (38.5 MB), dout (67.1 MB) and dW (0.35 MB), about 32 us at
// 3.35 TB/s; the float32 adds, one per in-vocabulary code per hidden unit
// (about 4.9 G), take about 74 us at 67 TFLOP/s. So the function is bound by
// its adds, then by its bytes.
//
// Design: the TPU kernel builds one-hot tiles and multiplies them into one
// output block that its in-order grid accumulates across steps; both are
// artifacts of the TPU's matrix unit and sequential grid. Here the function
// is a scatter-add, in two deterministic passes:
// 1. partial: one block per (group of cb view cells, chunk of samples). The
//    block keeps a float32 table for its cells, (cb, cw, H), in shared
//    memory. It stages the slot of each (plane, cell, sample) of a tile of
//    samples in shared memory (the code -> slot table is 3 x 256 entries in
//    shared memory), then thread (x, y) adds the bf16x2 dout pair x of each
//    sample into row slot of cell y. A table element belongs to exactly one
//    thread, so no atomics are needed, and every element sums its samples in
//    sample order. The block writes its whole table to its chunk's slice of
//    a float32 scratch (n_chunks, cells, cw, H). The groups of one chunk are
//    launched next to each other, so the chunk's dout rows are read from
//    device memory about once and from L2 by the other groups.
// 2. reduce: dW[i] = sum over chunks of scratch[c, i], in chunk order.
// The plan (cb, chunk length, chunk count) is a function of the shapes only,
// so the same inputs give the same bits on every run and every card.
// Shared-memory read-modify-writes, not the adds, limit pass 1: that is
// where a faster version starts (registers, a tensor-core formulation).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLut = 3 * 256;      // code -> slot, per plane
constexpr int kTile = 32;          // samples staged per step
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__global__ void onehot_embed_bwd_partial_kernel(
    const uint8_t* __restrict__ codes,          // (R, F, S)
    const __nv_bfloat162* __restrict__ dout,    // (R * S, H2)
    const int16_t* __restrict__ lut,            // (3, 256)
    float2* __restrict__ partial,               // (n_chunks, cells * cw, H2)
    int F, int S, long long M, int cells, int cw, int H2, int cb,
    long long chunk) {
  extern __shared__ float2 table[];             // (cb * cw, H2)
  int16_t* slots =
      reinterpret_cast<int16_t*>(table + static_cast<size_t>(cb) * cw * H2);
  __shared__ int16_t slut[kLut];
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int j0 = blockIdx.x * cb;
  const int ncell = min(cb, cells - j0);
  const long long m_begin = blockIdx.y * chunk;
  const long long m_end = min(M, m_begin + chunk);

  for (int i = tid; i < kLut; i += nthreads) slut[i] = lut[i];
  for (int i = tid; i < cb * cw * H2; i += nthreads) {
    table[i] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  const int x = threadIdx.x;                    // hidden pair
  const int y = threadIdx.y;                    // cell within the group
  float2* mine = table + static_cast<size_t>(y) * cw * H2 + x;
  for (long long m0 = m_begin; m0 < m_end; m0 += kTile) {
    const int n = static_cast<int>(min(static_cast<long long>(kTile),
                                       m_end - m0));
    for (int i = tid; i < 3 * cb * kTile; i += nthreads) {
      const int pq = i / kTile;                 // p * cb + q
      const int t = i - pq * kTile;
      const int p = pq / cb;
      const int q = pq - p * cb;
      int16_t slot = -1;
      if (q < ncell && t < n) {
        const long long m = m0 + t;
        const long long r = m / S;
        const long long s = m - r * S;
        slot = slut[p * 256 +
                    codes[(r * F + p * cells + j0 + q) * S + s]];
      }
      slots[i] = slot;
    }
    __syncthreads();
    if (y < ncell) {
      const __nv_bfloat162* d = dout + m0 * H2 + x;
      for (int t = 0; t < n; ++t) {
        const float2 v = __bfloat1622float2(d[static_cast<size_t>(t) * H2]);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const int slot = slots[(p * cb + y) * kTile + t];
          if (slot >= 0) {
            float2 a = mine[slot * H2];
            a.x += v.x;
            a.y += v.y;
            mine[slot * H2] = a;
          }
        }
      }
    }
    __syncthreads();
  }

  float2* out = partial +
                (static_cast<size_t>(blockIdx.y) * cells + j0) * cw * H2;
  for (int i = tid; i < ncell * cw * H2; i += nthreads) out[i] = table[i];
}

__global__ void onehot_embed_bwd_reduce_kernel(
    const float* __restrict__ partial,          // (n_chunks, n)
    float* __restrict__ dw, long long n, int n_chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += partial[c * n + i];
    dw[i] = acc;
  }
}

}  // namespace

// codes (R, F, S) uint8, dout (R, S, H) bf16, lut (3, 256) int16 slot or -1,
// partial (n_chunks, cells, cw, H) float32 scratch, dw (cells, cw, H)
// float32; all contiguous on `device`, H even, F == 3 * cells. The plan:
// cb cells per block (cb * H / 2 <= 1024 threads), chunks of `chunk`
// samples, n_chunks * chunk >= R * S > (n_chunks - 1) * chunk. Launches
// both passes on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int onehot_embed_bwd(const void* codes, const void* dout,
                                const void* lut, void* partial, void* dw,
                                int R, int F, int S, int cells, int cw, int H,
                                int cb, long long chunk, int n_chunks,
                                int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int h2 = H / 2;
  const long long M = static_cast<long long>(R) * S;
  if (H % 2 != 0 || h2 < 1 || F != 3 * cells || cells < 1 || cw < 1 ||
      cb < 1 || cb * h2 > 1024 || chunk < 1 || n_chunks < 1 ||
      n_chunks > 65535 || static_cast<long long>(n_chunks) * chunk < M ||
      static_cast<long long>(n_chunks - 1) * chunk >= (M > 0 ? M : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(cb) * cw * H * sizeof(float) +
                      3 * static_cast<size_t>(cb) * kTile * sizeof(int16_t);
  if (smem + kLut * sizeof(int16_t) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > kStaticSmem) {
    const cudaError_t a = cudaFuncSetAttribute(
        onehot_embed_bwd_partial_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (cells + cb - 1) / cb;
  onehot_embed_bwd_partial_kernel<<<dim3(groups, n_chunks), dim3(h2, cb),
                                    smem, st>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat162*>(dout),
      static_cast<const int16_t*>(lut), static_cast<float2*>(partial), F, S,
      M, cells, cw, h2, cb, chunk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(cells) * cw * H;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  onehot_embed_bwd_reduce_kernel<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}
