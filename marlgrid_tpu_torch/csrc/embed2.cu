// onehot_embed2's weight gradient (K5b): the plane-major one-hot embed of
// the encode-obs torso, on Hopper (sm_90a). Its forward (K5f) shares K2f's
// tensor-core kernel in csrc/embed_fwd.cu.
//
// Replaces the backward TPU kernel of marlgrid_tpu/ops/embed2.py: _bwd
// (_kernel_bwd). With codes (R, F, S) uint8, F = 3 * cells, plane p holding
// rows p*cells .. (p+1)*cells, and bf16 dout (R, S, H):
//   dW_p[j, slot_p(codes[r, p*cells + j, s]), :] += dout[r, s, :]
// over every (r, s), sums in float32, one float32 (cells, n_p, H) gradient
// per table. slot_p maps plane p's code to its row in the plane's
// vocabulary or to "no row": the full vocabularies give type and color
// codes past their width no row and clip state codes at 19; a compact
// palette gives a code outside plane p's vocabulary no row. The wrapper
// passes that map as a (3, 256) int16 table.
//
// Bound on an H100 SXM at the PPO update's shapes (R = 2048, F = 147,
// S = 128, H = 128, goal_cycle palette): one float32 add per in-vocabulary
// code per hidden unit, about 4.9 G, take 74 us at 67 TFLOP/s; it reads
// 67 MB of bf16 dout (20 us). As the dense bf16 product on the tensor
// cores (K2b's route, csrc/embed_bwd.cu) it would take 46.55 us.
//
// Design: a deterministic two-pass scatter-add: (1) one block per (group
// of cb view cells, chunk of samples) keeps a float32 table (cb, n0 + n1 +
// n2, H) for its cells in shared memory; a table element belongs to one
// thread, which adds the dout rows of the chunk's samples in sample order
// (no atomics); the block writes its table to its chunk's slice of a
// float32 scratch; (2) dW_p = the sum over chunks in chunk order, written
// straight into the three per-plane gradients. The plan (cb, chunk length,
// chunk count) is a function of the shapes only, so the same inputs give
// the same bits.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLut = 3 * 256;      // code -> slot, per plane
constexpr int kTile = 32;          // backward: samples staged per step
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__global__ void onehot_embed2_bwd_partial_kernel(
    const uint8_t* __restrict__ codes,          // (R, F, S)
    const __nv_bfloat162* __restrict__ dout,    // (R * S, H2)
    const int16_t* __restrict__ lut,            // (3, 256) slot in plane
    float2* __restrict__ partial,               // (n_chunks, cells * cw, H2)
    int F, int S, long long M, int cells, int n0, int n1, int cw, int H2,
    int cb, long long chunk) {
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

  // the slot table as rows of the packed (cw) per-cell table
  for (int i = tid; i < kLut; i += nthreads) {
    const int p = i / 256;
    const int off = p == 0 ? 0 : (p == 1 ? n0 : n0 + n1);
    const int slot = lut[i];
    slut[i] = static_cast<int16_t>(slot < 0 ? -1 : off + slot);
  }
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
      const int tt = i - pq * kTile;
      const int p = pq / cb;
      const int q = pq - p * cb;
      int16_t slot = -1;
      if (q < ncell && tt < n) {
        const long long m = m0 + tt;
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
      for (int tt = 0; tt < n; ++tt) {
        const float2 v = __bfloat1622float2(d[static_cast<size_t>(tt) * H2]);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const int slot = slots[(p * cb + y) * kTile + tt];
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

  float2* o = partial +
              (static_cast<size_t>(blockIdx.y) * cells + j0) * cw * H2;
  for (int i = tid; i < ncell * cw * H2; i += nthreads) o[i] = table[i];
}

__global__ void onehot_embed2_bwd_reduce_kernel(
    const float* __restrict__ partial,          // (n_chunks, cells, cw, H)
    float* __restrict__ dw0, float* __restrict__ dw1,
    float* __restrict__ dw2,                    // (cells, n_p, H)
    long long n, int n_chunks, int n0, int n1, int cw, int H) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += partial[c * n + i];
    const long long j = i / (static_cast<long long>(cw) * H);
    const int rem = static_cast<int>(i - j * cw * H);
    const int slot = rem / H;
    const int h = rem - slot * H;
    if (slot < n0) {
      dw0[(j * n0 + slot) * H + h] = acc;
    } else if (slot < n0 + n1) {
      dw1[(j * n1 + slot - n0) * H + h] = acc;
    } else {
      const int n2 = cw - n0 - n1;
      dw2[(j * n2 + slot - n0 - n1) * H + h] = acc;
    }
  }
}

bool bad_widths(int n0, int n1, int n2) {
  return n0 < 1 || n1 < 1 || n2 < 1 || n0 > 256 || n1 > 256 || n2 > 256;
}

}  // namespace

// codes (R, F, S) uint8, dout (R, S, H) bf16, lut (3, 256) int16 slot within
// plane p or -1, partial (n_chunks, cells, n0 + n1 + n2, H) float32 scratch,
// dw_p (cells, n_p, H) float32; all contiguous on `device`, H even,
// F == 3 * cells. The plan: cb cells per block (cb * H / 2 <= 1024
// threads), chunks of `chunk` samples, n_chunks * chunk >= R * S >
// (n_chunks - 1) * chunk. Launches both passes on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan the
// kernel does not take.
extern "C" int onehot_embed2_bwd(const void* codes, const void* dout,
                                 const void* lut, void* partial, void* dw0,
                                 void* dw1, void* dw2, int R, int F, int S,
                                 int cells, int n0, int n1, int n2, int H,
                                 int cb, long long chunk, int n_chunks,
                                 int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int h2 = H / 2;
  const int cw = n0 + n1 + n2;
  const long long M = static_cast<long long>(R) * S;
  if (H % 2 != 0 || h2 < 1 || F != 3 * cells || cells < 1 ||
      bad_widths(n0, n1, n2) || cw > 32767 || cb < 1 || cb * h2 > 1024 ||
      chunk < 1 || n_chunks < 1 || n_chunks > 65535 ||
      static_cast<long long>(n_chunks) * chunk < M ||
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
        onehot_embed2_bwd_partial_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (cells + cb - 1) / cb;
  onehot_embed2_bwd_partial_kernel<<<dim3(groups, n_chunks), dim3(h2, cb),
                                     smem, st>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat162*>(dout),
      static_cast<const int16_t*>(lut), static_cast<float2*>(partial), F, S,
      M, cells, n0, n1, cw, h2, cb, chunk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(cells) * cw * H;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  onehot_embed2_bwd_reduce_kernel<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw0),
      static_cast<float*>(dw1), static_cast<float*>(dw2), n, n_chunks, n0, n1,
      cw, H);
  return static_cast<int>(cudaGetLastError());
}
