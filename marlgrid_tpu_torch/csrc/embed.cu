// The embed-roofline probe, kernel K6, on Hopper (sm_90a): the PR 1
// gather-sum design of onehot_embed's forward, kept as the probe of that
// design. K2f itself moved to the tensor cores in csrc/embed_fwd.cu.
//
// Replaces the TPU probe scripts/embed_roofline.py::_fwd_variant. With codes
// (R, F, S) uint8, F = 3 * cells, a packed (cells, cw, H) bf16 table and a
// per-plane code -> slot table (3 x 256; the full vocabulary clips state
// codes to 19 and gives type/color codes past their width no row, a
// compact palette gives out-of-vocabulary codes no row), a `Mode` template
// parameter picks the function, each with a float32 store:
//   kFull  - K2f's function, out[r, s, :] = sum over features f = p*cells
//            + j of W[j, slot_p(codes[r, f, s])], summed in float32;
//   kBuild - the index half alone: the code loads and the slot lookup, no
//            table read; out[r, s, h] = the number of (cell, plane) pairs
//            whose code selects a row (the row-sum of the one-hot);
//   kGemm  - the sum half alone: no lookup; every one of the cells * cw
//            table rows is read and multiplied by the sample's first code
//            (the TPU probe's dense product against a broadcast code row),
//            out[r, s, h] = float(codes[r, 0, s]) * sum_k W[k, h].
// kGemm walks all cells * cw rows per sample on purpose: a precomputed
// column sum would compute the same values and measure nothing.
//
// Bound on an H100 SXM, at the rollout's shapes (R = 4 agents, F = 147,
// S = 4096 samples, H = 128): bytes are codes in (2.4 MB), the table in
// (at most 49 * 42 * 128 * 2 = 527 KB) and the float32 output (8.4 MB);
// kFull's float32 adds, one per in-vocabulary code per hidden unit (at
// most 308 M), take about 4.6 us at 67 TFLOP/s.
//
// Design (PR 1's gather-sum): one block per (row r, tile of TS samples).
// The block reads the tile's codes once, as bytes, maps each through the
// slot table (in shared memory) and keeps the W row index of every
// (feature, sample) in shared memory. Threads run over pairs of hidden
// units (bf16x2 loads: a warp reads 128 contiguous bytes of one table row)
// and over SPT samples each, summing in float32 registers. The table is
// left to L2 and L1: every sample reads its selected rows anew, which is
// what the probe measures against the redesigned K2f.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSpt = 4;          // samples per thread
constexpr int kLut = 3 * 256;    // code -> slot, per plane
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

enum Mode { kFull = 0, kBuild = 1, kGemm = 2 };

template <int kMode>
__global__ void embed_variant_kernel(
    const uint8_t* __restrict__ codes,        // (R, F, S)
    const __nv_bfloat162* __restrict__ w,     // (cells * cw, H / 2)
    const int16_t* __restrict__ lut,          // (3, 256)
    float2* __restrict__ out,                 // (R, S, H / 2)
    int F, int S, int cells, int cw, int H2) {
  // (F, TS) W row or -1; kGemm keeps the TS first codes here as floats
  extern __shared__ int32_t rows[];
  __shared__ int16_t slut[kLut];
  const int ts = blockDim.y * kSpt;
  const int r = blockIdx.y;
  const int s0 = blockIdx.x * ts;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const uint8_t* xr = codes + static_cast<size_t>(r) * F * S;
  float* x0 = reinterpret_cast<float*>(rows);

  if (kMode == kGemm) {
    for (int s = tid; s < ts; s += nthreads) {
      x0[s] = s0 + s < S ? static_cast<float>(xr[s0 + s]) : 0.f;
    }
  } else {
    for (int i = tid; i < kLut; i += nthreads) slut[i] = lut[i];
    __syncthreads();
    for (int i = tid; i < F * ts; i += nthreads) {
      const int f = i / ts;
      const int s = i - f * ts;
      int row = -1;
      if (s0 + s < S) {
        const int p = f / cells;
        const int j = f - p * cells;
        const int slot =
            slut[p * 256 + xr[static_cast<size_t>(f) * S + s0 + s]];
        row = slot < 0 ? -1 : j * cw + slot;
      }
      rows[i] = row;
    }
  }
  __syncthreads();

  const int h2 = threadIdx.x;
  float2 acc[kSpt];
#pragma unroll
  for (int k = 0; k < kSpt; ++k) acc[k] = make_float2(0.f, 0.f);
  if (kMode == kGemm) {
    float xs[kSpt];
#pragma unroll
    for (int k = 0; k < kSpt; ++k) xs[k] = x0[threadIdx.y + k * blockDim.y];
    const int n_rows = cells * cw;
    for (int j = 0; j < n_rows; ++j) {
      const float2 v = __bfloat1622float2(w[static_cast<size_t>(j) * H2 + h2]);
#pragma unroll
      for (int k = 0; k < kSpt; ++k) {
        acc[k].x = fmaf(xs[k], v.x, acc[k].x);
        acc[k].y = fmaf(xs[k], v.y, acc[k].y);
      }
    }
  } else {
    for (int f = 0; f < F; ++f) {
      const int32_t* rf = rows + f * ts + threadIdx.y;
#pragma unroll
      for (int k = 0; k < kSpt; ++k) {
        const int row = rf[k * blockDim.y];
        if (row >= 0) {
          if (kMode == kBuild) {
            acc[k].x += 1.f;
            acc[k].y += 1.f;
          } else {
            const float2 v =
                __bfloat1622float2(w[static_cast<size_t>(row) * H2 + h2]);
            acc[k].x += v.x;
            acc[k].y += v.y;
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    const int s = s0 + threadIdx.y + k * blockDim.y;
    if (s < S) out[(static_cast<size_t>(r) * S + s) * H2 + h2] = acc[k];
  }
}

template <int kMode>
int launch(const void* codes, const void* w, const void* lut, void* out,
           int R, int F, int S, int cells, int cw, int H, int device,
           void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (R <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const int h2 = H / 2;
  if (H % 2 != 0 || h2 < 1 || h2 > 1024 || F != 3 * cells || R > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int by = h2 >= 256 ? 1 : 256 / h2;
  size_t smem = static_cast<size_t>(F) * by * kSpt * sizeof(int32_t);
  while (smem > kStaticSmem && by > 1) {
    by /= 2;
    smem = static_cast<size_t>(F) * by * kSpt * sizeof(int32_t);
  }
  if (smem + kLut * sizeof(int16_t) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > kStaticSmem) {
    cudaFuncSetAttribute(embed_variant_kernel<kMode>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int ts = by * kSpt;
  const dim3 block(h2, by);
  const dim3 grid((S + ts - 1) / ts, R);
  embed_variant_kernel<kMode><<<grid, block, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat162*>(w),
      static_cast<const int16_t*>(lut), static_cast<float2*>(out), F, S, cells,
      cw, h2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6. codes (R, F, S) uint8, w (cells * cw, H) bf16, lut (3, 256) int16
// slot or -1, out (R, S, H) float32; all contiguous on `device`, H even,
// F == 3 * cells; `mode` 0 (full), 1 (build) or 2 (gemm). Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape or mode the kernel does not take.
extern "C" int embed_variant_fwd(const void* codes, const void* w,
                                 const void* lut, void* out, int R, int F,
                                 int S, int cells, int cw, int H, int mode,
                                 int device, void* stream) {
  switch (mode) {
    case kFull:
      return launch<kFull>(codes, w, lut, out, R, F, S, cells, cw, H, device,
                           stream);
    case kBuild:
      return launch<kBuild>(codes, w, lut, out, R, F, S, cells, cw, H,
                            device, stream);
    case kGemm:
      return launch<kGemm>(codes, w, lut, out, R, F, S, cells, cw, H, device,
                           stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
