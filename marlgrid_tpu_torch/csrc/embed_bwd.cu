// The one-hot embed backwards (the weight gradients), K2b (onehot_embed)
// and K5b (onehot_embed2): the encode-obs torso's first layer, on Hopper
// (sm_90a), as one tensor-core kernel and one reduce pass.
//
// Replaces the backward TPU kernels marlgrid_tpu/ops/embed.py::onehot_embed
// (_bwd_w / _kernel(bwd=True)) and marlgrid_tpu/ops/embed2.py::
// onehot_embed2 (_vjp_bwd -> _bwd / _kernel_bwd). Both compute, over every
// row r, sample s, plane p and view cell j,
//   dW[j, slot_p(codes[r, p*cells + j, s]), :] += dout[r, s, :]
// where slot_p maps plane p's code to its row in the cell's (cw, H) table or
// to "no row" (out-of-vocabulary; the full vocabulary clips state codes at
// 19), dout is bf16 and the sums are float32. They differ only in where the
// sums land: K2b writes one packed (cells, cw, H) gradient, K5b three
// plane-major (cells, n_p, H) gradients, row off_p + k of cell j of the
// packed layout being row k of cell j of plane p's.
//
// Bound on an H100 SXM, at the PPO update's shapes (R = 2048 blocks,
// F = 147, S = 128 samples, H = 128, goal_cycle palette cw = 14): bytes are
// the codes (38.5 MB), dout (67.1 MB) and dW (0.35 MB), about 32 us at
// 3.35 TB/s. The sum is the product dW = A^T D, with A the (samples,
// cells * cw) one-hot matrix of the codes and D the (samples, H) dout: as
// float32 adds, one per in-vocabulary code per hidden unit (about 4.9 G),
// it takes 74 us at 67 TFLOP/s; as a dense bf16 product, 2 * 262,144 *
// 686 * 128 operations, 46.55 us at 989 TFLOP/s. The least of the routes
// bounds it: 46.55 us, by the tensor cores.
//
// What held the first ports of K2b and K5b back: a scatter-add with one
// float32 shared-memory read-modify-write per (sample, plane) and hidden
// pair, in a serial loop per thread, 3.19 ms (K2b) and 3.20 ms (K5b) at the
// update's shape (PERF.md's kernel table, the times before the redesigns):
// 69x the tensor-core bound.
//
// Design: the product on the tensor cores, with mma.sync.m16n8k16 (bf16 in,
// float32 sums in registers). A's entries are 0 or 1, exact in bf16, and
// the bf16 products are exact in float32, so only the order of the float32
// sums differs from the plain version.
// 1. partial: one block per (tile of bm table rows by bn hidden units,
//    chunk of samples), two blocks per SM (about 126 registers a thread).
//    Its 8 warps each keep a 32-row by min(bn, 64)-unit tile of float32
//    sums in registers (64 per thread at bn = 128). The block walks its
//    chunk in steps of 128 samples (on the card faster than 64: half the
//    barriers), double-buffered: it copies the step's dout rows to shared
//    memory with cp.async (rows padded by 16 bytes, so ldmatrix reads them
//    without bank conflicts) and, for every (plane, cell) its rows touch,
//    the step's slot bytes (from the codes through the 3 x 256 slot table;
//    0xff for no row), stored in the order of the mma's A fragment: a
//    thread's four samples of a k-step in one word. A thread builds its A
//    fragment of one row from that word with a byte compare against the
//    row's slot and two byte permutes (no one-hot tile exists in memory),
//    and its B fragments with ldmatrix.trans. The block writes its sums to
//    its chunk's slice of a float32 scratch (n_chunks, cells * cw, H). The
//    row tiles of one chunk are launched next to each other, so the chunk's
//    dout rows come from device memory about once and from L2 for the
//    other tiles.
// 2. reduce: dW[i] = sum over chunks of scratch[c, i], in chunk order,
//    stored at element i of the packed gradient (K2b) or at its row of
//    plane p's gradient (K5b): the reduce's output layout is a template
//    parameter, and everything before it is shared.
// The plan (ops/embed.py::bwd_plan: tile sizes, chunk length, chunk count)
// is a function of the shapes only, so the same inputs give the same bits
// on every run and every card.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kSteps = 128;        // samples staged per step
constexpr int kWarpRows = 32;      // table rows per warp: two m16 tiles
constexpr int kSlotRow = kSteps + 16;   // bytes per (plane, cell) slot row
constexpr int kLut = 3 * 256;      // code -> slot, per plane
constexpr int kMaxSmem = 227 * 1024;

// Tile shapes for bn hidden units per block.
template <int kBN>
struct Tile {
  static constexpr int kWN = kBN < 64 ? kBN : 64;   // units per warp
  static constexpr int kNT = kWN / 8;               // n8 tiles per warp
  static constexpr int kWarpsN = kBN / kWN;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kBM = kWarpsM * kWarpRows;   // rows per block
  static constexpr int kDRow = kBN * 2 + 16;        // bytes per dout row
  static constexpr int kDBytes = kSteps * kDRow;    // one dout stage
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Four 8x8 b16 matrices, transposed: B fragments of two n8 tiles.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Shape {
  int F, S, cells, w0, w01, cw, P, H;   // w01: w0 + w1; P = cells * cw
  long long M;                          // R * S samples
  int span, row_groups;                 // see ops/embed.py::BwdPlan
  long long chunk;
  bool rows16;   // S % 16 == 0 and aligned codes: 16-byte code loads
};

template <int kBN, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2) onehot_embed_bwd_mma_kernel(
    const uint8_t* __restrict__ codes,          // (R, F, S)
    const __nv_bfloat16* __restrict__ dout,     // (R * S, H)
    const int16_t* __restrict__ lut,            // (3, 256)
    float* __restrict__ partial,                // (n_chunks, P, H)
    Shape sh) {
  using Tl = Tile<kBN>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint8_t slut[kLut];   // slot, 0xff for none
  const int slot_bytes = 3 * sh.span * kSlotRow;
  uint8_t* dbuf = smem;                              // 2 dout stages
  uint8_t* sbuf = smem + 2 * Tl::kDBytes;            // 2 slot stages

  const int group = blockIdx.x % sh.row_groups;
  const int n0 = (blockIdx.x / sh.row_groups) * kBN;
  const int r0 = group * Tl::kBM;
  const int c0 = r0 / sh.cw;
  const int ncell = (min(sh.P, r0 + Tl::kBM) - 1) / sh.cw - c0 + 1;
  const long long m_begin = blockIdx.y * sh.chunk;
  const long long m_end = min(sh.M, m_begin + sh.chunk);
  const int steps = static_cast<int>((m_end - m_begin + kSteps - 1) / kSteps);
  const int tid = threadIdx.x;

  for (int i = tid; i < kLut; i += kThreads)
    slut[i] = lut[i] < 0 ? 0xff : static_cast<uint8_t>(lut[i]);

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  const int g = lane >> 2, t = lane & 3;
  // the thread's four A rows (m16 tile mt, row g or g + 8): where their
  // (plane, cell) slot row starts in a slot stage, and the slot they match
  // (0xfe never matches: a padding row past P)
  int roff[2][2];
  uint32_t rslot[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm * kWarpRows + mt * 16 + h * 8 + g;
      roff[mt][h] = 0;
      rslot[mt][h] = 0xfefefefeu;
      if (r < sh.P) {
        const int cell = r / sh.cw, k = r - cell * sh.cw;
        const int p = k < sh.w0 ? 0 : (k < sh.w01 ? 1 : 2);
        roff[mt][h] = (p * sh.span + cell - c0) * kSlotRow + 4 * t;
        rslot[mt][h] = static_cast<uint32_t>(k) * 0x01010101u;
      }
    }
  }
  float acc[2][Tl::kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tl::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  __syncthreads();   // slut

  // dout rows of `step` into buffer `buf` by cp.async (rows past the chunk
  // zeroed, so their zero A entries meet finite values; units past H are
  // left as they are and only reach output columns that are not written)
  auto copy_dout = [&](int buf, int step) {
    const long long m0 = m_begin + static_cast<long long>(step) * kSteps;
    uint8_t* db = dbuf + buf * Tl::kDBytes;
    constexpr int kPer = kVec16 ? 8 : 2;           // bf16 per copy
    for (int i = tid; i < kSteps * (kBN / kPer); i += kThreads) {
      const int row = i / (kBN / kPer), u = (i - row * (kBN / kPer)) * kPer;
      const int col = n0 + u;
      if (col >= sh.H) continue;
      uint8_t* dst = db + row * Tl::kDRow + u * 2;
      const long long m = m0 + row;
      if (m < m_end) {
        const __nv_bfloat16* src = dout + m * sh.H + col;
        if constexpr (kVec16) cp_async16(dst, src);
        else cp_async4(dst, src);
      } else if constexpr (kVec16) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = 0;
      }
    }
  };

  // slot bytes of `step` into buffer `buf`: one thread per (plane, cell,
  // 16 samples), 16 code bytes, 16 lookups, one 16-byte store in the A
  // fragment's order
  auto store_slots = [&](int buf, int step) {
    uint8_t* sb = sbuf + buf * slot_bytes;
    for (int i = tid; i < 3 * ncell * (kSteps / 16); i += kThreads) {
      const int pc = i / (kSteps / 16), q = i - pc * (kSteps / 16);
      const int p = pc / ncell, c = pc - p * ncell;
      const long long m =
          m_begin + static_cast<long long>(step) * kSteps + 16 * q;
      uint32_t w[4] = {~0u, ~0u, ~0u, ~0u};
      if (m < m_end) {
        const int n_ok = static_cast<int>(min(16LL, m_end - m));
        const uint8_t* row =
            codes + static_cast<size_t>(p * sh.cells + c0 + c) * sh.S;
        uint32_t code[16];
        if (sh.rows16) {   // the 16 samples lie in one row, 16-byte aligned
          const long long r = m / sh.S, s = m - r * sh.S;
          const uint4 v = *reinterpret_cast<const uint4*>(
              row + static_cast<size_t>(r) * sh.F * sh.S + s);
          const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            code[e] = (vw[e / 4] >> (8 * (e % 4))) & 0xff;
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const long long me = e < n_ok ? m + e : m;
            const long long r = me / sh.S, s = me - r * sh.S;
            code[e] = row[static_cast<size_t>(r) * sh.F * sh.S + s];
          }
        }
        uint32_t sl[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          sl[e] = e < n_ok ? slut[p * 256 + code[e]] : 0xffu;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = sl[2 * u] | sl[2 * u + 1] << 8 | sl[2 * u + 8] << 16 |
                 sl[2 * u + 9] << 24;
      }
      *reinterpret_cast<uint4*>(sb + (p * sh.span + c) * kSlotRow + 16 * q) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  };

  copy_dout(0, 0);
  cp_async_commit();
  store_slots(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      copy_dout(buf ^ 1, step + 1);
      store_slots(buf ^ 1, step + 1);
    }
    cp_async_commit();
    cp_async_wait_one();   // this step's copies have landed
    __syncthreads();
    const uint8_t* db = dbuf + buf * Tl::kDBytes;
    const uint8_t* sb = sbuf + buf * slot_bytes;
#pragma unroll
    for (int kk = 0; kk < kSteps / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t lo = __vcmpeq4(
            *reinterpret_cast<const uint32_t*>(sb + roff[mt][0] + kk * 16),
            rslot[mt][0]);
        const uint32_t hi = __vcmpeq4(
            *reinterpret_cast<const uint32_t*>(sb + roff[mt][1] + kk * 16),
            rslot[mt][1]);
        // bf16 1.0 (0x3f80) where the byte matched, per sample pair
        a[mt][0] = __byte_perm(lo, 0, 0x1100) & 0x3f803f80u;
        a[mt][1] = __byte_perm(hi, 0, 0x1100) & 0x3f803f80u;
        a[mt][2] = __byte_perm(lo, 0, 0x3322) & 0x3f803f80u;
        a[mt][3] = __byte_perm(hi, 0, 0x3322) & 0x3f803f80u;
      }
      const int brow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const uint8_t* bp =
          db + brow * Tl::kDRow + (wn * Tl::kWN + (lane >> 4) * 8) * 2;
#pragma unroll
      for (int np = 0; np < Tl::kNT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, bp + np * 32);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();   // the buffer is free for step + 2
  }

  float* out = partial + static_cast<size_t>(blockIdx.y) * sh.P * sh.H;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < Tl::kNT; ++nt) {
      const int col = n0 + wn * Tl::kWN + nt * 8 + 2 * t;
      if (col >= sh.H) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm * kWarpRows + mt * 16 + h * 8 + g;
        if (r < sh.P) {
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * sh.H +
                                     col) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
  }
}

// The reduce pass's output layouts. Element i = (j * cw + k) * H + h of the
// packed sum goes to element i of K2b's (cells, cw, H) gradient ...
struct PackedOut {
  float* dw;
  __device__ __forceinline__ void store(long long i, float v) const {
    dw[i] = v;
  }
};

// ... or, for K5b, to row k - off_p of cell j of plane p's (cells, n_p, H)
// gradient, p the plane whose rows [off_p, off_p + n_p) hold k.
struct PlanesOut {
  float* dw0;
  float* dw1;
  float* dw2;
  int n0, n01, cw, H;   // n01: n0 + n1
  __device__ __forceinline__ void store(long long i, float v) const {
    const long long cwh = static_cast<long long>(cw) * H;
    const long long j = i / cwh;
    const int rem = static_cast<int>(i - j * cwh);
    const int k = rem / H, h = rem - k * H;
    if (k < n0) {
      dw0[(j * n0 + k) * H + h] = v;
    } else if (k < n01) {
      dw1[(j * (n01 - n0) + k - n0) * H + h] = v;
    } else {
      dw2[(j * (cw - n01) + k - n01) * H + h] = v;
    }
  }
};

template <typename Out>
__global__ void onehot_embed_bwd_reduce_kernel(
    const float* __restrict__ partial,          // (n_chunks, n)
    const Out out, long long n, int n_chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += partial[c * n + i];
    out.store(i, acc);
  }
}

template <int kBN, bool kVec16>
cudaError_t launch_partial(const uint8_t* codes, const __nv_bfloat16* dout,
                           const int16_t* lut, float* partial,
                           const Shape& sh, int n_chunks, cudaStream_t st) {
  using Tl = Tile<kBN>;
  if (sh.row_groups != (sh.P + Tl::kBM - 1) / Tl::kBM)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(Tl::kDBytes) +
                      2 * 3 * static_cast<size_t>(sh.span) * kSlotRow;
  if (smem + kLut * sizeof(int16_t) > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = onehot_embed_bwd_mma_kernel<kBN, kVec16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_groups = (sh.H + kBN - 1) / kBN;
  kernel<<<dim3(sh.row_groups * n_groups, n_chunks), kThreads, smem, st>>>(
      codes, dout, lut, partial, sh);
  return cudaGetLastError();
}

template <int kBN>
cudaError_t launch_bn(const uint8_t* codes, const __nv_bfloat16* dout,
                      const int16_t* lut, float* partial, const Shape& sh,
                      int n_chunks, cudaStream_t st) {
  const bool vec =
      sh.H % 8 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  return vec ? launch_partial<kBN, true>(codes, dout, lut, partial, sh,
                                         n_chunks, st)
             : launch_partial<kBN, false>(codes, dout, lut, partial, sh,
                                          n_chunks, st);
}

// Both passes on `stream`, after the checks both entry points share (see
// onehot_embed_bwd); planes of w0, w1 and cw - w0 - w1 table rows.
template <typename Out>
int launch(const void* codes, const void* dout, const void* lut,
           void* partial, const Out& out, int R, int F, int S, int cells,
           int w0, int w1, int cw, int H, int bn, int span, long long chunk,
           int n_chunks, int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long M = static_cast<long long>(R) * S;
  const int bm = bn == 128 ? 128 : 256;
  const int P = cells * cw;
  // the most view cells one block's rows touch
  int need = 0;
  for (int r0 = 0; r0 < P; r0 += bm) {
    const int r1 = (r0 + bm < P ? r0 + bm : P) - 1;
    need = need > r1 / cw - r0 / cw + 1 ? need : r1 / cw - r0 / cw + 1;
  }
  if (H % 2 != 0 || H < 2 || F != 3 * cells || cells < 1 || cw < 1 ||
      cw > 250 || w0 < 0 || w1 < 0 || w0 + w1 > cw || span < need ||
      chunk < 1 || chunk % kSteps != 0 || n_chunks < 1 || n_chunks > 65535 ||
      static_cast<long long>(n_chunks) * chunk < M ||
      static_cast<long long>(n_chunks - 1) * chunk >= (M > 0 ? M : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool rows16 =
      S % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const Shape sh{F, S, cells, w0, w0 + w1, cw, P, H, M, span,
                 (P + bm - 1) / bm, chunk, rows16};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* d = static_cast<const __nv_bfloat16*>(dout);
  const auto* l = static_cast<const int16_t*>(lut);
  auto* p = static_cast<float*>(partial);
  cudaError_t e;
  switch (bn) {
    case 16: e = launch_bn<16>(c, d, l, p, sh, n_chunks, st); break;
    case 32: e = launch_bn<32>(c, d, l, p, sh, n_chunks, st); break;
    case 64: e = launch_bn<64>(c, d, l, p, sh, n_chunks, st); break;
    case 128: e = launch_bn<128>(c, d, l, p, sh, n_chunks, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(P) * H;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  onehot_embed_bwd_reduce_kernel<Out><<<blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), out, n, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2b. codes (R, F, S) uint8, dout (R, S, H) bf16, lut (3, 256) int16 row
// within a cell's table (off_p + slot) or -1, partial (n_chunks, cells, cw,
// H) float32 scratch, dw (cells, cw, H) float32; all contiguous on
// `device`, H even, F == 3 * cells, planes of w0, w1 and cw - w0 - w1 table
// rows, cw <= 250. The plan (ops/embed.py::bwd_plan): bn hidden units per
// block (16, 32, 64, 128), rows per block fixed by bn, `span` view cells
// touched by one block's rows at most, chunks of `chunk` samples (a
// multiple of 128), n_chunks * chunk >= R * S > (n_chunks - 1) * chunk.
// Launches both passes on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int onehot_embed_bwd(const void* codes, const void* dout,
                                const void* lut, void* partial, void* dw,
                                int R, int F, int S, int cells, int w0,
                                int w1, int cw, int H, int bn, int span,
                                long long chunk, int n_chunks, int device,
                                void* stream) {
  return launch(codes, dout, lut, partial, PackedOut{static_cast<float*>(dw)},
                R, F, S, cells, w0, w1, cw, H, bn, span, chunk, n_chunks,
                device, stream);
}

// K5b. As onehot_embed_bwd, with the same packed lut (rows off_p + slot,
// off_p = n_0 + .. + n_{p-1}) and scratch, over planes of n0, n1, n2 >= 1
// rows, n0 + n1 + n2 <= 250; dw_p (cells, n_p, H) float32 receives rows
// [off_p, off_p + n_p) of each cell of the packed sum.
extern "C" int onehot_embed2_bwd(const void* codes, const void* dout,
                                 const void* lut, void* partial, void* dw0,
                                 void* dw1, void* dw2, int R, int F, int S,
                                 int cells, int n0, int n1, int n2, int H,
                                 int bn, int span, long long chunk,
                                 int n_chunks, int device, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cw = n0 + n1 + n2;
  const PlanesOut out{static_cast<float*>(dw0), static_cast<float*>(dw1),
                      static_cast<float*>(dw2), n0, n0 + n1, cw, H};
  return launch(codes, dout, lut, partial, out, R, F, S, cells, n0, n1, cw,
                H, bn, span, chunk, n_chunks, device, stream);
}
