// The one-hot embed forwards, K2f (onehot_embed) and K5f (onehot_embed2): the
// encode-obs torso's first layer, on Hopper (sm_90a), as one tensor-core
// kernel with the table resident in shared memory; and K6, the probe of that
// kernel's two halves.
//
// Replaces the forward TPU kernels marlgrid_tpu/ops/embed.py::onehot_embed
// (_fwd / _kernel(bwd=False)) and marlgrid_tpu/ops/embed2.py::onehot_embed2
// (_fwd / _kernel_fwd). Both compute, for every sample m = (row r, sample s)
// of codes (R, F, S) uint8, F = 3 * cells,
//   out[m, :] = sum over features f = p*cells + j of T[row_f(code), :]
// where T is a bf16 table of P rows, row_f(code) = walk[f] + lut[p][code]
// (no row where lut[p][code] < 0: a code outside plane p's vocabulary; the
// full vocabulary clips state codes at 19), and the sum is float32. The
// two differ only in the table's row order and the output dtype:
// - K2f: one packed (cells, cw, H) table, rows j*cw + off_p + slot (lut
//   gives off_p + slot); the sum is rounded once to bf16, to nearest even;
// - K5f: three plane-major (cells, n_p, H) tables staged back to back in one
//   row space, rows cells*off_p + j*n_p + slot (lut gives slot); float32 out.
// The wrappers (ops/embed.py, ops/embed2.py) pass the row bases walk.
//
// Bound on an H100 SXM. Written as the product out = A T, with A the
// (samples, P) one-hot matrix of the codes, the sum is a dense bf16 product
// of 2 * samples * P * H operations; A's entries are 0 or 1, exact in bf16,
// and the bf16 products are exact in float32, so only the order of the
// float32 sums differs from a gather-sum. At the PPO update's shape (R =
// 2048, F = 147, S = 128, H = 128, goal_cycle palette, P = 686) that is
// 46.0 G operations, 46.55 us at 989 TFLOP/s; as float32 adds, one per
// in-vocabulary code per hidden unit, 73.62 us at 67 TFLOP/s. The bytes
// are the codes (38.5 MB) and the output, 67.1 MB bf16 (K2f: 31.6 us at
// 3.35 TB/s) or 134.2 MB float32 (K5f: 51.6 us). The least over the
// routes: K2f 46.55 us (tensor cores), K5f 51.6 us (bytes). At the
// rollout's shape (R = 4, S = 4096): 2.91 us and 3.3 us.
//
// What the earlier design lost (PR 1's gather-sum for K2f, PR 4's for K5f):
// one block per (row r, 16 samples), and for every feature of every sample
// a dependent 4-byte load of the selected table row from L2. At the
// update's shape each sample re-read up to 147 rows of 256 bytes, about
// 9.9 GB of L2 traffic for a 67 MB output: K2f 1964.17 / 134.70 us and K5f
// 1987.01 / 141.62 us at the update's / rollout's shape (PERF.md's kernel
// table, the times before the redesign), 42x and 38x the bound.
//
// Design: the product on the tensor cores, with mma.sync.m16n8k16 (bf16 in,
// float32 sums in registers), as csrc/embed_bwd.cu does for the gradient.
// 1. The table crosses from L2 into each SM once per launch. Blocks are
//    persistent, one per SM (ops/embed.py::fwd_plan caps the grid at 132
//    blocks). Each stages a slice of bn hidden units of all P table rows
//    (padded to a multiple of 32) into shared memory once, by cp.async, in
//    16-byte chunks XOR-swizzled by row, so that ldmatrix.trans reads eight
//    rows without bank conflicts (rows past P and units past H are zeroed),
//    then walks tiles of 128 samples. With the palette at H = 128 the whole
//    table fits (704 x 256 B = 176 KB); the full vocabulary (2058 rows at 49
//    cells, 1050 at 25) and large H take groups of bn = 16, 32 or 64 units.
//    Block b takes group b % n_groups and tiles b / n_groups, + blocks per
//    group, ...: the groups of one tile run side by side, so the tile's
//    codes come from device memory about once and from L2 for the others.
// 2. No one-hot tile exists. Four builder warps make, for each tile, a row
//    mask per sample in shared memory, a 32-bit word per 32 table rows (two
//    16-row k-steps), while the eight mma warps multiply the previous tile
//    (two mask buffers, named barriers between the roles). The builders
//    copy the tile's codes into shared memory by cp.async; then lane q
//    takes samples 4q .. 4q + 3 (one 4-byte word of a feature's codes) and
//    ORs, in registers, the bits of each mask word over the features whose
//    rows can fall in it (a range of the features in row order, from the
//    wrapper's walk table), and stores each word once: no atomics, no
//    zeroing. Within a word, row 16*kk + 2q' + e sits at bit q' + 8*(kk &
//    1) + 16*e, so a thread's A fragment register (rows 2t, 2t + 1 of a
//    k-step for one sample) is the word shifted by t, masked and multiplied
//    by bf16 1.0 (0x3f80): two bits in the two halves.
// 3. Each mma warp keeps a (64, 32, 16 or 16) sample by (32, 32, 32 or 16)
//    unit tile of float32 sums in registers for bn = 128, 64, 32, 16; B
//    fragments come from the staged table by ldmatrix.trans; the next mask
//    word is loaded while the current one's products run. Each output
//    element is summed by one thread over all k-steps in order, so the
//    result does not depend on the plan or the card: the same inputs give
//    the same bits. The epilogue swaps pairs of sums between neighbouring
//    lanes so that each thread stores four consecutive units (8 bytes of
//    bf16 for K2f, rounded once; 16 bytes of float32 for K5f): a warp's
//    store fills whole 32-byte sectors. Where H % 4 != 0, pairs are stored
//    as they are.
// On the card, shared-memory atomics from every (sample, feature), two
// blocks per SM without the builder warps, a skip of k-steps whose masks
// are empty for a whole warp, and 16 mma warps at bn = 128 were each
// slower than this design at the update's shape.
//
// K6, the embed-roofline probe (replaces the TPU probe
// scripts/embed_roofline.py::_fwd_variant, which splits the TPU kernel the
// same way): the kernel's `Mode` template parameter runs it under K2f's
// plan, grid and packed table with a float32 store (K5f's epilogue), whole
// (kModeFull: K2f's sum) or one half alone, so that the three times split
// it:
//   kModeBuild - the index half: the builder warps make the row masks
//     exactly as in kModeFull (with the full vocabulary, every unit group
//     again); the mma warps stage no table and run no mma, and store, for
//     every unit, the popcount of their sample's mask words: the number of
//     (cell, plane) pairs whose code selects a row (the row-sum of the
//     one-hot), exact;
//   kModeGemm - the sum half: the table is staged as in kModeFull, no mask
//     is built (the builder warps leave at once); every A register holds
//     the sample's first code, in bf16 (exact: codes are at most 255), in
//     both halves, at every k-step, and the same ldmatrix.trans / mma
//     sequence runs over all padded rows (zero past P): out[m, h] =
//     code(m, 0) * sum_k T[k, h], summed over the k-steps in order. A
//     column sum computed once would give the same values and measure
//     nothing: the kernel does not take it.
// Bound on an H100 SXM, at the update's / rollout's shape with the palette:
// kModeFull its float32 output's bytes, 51.6 / 3.3 us (as K5f); kModeBuild
// its codes and float32 output, 51.6 / 3.2 us; kModeGemm, the function
// code(m, 0) * colsum(T)[h], the bytes of its first code row, table and
// float32 output, 40.20 / 2.56 us. The dense bf16 product that kModeGemm
// runs in its place would take 46.55 / 2.91 us at 989 TFLOP/s.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMmaWarps = 8;       // the products and the stores
constexpr int kBuildWarps = 4;     // the row masks of the next tile
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBuildThreads = 32 * kBuildWarps;
constexpr int kThreads = 32 * (kMmaWarps + kBuildWarps);
constexpr int kTile = 128;         // samples per tile
// named barriers (0 is __syncthreads): masks buffer b full / empty; the
// table staged, among the mma warps; the tile's codes, among the builders
constexpr int kFull = 1, kEmpty = 3, kTable = 5, kCodes = 6;
constexpr int kLut = 3 * 256;      // code -> slot, per plane
constexpr int kMaxSmem = 227 * 1024;
// the kernel's function: K2f's / K5f's sum, or one of K6's halves
enum Mode { kModeFull = 0, kModeBuild = 1, kModeGemm = 2 };
// the mask build: 32 lanes of 4 samples cover a tile
static_assert(kTile == 128, "mask build layout");

// Where sample m of a tile keeps its mask words within a row of kTile
// words: in 32-sample blocks, with the 4 samples of a build lane rotated
// by the block, so that the build's stores (one sample j of each of 32
// lanes) and the mma's loads (8 consecutive samples) each hit 32 or 8
// different banks.
__device__ __forceinline__ int mask_pos(int m) {
  const int blk = m >> 5, u = m & 31;
  return 32 * blk + 4 * (u >> 2) + (((u & 3) + blk) & 3);
}

// Warp tiles for bn hidden units per block: the 8 mma warps over 128
// samples and bn units.
template <int kBN>
struct Tile {
  static constexpr int kWN = kBN < 32 ? kBN : 32;   // units per warp
  static constexpr int kNT = kWN / 8;               // n8 tiles per warp
  static constexpr int kWarpsN = kBN / kWN;
  static constexpr int kWarpsM = kMmaWarps / kWarpsN;
  static constexpr int kWM = kTile / kWarpsM;       // samples per warp
  static constexpr int kMT = kWM / 16;              // m16 tiles per warp
  static constexpr int kRow = kBN * 2;              // bytes per table row
  // The 16-byte chunk c of table row k is stored at chunk c ^ swz(k), so
  // that the 8 rows an ldmatrix reads with one chunk index fall in 8
  // different 16-byte bank groups (rows of 32, 64, 128 or 256 bytes).
  static __device__ __forceinline__ int swz(int k) {
    if constexpr (kBN >= 64) return k & 7;
    else if constexpr (kBN == 32) return (k >> 1) & 3;
    else return (k >> 2) & 1;
  }
};

// The table: up to three row-major (rows_i, H) bf16 segments, back to back
// in one row space (K2f: one; K5f: the three plane tables).
struct Segs {
  const __nv_bfloat16* w[3];
  int rows[3];
};

struct Shape {
  long long M;          // R * S samples
  long long n_tiles;    // ceil(M / kTile)
  int F, S, cells, P, H;
  int k_steps;          // ceil(P / 32) * 2: the table padded to 32 rows
  int k_words;          // k_steps / 2: mask words per sample
  int n_groups;         // ceil(H / bn)
  int blocks;           // blocks per group
  bool vec_table;       // H % 8 == 0, tables 16-byte aligned: 16-byte copies
  bool vec_out;         // H % 4 == 0: four units per store
  bool vec_codes;       // S % 16 == 0, codes 16-byte aligned: cp.async
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Wait at named barrier `id` until `n` threads have arrived or waited.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Arrive at named barrier `id` (of `n` threads) without waiting.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

// Registers only (no volatile): the compiler may interleave it with loads.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four consecutive units at out + i: bf16 rounded once (8 bytes) or float32
// (16 bytes).
__device__ __forceinline__ void store4(__nv_bfloat16* out, long long i,
                                       float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(out + i) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void store4(float* out, long long i, float4 v) {
  *reinterpret_cast<float4*>(out + i) = v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, long long i,
                                       float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) =
      __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ void store2(float* out, long long i, float2 v) {
  *reinterpret_cast<float2*>(out + i) = v;
}

template <int kBN, int kMode, typename Out>
__global__ void __launch_bounds__(kThreads, 1) onehot_embed_fwd_mma_kernel(
    const uint8_t* __restrict__ codes,          // (R, F, S)
    const Segs segs,                            // (P, H) bf16 in segments
    const int16_t* __restrict__ lut,            // (3, 256) slot or -1
    const int32_t* __restrict__ walk,           // see onehot_embed_fwd
    Out* __restrict__ out,                      // (R, S, H)
    const Shape sh) {
  using Tl = Tile<kBN>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int16_t slut[kLut];
  // tab (k_steps * 16, kRow): the table's slice; masks 2 x (k_words, kTile):
  // a sample's row bits, sample m at mask_pos(m), one buffer per tile in
  // flight; tcodes (F, kTile): the codes of the tile being built; feat
  // (F,), in row order: row base, p * 256, feature index
  uint8_t* tab = smem;
  uint32_t* masks = reinterpret_cast<uint32_t*>(
      smem + static_cast<size_t>(sh.k_steps) * 16 * Tl::kRow);
  const int mask_words = sh.k_words * kTile;
  uint8_t* tcodes = reinterpret_cast<uint8_t*>(masks + 2 * mask_words);
  int4* feat = reinterpret_cast<int4*>(tcodes + sh.F * kTile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = (blockIdx.x % sh.n_groups) * kBN;
  const long long first = blockIdx.x / sh.n_groups;

  for (int i = tid; i < kLut; i += kThreads) slut[i] = lut[i];
  for (int i = tid; i < sh.F; i += kThreads) {
    const int f = walk[2 * i];
    feat[i] = make_int4(walk[2 * i + 1], (f / sh.cells) * 256, f, 0);
  }
  if (warp < kMmaWarps && kMode != kModeBuild) {
    // the table's slice of units [n0, n0 + bn), once per launch
    constexpr int kChunks = kBN / 8;                      // 16 bytes each
    for (int i = tid; i < sh.k_steps * 16 * kChunks; i += kMmaThreads) {
      const int k = i / kChunks, c = i - k * kChunks;
      const int col = n0 + 8 * c;
      uint8_t* dst =
          tab + static_cast<size_t>(k) * Tl::kRow + 16 * (c ^ Tl::swz(k));
      const __nv_bfloat16* src = nullptr;
      if (k < sh.P) {
        int row = k;
        const __nv_bfloat16* w = segs.w[0];
        if (row >= segs.rows[0]) {
          row -= segs.rows[0];
          w = segs.w[1];
          if (row >= segs.rows[1]) {
            row -= segs.rows[1];
            w = segs.w[2];
          }
        }
        src = w + static_cast<size_t>(row) * sh.H;
      }
      if (src != nullptr && sh.vec_table && col < sh.H) {
        cp_async16(dst, src + col);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {      // H is even: whole pairs
          uint32_t* d = reinterpret_cast<uint32_t*>(dst + 4 * e);
          if (src != nullptr && col + 2 * e < sh.H) {
            cp_async4(d, src + col + 2 * e);
          } else {
            *d = 0u;
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __syncthreads();   // slut, feat

  if (warp >= kMmaWarps) {
    if constexpr (kMode == kModeGemm) return;
    // The builders: per tile, they copy its codes into shared memory; then
    // lane q takes samples 4q .. 4q + 3 (one 4-byte word of a feature's
    // codes), builder warp bw the mask words bw, bw + 4, ...; each (sample,
    // word) is ORed in a register over the features whose rows can fall in
    // the word and stored once.
    const int q = lane, bw = warp - kMmaWarps;
    const int* ranges = walk + 2 * sh.F;
    int mpos[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mpos[j] = mask_pos(4 * q + j);
    const int btid = tid - kMmaThreads;
    int it = 0;
    for (long long tile = first; tile < sh.n_tiles;
         tile += sh.blocks, ++it) {
      const int buf = it & 1;
      const long long m0 = tile * kTile;
      // the tile's codes into shared memory, (F, kTile) bytes
      if (it > 0) bar_sync(kCodes, kBuildThreads);   // all read the last
      if (sh.vec_codes) {
        // S % 16 == 0: each 16 samples lie in one row, 16-byte aligned
        for (int i = btid; i < sh.F * (kTile / 16); i += kBuildThreads) {
          const int f = i / (kTile / 16), c = i - f * (kTile / 16);
          const long long m = m0 + 16 * c;
          if (m < sh.M) {
            const long long r = m / sh.S;
            cp_async16(tcodes + f * kTile + 16 * c,
                       codes + (r * sh.F + f) * sh.S + (m - r * sh.S));
          }
        }
        asm volatile("cp.async.commit_group;\n" ::);
        cp_async_wait_all();
      } else {
        for (int i = btid; i < sh.F * kTile; i += kBuildThreads) {
          const int f = i / kTile;
          const long long m = m0 + (i - f * kTile);
          uint8_t code = 0;
          if (m < sh.M) {
            const long long r = m / sh.S;
            code = codes[(r * sh.F + f) * sh.S + (m - r * sh.S)];
          }
          tcodes[i] = code;
        }
      }
      bar_sync(kCodes, kBuildThreads);
      if (it >= 2) bar_sync(kEmpty + buf, kThreads);   // mma warps done
      uint32_t* mb = masks + buf * mask_words;
      for (int w = bw; w < sh.k_words; w += kBuildWarps) {
        const int i0 = ranges[2 * w], i1 = ranges[2 * w + 1];
        uint32_t bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
        for (int i = i0; i < i1; ++i) {
          const int4 fi = feat[i];
          const uint32_t c4 =
              *reinterpret_cast<const uint32_t*>(tcodes + fi.z * kTile + 4 * q);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int slot = slut[fi.y + ((c4 >> (8 * j)) & 0xffu)];
            const int row = fi.x + slot;
            if (slot >= 0 && row >> 5 == w)
              bits[j] |= 1u << (((row >> 1) & 7) | ((row >> 4) & 1) << 3 |
                                (row & 1) << 4);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mb[w * kTile + mpos[j]] = bits[j];
      }
      __threadfence_block();
      bar_arrive(kFull + buf, kThreads);   // the masks of `tile` are ready
    }
    return;
  }

  // The mma warps.
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix.trans row within a k-step, and the swizzled
  // chunk of each pair of n8 tiles (the swizzle of row 16 * kk + lr is
  // that of lr)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint8_t* brow = tab + lr * Tl::kRow;
  int bchunk[Tl::kNT / 2];
#pragma unroll
  for (int np = 0; np < Tl::kNT / 2; ++np)
    bchunk[np] =
        16 * (((wn * Tl::kWN + 16 * np + (lane >> 4) * 8) / 8) ^ Tl::swz(lr));
  // the mask words of the sample rows g and g + 8 of each m16 tile
  int mrow[Tl::kMT][2];
#pragma unroll
  for (int i = 0; i < Tl::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mrow[i][h] = mask_pos(wm * Tl::kWM + 16 * i + 8 * h + g);
  cp_async_wait_all();
  bar_sync(kTable, kMmaThreads);   // the table has landed

  int it = 0;
  for (long long tile = first; tile < sh.n_tiles; tile += sh.blocks, ++it) {
    const int buf = it & 1;
    const uint32_t* mb = masks + buf * mask_words;
    if constexpr (kMode != kModeGemm)
      bar_sync(kFull + buf, kThreads);   // the builders are done
    float acc[Tl::kMT][Tl::kNT][4];
#pragma unroll
    for (int i = 0; i < Tl::kMT; ++i)
#pragma unroll
      for (int j = 0; j < Tl::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    if constexpr (kMode == kModeBuild) {
      // K6 'build': the rows selected, the set bits of the sample's mask
      // words, as every unit's value
#pragma unroll
      for (int i = 0; i < Tl::kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int bits = 0;
          for (int kw = 0; kw < sh.k_words; ++kw)
            bits += __popc(mb[kw * kTile + mrow[i][h]]);
#pragma unroll
          for (int j = 0; j < Tl::kNT; ++j) {
            acc[i][j][2 * h] = static_cast<float>(bits);
            acc[i][j][2 * h + 1] = static_cast<float>(bits);
          }
        }
      }
    } else {
      // K6 'gemm': the A registers of the sample rows g and g + 8 of each
      // m16 tile, their first code in bf16 in both halves (0 past M)
      [[maybe_unused]] uint32_t x0[Tl::kMT][2];
      if constexpr (kMode == kModeGemm) {
#pragma unroll
        for (int i = 0; i < Tl::kMT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long m =
                tile * kTile + wm * Tl::kWM + 16 * i + 8 * h + g;
            float code = 0.f;
            if (m < sh.M) {
              const long long r = m / sh.S;
              code = codes[r * sh.F * sh.S + (m - r * sh.S)];
            }
            x0[i][h] = static_cast<uint32_t>(__bfloat16_as_ushort(
                           __float2bfloat16(code))) * 0x00010001u;
          }
        }
      }
      // two k-steps per mask word; the next word's masks are loaded while
      // this word's products run
      [[maybe_unused]] uint32_t lo[Tl::kMT], hi[Tl::kMT];
      if constexpr (kMode == kModeFull) {
#pragma unroll
        for (int i = 0; i < Tl::kMT; ++i) {
          lo[i] = mb[mrow[i][0]];
          hi[i] = mb[mrow[i][1]];
        }
      }
      for (int kw = 0; kw < sh.k_words; ++kw) {
        [[maybe_unused]] uint32_t nlo[Tl::kMT], nhi[Tl::kMT];
        if constexpr (kMode == kModeFull) {
          const int kn = min(kw + 1, sh.k_words - 1) * kTile;
#pragma unroll
          for (int i = 0; i < Tl::kMT; ++i) {
            nlo[i] = mb[kn + mrow[i][0]];
            nhi[i] = mb[kn + mrow[i][1]];
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // a0/a1: rows 2t, 2t + 1 (bits t, t + 16 after the shift) of
          // samples g / g + 8; a2/a3: rows 2t + 8, 2t + 9 (bits t + 4,
          // t + 20)
          uint32_t a[Tl::kMT][4];
#pragma unroll
          for (int i = 0; i < Tl::kMT; ++i) {
            if constexpr (kMode == kModeFull) {
              const uint32_t x = lo[i] >> (t + 8 * h);
              const uint32_t y = hi[i] >> (t + 8 * h);
              a[i][0] = (x & 0x00010001u) * 0x3f80u;
              a[i][1] = (y & 0x00010001u) * 0x3f80u;
              a[i][2] = (x & 0x00100010u) * 0x3f8u;
              a[i][3] = (y & 0x00100010u) * 0x3f8u;
            } else {
              a[i][0] = a[i][2] = x0[i][0];
              a[i][1] = a[i][3] = x0[i][1];
            }
          }
          const uint8_t* bp =
              brow + static_cast<size_t>(2 * kw + h) * 16 * Tl::kRow;
#pragma unroll
          for (int np = 0; np < Tl::kNT / 2; ++np) {
            uint32_t b[4];
            ldsm_x4_trans(b, bp + bchunk[np]);
#pragma unroll
            for (int i = 0; i < Tl::kMT; ++i) {
              mma_bf16(acc[i][2 * np], a[i], b[0], b[1]);
              mma_bf16(acc[i][2 * np + 1], a[i], b[2], b[3]);
            }
          }
        }
        if constexpr (kMode == kModeFull) {
#pragma unroll
          for (int i = 0; i < Tl::kMT; ++i) {
            lo[i] = nlo[i];
            hi[i] = nhi[i];
          }
        }
      }
    }
    // the builders may refill this buffer with the tile after next
    if (kMode != kModeGemm && tile + 2 * sh.blocks < sh.n_tiles)
      bar_arrive(kEmpty + buf, kThreads);

    // sums of (sample g or g + 8, units 2t, 2t + 1) of each n8 tile
#pragma unroll
    for (int i = 0; i < Tl::kMT; ++i) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long m =
            tile * kTile + wm * Tl::kWM + 16 * i + 8 * hr + g;
        const bool ok = m < sh.M;
        Out* orow = out + m * sh.H;
#pragma unroll
        for (int np = 0; np < Tl::kNT / 2; ++np) {
          const int base = n0 + wn * Tl::kWN + 16 * np;
          const float2 v0 = make_float2(acc[i][2 * np][2 * hr],
                                        acc[i][2 * np][2 * hr + 1]);
          const float2 v1 = make_float2(acc[i][2 * np + 1][2 * hr],
                                        acc[i][2 * np + 1][2 * hr + 1]);
          if (sh.vec_out) {
            // lanes t, t ^ 1 swap a pair: even t stores units base + 2t ..
            // + 3 of the first n8 tile, odd t units base + 8 + 2(t - 1) ..
            // of the second
            const float2 send = (t & 1) ? v0 : v1;
            const float2 recv =
                make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                            __shfl_xor_sync(0xffffffffu, send.y, 1));
            const float4 v = (t & 1)
                                 ? make_float4(recv.x, recv.y, v1.x, v1.y)
                                 : make_float4(v0.x, v0.y, recv.x, recv.y);
            const int col = base + 4 * ((t >> 1) + 2 * (t & 1));
            if (ok && col < sh.H) store4(orow, col, v);
          } else {
            if (ok && base + 2 * t < sh.H) store2(orow, base + 2 * t, v0);
            if (ok && base + 8 + 2 * t < sh.H)
              store2(orow, base + 8 + 2 * t, v1);
          }
        }
      }
    }
  }
}

template <int kBN, int kMode, typename Out>
cudaError_t launch_bn(const uint8_t* codes, const Segs& segs,
                      const int16_t* lut, const int32_t* walk, Out* out,
                      const Shape& sh, cudaStream_t st) {
  using Tl = Tile<kBN>;
  const size_t smem =
      static_cast<size_t>(sh.k_steps) * 16 * Tl::kRow +
      2 * static_cast<size_t>(sh.k_words) * kTile * 4 +
      static_cast<size_t>(sh.F) * kTile +
      static_cast<size_t>(sh.F) * sizeof(int4);
  if (smem + kLut * sizeof(int16_t) > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = onehot_embed_fwd_mma_kernel<kBN, kMode, Out>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<sh.blocks * sh.n_groups, kThreads, smem, st>>>(codes, segs, lut,
                                                          walk, out, sh);
  return cudaGetLastError();
}

template <int kMode, typename Out>
int launch(const void* codes, const Segs& segs, const void* lut,
           const void* walk, void* out, int R, int F, int S, int cells,
           int H, int bn, int blocks, int device, void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int P = segs.rows[0] + segs.rows[1] + segs.rows[2];
  bool aligned4 = true, aligned16 = true;
  for (int i = 0; i < 3; ++i) {
    const auto a = reinterpret_cast<uintptr_t>(segs.w[i]);
    aligned4 = aligned4 && a % 4 == 0;
    aligned16 = aligned16 && a % 16 == 0;
  }
  if (H % 2 != 0 || H < 2 || H > 2048 || F != 3 * cells || cells < 1 ||
      R < 0 || R > 65535 || S < 0 || P < 1 || blocks < 1 || !aligned4 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long M = static_cast<long long>(R) * S;
  if (M == 0) return static_cast<int>(cudaGetLastError());
  Shape sh;
  sh.M = M;
  sh.n_tiles = (M + kTile - 1) / kTile;
  sh.F = F;
  sh.S = S;
  sh.cells = cells;
  sh.P = P;
  sh.H = H;
  sh.k_words = (P + 31) / 32;
  sh.k_steps = 2 * sh.k_words;
  sh.n_groups = (H + bn - 1) / bn;
  sh.blocks = blocks;
  sh.vec_table = H % 8 == 0 && aligned16;
  sh.vec_out = H % 4 == 0;
  sh.vec_codes =
      S % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  if (static_cast<long long>(blocks) > sh.n_tiles ||
      static_cast<long long>(blocks) * sh.n_groups > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* l = static_cast<const int16_t*>(lut);
  const auto* rb = static_cast<const int32_t*>(walk);
  Out* o = static_cast<Out*>(out);
  cudaError_t e;
  switch (bn) {
    case 16: e = launch_bn<16, kMode>(c, segs, l, rb, o, sh, st); break;
    case 32: e = launch_bn<32, kMode>(c, segs, l, rb, o, sh, st); break;
    case 64: e = launch_bn<64, kMode>(c, segs, l, rb, o, sh, st); break;
    case 128: e = launch_bn<128, kMode>(c, segs, l, rb, o, sh, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace

// K2f. codes (R, F, S) uint8, w (cells, cw, H) bf16, lut (3, 256) int16
// row within a cell's table (off_p + slot) or -1, walk int32
// (ops/embed.py::fwd_walk): (feature p*cells + j, its row base j * cw) for
// the F features in the order of their rows, then for each of the
// ceil(P / 32) mask words the range [i0, i1) of those features whose rows
// can fall in it; out (R, S, H) bf16; all contiguous on
// `device`, H even <= 2048, F == 3 * cells, R <= 65535. The plan
// (ops/embed.py::fwd_plan): bn hidden units per block (16, 32, 64, 128),
// `blocks` blocks per group of units, at most one per tile of 128 samples.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int onehot_embed_fwd(const void* codes, const void* w,
                                const void* lut, const void* walk, void* out,
                                int R, int F, int S, int cells, int cw, int H,
                                int bn, int blocks, int device,
                                void* stream) {
  if (cw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Segs segs{{static_cast<const __nv_bfloat16*>(w), nullptr, nullptr},
                  {cells * cw, 0, 0}};
  return launch<kModeFull, __nv_bfloat16>(codes, segs, lut, walk, out, R, F,
                                          S, cells, H, bn, blocks, device,
                                          stream);
}

// K5f. codes (R, F, S) uint8, w_p (cells, n_p, H) bf16, lut (3, 256) int16
// slot within plane p or -1, walk int32 as for onehot_embed_fwd with the
// row bases cells * (n_0 + .. + n_{p-1}) + j * n_p, out (R, S, H) float32;
// otherwise as onehot_embed_fwd.
extern "C" int onehot_embed2_fwd(const void* codes, const void* w0,
                                 const void* w1, const void* w2,
                                 const void* lut, const void* walk,
                                 void* out, int R, int F, int S, int cells,
                                 int n0, int n1, int n2, int H, int bn,
                                 int blocks, int device, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || n0 > 256 || n1 > 256 || n2 > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Segs segs{{static_cast<const __nv_bfloat16*>(w0),
                   static_cast<const __nv_bfloat16*>(w1),
                   static_cast<const __nv_bfloat16*>(w2)},
                  {cells * n0, cells * n1, cells * n2}};
  return launch<kModeFull, float>(codes, segs, lut, walk, out, R, F, S,
                                  cells, H, bn, blocks, device, stream);
}

// K6. As onehot_embed_fwd (the packed table, its lut and walk, its plan),
// with out (R, S, H) float32 and `mode` 0 (kModeFull), 1 (kModeBuild) or
// 2 (kModeGemm): see the header.
extern "C" int embed_variant_fwd(const void* codes, const void* w,
                                 const void* lut, const void* walk,
                                 void* out, int R, int F, int S, int cells,
                                 int cw, int H, int bn, int blocks, int mode,
                                 int device, void* stream) {
  if (cw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Segs segs{{static_cast<const __nv_bfloat16*>(w), nullptr, nullptr},
                  {cells * cw, 0, 0}};
  switch (mode) {
    case kModeFull:
      return launch<kModeFull, float>(codes, segs, lut, walk, out, R, F, S,
                                      cells, H, bn, blocks, device, stream);
    case kModeBuild:
      return launch<kModeBuild, float>(codes, segs, lut, walk, out, R, F, S,
                                       cells, H, bn, blocks, device, stream);
    case kModeGemm:
      return launch<kModeGemm, float>(codes, segs, lut, walk, out, R, F, S,
                                      cells, H, bn, blocks, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
