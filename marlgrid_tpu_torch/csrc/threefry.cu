// threefry2x32: the Threefry-2x32 hash (20 rounds) of JAX's PRNG, one
// launch per draw, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws through jax.random, whose
// threefry2x32 XLA fuses into one elementwise op. The port's plain version
// (ops/threefry.py::threefry2x32_plain) emulates uint32 arithmetic in
// int64, one masked elementwise op for every add, shift, or, and and xor of
// the 20 rounds, the 5 key injections and the key schedule: about 171
// launches a draw, each over the whole draw, which made the env engine's
// randomness about half of the encode train step's graph nodes. Every
// sampler of core/rng.py goes through split, fold_in or random_bits, and
// each of those is now one launch of this kernel.
//
// Bound on an H100 SXM: the larger of (1) the bytes, each int64 output
// written once and the keys and count tables read once, at 3.35 TB/s, and
// (2) about 70 32-bit integer instructions an element (20 rounds of an add,
// a funnel shift and a xor, 6 key adds, the index arithmetic) at 16.7 T/s
// (132 SMs x 64 lanes x 1.98 GHz). At the acting cell's Gumbel draw, (4,
// 32768, 7) = 917,504 elements, that is 7.3 MB, about 2.2 us, against
// 64 M instructions, about 3.9 us; a split of B keys is bound by the
// launch itself.
//
// Design: one thread per output element, walked with a grid stride, the
// counts, the three key words and the state in uint32 registers, a
// rotation one funnel shift. Element e of a draw of K keys by M counts is
// count j = e % M of key k = e / M (32-bit index arithmetic below 2^31
// elements, 64-bit above). A key is read through its row and word strides,
// so a sliced key batch (keys[:, 0] of a split) or a broadcast key (stride
// 0) is read where it lies; the key words are int64 tensors of uint32
// values, and only their low 32 bits enter the hash, as in the plain
// version. The count pair (x0, x1) comes from one of three sources:
//   iota : (j >> 32, j & 0xffffffff), the flat index of the draw
//          (split, random_bits);
//   table: (hi[j], lo[j]), int64 tables of the indices of a part of a
//          larger draw (random_bits with part, core/rng.py::part_counts);
//   fold : (0, data[k]) with an int32 or int64 datum per key read through
//          its stride, or one value for every key (fold_in).
// The output is the pair (x0, x1) at out[2e], out[2e + 1] ((..., 2) keys
// of split and fold_in) or x0 ^ x1 at out[e] (random_bits), as int64 holding
// uint32 values, the layout the callers read. The kernel allocates nothing
// and does not synchronise, so a CUDA graph capture records it as one node.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks an SM, then grid stride
constexpr uint32_t kParity = 0x1BD11BDAu;

enum Source : int { kIota = 0, kTable = 1, kFold = 2 };

struct Draw {
  const int64_t* keys;      // key k's words at keys[k * key_stride] and
  int64_t key_stride;       // keys[k * key_stride + word_stride]
  int64_t word_stride;
  int64_t counts;           // M, counts per key
  int source;               // Source
  const int64_t* hi;        // kTable: (M,) contiguous
  const int64_t* lo;
  const void* data;         // kFold: datum of key k at data[k * data_stride],
  int64_t data_stride;      // int32 or int64 (data_bytes); nullptr: value
  int data_bytes;
  uint32_t value;
  int xor_out;              // 1: out[e] = x0 ^ x1; 0: the pair at 2e, 2e + 1
  int64_t* out;
};

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const Draw d, const Index total) {
  const Index m = static_cast<Index>(d.counts);
  const Index step = static_cast<Index>(gridDim.x) * kThreads;
  for (Index e = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += step) {
    const Index k = e / m;
    const Index j = e - k * m;
    const int64_t* key = d.keys + static_cast<int64_t>(k) * d.key_stride;
    uint32_t x0, x1;
    if (d.source == kIota) {
      x0 = static_cast<uint32_t>(static_cast<uint64_t>(j) >> 32);
      x1 = static_cast<uint32_t>(j);
    } else if (d.source == kTable) {
      x0 = static_cast<uint32_t>(d.hi[j]);
      x1 = static_cast<uint32_t>(d.lo[j]);
    } else {
      const int64_t at = static_cast<int64_t>(k) * d.data_stride;
      x0 = 0;
      x1 = d.data == nullptr ? d.value
           : d.data_bytes == 4
               ? static_cast<uint32_t>(static_cast<const int32_t*>(d.data)[at])
               : static_cast<uint32_t>(
                     static_cast<const int64_t*>(d.data)[at]);
    }
    threefry(static_cast<uint32_t>(key[0]),
             static_cast<uint32_t>(key[d.word_stride]), x0, x1);
    const int64_t o = static_cast<int64_t>(e);
    if (d.xor_out) {
      d.out[o] = static_cast<int64_t>(x0 ^ x1);
    } else {
      d.out[2 * o] = static_cast<int64_t>(x0);
      d.out[2 * o + 1] = static_cast<int64_t>(x1);
    }
  }
}

}  // namespace

// The hash of n_keys keys by `counts` counts each (see the header for the
// three count sources and the two output layouts), all on `device`.
// Launches on `stream` (nothing for an empty draw); returns
// cudaGetLastError(), or cudaErrorInvalidValue for an argument the kernel
// does not take.
extern "C" int threefry2x32(const void* keys, long long key_stride,
                            long long word_stride, long long n_keys,
                            long long counts, int source, const void* hi,
                            const void* lo, const void* data,
                            long long data_stride, int data_bytes,
                            unsigned int value, int xor_out, void* out,
                            int device, void* stream) {
  if (n_keys < 0 || counts < 0 || source < kIota || source > kFold ||
      (source == kTable && (hi == nullptr || lo == nullptr)) ||
      (source == kFold && data != nullptr && data_bytes != 4 &&
       data_bytes != 8) ||
      (counts > 0 && n_keys > INT64_MAX / counts))
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long total = n_keys * counts;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const Draw d{static_cast<const int64_t*>(keys), key_stride, word_stride,
               counts, source, static_cast<const int64_t*>(hi),
               static_cast<const int64_t*>(lo), data, data_stride,
               data_bytes, value, xor_out, static_cast<int64_t*>(out)};
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total < (1LL << 31)) {
    threefry_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        d, static_cast<uint32_t>(total));
  } else {
    threefry_kernel<uint64_t><<<blocks, kThreads, 0, s>>>(
        d, static_cast<uint64_t>(total));
  }
  return static_cast<int>(cudaGetLastError());
}
