// Fused k-mer extraction and canonicalisation for Hopper (sm_90a).
//
// Replaces the TPU kernel spades_for_blackbird_tpu/ops/kmer_pallas.py::_kernel
// (with its helper _revcomp_words, launched by _fused_raw through
// pl.pallas_call). For every k-window of every read it packs W = ceil(k/16)
// big-endian 2-bit words, flags windows that hold a code >= 4 (N or padding)
// or run past the read's length, takes the reverse complement and keeps the
// lexicographic minimum: the canonical k-mer.
//
// Bound: device memory bandwidth. Each window reads its k bases from shared
// memory, but from device memory the kernel reads only 1 byte per base of
// the read batch and writes 4*W + 1 bytes per window (W canonical words and
// one validity byte); the arithmetic is a few dozen integer operations per
// base. The design keeps the traffic at that floor:
//   - one block stages a tile of reads in shared memory with coalesced byte
//     loads, so device memory sees each base once, not once per window;
//   - one thread per (read, window) builds its W words in registers,
//     reverse-complements them there (NOT, 2-bit-slot reversal with __brev,
//     word-order reversal, left shift over the pad slots) and selects the
//     minimum, so no intermediate touches device memory;
//   - output is column-major, out[w][r*P + p], so neighbouring threads store
//     to neighbouring addresses, and the layout is what the counting sort
//     reads (segments.count_sorted_cols) with no transpose.
// With sentinel_safe (k % 16 != 0, so no real k-mer is all-ones) invalid
// windows are folded into the all-ones sentinel; otherwise (k = 128, the
// k=127 rung's (k+1)-mers) they keep their words and only the validity byte
// marks them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;  // shared-memory budget for staged reads
constexpr int kMaxTileReads = 64;
constexpr uint32_t kAllOnes = 0xFFFFFFFFu;

// Reverse the order of the 16 2-bit base slots of a word.
__device__ __forceinline__ uint32_t reverse_slots(uint32_t x) {
  const uint32_t y = __brev(x);  // reverses bits, so each slot's 2 bits swap
  return ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
kmer_extract_kernel(const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ lengths, int R, int L, int k,
                    int P, int tile_reads, int sentinel_safe,
                    uint32_t* __restrict__ out, uint8_t* __restrict__ valid) {
  extern __shared__ uint8_t tile[];
  const int r0 = blockIdx.x * tile_reads;
  const int nr = min(tile_reads, R - r0);
  const uint8_t* src = codes + static_cast<size_t>(r0) * L;
  for (int i = threadIdx.x; i < nr * L; i += blockDim.x) tile[i] = src[i];
  __syncthreads();

  const int last_bases = k - (W - 1) * 16;
  const uint32_t last_mask =
      last_bases == 16 ? kAllOnes : (kAllOnes << ((16 - last_bases) * 2));
  const int pad_bits = (W * 16 - k) * 2;  // < 32: W = ceil(k/16)
  const size_t n_windows = static_cast<size_t>(R) * P;

  for (int t = threadIdx.x; t < nr * P; t += blockDim.x) {
    const int r = t / P;
    const int p = t - r * P;
    const uint8_t* s = tile + r * L + p;

    uint32_t fwd[W];
    bool bad = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t acc = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = w * 16 + j;
        uint32_t c = 0;
        if (i < k) {
          const uint8_t b = s[i];
          bad |= b >= 4;
          c = b & 3u;
        }
        acc = (acc << 2) | c;
      }
      fwd[w] = acc;
    }

    // reverse complement: complement every slot, reverse slots and words,
    // then shift the W-word big-endian value left over the pad slots
    uint32_t rev[W];
#pragma unroll
    for (int w = 0; w < W; ++w) rev[w] = reverse_slots(~fwd[W - 1 - w]);
    uint32_t rc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t lo = (w + 1 < W) ? rev[w + 1] : 0u;
      rc[w] = pad_bits ? ((rev[w] << pad_bits) | (lo >> (32 - pad_bits)))
                       : rev[w];
    }
    rc[W - 1] &= last_mask;

    // canonical = lexicographic minimum (ties keep the forward k-mer)
    bool rc_lt = false;
    bool decided = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (!decided && rc[w] != fwd[w]) {
        rc_lt = rc[w] < fwd[w];
        decided = true;
      }
    }

    const bool ok = !bad && p <= lengths[r0 + r] - k;
    const bool fold = sentinel_safe && !ok;
    const size_t idx = static_cast<size_t>(r0 + r) * P + p;
#pragma unroll
    for (int w = 0; w < W; ++w)
      out[w * n_windows + idx] = fold ? kAllOnes : (rc_lt ? rc[w] : fwd[w]);
    valid[idx] = ok;
  }
}

template <int W>
void launch(const uint8_t* codes, const int32_t* lengths, int R, int L, int k,
            int sentinel_safe, uint32_t* out, uint8_t* valid,
            cudaStream_t stream) {
  const int tile_reads = max(1, min(kMaxTileReads, kTileBytes / L));
  const int blocks = (R + tile_reads - 1) / tile_reads;
  const size_t smem = static_cast<size_t>(tile_reads) * L;
  kmer_extract_kernel<W><<<blocks, kThreads, smem, stream>>>(
      codes, lengths, R, L, k, L - k + 1, tile_reads, sentinel_safe, out,
      valid);
}

}  // namespace

// Plain C entry point (loaded with ctypes). codes: (R, L) uint8, row-major;
// lengths: (R,) int32; out: (W, R*P) uint32; valid: (R*P,) uint8, with
// P = L - k + 1. The caller checks 1 <= k <= min(L, 128) and L <= 49152.
// Returns cudaGetLastError() after the launch.
extern "C" int sfb_kmer_extract(const void* codes, const void* lengths,
                                int R, int L, int k, int sentinel_safe,
                                void* out, void* valid, void* stream) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* o = static_cast<uint32_t*>(out);
  auto* v = static_cast<uint8_t*>(valid);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((k + 15) / 16) {
    case 1: launch<1>(c, len, R, L, k, sentinel_safe, o, v, st); break;
    case 2: launch<2>(c, len, R, L, k, sentinel_safe, o, v, st); break;
    case 3: launch<3>(c, len, R, L, k, sentinel_safe, o, v, st); break;
    case 4: launch<4>(c, len, R, L, k, sentinel_safe, o, v, st); break;
    case 5: launch<5>(c, len, R, L, k, sentinel_safe, o, v, st); break;
    case 6: launch<6>(c, len, R, L, k, sentinel_safe, o, v, st); break;
    case 7: launch<7>(c, len, R, L, k, sentinel_safe, o, v, st); break;
    case 8: launch<8>(c, len, R, L, k, sentinel_safe, o, v, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sfb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
