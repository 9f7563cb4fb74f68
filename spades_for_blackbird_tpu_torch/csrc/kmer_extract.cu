// Canonical k-mer extraction for Hopper (sm_90a), written as sort keys.
//
// Replaces the TPU kernel ops/kmer_pallas.py::_kernel of the JAX package
// (with its helper _revcomp_words, launched by _fused_raw through
// pl.pallas_call). For every k-window of every read it forms the canonical
// k-mer (the smaller of the window and its reverse complement, W = ceil(k/16)
// big-endian 2-bit words) and decides whether the window is valid (it lies
// within the read's length and holds no code >= 4). The output is what the
// counting sort sorts: G = ceil(W/2) int64 key columns, a pair of words fused
// as ((hi << 32) | lo) ^ (1 << 63) and a lone last word as its own value
// (segments.fused_cols), window (r, p) in column r*P + p. With k % 16 != 0 an
// invalid window's keys are the fused all-ones sentinel and nothing else is
// written; with k % 16 == 0 (all-ones is then a real k-mer) the words are
// kept, N read as A, and one validity byte a window is written beside them.
// On request (a non-null `fwd`) one more byte a window says which strand is
// the canonical one: 1 where the forward k-mer is, ties (palindromes)
// included, as dna.canonicalize_kmers decides. It is decided on the window's
// bases as the row holds them (codes >= 4 read as code & 3), so it is defined,
// and equal to the plain version's, on every window, the invalid ones too.
// The error corrector's passes need it to orient a window's bases and
// qualities; the counting path passes null and stores nothing more.
//
// Bound: device memory bandwidth. The kernel must read 1 byte a base and
// 4 bytes a read and write 8*G bytes a window (one more with `fwd`); at
// R = 1,048,576, L = 100, k = 56 that is 104.9 + 4.2 + 755.0 = 864 MB, 0.26 ms
// at 3.35 TB/s. The
// instruction count must stay far enough below that for the stores to be the
// limit, which is what the design is for:
//   - Pack once, window by funnel shift. A block packs each read of its tile
//     into 2-bit words in shared memory, once: the forward strand, the
//     reverse complement of the whole row, and one "bad" bit a base (code
//     >= 4, or at or past the read's length). Word w of window p is then one
//     funnel shift of two neighbouring packed words, its reverse complement
//     the same shift of the reverse row at start L-k-p, and its validity a
//     funnel shift over the bad bits: W+1 shared loads and W shifts a strand
//     instead of k byte loads and a bit reversal a window.
//   - Asynchronous, wide loads. A tile's codes are one contiguous byte range
//     that one thread requests with a bulk asynchronous copy (cp.async.bulk,
//     completion on an mbarrier) into one of two staging buffers, so the
//     next tile's bytes arrive while this tile is packed and stored. The
//     copy needs 16-byte alignment: tiles hold a multiple of 16/gcd(L,16)
//     reads, and a ragged last tile or a misaligned base pointer is loaded
//     by the threads themselves.
//   - Persistent blocks. As many blocks as fit the card at once walk over
//     the tiles; thread-to-window indices advance by increments, with no
//     division in the loops.
//   - Stores the sort reads. Neighbouring threads write neighbouring 8-byte
//     keys of one column, 256 contiguous bytes a warp and store, with the
//     streaming hint since nothing here reads them again.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 8192;  // codes of one tile, where L allows
constexpr int kFrontPad = 16;     // bytes before a staged tile (see pack_rc)
constexpr int kTailPad = 32;      // bytes after it (word loads past the end)
constexpr uint32_t kAllOnes = 0xFFFFFFFFu;
constexpr unsigned long long kSign = 0x8000000000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk asynchronous copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from device to shared memory; completion is counted on
// the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The 16 bytes at byte offset b of a 4-byte aligned shared buffer, as four
// little-endian words (byte b in the low bits of y[0]).
__device__ __forceinline__ void load16(const uint8_t* buf, int b,
                                       uint32_t y[4]) {
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(buf) + (b >> 2);
  const uint32_t sh = (b & 3) * 8;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) x[i] = wp[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = __funnelshift_r(x[i], x[i + 1], sh);
}

// Four codes (one a byte, lowest address first) -> 8 bits, first code high.
__device__ __forceinline__ uint32_t pack4_fwd(uint32_t y) {
  return ((y & 0x03030303u) * 0x40100401u) >> 24;
}

// Four codes -> 8 bits, last code high (the order of the reverse strand).
__device__ __forceinline__ uint32_t pack4_rev(uint32_t y) {
  return ((y & 0x03030303u) * 0x01041040u) >> 24;
}

// Four codes -> 4 bits, bit j set where code j is >= 4.
__device__ __forceinline__ uint32_t bad4(uint32_t y) {
  return ((__vcmpgeu4(y, 0x04040404u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Keep the first n of a packed word's 16 bases (n in 1..16).
__device__ __forceinline__ uint32_t keep_bases(uint32_t word, int n) {
  return n >= 16 ? word : word & (kAllOnes << (2 * (16 - n)));
}

template <int W>
__global__ void __launch_bounds__(kThreads)
kmer_extract_kernel(const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ lengths, int R, int L, int k,
                    int tile_reads, int n_tiles, int bulk_aligned,
                    int stage_bytes, int Q, unsigned long long* __restrict__ keys,
                    uint8_t* __restrict__ valid, uint8_t* __restrict__ fwd) {
  constexpr int G = (W + 1) / 2;
  const int P = L - k + 1;
  const int BW = Q / 2;  // 32-bit words of bad bits a read
  const int tid = threadIdx.x;

  // shared memory: two mbarriers, two staging buffers, the packed rows
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* stage0 = smem + 16;
  uint32_t* pk = reinterpret_cast<uint32_t*>(stage0 + 2 * stage_bytes);
  uint32_t* rk = pk + tile_reads * Q;
  uint32_t* bad = rk + tile_reads * Q;
  uint16_t* bad16 = reinterpret_cast<uint16_t*>(bad);

  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]), 1);
    mbar_init(smem_addr(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // thread -> (read, word) of the pack loop and (read, window) of the window
  // loop: the first index of each and the step of kThreads, both split by
  // one division here and none later
  const int pack_r0 = tid / Q, pack_q0 = tid - pack_r0 * Q;
  const int pack_dr = kThreads / Q, pack_dq = kThreads - pack_dr * Q;
  const int win_r0 = tid / P, win_p0 = tid - win_r0 * P;
  const int win_dr = kThreads / P, win_dp = kThreads - win_dr * P;

  const int last_bases = k - (W - 1) * 16;
  const uint32_t last_mask = keep_bases(kAllOnes, last_bases);
  const int last_bits = k - (G - 1) * 32;  // bad bits in the last word, 1..32
  const uint32_t bad_mask =
      last_bits >= 32 ? kAllOnes : ((1u << last_bits) - 1u);
  const size_t n_windows = static_cast<size_t>(R) * P;
  const bool fold = valid == nullptr;  // invalid windows become the sentinel

  // A tile goes through the bulk copy when its byte range is 16-byte
  // aligned at both ends; tile_reads * L is a multiple of 16, so only the
  // last tile can be ragged.
  auto tile_nr = [&](int tile) { return min(tile_reads, R - tile * tile_reads); };
  auto bulk_ok = [&](int tile) {
    return bulk_aligned && ((tile_nr(tile) * L) & 15) == 0;
  };
  auto start_copy = [&](int tile, int s) {
    const uint32_t bytes = static_cast<uint32_t>(tile_nr(tile) * L);
    const uint32_t bar = smem_addr(&bars[s]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_addr(stage0 + s * stage_bytes + kFrontPad),
              codes + static_cast<size_t>(tile) * tile_reads * L, bytes, bar);
  };

  int tile = blockIdx.x;
  if (tid == 0 && tile < n_tiles && bulk_ok(tile)) start_copy(tile, 0);
  uint32_t phases = 0;  // bit s: parity of the next completion of stage s

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int s = it & 1;
    const int r0 = tile * tile_reads;
    const int nr = tile_nr(tile);
    uint8_t* stage = stage0 + s * stage_bytes + kFrontPad;

    // the other staging buffer was last read before the two barriers that
    // ended the previous iteration: start the next tile's copy into it
    const int next = tile + gridDim.x;
    if (tid == 0 && next < n_tiles && bulk_ok(next)) start_copy(next, s ^ 1);

    if (bulk_ok(tile)) {
      mbar_wait(smem_addr(&bars[s]), (phases >> s) & 1u);
      phases ^= 1u << s;
    } else {
      const uint8_t* src = codes + static_cast<size_t>(r0) * L;
      for (int i = tid; i < nr * L; i += kThreads) stage[i] = src[i];
      __syncthreads();
    }

    // ---- pack: one task a (read, 16-base word), both strands ----
    for (int r = pack_r0, q = pack_q0; r < nr;) {
      const int nb = L - 16 * q;  // bases of the row in this word
      uint32_t fw = 0, rw = 0, bits = 0xFFFFu;
      if (nb > 0) {
        const uint8_t* buf = stage - kFrontPad;  // 16-byte aligned
        const int base = kFrontPad + r * L;      // the row's offset in buf
        uint32_t y[4];
        // forward: row positions 16q .. 16q+15, first base in the high bits
        load16(buf, base + 16 * q, y);
        fw = (pack4_fwd(y[0]) << 24) | (pack4_fwd(y[1]) << 16) |
             (pack4_fwd(y[2]) << 8) | pack4_fwd(y[3]);
        fw = keep_bases(fw, nb);
        bits = bad4(y[0]) | (bad4(y[1]) << 4) | (bad4(y[2]) << 8) |
               (bad4(y[3]) << 12);
        // positions at or past the read's length are bad too
        const int good = lengths[r0 + r] - 16 * q;
        if (good < 16) bits |= good <= 0 ? 0xFFFFu : (0xFFFFu << good) & 0xFFFFu;
        // reverse complement of the row: its base 16q+j is the complement
        // of row position L-1-16q-j, so the word reads positions
        // L-16-16q .. L-1-16q backwards. A start below 0 reaches into the
        // front pad or the previous row; keep_bases cuts those bases off.
        load16(buf, base + nb - 16, y);
        rw = (pack4_rev(y[3]) << 24) | (pack4_rev(y[2]) << 16) |
             (pack4_rev(y[1]) << 8) | pack4_rev(y[0]);
        rw = keep_bases(~rw, nb);
      }
      pk[r * Q + q] = fw;
      rk[r * Q + q] = rw;
      bad16[r * Q + q] = static_cast<uint16_t>(bits);
      q += pack_dq;
      r += pack_dr;
      if (q >= Q) {
        q -= Q;
        ++r;
      }
    }
    __syncthreads();

    // ---- windows: one (read, window) a thread and step ----
    const int nw = nr * P;
    const size_t out0 = static_cast<size_t>(r0) * P;
    for (int t = tid, r = win_r0, p = win_p0; t < nw; t += kThreads) {
      uint32_t f[W], c[W];
      {
        const uint32_t* src = pk + r * Q + (p >> 4);
        const uint32_t sh = (p & 15) * 2;
        uint32_t hi = src[0];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t lo = src[w + 1];
          f[w] = __funnelshift_l(lo, hi, sh);
          hi = lo;
        }
        f[W - 1] &= last_mask;
      }
      {
        const int rp = P - 1 - p;  // start of the window on the reverse row
        const uint32_t* src = rk + r * Q + (rp >> 4);
        const uint32_t sh = (rp & 15) * 2;
        uint32_t hi = src[0];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t lo = src[w + 1];
          c[w] = __funnelshift_l(lo, hi, sh);
          hi = lo;
        }
        c[W - 1] &= last_mask;
      }
      // canonical = lexicographic minimum (a tie keeps either: they are equal)
      bool rc_lt = false, decided = false;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (!decided && c[w] != f[w]) {
          rc_lt = c[w] < f[w];
          decided = true;
        }
      }
      // any bad bit among positions p .. p+k-1
      uint32_t any_bad = 0;
      {
        const uint32_t* src = bad + r * BW + (p >> 5);
        const uint32_t sh = p & 31;
        uint32_t lo = src[0];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint32_t hi = src[g + 1];
          uint32_t m = __funnelshift_r(lo, hi, sh);
          if (g == G - 1) m &= bad_mask;
          any_bad |= m;
          lo = hi;
        }
      }
      const bool ok = any_bad == 0;
      const bool sentinel = fold && !ok;
      const size_t idx = out0 + t;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        unsigned long long key;
        if (2 * g + 1 < W) {
          const uint32_t hi = rc_lt ? c[2 * g] : f[2 * g];
          const uint32_t lo = rc_lt ? c[2 * g + 1] : f[2 * g + 1];
          key = ((static_cast<unsigned long long>(hi) << 32) | lo) ^ kSign;
          if (sentinel) key = ~kSign;
        } else {
          key = rc_lt ? c[W - 1] : f[W - 1];
          if (sentinel) key = kAllOnes;
        }
        __stcs(keys + g * n_windows + idx, key);
      }
      if (!fold) valid[idx] = ok;
      if (fwd != nullptr) fwd[idx] = !rc_lt;
      p += win_dp;
      r += win_dr;
      if (p >= P) {
        p -= P;
        ++r;
      }
    }
    __syncthreads();  // the packed rows are rewritten by the next tile
  }
}

template <int W>
cudaError_t launch(const uint8_t* codes, const int32_t* lengths, int R, int L,
                   int k, unsigned long long* keys, uint8_t* valid,
                   uint8_t* fwd, cudaStream_t stream) {
  // reads a tile: a multiple of `unit`, so that every full tile starts and
  // ends on a 16-byte boundary of the codes
  int g = L & 15;  // gcd(L, 16) is the lowest set bit of L, capped at 16
  const int unit = g == 0 ? 1 : 16 / (g & -g);
  const int tile_reads = max(unit, kTileBytes / L / unit * unit);
  const int n_tiles = (R + tile_reads - 1) / tile_reads;
  const int Q = 2 * ((L + 31) / 32 + 1);  // packed words a read, with padding
  const int stage_bytes = (kFrontPad + tile_reads * L + kTailPad + 15) / 16 * 16;
  const size_t smem = 16 + 2 * static_cast<size_t>(stage_bytes) +
                      static_cast<size_t>(tile_reads) * Q * 10;
  const int bulk_aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;

  auto kernel = kmer_extract_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, blocks_per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks_per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = min(n_tiles, sms * blocks_per_sm);
  kernel<<<blocks, kThreads, smem, stream>>>(codes, lengths, R, L, k,
                                             tile_reads, n_tiles, bulk_aligned,
                                             stage_bytes, Q, keys, valid, fwd);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). codes: (R, L) uint8, row-major;
// lengths: (R,) int32; keys: (G, R*P) int64 with G = ceil(ceil(k/16)/2) and
// P = L - k + 1; valid: (R*P,) uint8, or null when k % 16 != 0 (invalid
// windows are then written as the sentinel); fwd: (R*P,) uint8, 1 where the
// forward k-mer is canonical, or null for none. The caller checks R >= 1,
// 1 <= k <= min(L, 128), L <= 4096 and R*L < 2^31. Returns the first CUDA
// error of the launch, 0 for none.
extern "C" int sfb_kmer_extract(const void* codes, const void* lengths,
                                int R, int L, int k, void* keys, void* valid,
                                void* fwd, void* stream) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* o = static_cast<unsigned long long*>(keys);
  auto* v = static_cast<uint8_t*>(valid);
  auto* f = static_cast<uint8_t*>(fwd);
  auto st = static_cast<cudaStream_t>(stream);
  if ((v == nullptr) != (k % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch ((k + 15) / 16) {
    case 1: err = launch<1>(c, len, R, L, k, o, v, f, st); break;
    case 2: err = launch<2>(c, len, R, L, k, o, v, f, st); break;
    case 3: err = launch<3>(c, len, R, L, k, o, v, f, st); break;
    case 4: err = launch<4>(c, len, R, L, k, o, v, f, st); break;
    case 5: err = launch<5>(c, len, R, L, k, o, v, f, st); break;
    case 6: err = launch<6>(c, len, R, L, k, o, v, f, st); break;
    case 7: err = launch<7>(c, len, R, L, k, o, v, f, st); break;
    case 8: err = launch<8>(c, len, R, L, k, o, v, f, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* sfb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
