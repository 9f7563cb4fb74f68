// Banded edit distance of a batch of sequence pairs, one warp a pair.
//
// Replaces the JAX package's ops/align.py::banded_edit_distance (:25):
// there a lax.scan over the DP columns (:80) with a second lax.scan
// inside each column (:72) for the within-column dependency. That
// function is no Pallas kernel; written as plain PyTorch each column is
// about a dozen small launches, so a 2,000-column pair costs ~25 ms of
// launch overhead alone. Here the whole recursion runs in one launch.
//
// The DP (identical to the JAX order, so results are bit-equal):
//   column jj of the matrix keeps rows i = jj + (w - band) in slot w of a
//   band of W = 2*band + 1 slots; column 0 holds D[i][0] = i, BIG where
//   i < 0. For column jj = j + 1:
//     x[w]   = min(dp[w] + sub(a[i-1], b[j]), dp[w+1] + 1)  (dp[W] = BIG)
//     cur[w] = min over w' <= w of x[w'] + (w - w'), and BIG + 1 + w
//            = min(w + inclusive_min_scan(x[w'] - w'), BIG + 1 + w)
//     dp[w]  = cur[w] where 0 <= i <= a_len, else BIG
//   columns past b_len leave dp as it is, so the loop stops there. The
//   answer is dp[band + a_len - b_len] capped by the fallback
//   |a_len - b_len| + min(a_len, b_len), or the fallback where that slot
//   is outside the band. Every value is an int32 below 2^21: no overflow.
//
// The recursion is serial over columns, so the card's rates do not bound
// it (bytes: the two rows once, ~4 KB a pair; operations: ~12 integer
// operations a cell): a launch takes the columns times the latency of one
// column. Design: a warp a pair, SPL consecutive slots a lane (the power
// of two that fits ceil(W / 32): 4 at band 48, 32 at band 511), the band
// in registers; the slot below a lane's last comes from the next lane by
// one __shfl_down_sync; the in-column min-scan of x - w is an in-lane fold
// and a 5-step shuffle scan. No shared memory and no __syncthreads; four
// pairs a block, each warp on its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kInvalid = 4;  // dna.INVALID_CODE
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPairsPerBlock = 4;

template <int SPL>
__global__ void __launch_bounds__(32 * kPairsPerBlock)
    banded_ed_kernel(const uint8_t* __restrict__ a,
                     const int32_t* __restrict__ a_len,
                     const uint8_t* __restrict__ b,
                     const int32_t* __restrict__ b_len, int B, int L,
                     int band, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kPairsPerBlock + (threadIdx.x >> 5);
  if (pair >= B) return;
  const int W = 2 * band + 1;
  const uint8_t* ap = a + (size_t)pair * L;
  const uint8_t* bp = b + (size_t)pair * L;
  const int al = a_len[pair];
  const int bl = b_len[pair];
  const int w0 = lane * SPL;

  // slots past the band (w >= W) hold BIG throughout
  int dp[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int w = w0 + s;
    dp[s] = (w < W && w >= band) ? w - band : kBig;
  }
  const int ncols = min(bl, L);
  // the bytes of column j: a[i - 1] of each slot (INVALID outside a) and
  // b[j], fetched a column ahead so the loads wait on nothing
  int an[SPL];
  int bn = 0;
  auto fetch = [&](int j) {
    bn = bp[j];
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int i1 = j + w0 + s - band;
      const int v = ap[min(max(i1, 0), L - 1)];
      an[s] = (i1 >= 0 && i1 < L) ? v : kInvalid;
    }
  };
  if (ncols > 0) fetch(0);
  for (int j = 0; j < ncols; ++j) {
    const int jj = j + 1;
    const int bj = bn;
    int ai[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) ai[s] = an[s];
    fetch(min(j + 1, ncols - 1));
    int below = __shfl_down_sync(kFull, dp[0], 1);
    if (lane == 31) below = kBig;
    int y[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int w = w0 + s;
      const int sub = (ai[s] != bj || bj >= kInvalid) ? 1 : 0;
      const int up = s + 1 < SPL ? dp[s + 1] : below;
      y[s] = min(dp[s] + sub, up + 1) - w;
      if (s > 0) y[s] = min(y[s], y[s - 1]);
    }
    int t = y[SPL - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t = min(t, o);
    }
    const int pre = __shfl_up_sync(kFull, t, 1);
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int w = w0 + s;
      const int i = jj + w - band;
      const int yy = lane > 0 ? min(y[s], pre) : y[s];
      const int cur = min(yy + w, kBig + 1 + w);
      dp[s] = (w < W && i >= 0 && i <= al) ? cur : kBig;
    }
  }
  const int diff = al - bl;
  const int fallback = (diff < 0 ? -diff : diff) + min(al, bl);
  const int slot = band + diff;
  int v = kBig;
  if (slot >= 0 && slot < W) {
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      if (s == slot % SPL) v = dp[s];
    v = __shfl_sync(kFull, v, slot / SPL);
  }
  if (lane == 0) out[pair] = (slot >= 0 && slot < W) ? min(v, fallback)
                                                     : fallback;
}

template <int SPL>
int launch(const uint8_t* a, const int32_t* a_len, const uint8_t* b,
           const int32_t* b_len, int B, int L, int band, int32_t* out,
           cudaStream_t stream) {
  const int blocks = (B + kPairsPerBlock - 1) / kPairsPerBlock;
  banded_ed_kernel<SPL><<<blocks, 32 * kPairsPerBlock, 0, stream>>>(
      a, a_len, b, b_len, B, L, band, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b: (B, L) uint8; a_len, b_len: (B,) int32; out: (B,) int32; band
// 0..511. Returns a cudaError_t (0 on success) of the launch.
int sfb_banded_ed(const void* a, const void* a_len, const void* b,
                  const void* b_len, int B, int L, int band, void* out,
                  void* stream) {
  if (B <= 0) return 0;
  if (band < 0 || band > 511) return (int)cudaErrorInvalidValue;
  const int need = (2 * band + 1 + 31) / 32;  // slots a lane
  auto* ua = (const uint8_t*)a;
  auto* ub = (const uint8_t*)b;
  auto* la = (const int32_t*)a_len;
  auto* lb = (const int32_t*)b_len;
  auto* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (need <= 1) return launch<1>(ua, la, ub, lb, B, L, band, o, s);
  if (need <= 2) return launch<2>(ua, la, ub, lb, B, L, band, o, s);
  if (need <= 4) return launch<4>(ua, la, ub, lb, B, L, band, o, s);
  if (need <= 8) return launch<8>(ua, la, ub, lb, B, L, band, o, s);
  if (need <= 16) return launch<16>(ua, la, ub, lb, B, L, band, o, s);
  return launch<32>(ua, la, ub, lb, B, L, band, o, s);
}

const char* sfb_banded_ed_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
