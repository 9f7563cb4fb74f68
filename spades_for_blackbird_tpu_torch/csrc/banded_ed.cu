// Banded edit distance of a batch of sequence pairs, one block a pair.
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
// Design: a thread holds one slot in a register; the neighbour slot
// comes through shared memory and the in-column term is a block-wide
// inclusive min-scan (warp shuffles, then the warp totals). Three
// __syncthreads a column. The recursion is serial over columns, so the
// card's rates do not bound it: its time is the columns times the
// latency of one column's scan (bytes: the two rows once, ~4 KB a pair;
// operations: ~15 integer operations a cell).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kInvalid = 4;  // dna.INVALID_CODE
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_inclusive_min(int y, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(kFull, y, d);
    if (lane >= d) y = min(y, o);
  }
  return y;
}

__global__ void banded_ed_kernel(const uint8_t* __restrict__ a,
                                 const int32_t* __restrict__ a_len,
                                 const uint8_t* __restrict__ b,
                                 const int32_t* __restrict__ b_len,
                                 int L, int band,
                                 int32_t* __restrict__ out) {
  extern __shared__ int shm[];
  const int T = blockDim.x;
  int* s_dp = shm;              // T slots
  int* s_warp = shm + T;        // 32 warp totals
  const int pair = blockIdx.x;
  const int w = threadIdx.x;
  const int lane = w & 31;
  const int warp = w >> 5;
  const int nwarps = T >> 5;
  const int W = 2 * band + 1;
  const uint8_t* ap = a + (size_t)pair * L;
  const uint8_t* bp = b + (size_t)pair * L;
  const int al = a_len[pair];
  const int bl = b_len[pair];
  const int row0 = w - band;

  int dp = (w < W && row0 >= 0) ? row0 : kBig;
  const int ncols = min(bl, L);
  for (int j = 0; j < ncols; ++j) {
    const int jj = j + 1;
    s_dp[w] = dp;
    __syncthreads();
    const int up = (w + 1 < W) ? s_dp[w + 1] : kBig;
    const int i = jj + row0;
    const int bj = bp[j];
    const int ai = (i - 1 >= 0 && i - 1 < L) ? ap[i - 1] : kInvalid;
    const int sub = (ai != bj || bj >= kInvalid) ? 1 : 0;
    const int x = min(dp + sub, up + 1);
    int y = warp_inclusive_min(x - w, lane);
    if (lane == 31) s_warp[warp] = y;
    __syncthreads();
    if (warp == 0) {
      int t = lane < nwarps ? s_warp[lane] : INT_MAX;
      t = warp_inclusive_min(t, lane);
      if (lane < nwarps) s_warp[lane] = t;
    }
    __syncthreads();
    if (warp > 0) y = min(y, s_warp[warp - 1]);
    const int cur = min(y + w, kBig + 1 + w);
    dp = (i >= 0 && i <= al) ? cur : kBig;
  }
  s_dp[w] = dp;
  __syncthreads();
  if (w == 0) {
    const int diff = al - bl;
    const int fallback = (diff < 0 ? -diff : diff) + min(al, bl);
    const int slot = band + diff;
    out[pair] = (slot >= 0 && slot < W) ? min(s_dp[slot], fallback)
                                        : fallback;
  }
}

}  // namespace

extern "C" {

// a, b: (B, L) uint8; a_len, b_len: (B,) int32; out: (B,) int32.
// Returns a cudaError_t (0 on success) of the launch.
int sfb_banded_ed(const void* a, const void* a_len, const void* b,
                  const void* b_len, int B, int L, int band, void* out,
                  void* stream) {
  if (B <= 0) return 0;
  const int W = 2 * band + 1;
  if (band < 0 || W > 1024) return (int)cudaErrorInvalidValue;
  const int T = (W + 31) / 32 * 32;
  const size_t shm = (size_t)(T + 32) * sizeof(int);
  banded_ed_kernel<<<B, T, shm, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const int32_t*)a_len, (const uint8_t*)b,
      (const int32_t*)b_len, L, band, (int32_t*)out);
  return (int)cudaGetLastError();
}

const char* sfb_banded_ed_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
