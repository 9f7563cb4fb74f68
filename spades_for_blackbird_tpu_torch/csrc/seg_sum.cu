// Ordered segment sums: the float scatter-add with the CPU's bits.
//
// On the CPU, Tensor.index_add_ adds a slot's terms one after another in
// row order, starting from the slot's value; so does XLA's CPU scatter,
// which the JAX package's parity tests rest on. The card's index_add_ adds
// them with atomics in the order threads arrive, so a float sum can change
// in its last bits from one run to the next. The route
// (ops/segments.py::ordered_index_add_) sorts the rows' slots with a
// stable sort (row order kept within a slot; rows aimed at no slot keyed
// at `limit`) and hands this kernel the sorted slots and either the rows
// copied out in that order or the unsorted rows with the sort's
// permutation, through which the kernel reads them. The kernel adds each
// slot's run in row order, starting from the slot's value, with
// __fadd_rn / __dadd_rn (never contracted or reordered): the CPU's
// operations in the CPU's order, so the same bits on every run. Runs at
// `limit` or past it are skipped. It replaces no TPU kernel: the JAX
// package leaves its float scatter-adds to XLA.
//
// A run is a serial chain: no tree, no split, no reassociation. So the
// card's rates do not bound a long run; the latency of one dependent add
// does (about 4 cycles), and the design keeps the adding thread fed so
// that it issues its adds back to back. Short runs are bound by bytes
// and by the latency of the few rounds of loads a tile takes.
//
// Runs by length, in one launch of two block roles. A tile is `tile`
// rows (8 KB of values); a run of more than `tile` rows is long.
//  * Long-run blocks come first in the grid, so they start in the first
//    wave. Each looks at eight positions r0 = multiples of `tile`, one a
//    warp: every long run holds exactly one r0 with its head within
//    `tile` rows before it, and holds r0 - tile / 2 or r0 + tile / 2 as
//    well, so one round of loads clears most positions. For a candidate
//    the block finds the head and the end with a block-wide search (256
//    probes a round), then streams the run through a ring of kStages
//    chunks in shared memory: warps 1-7 fill the chunks kAhead ahead
//    with cp.async (4 or 8 bytes an element, through the permutation
//    where there is one, whose entries they read a chunk before their
//    copies), one __syncthreads a chunk, and warp 0 adds: lane c takes
//    column c (and c + 32, ...), so C columns are C chains at once; one
//    column reads 16-byte vectors four ahead of its adds.
//  * Tile blocks: block t copies its tile's slots (and the slots of up to
//    kWindow rows after it), and its values or permutation, into shared
//    memory in one round of copies; then the values through the
//    permutation and the tail of the one short run that crosses the
//    tile's end; then one thread a (run head, column) adds its run from
//    shared memory, the run heads' slot values loaded together first.
// Each run is summed by exactly one thread (short) or lane (long), from
// the slot's value in `out` to the slot's value in `out`.
//
// The entry sfb_seg_sum_chain runs one thread through n dependent adds:
// what one add of a run's chain costs on the card, which chip_smoke.py
// times for the kernel's bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kProducers = kThreads - 32;  // warps 1-7 of a long-run block
constexpr int kStages = 6;                 // ring chunks of a long run
constexpr int kAhead = kStages - 2;        // chunks in flight ahead
constexpr int kPer = 10;                   // a producer's elements a chunk
constexpr int kElems = 8;                  // a tile thread's elements a batch
constexpr int kMaxElems = kElems * kThreads;  // values of a tile or a
                                              // chunk
constexpr int kWindow = 256;  // slots read past a tile for its last run

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// one 4- or 8-byte element, global to shared, asynchronous
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4 or 8 bytes");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, typename S>
struct Job {
  const S* slot;        // (M,) ascending
  const T* vals;        // (M, C) sorted rows, or the rows perm points at
  const int64_t* perm;  // (M,) or null
  int64_t M;
  int C;
  int64_t limit;        // runs at limit or past it are skipped
  T* out;               // (>= limit, C)
  int tile;             // rows a tile; a longer run is long
  int chunk;            // rows a ring chunk of a long run
  int64_t n_long;       // long-run blocks: ceil(M / tile / 8)
};

// dst[i] = src[i] for i = first, first + stride, ... < n
template <typename E>
__device__ __forceinline__ void copy_flat(E* dst, const E* src, int n,
                                          int first, int stride) {
  for (int i = first; i < n; i += stride) cp_async(dst + i, src + i);
}

// element x of rows r_lo.. of the sorted order (row x / C, column x % C)
// to dst[x], for x = first, first + stride, ... < n: the row's values at
// row perm[r] of vals (kPerm; perm in global or shared memory) or at row
// r; the permutation's entries of a batch are read before its copies
template <typename T, bool kPerm>
__device__ __forceinline__ void gather(T* dst, const T* vals,
                                       const int64_t* perm, int64_t r_lo,
                                       int n, int C, int first, int stride) {
  for (int base = first; base < n; base += kElems * stride) {
    int64_t src[kElems];
#pragma unroll
    for (int u = 0; u < kElems; ++u) {
      const int x = base + u * stride;
      if (x < n) {
        const int r = x / C;
        const int64_t row = kPerm ? perm[r_lo + r] : r_lo + r;
        src[u] = row * C + (x - r * C);
      }
    }
#pragma unroll
    for (int u = 0; u < kElems; ++u) {
      const int x = base + u * stride;
      if (x < n) cp_async(dst + x, vals + src[u]);
    }
  }
}

// the first p in [lo, hi) where slot[p] < s (kUpper: <= s) fails, hi if
// none; the predicate holds on a prefix (slots ascend). Every thread of
// the block calls it with the same arguments.
template <bool kUpper, typename S>
__device__ int64_t block_search(const S* slot, int64_t lo, int64_t hi,
                                int64_t s) {
  while (hi > lo) {
    const int64_t step = (hi - lo + kThreads - 1) / kThreads;
    const int64_t p = lo + (int64_t)threadIdx.x * step;
    bool below = false;
    if (p < hi) {
      const int64_t v = slot[p];
      below = kUpper ? v <= s : v < s;
    }
    const int cnt = __syncthreads_count(below);
    if (cnt == 0) return lo;
    const int64_t next_lo = lo + (int64_t)(cnt - 1) * step + 1;
    hi = lmin(hi, lo + (int64_t)cnt * step);
    lo = next_lo;
  }
  return lo;
}

// one column's chain over n rows of shared memory (stride C): each add
// issued beside the load of the row eight ahead, so the loads hide under
// the chain
template <typename T>
__device__ __forceinline__ T add_column(T a, const T* col, int n, int C) {
  int r = 0;
  if (n >= 8) {
    T v[8], w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = col[u * C];
    r = 8;
    for (;;) {  // v holds rows r - 8 .. r - 1
      if (r + 8 > n) {
#pragma unroll
        for (int u = 0; u < 8; ++u) a = add_rn(a, v[u]);
        break;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        w[u] = col[(r + u) * C];
        a = add_rn(a, v[u]);
      }
      r += 8;  // w holds rows r - 8 .. r - 1
      if (r + 8 > n) {
#pragma unroll
        for (int u = 0; u < 8; ++u) a = add_rn(a, w[u]);
        break;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = col[(r + u) * C];
        a = add_rn(a, w[u]);
      }
      r += 8;
    }
  }
  for (; r < n; ++r) a = add_rn(a, col[r * C]);
  return a;
}

template <typename T>
struct Vec16;  // 16 bytes of T
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
__device__ __forceinline__ float add_vec(float a, float4 v) {
  return add_rn(add_rn(add_rn(add_rn(a, v.x), v.y), v.z), v.w);
}
__device__ __forceinline__ double add_vec(double a, double2 v) {
  return add_rn(add_rn(a, v.x), v.y);
}

// C == 1: rows [0, n) of buf (16-byte aligned) in order, 16-byte loads
// issued four vectors ahead of the adds
template <typename T>
__device__ __forceinline__ T add_contiguous(T a, const T* buf, int n) {
  using V = typename Vec16<T>::type;
  constexpr int K = 16 / sizeof(T);  // rows a vector
  const V* vb = reinterpret_cast<const V*>(buf);
  const int nv = n / K;
  int j = 0;
  if (nv >= 8) {
    V x[4], y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = vb[k];
    j = 4;
    for (;;) {  // x holds vectors j - 4 .. j - 1
      if (j + 4 > nv) {
#pragma unroll
        for (int k = 0; k < 4; ++k) a = add_vec(a, x[k]);
        break;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        y[k] = vb[j + k];
        a = add_vec(a, x[k]);
      }
      j += 4;  // y holds vectors j - 4 .. j - 1
      if (j + 4 > nv) {
#pragma unroll
        for (int k = 0; k < 4; ++k) a = add_vec(a, y[k]);
        break;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = vb[j + k];
        a = add_vec(a, y[k]);
      }
      j += 4;
    }
  }
  for (; j < nv; ++j) a = add_vec(a, vb[j]);
  for (int r = nv * K; r < n; ++r) a = add_rn(a, buf[r]);
  return a;
}

// rows [i, end) of a column of shared memory (stride C), in order: the
// vector loop where C == 1 (after the rows up to a 16-byte boundary)
template <typename T>
__device__ __forceinline__ T add_rows(T a, const T* col, int i, int end,
                                      int C) {
  if (C != 1) return add_column(a, col + i * C, end - i, C);
  constexpr int K = 16 / sizeof(T);
  for (; i < end && i % K; ++i) a = add_rn(a, col[i]);
  return add_contiguous(a, col + i, end - i);
}

// add_rows out of line: the tile walk's long runs, without the vector
// loop's code unrolled at each of a thread's elements
template <typename T>
__device__ __noinline__ T add_rows_call(T a, const T* col, int i, int end,
                                        int C) {
  return add_rows(a, col, i, end, C);
}

// A long run, headed within the tile rows before r0 (the caller's
// candidate): warps 1-7 stream its rows through the ring (a chunk's
// source offsets, through the permutation, read a chunk before its
// copies), warp 0 adds.
template <typename T, typename S, bool kPerm>
__device__ void long_run(const Job<T, S>& jb, int64_t r0,
                         unsigned char* smem) {
  const int64_t L = jb.tile;
  const int64_t s = jb.slot[r0];
  const int64_t h = block_search<false>(jb.slot, r0 >= L ? r0 - L + 1 : 0,
                                        r0, s);
  if (h + L >= jb.M || jb.slot[h + L] != s) return;  // <= L rows: a tile's
  const int64_t e = block_search<true>(jb.slot, h + L + 1, jb.M, s);

  const int C = jb.C;
  const int crow = jb.chunk;
  const int celems = crow * C;
  T* acc = reinterpret_cast<T*>(smem);  // warp 0's C sums
  T* ring = reinterpret_cast<T*>(smem + align16((size_t)C * sizeof(T)));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = (int)threadIdx.x - 32;
  const int64_t nchunks = (e - h + crow - 1) / crow;
  int64_t src[kPer];  // a producer's source offsets of its next chunk
  auto elems = [&](int64_t q) {
    return q < nchunks ? (int)lmin(crow, e - h - q * crow) * C : 0;
  };
  auto sources = [&](int64_t q) {
    const int n = elems(q);
    const int64_t r_lo = h + q * crow;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int x = p + k * kProducers;
      if (x < n) {
        const int r = x / C;
        const int64_t row = kPerm ? jb.perm[r_lo + r] : r_lo + r;
        src[k] = row * C + (x - r * C);
      }
    }
  };
  auto issue = [&](int64_t q) {
    const int n = elems(q);
    T* dst = ring + (q % kStages) * celems;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int x = p + k * kProducers;
      if (x < n) cp_async(dst + x, jb.vals + src[k]);
    }
    cp_async_commit();  // an empty group too, so the count stays exact
  };
  if (warp == 0) {
    for (int c = lane; c < C; c += 32) acc[c] = jb.out[s * C + c];
  } else {
    for (int q = 0; q < kAhead; ++q) {
      sources(q);
      issue(q);
    }
    sources(kAhead);
  }
  for (int64_t q = 0; q < nchunks; ++q) {
    if (warp != 0) {
      issue(q + kAhead);
      sources(q + kAhead + 1);
      cp_async_wait<kAhead>();  // this thread's copies of chunk q
    }
    __syncthreads();  // everyone's copies of chunk q; the chunk refilled
                      // next was read before the last barrier
    if (warp == 0) {
      const T* buf = ring + (q % kStages) * celems;
      const int n = elems(q) / C;
      for (int c = lane; c < C; c += 32)
        acc[c] = add_rows(acc[c], buf + c, 0, n, C);
    }
  }
  if (warp == 0)
    for (int c = lane; c < C; c += 32) jb.out[s * C + c] = acc[c];
  __syncthreads();  // the ring is free for the block's next run
}

// Long-run block b: the positions r0 = (8 b + w) * tile, one a warp. A
// run of more than `tile` rows through r0, headed after r0 - tile, holds
// r0 - tile / 2 or r0 + tile / 2 too: one round of loads clears most
// positions; the block then takes its candidates in order.
template <typename T, typename S, bool kPerm>
__device__ void long_runs(const Job<T, S>& jb, int64_t b,
                          unsigned char* smem) {
  __shared__ int cand[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int64_t L = jb.tile;
  const int64_t half = L / 2;
  const int64_t r0 = (b * (kThreads / 32) + warp) * L;
  if ((threadIdx.x & 31) == 0) {
    bool c = false;
    if (r0 < jb.M) {
      const S s = jb.slot[r0];
      const S before = r0 >= L ? jb.slot[r0 - L] : (S)-1;
      const S left = r0 >= half ? jb.slot[r0 - half] : (S)-1;
      const S right = r0 + half < jb.M ? jb.slot[r0 + half] : (S)-1;
      c = s < jb.limit && before != s && (left == s || right == s);
    }
    cand[warp] = c;
  }
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w)
    if (cand[w])
      long_run<T, S, kPerm>(jb, (b * (kThreads / 32) + w) * L, smem);
}

// A tile's short runs: (A) the slots of the tile and of up to kWindow
// rows after it, and the tile's permutation (or its values), in one round
// of copies; (B) the values through the permutation; the run crossing
// the tile's end, its end found in the slots after the tile (a block
// search where it reaches past them) and its tail copied; each run head's
// slot value loaded; (C) a thread a (run head, column) adds its run from
// shared memory.
template <typename T, typename S, bool kPerm>
__device__ void tile_runs(const Job<T, S>& jb, int64_t t,
                          unsigned char* smem) {
  __shared__ int x_head;  // the crossing run's head (tile row), or -1
  __shared__ int x_end;   // its end (tile row) where the window holds it
  const int L = jb.tile;
  const int64_t t0 = t * L;
  if (t0 >= jb.M) return;
  if (jb.slot[t0] >= jb.limit) return;  // every run of the tile dropped
  const int nt = (int)lmin(L, jb.M - t0);
  const int ne = (int)lmin(L < kWindow ? L : kWindow, jb.M - t0 - nt);
  const int C = jb.C;
  const int tid = threadIdx.x;
  S* s_slot = reinterpret_cast<S*>(smem);  // [0] row t0 - 1, [1 + i] t0 + i
  int64_t* s_perm = reinterpret_cast<int64_t*>(
      smem + align16((size_t)(L + kWindow + 1) * sizeof(S)));
  T* s_val = reinterpret_cast<T*>(s_perm + (kPerm ? L : 0));  // 2L rows

  copy_flat(s_slot + 1, jb.slot + t0, nt + ne, tid, kThreads);
  if (kPerm)
    copy_flat(s_perm, jb.perm + t0, nt, tid, kThreads);
  else
    gather<T, false>(s_val, jb.vals, nullptr, t0, nt * C, C, tid, kThreads);
  cp_async_commit();
  if (tid == 0) {
    s_slot[0] = t0 > 0 ? jb.slot[t0 - 1] : (S)-1;
    x_head = -1;
    x_end = -1;
  }
  cp_async_wait<0>();
  __syncthreads();

  if (kPerm) {
    gather<T, true>(s_val, jb.vals, s_perm, 0, nt * C, C, tid, kThreads);
    cp_async_commit();
  }
  const S last = s_slot[nt];
  const bool crosses = ne > 0 && last < jb.limit && s_slot[nt + 1] == last;
  if (crosses) {
    for (int i = tid; i < nt + ne; i += kThreads) {
      const S cur = s_slot[i + 1];
      const S prev = s_slot[i];
      if (i < nt && cur == last && prev != last) x_head = i;
      if (i >= nt && cur != last && prev == last) x_end = i;
    }
  }
  __syncthreads();
  // the crossing run is ours if it starts here; a long-run block's if it
  // has more than L rows
  const bool ours = crosses && x_head >= 0;
  int xe = x_end;
  if (ours && xe < 0)
    xe = t0 + nt + ne == jb.M
             ? nt + ne
             : (int)(block_search<true>(jb.slot, t0 + nt + ne,
                                        lmin(jb.M, t0 + x_head + L + 1),
                                        (int64_t)last) -
                     t0);
  const bool cross_long = ours && xe - x_head > L;
  if (ours && !cross_long) {
    gather<T, kPerm>(s_val + nt * C, jb.vals, jb.perm, t0 + nt,
                     (xe - nt) * C, C, tid, kThreads);
    cp_async_commit();
  }
  T o[kElems];
  bool head[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int x = tid + u * kThreads;
    head[u] = false;
    if (x < nt * C) {
      const int i = x / C;
      const S sl = s_slot[i + 1];
      head[u] = sl != s_slot[i] && sl < jb.limit &&
                !(i == x_head && cross_long);
      if (head[u]) o[u] = jb.out[(int64_t)sl * C + (x - i * C)];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    if (!head[u]) continue;
    const int x = tid + u * kThreads;
    const int i = x / C;
    const int c = x - i * C;
    const S sl = s_slot[i + 1];
    int end;
    if (i == x_head && ours) {
      end = xe;
    } else {
      end = i + 1;
      while (end + 8 <= nt && s_slot[end + 8] == sl) end += 8;
      while (end < nt && s_slot[end + 1] == sl) ++end;
    }
    T a = o[u];
    if (end - i < 16) {
      const T* col = s_val + c;
      for (int r = i; r < end; ++r) a = add_rn(a, col[r * C]);
    } else {
      a = add_rows_call(a, s_val + c, i, end, C);
    }
    jb.out[(int64_t)sl * C + c] = a;
  }
}

template <typename T, typename S, bool kPerm>
__global__ void __launch_bounds__(kThreads) seg_sum_kernel(Job<T, S> jb) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.x < jb.n_long)
    long_runs<T, S, kPerm>(jb, blockIdx.x, smem);
  else
    tile_runs<T, S, kPerm>(jb, blockIdx.x - jb.n_long, smem);
}

template <typename T>
__global__ void add_chain_kernel(int64_t n, T* buf) {
  T v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = buf[u];
  T a = buf[8];
  for (int64_t i = 0; i < n; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) a = add_rn(a, v[u]);
  }
  buf[8] = a;
}

template <typename T, typename S, bool kPerm>
int launch(const Job<T, S>& jb, cudaStream_t stream) {
  const size_t a16 = 15;
  const size_t tile_smem =
      (((size_t)(jb.tile + kWindow + 1) * sizeof(S) + a16) & ~a16) +
      (kPerm ? (size_t)jb.tile * sizeof(int64_t) : 0) +
      2 * (size_t)jb.tile * jb.C * sizeof(T);
  const size_t long_smem = (((size_t)jb.C * sizeof(T) + a16) & ~a16) +
                           (size_t)kStages * jb.chunk * jb.C * sizeof(T);
  const size_t smem = tile_smem > long_smem ? tile_smem : long_smem;
  cudaError_t err = cudaFuncSetAttribute(
      seg_sum_kernel<T, S, kPerm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the long-run blocks, eight positions each, then the tiles
  const int64_t tiles = (jb.M + jb.tile - 1) / jb.tile;
  const int64_t blocks = jb.n_long + tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  seg_sum_kernel<T, S, kPerm>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(jb);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int dispatch(const void* slot, const void* perm, const void* vals,
             int64_t M, int C, int64_t limit, void* out, int tile,
             int chunk, cudaStream_t stream) {
  if ((int64_t)tile * C > kMaxElems || (int64_t)chunk * C > kMaxElems)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (M + tile - 1) / tile;
  Job<T, S> jb{(const S*)slot, (const T*)vals, (const int64_t*)perm, M, C,
               limit, (T*)out, tile, chunk,
               (tiles + kThreads / 32 - 1) / (kThreads / 32)};
  return perm ? launch<T, S, true>(jb, stream)
              : launch<T, S, false>(jb, stream);
}

}  // namespace

extern "C" {

// slot: (M,) int32 (slot_is_64 0) or int64, ascending; perm: (M,) int64,
// sorted row i's values at row perm[i] of vals, or null (vals sorted);
// vals: rows of C float32 (is_double 0) or float64; out: (>= limit, C) of
// the same type, read and written in place at the slots below limit.
// tile: rows a tile (a longer run is long), chunk: rows a ring chunk;
// both >= 1, tile * C and chunk * C at most 2048. Returns a cudaError_t
// (0 on success) of the launch.
int sfb_seg_sum(const void* slot, int slot_is_64, const void* perm,
                const void* vals, int64_t M, int64_t C, int64_t limit,
                void* out, int is_double, int tile, int chunk,
                void* stream) {
  if (M <= 0 || C <= 0 || limit <= 0) return 0;
  if (tile <= 0 || chunk <= 0 || C > kMaxElems)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int c = (int)C;
  if (is_double)
    return slot_is_64 ? dispatch<double, int64_t>(slot, perm, vals, M, c,
                                                  limit, out, tile, chunk, st)
                      : dispatch<double, int32_t>(slot, perm, vals, M, c,
                                                  limit, out, tile, chunk, st);
  return slot_is_64 ? dispatch<float, int64_t>(slot, perm, vals, M, c, limit,
                                               out, tile, chunk, st)
                    : dispatch<float, int32_t>(slot, perm, vals, M, c, limit,
                                               out, tile, chunk, st);
}

// one thread through n (a multiple of 8) dependent adds of buf[0..7] onto
// buf[8], written back to buf[8]
int sfb_seg_sum_chain(int64_t n, void* buf, int is_double, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    add_chain_kernel<double><<<1, 1, 0, st>>>(n, (double*)buf);
  else
    add_chain_kernel<float><<<1, 1, 0, st>>>(n, (float*)buf);
  return (int)cudaGetLastError();
}

const char* sfb_seg_sum_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
