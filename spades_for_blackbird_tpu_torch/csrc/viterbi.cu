// Local profile-HMM Viterbi over ragged amino-acid rows, every profile of
// a batch in one entry call: a warp a (profile, row) pair for profiles up
// to 512 nodes, a block a pair above that.
//
// Replaces the JAX package's ops/hmm.py::viterbi_ends (:89): a lax.scan
// over sequence positions (:160) with a lax.associative_scan over the
// delete chain inside each position (:139), vmapped over rows. That
// function is no Pallas kernel; written as plain PyTorch every position
// is some forty small launches, so one 500 kb contig (167,000 positions
// a frame) would keep the card idle for minutes.
//
// Per position i with residue a, for every model node j (the JAX order of
// operations, float32, compiled with --fmad=false; every operation is an
// add, a compare or a select, so the kernel is bit-equal to the plain
// PyTorch version ops/hmm.py::viterbi_ends_plain):
//   pm, pi, pd = VM[j-1] + tMM[j-1], VI[j-1] + tIM[j-1], VD[j-1] + tDM[j-1]
//                (NEG at j = 0), starts SM/SI/SD[j-1] (0 at j = 0)
//   VMn[j] = match[j][a] + max(tBM, pm, pi, pd), the first on ties; SMn
//            the chosen start (i for the entry)
//   VIn[j] = (a == STOP ? NEG : 0) + max(VM[j] + tMI[j], VI[j] + tII[j]),
//            SIn[j] = im >= ii ? SM[j] : SI[j]
//   aval[j] = (VMn[j] + tMD[j]) - cdd[j], cdd = cumsum(tDD) (host, float32)
//   run[j] = inclusive max-plus scan of (aval, SMn), a tie to the later
//            node (a selection, so any grouping gives the sequential fold)
//   VDn[j] = run_s[j-1] + cdd[j-1] (NEG + 0 at j = 0), SDn[j] = run_i[j-1]
//   out: es[i] = max_j VMn[j], the first node on ties; st[i] its SMn.
// The first-on-ties max over (tBM, pm, pi, pd) is taken as the max over
// (pm, pi, pd), then against tBM: the same choice, so node j-1 hands node
// j one (value, start) pair.
//
// The recursion is serial over a row's positions, so the card's rates do
// not bound it: a launch takes about its longest row's positions times
// the latency of one position, and the design shortens that latency and
// runs every (profile, row) pair at once.
//
// Warp path (m <= 512): NPL consecutive nodes a lane (NPL the batch's
// largest ceil(m / 32), rounded up to even), the state and transitions in
// registers. Per position: one __shfl_up_sync brings the left lane's
// (value, start) pair; the delete chain is an in-lane fold and a 5-step
// shuffle scan (later wins ties); the exit argmax is a lane-local max, one
// __reduce_max_sync on an order-preserving integer key, a ballot for the
// first lane holding it and two shuffles, taken one position behind so
// the next position's chain does not wait on it. Nodes past m score -inf
// (never the exit, never read by a real node). No __syncthreads, no
// shared-memory write and no branch on the chain, and two positions a
// trip of the loop, so the in-order warp has independent work to issue
// while a shuffle is in flight. The warps of a block share one profile's
// match table in shared memory, laid out [residue][node of the lane]
// [lane] so a warp's 32 loads hit 32 banks. Residues come 128 at a time
// (a 4-byte word a lane, one coalesced load, the next word fetched a
// chunk ahead) and are broadcast by shuffle; scores and starts are kept a
// position a lane and stored 32 at a time. Blocks take (row group,
// profile) with rows longest first, so every profile's longest rows start
// in the first wave.
//
// Block path (512 < m <= 2048): one block a (profile, row) pair, NPT
// consecutive nodes a thread (1 up to 1024 nodes, 2 above), the left
// neighbour and the scan's warp totals through shared memory, four
// __syncthreads a position.
//
// Rows are ragged: row r's residues at seqs[row_off[r] ..], its outputs at
// es/st[p * N + row_off[r] ..]; a padded (B, L) array is the ragged rows
// at offsets r * L. The kernels write only the positions inside a row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kStop = 20;
constexpr int kSym = 21;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxM = 512;
constexpr int kWarpsPerBlock = 2;

struct Batch {
  const float* matchT;     // (21, Mtot): a residue's scores, node-contiguous
  const float* trans;      // (7, Mtot): tMM, tMI, tMD, tIM, tII, tDM, cdd
  int Mtot;
  const int32_t* meta;     // (P, 2): node offset, m
  const float* tbm;        // (P,): entry score log(1/m)
  const int32_t* ids;      // profiles of this launch
  int n_ids;
  const uint8_t* seqs;     // residues, 4-byte aligned, nbytes % 4 == 0
  long long nbytes;
  const int64_t* row_off;  // (B,)
  const int32_t* row_len;  // (B,), each >= 0
  const int32_t* order;    // (B,) rows in the order to run
  int B;
  long long N;             // positions of one profile's outputs
  float* es;               // (P, N)
  int32_t* st;             // (P, N)
};

// later-wins-ties selection: (s, i) of the later segment if s >= earlier
__device__ __forceinline__ void take_later(float& s, int& i, float es,
                                           int ei) {
  if (!(s >= es)) {
    s = es;
    i = ei;
  }
}

// argmax with the first (smallest node) index on ties
__device__ __forceinline__ void take_best(float& v, int& j, int& st,
                                          float ov, int oj, int ost) {
  if (ov > v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
    st = ost;
  }
}

__device__ __forceinline__ void row_of(const Batch& bt, int item, int& r,
                                       long long& off, int& len) {
  r = bt.order[item];
  off = bt.row_off[r];
  len = bt.row_len[r];
}

// the 4-byte word of seqs at byte wa (a multiple of 4; nbytes is one
// too); a word past the buffer reads its last word, whose bytes no row
// past it uses
__device__ __forceinline__ uint32_t load_word(const uint8_t* seqs,
                                              long long nbytes,
                                              long long wa) {
  return __ldg(
      reinterpret_cast<const uint32_t*>(seqs + min(wa, nbytes - 4)));
}

// an integer key whose order is the floats' (-0 and +0 alike)
__device__ __forceinline__ int order_key(float f) {
  int b = __float_as_int(f + 0.0f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// residue of byte k (k & 127 of a 128-byte chunk) from the chunk's word
// held by each lane
__device__ __forceinline__ int residue(uint32_t word, int k) {
  return (__shfl_sync(kFull, word, (k >> 2) & 31) >> (8 * (k & 3))) & 0xff;
}

// the warp's exit at one position from each lane's first best node
// (bv, bst): the first lane holding the largest value gives the end score
// and start, which the lane ``mine`` keeps
__device__ __forceinline__ void exit_of(float bv, int bst, bool mine,
                                        float& es, int& st) {
  const int key = order_key(bv);
  const int kmax = __reduce_max_sync(kFull, key);
  const int src = __ffs(__ballot_sync(kFull, key == kmax)) - 1;
  const float ev = __shfl_sync(kFull, bv, src);
  const int est = __shfl_sync(kFull, bst, src);
  es = mine ? ev : es;
  st = mine ? est : st;
}

template <int NPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    viterbi_warp_kernel(Batch bt) {
  extern __shared__ float s_match[];  // [kSym][NPL][32]
  const int p = bt.ids[blockIdx.x % bt.n_ids];
  const int group = blockIdx.x / bt.n_ids;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int off = bt.meta[2 * p];
  const int m = bt.meta[2 * p + 1];
  const float tBM = bt.tbm[p];
  const size_t Mtot = bt.Mtot;
  for (int x = threadIdx.x; x < kSym * NPL * 32; x += blockDim.x) {
    const int a = x / (NPL * 32);
    const int q = (x >> 5) % NPL;
    const int j = (x & 31) * NPL + q;
    s_match[x] = j < m ? bt.matchT[a * Mtot + off + j] : -INFINITY;
  }
  __syncthreads();
  const int item = group * kWarpsPerBlock + warp;
  if (item >= bt.B) return;

  float tMM[NPL], tMI[NPL], tMD[NPL], tIM[NPL], tII[NPL], tDM[NPL];
  float cdd[NPL];
  float VM[NPL], VI[NPL], VD[NPL];
  int SM[NPL], SI[NPL], SD[NPL];
  const int j0 = lane * NPL;
#pragma unroll
  for (int q = 0; q < NPL; ++q) {
    const int j = j0 + q;
    const bool real = j < m;
    const float* tr = bt.trans + off + j;
    tMM[q] = real ? tr[0 * Mtot] : 0.0f;
    tMI[q] = real ? tr[1 * Mtot] : 0.0f;
    tMD[q] = real ? tr[2 * Mtot] : 0.0f;
    tIM[q] = real ? tr[3 * Mtot] : 0.0f;
    tII[q] = real ? tr[4 * Mtot] : 0.0f;
    tDM[q] = real ? tr[5 * Mtot] : 0.0f;
    cdd[q] = real ? tr[6 * Mtot] : 0.0f;
    VM[q] = VI[q] = VD[q] = kNeg;
    SM[q] = SI[q] = SD[q] = 0;
  }
  // cdd of the node left of this lane's first
  const float cdd_in =
      (lane > 0 && j0 - 1 < m) ? bt.trans[6 * Mtot + off + j0 - 1] : 0.0f;

  int r, len;
  long long roff;
  row_of(bt, item, r, roff, len);
  const long long abase = roff & ~3LL;
  const int shift = (int)(roff - abase);
  float* es_out = bt.es + (long long)p * bt.N + roff;
  int32_t* st_out = bt.st + (long long)p * bt.N + roff;
  uint32_t wcur = load_word(bt.seqs, bt.nbytes, abase + 4 * lane);
  uint32_t wnext = load_word(bt.seqs, bt.nbytes, abase + 128 + 4 * lane);
  int a_next = residue(wcur, shift);
  float my_es = kNeg;  // this lane's position of the current 32
  int my_st = 0;
  float pbv = -INFINITY;  // the lane's exit candidate of the last position
  int pbst = 0;

  // two positions a trip, so the scheduler can fill one position's chain
  // with the other's independent work
#pragma unroll 2
  for (int i = 0; i < len; ++i) {
    const int k = shift + i;
    if ((k & 127) == 0 && i > 0) {
      wcur = wnext;
      wnext = load_word(bt.seqs, bt.nbytes,
                        abase + (long long)((k >> 7) + 1) * 128 + 4 * lane);
    }
    const int a = a_next;
    float me[NPL];
#pragma unroll
    for (int q = 0; q < NPL; ++q) me[q] = s_match[(a * NPL + q) * 32 + lane];

    // each node's (value, start) handed to the node on its right: the
    // first-on-ties max of the three transitions into it
    float ob[NPL];
    int obs[NPL];
#pragma unroll
    for (int q = 0; q < NPL; ++q) {
      ob[q] = VM[q] + tMM[q];
      obs[q] = SM[q];
      const float c2 = VI[q] + tIM[q];
      if (c2 > ob[q]) {
        ob[q] = c2;
        obs[q] = SI[q];
      }
      const float c3 = VD[q] + tDM[q];
      if (c3 > ob[q]) {
        ob[q] = c3;
        obs[q] = SD[q];
      }
    }
    float in_b = __shfl_up_sync(kFull, ob[NPL - 1], 1);
    int in_bs = __shfl_up_sync(kFull, obs[NPL - 1], 1);
    if (lane == 0) {
      in_b = kNeg;
      in_bs = 0;
    }

    // the exit of the last position, one position behind, so that its
    // warp reduction fills the latency of this position's chain
    exit_of(pbv, pbst, i > 0 && lane == ((i - 1) & 31), my_es, my_st);

    const float ie = (a == kStop) ? kNeg : 0.0f;
    float VMn[NPL], rs[NPL];
    int SMn[NPL], ri[NPL];
#pragma unroll
    for (int q = 0; q < NPL; ++q) {
      const float cb = q == 0 ? in_b : ob[q - 1];
      const int cbs = q == 0 ? in_bs : obs[q - 1];
      float best = tBM;
      int bs = i;
      if (cb > best) {
        best = cb;
        bs = cbs;
      }
      VMn[q] = me[q] + best;
      SMn[q] = bs;
      const float im = VM[q] + tMI[q];
      const float ii = VI[q] + tII[q];
      VI[q] = ie + (im >= ii ? im : ii);
      SI[q] = im >= ii ? SM[q] : SI[q];
      rs[q] = (VMn[q] + tMD[q]) - cdd[q];
      ri[q] = SMn[q];
    }

    // the delete chain: the lane's inclusive prefixes, then the warp's
#pragma unroll
    for (int q = 1; q < NPL; ++q)
      take_later(rs[q], ri[q], rs[q - 1], ri[q - 1]);
    float ts = rs[NPL - 1];
    int ti = ri[NPL - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float os = __shfl_up_sync(kFull, ts, d);
      const int oi = __shfl_up_sync(kFull, ti, d);
      if (lane >= d) take_later(ts, ti, os, oi);
    }
    const float ps = __shfl_up_sync(kFull, ts, 1);
    const int pi_ = __shfl_up_sync(kFull, ti, 1);
#pragma unroll
    for (int q = 0; q < NPL; ++q)
      if (lane > 0) take_later(rs[q], ri[q], ps, pi_);

    // this lane's exit candidate: its first best node (nodes past m
    // score -inf)
    pbv = VMn[0];
    pbst = SMn[0];
#pragma unroll
    for (int q = 1; q < NPL; ++q) {
      if (VMn[q] > pbv) {
        pbv = VMn[q];
        pbst = SMn[q];
      }
    }

#pragma unroll
    for (int q = 0; q < NPL; ++q) {
      VD[q] = q == 0 ? (lane == 0 ? kNeg + 0.0f : ps + cdd_in)
                     : rs[q - 1] + cdd[q - 1];
      SD[q] = q == 0 ? (lane == 0 ? 0 : pi_) : ri[q - 1];
      VM[q] = VMn[q];
      SM[q] = SMn[q];
    }
    // the next residue: in the next chunk's word at a chunk's end
    a_next = residue(((k + 1) & 127) ? wcur : wnext, k + 1);
    if (i > 0 && ((i - 1) & 31) == 31) {
      es_out[(i - 32) + lane] = my_es;
      st_out[(i - 32) + lane] = my_st;
    }
  }
  if (len > 0) {
    exit_of(pbv, pbst, lane == ((len - 1) & 31), my_es, my_st);
    const int at = ((len - 1) & ~31) + lane;
    if (at < len) {
      es_out[at] = my_es;
      st_out[at] = my_st;
    }
  }
}

template <int NPT>
__global__ void viterbi_block_kernel(Batch bt) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int p = bt.ids[blockIdx.x % bt.n_ids];
  const int item = blockIdx.x / bt.n_ids;
  const int off = bt.meta[2 * p];
  const int m = bt.meta[2 * p + 1];
  const float tBM = bt.tbm[p];
  const size_t Mtot = bt.Mtot;
  const int m_max = T * NPT;               // the launch's node capacity
  float* s_match = smem;                  // kSym * m_max
  float* x_pm = s_match + kSym * m_max;   // T: a thread's last node
  float* x_pi = x_pm + T;
  float* x_pd = x_pi + T;
  float* x_rs = x_pd + T;
  int* x_sm = reinterpret_cast<int*>(x_rs + T);
  int* x_si = x_sm + T;
  int* x_sd = x_si + T;
  int* x_ri = x_sd + T;
  float* w_s = reinterpret_cast<float*>(x_ri + T);  // 32 warp scan totals
  int* w_i = reinterpret_cast<int*>(w_s + 32);
  float* b_v = reinterpret_cast<float*>(w_i + 32);  // 32 warp argmaxes
  int* b_j = reinterpret_cast<int*>(b_v + 32);
  int* b_st = b_j + 32;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  for (int x = t; x < kSym * m; x += T) {
    const int a = x / m;
    s_match[x] = bt.matchT[a * Mtot + off + (x - a * m)];
  }

  float tMM[NPT], tMI[NPT], tMD[NPT], tIM[NPT], tII[NPT], tDM[NPT];
  float cdd[NPT], cdd_prev[NPT];
  float VM[NPT], VI[NPT], VD[NPT];
  int SM[NPT], SI[NPT], SD[NPT];
  bool real[NPT];
#pragma unroll
  for (int q = 0; q < NPT; ++q) {
    const int j = t * NPT + q;
    real[q] = j < m;
    const float* tr = bt.trans + off + (real[q] ? j : 0);
    tMM[q] = tr[0 * Mtot];
    tMI[q] = tr[1 * Mtot];
    tMD[q] = tr[2 * Mtot];
    tIM[q] = tr[3 * Mtot];
    tII[q] = tr[4 * Mtot];
    tDM[q] = tr[5 * Mtot];
    cdd[q] = tr[6 * Mtot];
    cdd_prev[q] = (real[q] && j > 0) ? tr[6 * Mtot - 1] : 0.0f;
    VM[q] = VI[q] = VD[q] = kNeg;
    SM[q] = SI[q] = SD[q] = 0;
  }
  __syncthreads();

  int r, len;
  long long roff;
  row_of(bt, item, r, roff, len);
  const uint8_t* seq = bt.seqs + roff;
  float* es_row = bt.es + (long long)p * bt.N + roff;
  int32_t* st_row = bt.st + (long long)p * bt.N + roff;
  for (int i = 0; i < len; ++i) {
    const int a = seq[i];
    x_pm[t] = VM[NPT - 1] + tMM[NPT - 1];
    x_pi[t] = VI[NPT - 1] + tIM[NPT - 1];
    x_pd[t] = VD[NPT - 1] + tDM[NPT - 1];
    x_sm[t] = SM[NPT - 1];
    x_si[t] = SI[NPT - 1];
    x_sd[t] = SD[NPT - 1];
    __syncthreads();  // 1: neighbours' old state visible

    float VMn[NPT], VIn[NPT], rs[NPT];
    int SMn[NPT], SIn[NPT], ri[NPT];
    const float ie = (a == kStop) ? kNeg : 0.0f;
#pragma unroll
    for (int q = 0; q < NPT; ++q) {
      float pm, pi, pd;
      int psm, psi, psd;
      if (q == 0) {
        if (t == 0) {
          pm = pi = pd = kNeg;
          psm = psi = psd = 0;
        } else {
          pm = x_pm[t - 1];
          pi = x_pi[t - 1];
          pd = x_pd[t - 1];
          psm = x_sm[t - 1];
          psi = x_si[t - 1];
          psd = x_sd[t - 1];
        }
      } else {
        pm = VM[q - 1] + tMM[q - 1];
        pi = VI[q - 1] + tIM[q - 1];
        pd = VD[q - 1] + tDM[q - 1];
        psm = SM[q - 1];
        psi = SI[q - 1];
        psd = SD[q - 1];
      }
      float best = tBM;
      int bs = i;
      if (pm > best) { best = pm; bs = psm; }
      if (pi > best) { best = pi; bs = psi; }
      if (pd > best) { best = pd; bs = psd; }
      const int j = t * NPT + q;
      const float me = real[q] ? s_match[a * m + j] : 0.0f;
      VMn[q] = me + best;
      SMn[q] = bs;
      const float im = VM[q] + tMI[q];
      const float ii = VI[q] + tII[q];
      VIn[q] = ie + (im >= ii ? im : ii);
      SIn[q] = im >= ii ? SM[q] : SI[q];
      rs[q] = (VMn[q] + tMD[q]) - cdd[q];
      ri[q] = SMn[q];
      if (q > 0) take_later(rs[q], ri[q], rs[q - 1], ri[q - 1]);
    }

    // block scan of the threads' totals (later wins ties)
    float ts = rs[NPT - 1];
    int ti = ri[NPT - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float os = __shfl_up_sync(kFull, ts, d);
      const int oi = __shfl_up_sync(kFull, ti, d);
      if (lane >= d) take_later(ts, ti, os, oi);
    }
    const float lane_prev_s = __shfl_up_sync(kFull, ts, 1);
    const int lane_prev_i = __shfl_up_sync(kFull, ti, 1);
    // this thread's exit candidate, then its warp's
    float bv = real[0] ? VMn[0] : -INFINITY;
    int bj = t * NPT;
    int bst = SMn[0];
#pragma unroll
    for (int q = 1; q < NPT; ++q)
      if (real[q]) take_best(bv, bj, bst, VMn[q], t * NPT + q, SMn[q]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float ov = __shfl_down_sync(kFull, bv, d);
      const int oj = __shfl_down_sync(kFull, bj, d);
      const int ost = __shfl_down_sync(kFull, bst, d);
      take_best(bv, bj, bst, ov, oj, ost);
    }
    if (lane == 31) {
      w_s[warp] = ts;
      w_i[warp] = ti;
    }
    if (lane == 0) {
      b_v[warp] = bv;
      b_j[warp] = bj;
      b_st[warp] = bst;
    }
    __syncthreads();  // 2: warp totals visible
    if (warp == 0) {
      float s = lane < nwarps ? w_s[lane] : kNeg;
      int si = lane < nwarps ? w_i[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float os = __shfl_up_sync(kFull, s, d);
        const int oi = __shfl_up_sync(kFull, si, d);
        if (lane >= d) take_later(s, si, os, oi);
      }
      float v = lane < nwarps ? b_v[lane] : -INFINITY;
      int vj = lane < nwarps ? b_j[lane] : 0x7fffffff;
      int vst = lane < nwarps ? b_st[lane] : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float ov = __shfl_down_sync(kFull, v, d);
        const int oj = __shfl_down_sync(kFull, vj, d);
        const int ost = __shfl_down_sync(kFull, vst, d);
        take_best(v, vj, vst, ov, oj, ost);
      }
      if (lane < nwarps) {
        w_s[lane] = s;
        w_i[lane] = si;
      }
      if (lane == 0) {
        es_row[i] = v;
        st_row[i] = vst;
      }
    }
    __syncthreads();  // 3: warp prefixes visible

    // exclusive prefix of this thread: earlier warps, then earlier lanes
    bool have = warp > 0;
    float ps = have ? w_s[warp - 1] : 0.0f;
    int pi_ = have ? w_i[warp - 1] : 0;
    if (lane > 0) {
      if (have) {
        float s = lane_prev_s;
        int si = lane_prev_i;
        take_later(s, si, ps, pi_);
        ps = s;
        pi_ = si;
      } else {
        ps = lane_prev_s;
        pi_ = lane_prev_i;
      }
      have = true;
    }
    if (have) {
#pragma unroll
      for (int q = 0; q < NPT; ++q) take_later(rs[q], ri[q], ps, pi_);
    }
    x_rs[t] = rs[NPT - 1];
    x_ri[t] = ri[NPT - 1];
    __syncthreads();  // 4: the scan's last node of each thread visible

#pragma unroll
    for (int q = 0; q < NPT; ++q) {
      float vd;
      int sd;
      if (q == 0) {
        if (t == 0) {
          vd = kNeg + 0.0f;
          sd = 0;
        } else {
          vd = x_rs[t - 1] + cdd_prev[0];
          sd = x_ri[t - 1];
        }
      } else {
        vd = rs[q - 1] + cdd_prev[q];
        sd = ri[q - 1];
      }
      VM[q] = VMn[q];
      VI[q] = VIn[q];
      VD[q] = vd;
      SM[q] = SMn[q];
      SI[q] = SIn[q];
      SD[q] = sd;
    }
  }
}

template <int NPL>
int launch_warp(const Batch& bt, cudaStream_t stream) {
  const int groups = (bt.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t shm = (size_t)kSym * NPL * 32 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_warp_kernel<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  viterbi_warp_kernel<NPL>
      <<<(unsigned)groups * bt.n_ids, 32 * kWarpsPerBlock, shm, stream>>>(bt);
  return (int)cudaGetLastError();
}

template <int NPT>
int launch_block(const Batch& bt, int m_max, cudaStream_t stream) {
  const int T = ((m_max + NPT - 1) / NPT + 31) / 32 * 32;
  const size_t shm = (size_t)kSym * T * NPT * sizeof(float)
                     + (size_t)T * 8 * sizeof(float) + 32 * 5 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_block_kernel<NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  viterbi_block_kernel<NPT>
      <<<(unsigned)bt.B * bt.n_ids, T, shm, stream>>>(bt);
  return (int)cudaGetLastError();
}

int dispatch_warp(const Batch& bt, int npl, cudaStream_t s) {
  switch (npl) {
    case 2: return launch_warp<2>(bt, s);
    case 4: return launch_warp<4>(bt, s);
    case 6: return launch_warp<6>(bt, s);
    case 8: return launch_warp<8>(bt, s);
    case 10: return launch_warp<10>(bt, s);
    case 12: return launch_warp<12>(bt, s);
    case 14: return launch_warp<14>(bt, s);
    case 16: return launch_warp<16>(bt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Every profile of a batch over ragged rows, in one call.
// matchT: (21, Mtot) float32; trans: (7, Mtot) float32 (tMM, tMI, tMD,
// tIM, tII, tDM, cdd); meta: (P, 2) int32 (node offset, m); tbm: (P,)
// float32; warp_ids (n_warp) and block_ids (n_block): int32 profiles of
// the warp path (m <= 512, npl the even nodes a lane that fits the
// largest) and of the block path (block_m their largest m, <= 2048);
// seqs: nbytes uint8 residues (0..20), 4-byte aligned, nbytes a positive
// multiple of 4; row_off: (B,)
// int64; row_len: (B,) int32, each >= 0; order: (B,) int32 rows in the
// order to run; es: (P, N) float32, st: (P, N) int32, written only inside
// the rows. *kernels gets the kernels launched (0, 1 or 2: the warp and
// the block path). Returns a cudaError_t (0 on success).
int sfb_viterbi_batched(const void* matchT, const void* trans, int Mtot,
                        const void* meta, const void* tbm,
                        const void* warp_ids, int n_warp, int npl,
                        const void* block_ids, int n_block, int block_m,
                        const void* seqs, long long nbytes,
                        const void* row_off, const void* row_len,
                        const void* order, int B, long long N,
                        void* es, void* st, void* stream, int* kernels) {
  *kernels = 0;
  if (B <= 0) return 0;
  if (n_warp > 0 && (npl < 2 || npl > kWarpMaxM / 32 || npl % 2))
    return (int)cudaErrorInvalidValue;
  if (n_block > 0 && (block_m <= 0 || block_m > 2048))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(seqs) % 4 || nbytes < 4 || nbytes % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Batch bt{(const float*)matchT, (const float*)trans, Mtot,
           (const int32_t*)meta, (const float*)tbm, nullptr, 0,
           (const uint8_t*)seqs, nbytes, (const int64_t*)row_off,
           (const int32_t*)row_len, (const int32_t*)order, B, N,
           (float*)es, (int32_t*)st};
  if (n_warp > 0) {
    bt.ids = (const int32_t*)warp_ids;
    bt.n_ids = n_warp;
    const int err = dispatch_warp(bt, npl, s);
    if (err) return err;
    ++*kernels;
  }
  if (n_block > 0) {
    bt.ids = (const int32_t*)block_ids;
    bt.n_ids = n_block;
    const int err = block_m <= 1024 ? launch_block<1>(bt, block_m, s)
                                    : launch_block<2>(bt, block_m, s);
    if (err) return err;
    ++*kernels;
  }
  return 0;
}

const char* sfb_viterbi_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
