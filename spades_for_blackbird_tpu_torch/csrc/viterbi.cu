// Local profile-HMM Viterbi over a batch of amino-acid rows, one block a
// row, the whole recursion over the row's positions in one launch.
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
// Positions at or past the row's length get es = NEG and st = 0.
//
// Design: NPT consecutive nodes a thread (NPT = 1 up to m = 1024, 2 up to
// 2048), the state in registers; the match table (21 x m float32,
// transposed so a residue's column is contiguous) in shared memory; a
// node's left neighbour comes from the thread itself or, for its first
// node, through shared memory; the delete-chain scan is a thread-local
// fold, warp shuffles, then the warp totals; the exit is a block argmax.
// Four __syncthreads a position. The recursion is serial over positions,
// so the card's rates do not bound it: its time is a row's positions
// times the latency of one position's scans, with the rows (and the
// profiles, launch after launch) in parallel over the SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kStop = 20;
constexpr int kSym = 21;
constexpr unsigned kFull = 0xffffffffu;

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

template <int NPT>
__global__ void viterbi_kernel(const float* __restrict__ matchT,
                               const float* __restrict__ trans,
                               const uint8_t* __restrict__ seqs,
                               const int32_t* __restrict__ lengths, int L,
                               int m, float tBM, float* __restrict__ es,
                               int32_t* __restrict__ st) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  float* s_match = smem;                  // kSym * m
  float* x_pm = s_match + kSym * m;       // T: a thread's last node
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

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  for (int x = t; x < kSym * m; x += T) s_match[x] = matchT[x];

  // trans rows: tMM, tMI, tMD, tIM, tII, tDM, cdd (each m float32)
  float tMM[NPT], tMI[NPT], tMD[NPT], tIM[NPT], tII[NPT], tDM[NPT];
  float cdd[NPT], cdd_prev[NPT];
  float VM[NPT], VI[NPT], VD[NPT];
  int SM[NPT], SI[NPT], SD[NPT];
  bool real[NPT];
#pragma unroll
  for (int q = 0; q < NPT; ++q) {
    const int j = t * NPT + q;
    real[q] = j < m;
    const int jj = real[q] ? j : 0;
    tMM[q] = trans[0 * m + jj];
    tMI[q] = trans[1 * m + jj];
    tMD[q] = trans[2 * m + jj];
    tIM[q] = trans[3 * m + jj];
    tII[q] = trans[4 * m + jj];
    tDM[q] = trans[5 * m + jj];
    cdd[q] = trans[6 * m + jj];
    cdd_prev[q] = (real[q] && j > 0) ? trans[6 * m + j - 1] : 0.0f;
    VM[q] = VI[q] = VD[q] = kNeg;
    SM[q] = SI[q] = SD[q] = 0;
  }
  __syncthreads();

  const int len = max(0, min(lengths[row], L));
  const uint8_t* seq = seqs + (size_t)row * L;
  float* es_row = es + (size_t)row * L;
  int32_t* st_row = st + (size_t)row * L;
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
  for (int i = len + t; i < L; i += T) {
    es_row[i] = kNeg;
    st_row[i] = 0;
  }
}

template <int NPT>
int launch(const float* matchT, const float* trans, const uint8_t* seqs,
           const int32_t* lengths, int B, int L, int m, float tBM,
           float* es, int32_t* st, cudaStream_t stream) {
  const int T = ((m + NPT - 1) / NPT + 31) / 32 * 32;
  const size_t shm = (size_t)kSym * m * sizeof(float)
                     + (size_t)T * 8 * sizeof(float) + 32 * 5 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_kernel<NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  viterbi_kernel<NPT><<<B, T, shm, stream>>>(matchT, trans, seqs, lengths,
                                             L, m, tBM, es, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// matchT: (21, m) float32; trans: (7, m) float32 (tMM, tMI, tMD, tIM, tII,
// tDM, cdd); seqs: (B, L) uint8; lengths: (B,) int32; es: (B, L)
// float32; st: (B, L) int32. Returns a cudaError_t (0 on success).
int sfb_viterbi(const void* matchT, const void* trans, const void* seqs,
                const void* lengths, int B, int L, int m, float tBM,
                void* es, void* st, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (m <= 0 || m > 2048) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= 1024)
    return launch<1>((const float*)matchT, (const float*)trans,
                     (const uint8_t*)seqs, (const int32_t*)lengths, B, L, m,
                     tBM, (float*)es, (int32_t*)st, s);
  return launch<2>((const float*)matchT, (const float*)trans,
                   (const uint8_t*)seqs, (const int32_t*)lengths, B, L, m,
                   tBM, (float*)es, (int32_t*)st, s);
}

const char* sfb_viterbi_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
