// Ordered segment sums: the float scatter-add with the CPU's bits.
//
// On the CPU, Tensor.index_add_ adds a slot's terms one after another in
// row order, starting from the slot's value; so does XLA's CPU scatter,
// which the JAX package's parity tests rest on. The card's index_add_ adds
// them with atomics in the order threads arrive, so a float sum can change
// in its last bits from one run to the next. The wrapper
// (ops/seg_sum.py) drops the rows aimed at no slot, sorts the rest by slot
// with a stable sort (row order kept within a slot) and hands this kernel
// the sorted slots and values; the kernel then adds each slot's run in
// that order, starting from the slot's value: the CPU's operations, in
// the CPU's order, so the same bits on every run.
//
// One thread a (row, column): the thread whose row heads its slot's run
// (row 0, or a row whose slot differs from the row above) walks the run
// and writes the sum; every other thread returns at once. Each add is
// __fadd_rn / __dadd_rn, which the compiler never contracts or reorders.
// A run is serial, so a slot with R terms takes R dependent adds; the
// loads of a run are independent and go out eight at a time ahead of
// them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_sum_kernel(const int64_t* __restrict__ slot,
                   const T* __restrict__ vals, int64_t M, int64_t C,
                   T* __restrict__ out) {
  const int64_t total = M * C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / C;
    const int64_t c = t - i * C;
    const int64_t s = slot[i];
    if (i > 0 && slot[i - 1] == s) continue;  // not the head of its run
    T acc = out[s * C + c];
    int64_t j = i;
    // slots ascend, so slot[j + 7] == s puts all of j .. j + 7 in the run:
    // eight loads issued together, then eight adds in row order
    while (j + 8 <= M && slot[j + 7] == s) {
      T v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = vals[(j + u) * C + c];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = add_rn(acc, v[u]);
      j += 8;
    }
    while (j < M && slot[j] == s) {
      acc = add_rn(acc, vals[j * C + c]);
      ++j;
    }
    out[s * C + c] = acc;
  }
}

template <typename T>
int launch(const int64_t* slot, const void* vals, int64_t M, int64_t C,
           void* out, cudaStream_t stream) {
  const int64_t total = M * C;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  seg_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      slot, (const T*)vals, M, C, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// slot: (M,) int64 sorted ascending, each in [0, rows of out); vals: (M, C)
// float32 (is_double 0) or float64 (is_double 1), row i the term of
// slot[i]; out: (rows, C) of the same type, read and written in place.
// Returns a cudaError_t (0 on success) of the launch.
int sfb_seg_sum(const void* slot, const void* vals, int64_t M, int64_t C,
                void* out, int is_double, void* stream) {
  if (M <= 0 || C <= 0) return 0;
  auto* s = (const int64_t*)slot;
  cudaStream_t st = (cudaStream_t)stream;
  return is_double ? launch<double>(s, vals, M, C, out, st)
                   : launch<float>(s, vals, M, C, out, st);
}

const char* sfb_seg_sum_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
