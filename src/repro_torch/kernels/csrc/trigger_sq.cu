// trigger_sq: per-device squared deviation of the Event-2 trigger (Eq. 3),
//
//     sq[i] = sum_n (w[i, n] - w_hat[i, n])^2       in fp32, w, w_hat (m, D)
//
// Replaces the TPU kernel src/repro/kernels/trigger/kernel.py:39
// (trigger_sq_pallas, body _trigger_kernel): there the sequential grid
// streams (m, block_n) column tiles through VMEM into one revisited
// (m, 128) lane accumulator that the wrapper sums.  Hopper blocks run in
// parallel with no carry between them, so the blocking is not carried over.
//
// Bound on the H100: memory.  The function reads w and w_hat once
// (2 m D 4 bytes) and does 3 m D flops, far below the fp32 ridge.
//
// Design: one block per row.  The row is read as float4 along D (after a
// scalar head that brings the pointer to a 16-byte boundary; rows of an
// odd-width (m, D) array start anywhere), each thread accumulates its
// strided share in an fp32 register, and a fixed warp-shuffle tree plus a
// shared-memory pass over the warps finishes the sum.  No atomics: the
// summation order is fixed, so v is the same from run to run.  w - w_hat
// never exists in device memory.
//
// bf16 rows (repro_trigger_sq_bf16): the train step's Event 2 over stacked
// parameter leaves, the reference's trigger_sq_tree leaf by leaf on bf16
// leaves.  The leaves there are few and long (m = 4 rows of up to 3.0e8
// columns at starcoder2-15b's width), so one block a row would fill 4 of
// the 132 SMs.  Two passes instead: the first cuts each row into slabs of
// BF16_COLS columns, one 256-thread block a slab (16-byte loads of 8
// values, widened to fp32), and writes the slab's fp32 sum to scratch; the
// second sums each row's slab sums in slab order, one block a row.  Both
// reduce in a fixed order (no atomics), so v is the same from run to run.
// Bound: memory, 2 m D 2 bytes read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sq4(float4 a, float4 b, float acc) {
  float d0 = a.x - b.x, d1 = a.y - b.y, d2 = a.z - b.z, d3 = a.w - b.w;
  acc += d0 * d0;
  acc += d1 * d1;
  acc += d2 * d2;
  acc += d3 * d3;
  return acc;
}

__global__ void __launch_bounds__(kThreads)
trigger_sq_kernel(const float* __restrict__ w, const float* __restrict__ h,
                  float* __restrict__ out, long long D) {
  const long long row = blockIdx.x;
  const float* wr = w + row * D;
  const float* hr = h + row * D;
  const uintptr_t aw = reinterpret_cast<uintptr_t>(wr);
  const uintptr_t ah = reinterpret_cast<uintptr_t>(hr);
  // float4 only when both rows sit at the same offset from a 16-byte line
  const bool vec = ((aw ^ ah) & 15u) == 0;
  long long head = vec ? (long long)(((16u - (aw & 15u)) & 15u) / 4u) : D;
  if (head > D) head = D;

  float acc = 0.f;
  for (long long n = threadIdx.x; n < head; n += kThreads) {
    float d = wr[n] - hr[n];
    acc += d * d;
  }
  if (vec) {
    const long long n4 = (D - head) / 4;
    const float4* w4 = reinterpret_cast<const float4*>(wr + head);
    const float4* h4 = reinterpret_cast<const float4*>(hr + head);
    for (long long q = threadIdx.x; q < n4; q += kThreads)
      acc = sq4(__ldg(w4 + q), __ldg(h4 + q), acc);
    for (long long n = head + 4 * n4 + threadIdx.x; n < D; n += kThreads) {
      float d = wr[n] - hr[n];
      acc += d * d;
    }
  }

  __shared__ float part[kThreads / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
    v = warp_sum(v);
    if (threadIdx.x == 0) out[row] = v;
  }
}

// a block's fp32 sum over the block (the shuffle tree, then the warps'
// sums in order); valid in thread 0
__device__ __forceinline__ float block_sum(float acc) {
  __shared__ float part[kThreads / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
    v = warp_sum(v);
  }
  return v;
}

constexpr long long BF16_COLS = 32768;  // columns a first-pass block sums

// first pass: slab blockIdx.x of row blockIdx.y -> part[row, slab]; V = 8
// when D % 8 == 0 and both bases are 16-byte aligned, else 1
template <int V>
__global__ void __launch_bounds__(kThreads)
trigger_sq_bf16_kernel(const uint16_t* __restrict__ w, const uint16_t* __restrict__ h,
                       float* __restrict__ part, long long D) {
  const long long row = blockIdx.y, slab = blockIdx.x;
  const long long c0 = slab * BF16_COLS;
  const long long c1 = c0 + BF16_COLS < D ? c0 + BF16_COLS : D;
  const uint16_t* wr = w + row * D;
  const uint16_t* hr = h + row * D;
  float acc = 0.f;
  for (long long c = c0 + (long long)threadIdx.x * V; c < c1; c += (long long)kThreads * V) {
    float a[V], b[V];
    bf16rows::load<V>(wr + c, a);
    bf16rows::load<V>(hr + c, b);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float d = a[t] - b[t];
      acc += d * d;
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[row * gridDim.x + slab] = acc;
}

// second pass: one block a row sums its n_slab slab sums
__global__ void __launch_bounds__(kThreads)
trigger_sq_bf16_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                            long long n_slab) {
  const long long row = blockIdx.x;
  float acc = 0.f;
  for (long long q = threadIdx.x; q < n_slab; q += kThreads) acc += part[row * n_slab + q];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[row] = acc;
}

}  // namespace

// w, w_hat: (m, D) bf16 row-major (as 16-bit words); out: (m,) fp32;
// part: (m, n_slab) fp32 scratch with n_slab = ceil(D / 32768), 1 <= m <=
// 65535.  Launches both passes on `stream` and returns the CUDA error of
// the launches.
extern "C" int repro_trigger_sq_bf16(const uint16_t* w, const uint16_t* w_hat, float* out,
                                     float* part, long long m, long long D, long long n_slab,
                                     void* stream) {
  if (m < 1 || m > 65535 || D < 1 || n_slab != (D + BF16_COLS - 1) / BF16_COLS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = D % 8 == 0 && (((uintptr_t)w | (uintptr_t)w_hat) & 15u) == 0;
  const dim3 grid((unsigned int)n_slab, (unsigned int)m);
  if (vec)
    trigger_sq_bf16_kernel<8><<<grid, kThreads, 0, st>>>(w, w_hat, part, D);
  else
    trigger_sq_bf16_kernel<1><<<grid, kThreads, 0, st>>>(w, w_hat, part, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  trigger_sq_bf16_rows_kernel<<<(unsigned int)m, kThreads, 0, st>>>(part, out, n_slab);
  return (int)cudaGetLastError();
}

// w, w_hat: (m, D) fp32 row-major; out: (m,) fp32.  Launches on `stream`
// and returns cudaGetLastError() of the launch.
extern "C" int repro_trigger_sq_f32(const float* w, const float* w_hat, float* out,
                                    long long m, long long D, void* stream) {
  trigger_sq_kernel<<<(unsigned int)m, kThreads, 0, (cudaStream_t)stream>>>(w, w_hat, out, D);
  return (int)cudaGetLastError();
}
