// trigger_sq: per-device squared deviation of the Event-2 trigger (Eq. 3),
//
//     sq[i] = sum_n (w[i, n] - w_hat[i, n])^2      summed in fp32, w, w_hat (m, D)
//
// over fp32 rows and bf16 rows (a train tree's bf16 leaves, widened exactly).
//
// Replaces the TPU kernel src/repro/kernels/trigger/kernel.py:39
// (trigger_sq_pallas) and its wrapper's lane sum: there a sequential grid
// streams (m, block_n) column tiles through VMEM into one revisited (m, 128)
// lane accumulator.  Hopper blocks run in parallel with no carry between them.
//
// Bound on the H100: memory.  The function reads w and w_hat once (2 m D x 4
// bytes in fp32, x 2 in bf16) and does 3 m D flops, far below the ridge.
//
// Design: a host plan (kernels/trigger/ops.py::slab_plan) cuts each row into
// n_slab column slabs, one 512-thread block a slab, numbered row-major on
// gridDim.x (any m with m n_slab < 2^31).  Rows that fill the card alone keep
// one slab: one pass, no scratch.  Few long rows (a train tree's 4 replicas of
// a 1.6e6-column router or a 3e8-column bf16 leaf) get enough slabs to fill
// the card instead of streaming through 4 of its 132 SMs.  Slab k > 0 starts
// 16-byte aligned at head + k cols, head being the scalar run before the row's
// first 16-byte boundary (rows of an odd-width array start anywhere): slab 0
// takes the head, the last slab the scalar tail.  A thread keeps kUnroll
// 16-byte streaming loads (__ldcs: each byte is read once) of each operand in
// flight into kUnroll fp32 accumulators, combined in a fixed order, then a
// fixed shuffle tree and a pass over the warps.  With several slabs a second
// launch sums each row's slab sums from scratch, one warp a row, in a fixed
// order.  No atomics: the same inputs give the same bits from run to run.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // 16-byte loads of each operand in flight a thread (4 sums)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
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

// V consecutive elements of B bytes at p (16-byte aligned when V > 1), read
// once (streaming) and widened to fp32
template <int B, int V>
__device__ __forceinline__ void load(const char* p, float (&x)[V]) {
  if constexpr (B == 4 && V == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else if constexpr (B == 4) {
    x[0] = __ldcs(reinterpret_cast<const float*>(p));
  } else if constexpr (V == 8) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[2 * t] = __uint_as_float(u[t] << 16);
      x[2 * t + 1] = __uint_as_float(u[t] & 0xFFFF0000u);
    }
  } else {
    x[0] = bf16rows::widen(__ldcs(reinterpret_cast<const unsigned short*>(p)));
  }
}

template <int V>
__device__ __forceinline__ float add_sq(const float (&a)[V], const float (&b)[V], float acc) {
#pragma unroll
  for (int t = 0; t < V; ++t) acc += (a[t] - b[t]) * (a[t] - b[t]);
  return acc;
}

// first pass: block b sums slab b % n_slab of row b / n_slab into dst[b];
// elements of B bytes, V a load (16 / B when both bases share their offset
// from a 16-byte line, else 1)
template <int B, int V>
__global__ void __launch_bounds__(kThreads)
trigger_sq_slab_kernel(const char* __restrict__ w, const char* __restrict__ h,
                       float* __restrict__ dst, long long D, long long cols, int n_slab) {
  const long long row = blockIdx.x / n_slab;
  const int slab = blockIdx.x % n_slab;
  const char* wr = w + row * D * B;
  const char* hr = h + row * D * B;
  const long long head = V > 1 ? min((long long)(((16u - ((uintptr_t)wr & 15u)) & 15u) / B), D) : 0;
  const long long c0 = slab == 0 ? 0 : min(head + slab * cols, D);
  const long long c1 = slab == n_slab - 1 ? D : min(head + (slab + 1) * cols, D);
  const long long v0 = slab == 0 ? head : c0;  // the first column on a 16-byte line
  const long long nv = (c1 - v0) / V, t0 = v0 + nv * V;
  float acc[kUnroll] = {0.f, 0.f, 0.f, 0.f};
  if (threadIdx.x < (v0 - c0) + (c1 - t0)) {  // the scalar head and tail: < 16 bytes each
    const long long n = threadIdx.x < v0 - c0 ? c0 + threadIdx.x : t0 + threadIdx.x - (v0 - c0);
    float a[1], b[1];
    load<B, 1>(wr + n * B, a);
    load<B, 1>(hr + n * B, b);
    acc[0] = add_sq<1>(a, b, acc[0]);
  }
  const char* wv = wr + v0 * B;
  const char* hv = hr + v0 * B;
  for (long long q = threadIdx.x; q < nv; q += kUnroll * kThreads) {
    float a[kUnroll][V] = {}, b[kUnroll][V] = {};  // past nv: 0 - 0 adds +0
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q + u * kThreads < nv) {
        load<B, V>(wv + (q + u * kThreads) * (V * B), a[u]);
        load<B, V>(hv + (q + u * kThreads) * (V * B), b[u]);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = add_sq<V>(a[u], b[u], acc[u]);
  }
  const float s = block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (threadIdx.x == 0) dst[blockIdx.x] = s;
}

// second pass: warp r of the grid sums row r's n_slab slab sums (lane l
// takes slabs l, l + 32, ... in order, then the shuffle tree)
__global__ void __launch_bounds__(kThreads)
trigger_sq_rows_kernel(const float* __restrict__ part, float* __restrict__ out, long long m,
                       int n_slab) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= m) return;  // whole warps: no block-wide barrier follows
  float acc = 0.f;
  for (int q = threadIdx.x & 31; q < n_slab; q += 32) acc += part[row * n_slab + q];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) out[row] = acc;
}

template <int B>
int launch(const char* w, const char* h, float* out, float* part, long long m, long long D,
           long long cols, long long n_slab, void* stream) {
  if (m < 1 || D < 1 || n_slab < 1 || n_slab > INT_MAX / m || cols < 1 ||
      cols % (16 / B) != 0 || (n_slab > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned int grid = (unsigned int)(m * n_slab);
  float* dst = n_slab == 1 ? out : part;
  if ((((uintptr_t)w ^ (uintptr_t)h) & 15u) == 0)
    trigger_sq_slab_kernel<B, 16 / B><<<grid, kThreads, 0, st>>>(w, h, dst, D, cols, (int)n_slab);
  else
    trigger_sq_slab_kernel<B, 1><<<grid, kThreads, 0, st>>>(w, h, dst, D, cols, (int)n_slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_slab == 1) return (int)err;
  trigger_sq_rows_kernel<<<(unsigned int)(m / (kThreads / 32) + 1), kThreads, 0, st>>>(
      part, out, m, (int)n_slab);
  return (int)cudaGetLastError();
}

}  // namespace

// w, w_hat: (m, D) row-major, fp32 or bf16 (as 16-bit words); out: (m,) fp32;
// part: (m, n_slab) fp32 scratch, unused (may be null) when n_slab == 1; cols:
// the plan's slab width, a multiple of 16 bytes of elements.  Launch both
// passes on `stream` and return the CUDA error of the launches.
extern "C" int repro_trigger_sq_f32(const float* w, const float* w_hat, float* out, float* part,
                                    long long m, long long D, long long cols, long long n_slab,
                                    void* stream) {
  return launch<4>((const char*)w, (const char*)w_hat, out, part, m, D, cols, n_slab, stream);
}

extern "C" int repro_trigger_sq_bf16(const uint16_t* w, const uint16_t* w_hat, float* out,
                                     float* part, long long m, long long D, long long cols,
                                     long long n_slab, void* stream) {
  return launch<2>((const char*)w, (const char*)w_hat, out, part, m, D, cols, n_slab, stream);
}
