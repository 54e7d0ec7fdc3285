// selective_scan: the selective scan of the Mamba (SSM) heads of a hybrid
// block (hymba-1.5b), over x, dt (B, S, di), b, c (B, S, n), a_log (di, n):
//
//     a[d, j]    = -exp(a_log[d, j])                               (fp32)
//     h[t, d, j] = exp(dt[t, d] a[d, j]) h[t-1, d, j] + round(dt[t, d] x[t, d]) b[t, j]
//     y[t, d]    = sum_j h[t, d, j] c[t, j]                        (j in order)
//
// per batch row, h starting at 0; round() is the input dtype's rounding of
// the product (a bf16 product is rounded to bf16 before it is widened, as the
// reference computes dt * x in the model's dtype), everything else fp32, exp
// the accurate expf.  y is (B, S, di) fp32.
//
// Replaces no TPU kernel: the reference's scan is src/repro/models/ssm.py:87,
// an XLA jax.lax.associative_scan over (B, S, di, n) fp32 tensors, not a
// Pallas kernel.  A plain PyTorch copy would hold three such tensors (6.7 GB
// each at hymba's (1, 32768, 3200, 16)), and a per-step loop costs ~7 launches
// a step; so this kernel keeps the state in registers and reads each input
// once a pass.
//
// Bound on the H100: the exps.  The function reads x and dt (B S di each)
// and b and c (B S n each) and writes y (B S di fp32): 0.25 ms at hymba's
// shape in bf16.  It takes S di n exps, 1.68e9 there: at 16 a clock per SM
// (MUFU.EX2, cc 9.0) on 132 SMs at 1.98 GHz, 0.40 ms.
//
// Design: one thread a (batch row, channel), its n <= 16 states in
// registers; a block of kThreads channels stages a tile of kTile time steps
// of x and dt (its own channels) and of b and c (read by all its channels) in
// shared memory.  One thread a channel gives only B di threads (3200 at B=1:
// 25 blocks for 132 SMs), so time is cut into n_chunks chunks of `chunk`
// steps (a host plan, kernels/scan/ops.py::chunk_plan):
//   1. selective_scan_state_kernel runs chunks 0..n_chunks-2 from a zero
//      state and writes each one's end state and decay product (fp32 scratch);
//   2. selective_scan_carry_kernel carries the states across chunks in chunk
//      order, one thread a (batch row, state, channel): the state entering
//      chunk k+1 is P_k h_in(k) + H_k, with h_in(1) = H_0;
//   3. selective_scan_out_kernel reruns every chunk from its carried state,
//      writing y.
// With one chunk only pass 3 runs.  Every sum has a fixed order and each
// product and sum is rounded as written (no contraction into FMAs), as the
// plain version rounds; no atomics, so the same inputs give the same bits
// from run to run.  A NaN (or inf) enters the carried states through the
// same products as in the plain loop, so it reaches the outputs it reaches
// there.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 128;   // channels a block
constexpr int kTile = 32;       // time steps staged a round
constexpr int kMaxState = 16;   // n
constexpr int kCarryThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elem<uint16_t> {
  static __device__ __forceinline__ float widen(uint16_t v) { return bf16rows::widen(v); }
  static __device__ __forceinline__ float round(float v) {
    return bf16rows::widen(bf16rows::narrow(v));
  }
};

// One chunk of one block of channels.  kOut: start from the carried state
// (zero for chunk 0) and write y; else start from zero, keep the decay
// product and write the end state and the product.
template <typename T, bool kOut>
__device__ __forceinline__ void scan_chunk(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ a_log, float* __restrict__ y,
    float* __restrict__ hbuf, float* __restrict__ pbuf, int64_t S, int64_t di, int n,
    int64_t chunk, int64_t n_chunks) {
  __shared__ T sx[kTile][kThreads];
  __shared__ T sdt[kTile][kThreads];
  __shared__ float sb[kTile][kMaxState];
  __shared__ float sc[kOut ? kTile : 1][kMaxState];

  const int tid = threadIdx.x;
  const int64_t d = (int64_t)blockIdx.x * kThreads + tid;
  const int64_t k = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const bool live = d < di;
  const int64_t t0 = k * chunk;
  const int64_t t1 = t0 + chunk < S ? t0 + chunk : S;
  // scratch of (B, n_chunks - 1, n, di): slot k of row bb, state j, channel d
  const int64_t slots = n_chunks - 1;

  float a[kMaxState], h[kMaxState], p[kMaxState];
#pragma unroll
  for (int j = 0; j < kMaxState; ++j) {
    a[j] = 0.f, h[j] = 0.f, p[j] = 1.f;
    if (j < n && live) {
      a[j] = -expf(Elem<T>::widen(a_log[d * n + j]));
      if (kOut && k > 0) h[j] = hbuf[((bb * slots + (k - 1)) * n + j) * di + d];
    }
  }

  for (int64_t tt0 = t0; tt0 < t1; tt0 += kTile) {
    const int steps = (int)(t1 - tt0 < kTile ? t1 - tt0 : kTile);
    __syncthreads();  // the previous tile is read
    if (live) {
      // independent loads: unrolled so that several are in flight a thread
#pragma unroll 8
      for (int s = 0; s < steps; ++s) {
        const int64_t i = (bb * S + tt0 + s) * di + d;
        sx[s][tid] = x[i];
        sdt[s][tid] = dt[i];
      }
    }
#pragma unroll 4
    for (int i = tid; i < steps * n; i += kThreads) {
      const int s = i / n, j = i - s * n;
      const int64_t src = (bb * S + tt0 + s) * n + j;
      sb[s][j] = Elem<T>::widen(bm[src]);
      if (kOut) sc[s][j] = Elem<T>::widen(cm[src]);
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < steps; ++s) {
      const float dtf = Elem<T>::widen(sdt[s][tid]);
      const float dtx = Elem<T>::round(__fmul_rn(dtf, Elem<T>::widen(sx[s][tid])));
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxState; ++j) {
        if (j < n) {
          const float decay = expf(__fmul_rn(dtf, a[j]));
          h[j] = __fadd_rn(__fmul_rn(decay, h[j]), __fmul_rn(dtx, sb[s][j]));
          if (kOut) {
            const float term = __fmul_rn(h[j], sc[s][j]);
            acc = j == 0 ? term : __fadd_rn(acc, term);
          } else {
            p[j] = __fmul_rn(p[j], decay);
          }
        }
      }
      if (kOut) y[(bb * S + tt0 + s) * di + d] = acc;
    }
  }
  if (!kOut && live) {
#pragma unroll
    for (int j = 0; j < kMaxState; ++j) {
      if (j < n) {
        const int64_t o = ((bb * slots + k) * n + j) * di + d;
        hbuf[o] = h[j];
        pbuf[o] = p[j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_state_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ a_log, float* __restrict__ hbuf, float* __restrict__ pbuf,
    int64_t S, int64_t di, int n, int64_t chunk, int64_t n_chunks) {
  scan_chunk<T, false>(x, dt, bm, nullptr, a_log, nullptr, hbuf, pbuf, S, di, n, chunk,
                       n_chunks);
}

// the states entering chunks 1..n_chunks-1, in place of the end states:
// slot k holds h_in(k + 1)
__global__ void __launch_bounds__(kCarryThreads) selective_scan_carry_kernel(
    float* __restrict__ hbuf, const float* __restrict__ pbuf, int64_t B, int64_t di,
    int n, int64_t n_chunks) {
  const int64_t e = (int64_t)blockIdx.x * kCarryThreads + threadIdx.x;
  const int64_t per_row = (int64_t)n * di;
  if (e >= B * per_row) return;
  const int64_t bb = e / per_row, jd = e - bb * per_row;
  const int64_t slots = n_chunks - 1;
  float carry = hbuf[bb * slots * per_row + jd];
#pragma unroll 4
  for (int64_t k = 1; k < slots; ++k) {
    const int64_t o = (bb * slots + k) * per_row + jd;
    carry = __fadd_rn(__fmul_rn(pbuf[o], carry), hbuf[o]);
    hbuf[o] = carry;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_out_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ a_log, float* __restrict__ y,
    const float* __restrict__ hbuf, int64_t S, int64_t di, int n, int64_t chunk,
    int64_t n_chunks) {
  scan_chunk<T, true>(x, dt, bm, cm, a_log, y, const_cast<float*>(hbuf), nullptr, S, di,
                      n, chunk, n_chunks);
}

template <typename T>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const void* a_log,
           void* y, void* scratch, int64_t B, int64_t S, int64_t di, int64_t n,
           int64_t chunk, int64_t n_chunks, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaSuccess;
  if (n < 1 || n > kMaxState || chunk < 1 || n_chunks < 1 || n_chunks > 65535 ||
      B > 65535 || (n_chunks - 1) * chunk >= S || n_chunks * chunk < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* dtp = static_cast<const T*>(dt);
  const auto* bp = static_cast<const T*>(bm);
  const auto* cp = static_cast<const T*>(cm);
  const auto* ap = static_cast<const T*>(a_log);
  float* hbuf = static_cast<float*>(scratch);
  const unsigned gx = (unsigned)((di + kThreads - 1) / kThreads);
  if (n_chunks > 1) {
    float* pbuf = hbuf + B * (n_chunks - 1) * n * di;
    selective_scan_state_kernel<T><<<dim3(gx, (unsigned)(n_chunks - 1), (unsigned)B),
                                     kThreads, 0, st>>>(xp, dtp, bp, ap, hbuf, pbuf, S, di,
                                                        (int)n, chunk, n_chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t cells = B * n * di;
    selective_scan_carry_kernel<<<(unsigned)((cells + kCarryThreads - 1) / kCarryThreads),
                                  kCarryThreads, 0, st>>>(hbuf, pbuf, B, di, (int)n,
                                                          n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  selective_scan_out_kernel<T><<<dim3(gx, (unsigned)n_chunks, (unsigned)B), kThreads, 0,
                                 st>>>(xp, dtp, bp, cp, ap, static_cast<float*>(y), hbuf, S,
                                       di, (int)n, chunk, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch: 2 B (n_chunks - 1) n di fp32 (the end states, then the decay
// products); unused with one chunk
int repro_selective_scan_f32(const void* x, const void* dt, const void* bm, const void* cm,
                             const void* a_log, void* y, void* scratch, int64_t B,
                             int64_t S, int64_t di, int64_t n, int64_t chunk,
                             int64_t n_chunks, void* stream) {
  return launch<float>(x, dt, bm, cm, a_log, y, scratch, B, S, di, n, chunk, n_chunks,
                       stream);
}

int repro_selective_scan_bf16(const void* x, const void* dt, const void* bm, const void* cm,
                              const void* a_log, void* y, void* scratch, int64_t B,
                              int64_t S, int64_t di, int64_t n, int64_t chunk,
                              int64_t n_chunks, void* stream) {
  return launch<uint16_t>(x, dt, bm, cm, a_log, y, scratch, B, S, di, n, chunk, n_chunks,
                          stream);
}

}  // extern "C"
