// mix: dense consensus mixing OUT = P @ W (paper Eq. 8/10) in true fp32,
//
//     P (m, m) Metropolis transition matrix, W (m, D) flat model rows
//
// Replaces the TPU kernel src/repro/kernels/mixing/kernel.py:32
// (mix_pallas, body _mix_kernel): there P stays resident in VMEM and the
// sequential grid streams (m, block_n) column blocks of W through the MXU.
//
// Bound on the H100: operations.  2 m^2 D flops against (m^2 + 2 m D) * 4
// bytes is ~m/4 flops per byte; at m = 1024 that is far above the ridge of
// the fp32 units (67 TFLOP/s outside the tensor cores).  The product must
// stay true fp32 for parity with the reference, so the tensor cores are
// out: TF32 keeps 10 mantissa bits, and wgmma takes no fp32 operands.
//
// Design: a tiled SIMT SGEMM.  Each 256-thread block owns a 128 x 128
// output tile and walks K in steps of 8.  Per step it stages an 8 x 128
// slice of P (transposed, so a thread reads its rows as one float4) and an
// 8 x 128 slice of W in shared memory; every thread then keeps an 8 x 8
// register micro-tile and issues 64 FFMA per 4 float4 shared-memory loads.
// Global loads of W are one float per thread with neighbouring threads on
// neighbouring columns (rows of an odd-width W are not 16-byte aligned).
// The ragged edges of m and D are zero-filled on load and masked on store.
// No TF32, no mma/wgmma.  Faster designs (double buffering, cp.async,
// larger tiles) are later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, NT = 256;

__global__ void __launch_bounds__(NT)
mix_kernel(const float* __restrict__ P, const float* __restrict__ W,
           float* __restrict__ OUT, int M, long long N, int K) {
  __shared__ __align__(16) float Ps[BK][BM];  // P tile, transposed: Ps[k][row]
  __shared__ __align__(16) float Ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BN;

  // load assignment: P tile 128 rows x 8 k (4 per thread), W tile 8 k x 128
  // columns (4 per thread, 32 apart so a warp reads 32 neighbouring floats)
  const int p_row = tid / 2, p_k = (tid % 2) * 4;
  const int w_k = tid / 32, w_col = tid % 32;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int r = row0 + p_row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + p_k + i;
      Ps[p_k + i][p_row] = (r < M && k < K) ? P[(long long)r * K + k] : 0.f;
    }
    const int kw = k0 + w_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long c = col0 + w_col + 32 * i;
      Ws[w_k][w_col + 32 * i] = (kw < K && c < N) ? W[(long long)kw * N + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Ps[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Ps[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < N) OUT[(long long)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// P: (m, m), W: (m, D), OUT: (m, D), all fp32 row-major.  Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int repro_mix_f32(const float* P, const float* W, float* OUT,
                             long long m, long long D, void* stream) {
  dim3 grid((unsigned int)((D + BN - 1) / BN), (unsigned int)((m + BM - 1) / BM));
  mix_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(P, W, OUT, (int)m, D, (int)m);
  return (int)cudaGetLastError();
}
