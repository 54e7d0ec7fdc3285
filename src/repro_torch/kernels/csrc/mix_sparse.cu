// mix_sparse: consensus mixing over the padded neighbor list (ELL),
//
//     out[i] = p_diag[i] * w[i] + sum_{s < d_max} p_off[i, s] * w[idx[i, s]]
//
// with the slots summed in order s = 0..d_max-1 in fp32.  Padded slots
// index the row itself and carry zero weight.
//
// Replaces the TPU kernel src/repro/kernels/mixing/kernel.py:74
// (mix_sparse_pallas, body _mix_sparse_kernel): there every row of one
// (m, block_n) column block is VMEM-resident and a sequential slot loop
// gathers from it, so the (m, d_max, D) gather never exists.
//
// Bound on the H100: memory.  The function needs W read once and OUT
// written once (2 m D 4 bytes) against ~2 nnz(P) D flops.  Gathered rows
// are random (RGG device ids carry no spatial order), so unless the rows a
// block needs are in L2 the real traffic approaches m d_max D 4 bytes.
//
// Design: a block covers ROWS rows and a 1024-column chunk; each of its
// 256 threads owns 4 columns 256 apart, so every gather of a neighbour row
// is coalesced along D and each thread keeps 4 independent accumulators.
// Blocks are numbered rows-fastest: the blocks in flight at any moment all
// work on the same column chunk, whose rows (m x 1024 x 4 bytes, 16 MB at
// m = 4096) stay in the 50 MB L2, so W comes from device memory about once.
// The slot loop runs in order with __fmul_rn/__fadd_rn (never contracted
// into an FMA), which is exactly the plain PyTorch version's arithmetic:
// the kernel and its plain version agree bit for bit.  Padded slots are
// read and multiplied, never skipped, so 0 * inf behaves as in the
// reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256, VEC = 4, ROWS = 4, CHUNK = NT * VEC;

__global__ void __launch_bounds__(NT)
mix_sparse_kernel(const int64_t* __restrict__ idx, const float* __restrict__ p_diag,
                  const float* __restrict__ p_off, const float* __restrict__ w,
                  float* __restrict__ out, int m, int d_max, long long D) {
  const int r0 = blockIdx.x * ROWS;
  const long long c0 = (long long)blockIdx.y * CHUNK + threadIdx.x;
  for (int r = 0; r < ROWS; ++r) {
    const int i = r0 + r;
    if (i >= m) return;
    const float* wi = w + (long long)i * D;
    const float pd = __ldg(p_diag + i);
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const long long c = c0 + q * NT;
      acc[q] = c < D ? __fmul_rn(pd, __ldg(wi + c)) : 0.f;
    }
    const int64_t* ii = idx + (long long)i * d_max;
    const float* pi = p_off + (long long)i * d_max;
    for (int s = 0; s < d_max; ++s) {
      const float p = __ldg(pi + s);
      const float* wj = w + __ldg(ii + s) * D;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const long long c = c0 + q * NT;
        if (c < D) acc[q] = __fadd_rn(acc[q], __fmul_rn(p, __ldg(wj + c)));
      }
    }
    float* oi = out + (long long)i * D;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const long long c = c0 + q * NT;
      if (c < D) oi[c] = acc[q];
    }
  }
}

}  // namespace

// idx: (m, d_max) int64, p_diag: (m,) fp32, p_off: (m, d_max) fp32,
// w and out: (m, D) fp32, all row-major.  Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int repro_mix_sparse_f32(const int64_t* idx, const float* p_diag,
                                    const float* p_off, const float* w, float* out,
                                    long long m, long long d_max, long long D,
                                    void* stream) {
  dim3 grid((unsigned int)((m + ROWS - 1) / ROWS), (unsigned int)((D + CHUNK - 1) / CHUNK));
  mix_sparse_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(idx, p_diag, p_off, w, out,
                                                           (int)m, (int)d_max, D);
  return (int)cudaGetLastError();
}
