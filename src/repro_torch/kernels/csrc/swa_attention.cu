// swa_attention: sliding-window causal attention, forward only, with GQA,
//
//     out[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, g] / sqrt(dh)) v[b, t, g]
//     over t with t <= s and t > s - window, g = h / (H / G),
//
// in the model's (B, S, H, dh) / (B, S, G, dh) layout, bf16 or fp32 in,
// output in q's dtype.  Every score, the online softmax (m, l, acc) and the
// products are fp32; masked scores are -1e30 (not -inf), l is clamped at
// 1e-30 before the final division, as in the TPU kernel.
//
// Replaces the TPU kernel src/repro/kernels/swa/kernel.py:76
// (swa_attention_pallas, body _swa_fwd_kernel): there the grid is
// (B, H, q blocks, window-pruned kv blocks) and the last, sequential axis
// carries the online softmax in VMEM scratch; the k/v BlockSpec folds
// h -> h // (H/G), so KV heads are never duplicated.
//
// Bound on the H100: operations.  The work is 4 dh flops per in-window
// (query, key) pair and head: at S = 32768, window 4096, H = 48, dh = 128
// that is 125.8 M pairs, 3.09 TFLOP, 3.13 ms at the bf16 tensor-core peak
// (989 TFLOP/s), against 0.87 GB of q/k/v/out (0.26 ms at 3.35 TB/s).
//
// Design (simple and right first; the tensor cores are later work): one
// 256-thread block per (64-query tile, head, batch) walks the KV tiles of
// 64 keys that intersect its window, first to last; tiles wholly outside
// the window are never read.  Each tile is staged in shared memory as
// fp32: Q (loaded once) and K transposed, V as is.  A thread owns 4 query
// rows and 4 key columns of the 64 x 64 score tile (16 FFMA per two
// 16-byte shared loads along dh), then the same 4 rows and dh/16 output
// columns of P V.  Row max and row sum reduce over the 16 threads of a
// row with warp shuffles.  The (m, l) state sits in registers, redundant
// over those 16 threads; the P tile reuses K's shared memory.  All
// arithmetic runs on the fp32 SIMT units (67 TFLOP/s), so the kernel
// cannot come closer than ~15x to the tensor-core bound.  KV head g is
// read by all H/G heads of its group straight from its (B, S, G, dh) rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, NT = 256, LDT = BQ + 4;  // LDT: transposed row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stages rows [r0, r0 + 64) of one head of a (B, S, heads, DH) array into
// dst[d][row] (transposed, row stride LDT), zero past S.  Thread t takes
// column d = t % DH of 4 consecutive rows and writes them as one float4.
template <typename T, int DH>
__device__ __forceinline__ void stage_transposed(float* dst, const T* __restrict__ src,
                                                 long long row_stride, int r0, int S) {
  constexpr int GROUPS_PER_PASS = NT / DH;
  const int d = threadIdx.x % DH;
#pragma unroll
  for (int rg = threadIdx.x / DH; rg < BQ / 4; rg += GROUPS_PER_PASS) {
    float4 x;
    float* xs = reinterpret_cast<float*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + rg * 4 + i;
      xs[i] = r < S ? to_f32(src[(long long)r * row_stride + d]) : 0.f;
    }
    *reinterpret_cast<float4*>(&dst[d * LDT + rg * 4]) = x;
  }
}

// Stages rows [r0, r0 + 64) into dst[row][d] (row stride DH), zero past S.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           long long row_stride, int r0, int S) {
  for (int i = threadIdx.x; i < BK * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    dst[i] = r0 + r < S ? to_f32(src[(long long)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// Output column of a thread's c-th accumulator: groups of VW contiguous
// columns, the 16 threads of a row side by side, so a quarter warp reads
// 128 contiguous bytes of V.
template <int DH>
__device__ __forceinline__ int out_col(int tx, int c) {
  constexpr int VW = DH / 16 < 4 ? DH / 16 : 4;
  return (c / VW) * (16 * VW) + tx * VW + c % VW;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT, 2)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int S, int H, int G, int window) {
  constexpr int CPT = DH / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  constexpr int KT_ROWS = DH > BK ? DH : BK;
  float* Qt = smem;               // [DH][LDT]  Q tile, transposed
  float* Kt = Qt + DH * LDT;      // [DH][LDT]  K tile, transposed; P tile after
  float* Ps = Kt;                 // [BK][LDT]  P tile, transposed: Ps[key][row]
  float* Vs = Kt + KT_ROWS * LDT; // [BK][DH]   V tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const long long q_stride = (long long)H * DH, kv_stride = (long long)G * DH;
  const T* qb = q + ((long long)b * S * H + h) * DH;
  const T* kb = k + ((long long)b * S * G + g) * DH;
  const T* vb = v + ((long long)b * S * G + g) * DH;
  const float scale = sqrtf((float)DH);

  stage_transposed<T, DH>(Qt, qb, q_stride, q0, S);

  float m_run[4], l_run[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // the KV tiles that hold a key of some row's window (t > s - window)
  const int k_lo = max(0, q0 - window + 1) / BK * BK;
  const int k_hi = min(S, q0 + BQ);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's P and V are consumed
    stage_transposed<T, DH>(Kt, kb, kv_stride, k0, S);
    stage_rows<T, DH>(Vs, vb, kv_stride, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, online softmax over the 16 threads (lanes tx) of each row
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool ok = kp <= qp && kp > qp - window && kp < S;
        s[i][j] = ok ? s[i][j] / scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading Kt; P takes its place
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * LDT + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&Ps[j * LDT + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[j * DH + out_col<DH>(tx, c)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(av[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float inv_l = 1.f / fmaxf(l_run[i], 1e-30f);
    T* o = out + (((long long)b * S + qp) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) from_f32(&o[out_col<DH>(tx, c)], acc[i][c] * inv_l);
  }
}

template <typename T, int DH>
int launch(const T* q, const T* k, const T* v, T* out, long long B, long long S,
           long long H, long long G, long long window, cudaStream_t stream) {
  const size_t smem =
      (size_t)((DH + (DH > BK ? DH : BK)) * LDT + BK * DH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned int)((S + BQ - 1) / BQ), (unsigned int)H, (unsigned int)B);
  swa_kernel<T, DH><<<grid, NT, smem, stream>>>(q, k, v, out, (int)S, (int)H,
                                                (int)G, (int)window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, long long B, long long S,
             long long H, long long G, long long dh, long long window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, G, window, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, G, window, st);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, G, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, dh), k/v (B, S, G, dh), out (B, S, H, dh), all contiguous,
// dh in {32, 64, 128}, H % G == 0.  Launches on `stream`
// and returns the CUDA error code of the launch.
extern "C" int repro_swa_attention_f32(const float* q, const float* k, const float* v,
                                       float* out, long long B, long long S, long long H,
                                       long long G, long long dh, long long window,
                                       void* stream) {
  return dispatch<float>(q, k, v, out, B, S, H, G, dh, window, stream);
}

extern "C" int repro_swa_attention_bf16(const void* q, const void* k, const void* v,
                                        void* out, long long B, long long S, long long H,
                                        long long G, long long dh, long long window,
                                        void* stream) {
  using bf = __nv_bfloat16;
  return dispatch<bf>((const bf*)q, (const bf*)k, (const bf*)v, (bf*)out, B, S, H, G,
                      dh, window, stream);
}
