// mix: dense consensus mixing OUT = P @ W (paper Eq. 8/10), fp32-accurate,
//
//     P (m, m) Metropolis transition matrix, W (m, D) flat model rows
//
// Replaces the TPU kernel src/repro/kernels/mixing/kernel.py:32
// (mix_pallas, body _mix_kernel): there P stays resident in VMEM and the
// sequential grid streams (m, block_n) column blocks of W through the MXU.
//
// Bound on the H100: operations.  2 m^2 D flops against (m^2 + 2 m D) * 4
// bytes is ~m/4 flops per byte, far above the ridge at m = 1024.  On the
// fp32 units (67 TFLOP/s) no kernel beats 2 m^2 D / 67e12 s.
//
// Design: split TF32 ("3xTF32") on the tensor cores.  Plain TF32 keeps 10
// mantissa bits, too few for parity.  Each operand is split, x = hi + lo
// with hi = rna_tf32(x) and lo = rna_tf32(x - hi), and each product takes
// three TF32 products with fp32 accumulators, lo*hi and hi*lo first, then
// hi*hi.  The dropped lo*lo term is ~2^-22 of each product, and lo's own
// rounding is of the same size.  The tensor cores add into their
// accumulator by truncation, not to nearest, so every k-step's three
// products (8 values of k) are summed there from zero and added to the
// fp32 result in registers, rounded to nearest.  (Summed over a whole
// 32-wide K tile instead, the truncation's bias toward zero moved a
// 30-iteration m=64 training run on the card outside the port's limits
// against the CPU.)  The result is then within a reordering of fp32 sums
// of the fp32 product.
// The work is 3 x 2 m^2 D tensor-core flops at the TF32 peak.
// Non-finite values: a split of +-inf is (inf, NaN), and a finite value
// that TF32 rounding carries past FLT_MAX splits into (inf, -inf), so
// every output such a value takes part in comes out NaN, and only those.
// The epilogue recomputes each NaN output as a plain fp32 dot product:
// there the kernel gives the fp32 product's inf, NaN or (after such an
// overflow) finite value.  This costs one compare per output on finite
// inputs and an m-long loop per NaN output otherwise.
//
// wgmma m64n128k8 (TF32): a 256-thread block (two warpgroups, 64 rows
// each) owns a 128 x 128 output tile and walks K in tiles of 32.  Tiles of
// P and W arrive raw through a 3-stage cp.async ring (8- or 4-byte copies
// where rows are not 16-byte aligned, as at D = 50890; TMA needs 16-byte
// strides).  wgmma takes TF32 B only K-major, and W's tile is [k][n]: all
// threads split it into hi and lo and write both transposed into 128-byte-
// swizzled K-major tiles (two buffers), the next tile's while the tensor
// cores work on this one's first k-step.  P's fragments (wgmma's register
// A operand) are read from the raw tile (padded so the reads hit 32
// distinct banks) and split in registers.  Ragged m and D are zero-filled
// on load and masked on store.  Blocks are numbered m-tiles-fastest: the
// blocks of one W column block run together, so W comes from device
// memory once.
// Cells: a batched run mixes C cells at once, P (C, m, m) and W (C, m, D)
// each cell's own, in one launch with the cells on blockIdx.z (slowest:
// one cell's blocks run together).  A cell's offsets are 64-bit (C m D
// passes 2^31 at 16 cells of 4096 x 50890), and its blocks do the solo
// launch's arithmetic on its slices, so each cell's output is bit-equal
// to a launch on that cell alone.
//
// bf16 rows (repro_mix_bf16): the train step's Event 3 on bf16 parameter
// leaves, as mix_pallas computes them (W in its dtype, fp32 sums, w.dtype
// out), one cell.  Bound: memory, m D 2 bytes read and written each, with
// 2 m^2 D flops far below the ridge for the few replicas of a train step
// (m = 4: 2 flops a byte).  A plain SIMT kernel: a thread owns 8 columns
// (one 16-byte load a row), reads the m source rows of them once for each
// tile of 8 output rows, and sums j = 0..m-1 in order, every product and
// sum rounded (__fmul_rn / __fadd_rn, never an FMA, so that the plain
// version in kernels/mixing/ref.py gives the same bits), then rounds to
// bf16 to nearest even.  64-bit column offsets: a leaf's rows reach
// 3.0e8 columns.  It does not use the tensor cores (a bf16 W is exact in
// TF32, so two TF32 products would do; ROADMAP Queue 2).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, NT = 256;
constexpr int LDA = BK + 4;          // raw P tile [BM][LDA] fp32: (row, k)
constexpr int RAW_A = BM * LDA * 4;  // bytes
constexpr int RAW_B = BK * BN * 4;   // raw W tile [BK][BN] fp32: (k, column)
constexpr int HL = BN * BK * 4;      // W_hi or W_lo: [BN][BK] TF32, K-major, 128B-swizzled
constexpr int SMEM_BYTES = 1024 + 4 * HL + STAGES * (RAW_A + RAW_B);

// copies V floats (4 V bytes) global -> shared; zero-fills when !valid
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(4 * V), "r"(valid ? 4 * V : 0)
               : "memory");
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// P's row r times W's column c in plain fp32, k in order, each product
// and sum rounded: the output where the split left NaN
__device__ __noinline__ float dot_fp32(const float* __restrict__ P, const float* __restrict__ W,
                                       int M, long long N, int r, long long c) {
  float s = 0.f;
  for (int k = 0; k < M; ++k)
    s = __fadd_rn(s, __fmul_rn(P[(long long)r * M + k], W[(long long)k * N + c]));
  return s;
}

// K-major 128B-swizzled operand: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

#define WGMMA_D                                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WGMMA_D_REGS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D (64 x 128, fp32) (+)= A (64 x 8, TF32 registers) * B (8 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WGMMA_D_REGS
               ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
               : WGMMA_D
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// A thread's share of the raw tiles: P rows tid / AV + i RA at k
// (tid % AV) VA, and W rows (k) tid / BV + i RB at columns (tid % BV) VB.
// Sources and destinations are set once; a tile adds k0 (P) or k0 N (W).
template <int VA, int VB>
struct Loader {
  static constexpr int AV = BK / VA, BV = BN / VB;     // copies per tile row
  static constexpr int NA = BM * AV / NT, NB = BK * BV / NT;  // copies per thread
  static constexpr int RA = NT / AV, RB = NT / BV;     // rows between them
  static_assert(BM * AV % NT == 0 && BK * BV % NT == 0, "copies split evenly");
  const float* pa;
  const float* pw;
  int da, db, ka, kb, M;
  long long N;
  uint32_t rows_ok;  // bit i: P row i lies below M
  bool cols_ok;      // the W columns lie below N

  __device__ Loader(const float* P, const float* W, int M_, long long N_, int row0,
                    long long col0, int tid)
      : M(M_), N(N_) {
    const int r = tid / AV, c = (tid % BV) * VB;
    ka = (tid % AV) * VA;
    kb = tid / BV;
    pa = P + (long long)(row0 + r) * M + ka;
    pw = W + (long long)kb * N + col0 + c;
    da = r * LDA + ka;
    db = kb * BN + c;
    rows_ok = 0;
#pragma unroll
    for (int i = 0; i < NA; ++i) rows_ok |= (row0 + r + i * RA < M ? 1u : 0u) << i;
    cols_ok = col0 + c < N;
  }

  // the tiles at k0 into As, Bs; zero where they pass M or N
  __device__ __forceinline__ void load(float* As, float* Bs, const float* P, const float* W,
                                       int k0) const {
    const bool k_ok = k0 + ka < M;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool ok = k_ok && (rows_ok >> i & 1u);
      cp_async<VA>(As + da + i * RA * LDA, ok ? pa + k0 + (long long)i * RA * M : P, ok);
    }
    const float* w0 = pw + (long long)k0 * N;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const bool ok = cols_ok && k0 + kb + i * RB < M;
      cp_async<VB>(Bs + db + i * RB * BN, ok ? w0 + (long long)i * RB * N : W, ok);
    }
  }
};

// raw W tile -> its hi and lo halves, K-major and 128B-swizzled: element
// (n, k) at byte n * 128 + ((k / 4) ^ (n % 8)) * 16 + (k % 4) * 4.  A warp
// takes 32 columns n and one 4-wide k chunk: conflict-free reads and
// 16-byte writes.
__device__ __forceinline__ void split_w(const float* Bs, uint8_t* hi, uint8_t* lo, int tid) {
#pragma unroll
  for (int i = 0; i < BN * BK / 4 / NT; ++i) {
    const int u = tid + i * NT, n = u % BN, kc = u / BN;
    uint4 h, l;
    split(Bs[(kc * 4 + 0) * BN + n], h.x, l.x);
    split(Bs[(kc * 4 + 1) * BN + n], h.y, l.y);
    split(Bs[(kc * 4 + 2) * BN + n], h.z, l.z);
    split(Bs[(kc * 4 + 3) * BN + n], h.w, l.w);
    const int off = n * 128 + ((kc ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
  // wgmma reads the tiles through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int VA, int VB>
__global__ void __launch_bounds__(NT, 1)
mix_kernel(const float* __restrict__ P, const float* __restrict__ W, float* __restrict__ OUT,
           int M, long long N) {
  // this block's cell: its slices of P, W and OUT
  const long long cell = blockIdx.z;
  P += cell * M * (long long)M;
  W += cell * M * N;
  OUT += cell * M * N;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  uint8_t* base =
      smem_raw + ((1024 - ((uint32_t)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
  auto w_hi = [&](int b) { return base + 2 * b * HL; };  // split buffer b
  auto w_lo = [&](int b) { return base + (2 * b + 1) * HL; };
  auto raw_a = [&](int s) {
    return reinterpret_cast<float*>(base + 4 * HL + s * (RAW_A + RAW_B));
  };
  auto raw_b = [&](int s) {
    return reinterpret_cast<float*>(base + 4 * HL + s * (RAW_A + RAW_B) + RAW_A);
  };

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * BM;
  const long long col0 = (long long)blockIdx.y * BN;
  const int KT = (M + BK - 1) / BK;
  const Loader<VA, VB> loader(P, W, M, N, row0, col0, tid);

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) loader.load(raw_a(s), raw_b(s), P, W, s * BK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
  __syncthreads();
  split_w(raw_b(0), w_hi(0), w_lo(0), tid);
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int b = kt % 2;
    // fetch tile kt + STAGES - 1 into the stage tile kt - 1 left
    if (kt + STAGES - 1 < KT)
      loader.load(raw_a((kt + STAGES - 1) % STAGES), raw_b((kt + STAGES - 1) % STAGES), P, W,
                  (kt + STAGES - 1) * BK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // this warp's 16 rows of P, split in registers: wgmma's A fragments
    const float* a = raw_a(kt % STAGES) + (wg * 64 + warp * 16 + g) * LDA + t;
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      split(a[kk * 8], ah[kk][0], al[kk][0]);
      split(a[8 * LDA + kk * 8], ah[kk][1], al[kk][1]);
      split(a[kk * 8 + 4], ah[kk][2], al[kk][2]);
      split(a[8 * LDA + kk * 8 + 4], ah[kk][3], al[kk][3]);
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // tile kt + 1 has landed

    // each k-step's three products for this warpgroup's 64 rows, summed
    // from zero, then into the result, rounded to nearest
    const uint32_t b_hi = (uint32_t)__cvta_generic_to_shared(w_hi(b));
    const uint32_t b_lo = (uint32_t)__cvta_generic_to_shared(w_lo(b));
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      fence_regs(part);
      wgmma_fence();
      wgmma_rs(part, al[kk], desc_k128(b_hi + kk * 32), 0);
      wgmma_rs(part, ah[kk], desc_k128(b_lo + kk * 32), 1);
      wgmma_rs(part, ah[kk], desc_k128(b_hi + kk * 32), 1);
      wgmma_commit();
      // meanwhile: split tile kt + 1 into the other buffer
      if (kk == 0 && kt + 1 < KT)
        split_w(raw_b((kt + 1) % STAGES), w_hi(1 - b), w_lo(1 - b), tid);
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    fence_regs(ah);
    fence_regs(al);
    __syncthreads();  // the split buffer is ready; the raw stage is free
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // accumulator (64 x 128 per warpgroup): rows 16 warp + g (+ 8),
  // columns 8 j + 2 t (+ 1) in acc[4 j ..]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wg * 64 + warp * 16 + g + 8 * h;
    if (r >= M) continue;
    float* orow = OUT + (long long)r * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const long long c = col0 + j * 8 + 2 * t;
      float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (c < N && isnan(x)) x = dot_fp32(P, W, M, N, r, c);
      if (c + 1 < N && isnan(y)) y = dot_fp32(P, W, M, N, r, c + 1);
      if (VB >= 2) {
        if (c < N) *reinterpret_cast<float2*>(orow + c) = float2{x, y};
      } else {
        if (c < N) orow[c] = x;
        if (c + 1 < N) orow[c + 1] = y;
      }
    }
  }
}

template <int VA, int VB>
int launch(const float* P, const float* W, float* OUT, long long cells, long long m,
           long long D, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mix_kernel<VA, VB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned int)((m + BM - 1) / BM), (unsigned int)((D + BN - 1) / BN),
            (unsigned int)cells);
  mix_kernel<VA, VB><<<grid, NT, SMEM_BYTES, stream>>>(P, W, OUT, (int)m, D);
  return (int)cudaGetLastError();
}

// the widest copy (4, 2 or 1 floats) that a row length and pointers allow
int width(long long n, uintptr_t ptrs) {
  return n % 4 == 0 && ptrs % 16 == 0 ? 4 : n % 2 == 0 && ptrs % 8 == 0 ? 2 : 1;
}

template <int VA>
int launch_b(int vb, const float* P, const float* W, float* OUT, long long cells, long long m,
             long long D, cudaStream_t s) {
  if (vb == 4) return launch<VA, 4>(P, W, OUT, cells, m, D, s);
  if (vb == 2) return launch<VA, 2>(P, W, OUT, cells, m, D, s);
  return launch<VA, 1>(P, W, OUT, cells, m, D, s);
}

}  // namespace

// P: (cells, m, m), W: (cells, m, D), OUT: (cells, m, D), all fp32
// row-major, 1 <= cells <= 65535.  Copies of P and of W are 16, 8 or 4
// bytes, the widest that m, D and the pointers' alignment allow (a cell's
// slices keep its alignment: m and D set the width).  Launches on `stream`
// and returns the CUDA error of the launch (0 on success).
extern "C" int repro_mix_f32(const float* P, const float* W, float* OUT, long long cells,
                             long long m, long long D, void* stream) {
  if (cells < 1 || cells > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int va = width(m, (uintptr_t)P);
  const int vb = width(D, (uintptr_t)W | (uintptr_t)OUT);
  if (va == 4) return launch_b<4>(vb, P, W, OUT, cells, m, D, s);
  if (va == 2) return launch_b<2>(vb, P, W, OUT, cells, m, D, s);
  return launch_b<1>(vb, P, W, OUT, cells, m, D, s);
}

namespace {

constexpr int MIXB_NT = 256, MIXB_TILE = 8;

// columns [c, c + V) of every output row; V = 8 when D % 8 == 0 and W and
// OUT are 16-byte aligned, else 1
template <int V>
__global__ void __launch_bounds__(MIXB_NT)
mix_bf16_kernel(const float* __restrict__ P, const uint16_t* __restrict__ W,
                uint16_t* __restrict__ OUT, int m, long long D) {
  const long long c = ((long long)blockIdx.x * MIXB_NT + threadIdx.x) * V;
  if (c >= D) return;
  for (int i0 = 0; i0 < m; i0 += MIXB_TILE) {
    float acc[MIXB_TILE][V];
    for (int j = 0; j < m; ++j) {
      float x[V];
      bf16rows::load<V>(W + (long long)j * D + c, x);
#pragma unroll
      for (int t = 0; t < MIXB_TILE; ++t) {
        if (i0 + t < m) {
          const float p = __ldg(P + (long long)(i0 + t) * m + j);
#pragma unroll
          for (int q = 0; q < V; ++q)
            acc[t][q] = j == 0 ? __fmul_rn(p, x[q]) : __fadd_rn(acc[t][q], __fmul_rn(p, x[q]));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < MIXB_TILE; ++t)
      if (i0 + t < m) bf16rows::store<V>(OUT + (long long)(i0 + t) * D + c, acc[t]);
  }
}

}  // namespace

// P: (m, m) fp32, W and OUT: (m, D) bf16 (as 16-bit words), row-major, one
// cell; W and OUT must not overlap.  Launches on `stream` and returns the
// CUDA error of the launch.
extern "C" int repro_mix_bf16(const float* P, const uint16_t* W, uint16_t* OUT, long long m,
                              long long D, void* stream) {
  if (m < 1 || m > 0x7fffffff || D < 1) return (int)cudaErrorInvalidValue;
  const bool vec = D % 8 == 0 && (((uintptr_t)W | (uintptr_t)OUT) & 15u) == 0;
  const int v = vec ? 8 : 1;
  const long long blocks = (D + (long long)MIXB_NT * v - 1) / ((long long)MIXB_NT * v);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (vec)
    mix_bf16_kernel<8><<<(unsigned int)blocks, MIXB_NT, 0, (cudaStream_t)stream>>>(P, W, OUT,
                                                                                  (int)m, D);
  else
    mix_bf16_kernel<1><<<(unsigned int)blocks, MIXB_NT, 0, (cudaStream_t)stream>>>(P, W, OUT,
                                                                                  (int)m, D);
  return (int)cudaGetLastError();
}
