// swa_attention_tf32: sliding-window causal attention, forward only, with
// GQA, fp32 in and out, on the H100's tensor cores in split TF32,
//
//     out[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, g] / sqrt(dh)) v[b, t, g]
//     over t with t <= s and t > s - window, g = h / (H / G),
//
// in the model's (B, S, H, dh) / (B, S, G, dh) layout, dh in {32, 64, 128}.
// Masked scores are -1e30 (not -inf), the online softmax (m, l, acc) runs
// in fp32 registers and l is clamped at 1e-30 before the final division, as
// in the TPU kernel.
//
// Replaces the TPU kernel src/repro/kernels/swa/kernel.py:76
// (swa_attention_pallas, body _swa_fwd_kernel at :30) for fp32 inputs; bf16
// inputs take swa_attention_tc.cu.  swa_attention.cu, the earlier SIMT
// design of this path, stays in the library but no wrapper route reaches it.
//
// Bound on the H100: operations.  The work is 4 dh flops per in-window
// (query, key) pair and head: at S = 8192, window 4096, H = 48, dh = 128
// that is 1.21 G pairs, 0.62 TFLOP of fp32 products, 9.23 ms on the fp32
// units (67 TFLOP/s) and, as three TF32 products each, 3.75 ms at the TF32
// tensor-core peak (494.7 TFLOP/s), against 0.43 GB of q/k/v/out (0.13 ms).
//
// Arithmetic: split TF32 for both products, S = Q K^T (k = dh) and
// O += P V (k = keys), with the rules of mix.cu but one: each operand is
// split, x = hi + lo with hi = rna_tf32(x) and lo = x - hi (exact), which
// the tensor cores read as TF32 (13 significant bits cut to 11).  mix.cu
// rounds lo to nearest instead, which costs more instructions a value here,
// where each tile splits every Q, K, V and P value it uses; built with
// -DSWA_TF32_RNA_LO this kernel does so too.  chip_smoke.py times both
// splits and holds both against fp64: the truncated lo keeps the error
// within the gate but somewhat above the rounded one's (PERF.md has the
// numbers) and takes less time.  Each k-step
// (8 values of k) takes three TF32 products, lo*hi, hi*lo, hi*hi (lo*lo is
// dropped), summed from zero in the tensor cores, whose adds truncate, and
// the k-step's sum is added to the fp32 result in registers, rounded to
// nearest.
//
// Design.  One 256-thread block per (128-query tile, head, batch): two
// warpgroups of 64 query rows each, walking the KV tiles of 64 keys that
// intersect the block's window, first to last.  Both products are wgmma
// m64nNk8 with A in registers and B K-major in 128B-swizzled shared memory
// (TF32 wgmma takes K-major operands only):
// - Q is staged once, raw; each k-step reads its A fragment from there (one
//   8-byte word a row) and splits it in registers.
// - K's (keys, dh) rows are K-major for Q K^T; V's are not, so the threads
//   write V transposed (dh rows of keys) while they split it.
// - P is the accumulator fragment of S, whose thread holds keys 2t, 2t+1 of
//   each 8-key group where wgmma's TF32 A fragment wants keys t, t+4; so
//   V^T's keys are permuted within each group of 8 (key 2i at i, 2i+1 at
//   i + 4): the k-step sums the same products in another order.
// - Shared memory holds one stage of K (hi, lo) and one of V^T (hi, lo):
//   at dh = 128, 2 x 64 KB beside 66 KB of Q and 32 KB of raw slots, all
//   227 KB a block may use.  So a tile runs in two phases, each closed by a
//   barrier: while the tensor cores compute S = Q K^T on the K stage, every
//   thread splits its share of the tile's V into the V stage; while they
//   compute O += P V on the V stage, it splits its share of the next tile's
//   K into the K stage.  Each thread copies (cp.async) the raw values it
//   splits into slots of its own, so the raw K and V of a tile share one
//   buffer and need no barrier of their own; the copies start half a tile
//   ahead.
// - Each k-step's three products go into one of two partial accumulators
//   (64 x 32 key halves for S, 64 x 64 column halves for O at dh = 128)
//   while the other is added into the result, so the tensor cores need not
//   drain between k-steps.
// - The epilogue divides by l and stores rows within S.  Rows past S in a
//   K/V tile are zero-filled on copy and masked.
// A tile takes ~13,600 SM cycles per warpgroup, of which the splits and
// copies take ~30% (PERF.md has the cycle profile of a -DSWA_TF32_PROFILE
// build): the same warps issue them between their wgmma groups.
//
// Non-finite inputs: a NaN or +-inf split leaves lo NaN, and a finite value
// that TF32 rounding carries past FLT_MAX splits into (inf, -inf), so every
// output such a value takes part in comes out NaN.  The epilogue recomputes
// each NaN output in plain fp32 over its row's window: there the kernel
// gives the fp32 softmax's inf, NaN or finite value (a -inf score drops its
// key, as in the plain version).  This costs one compare per output on
// finite inputs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128, BK = 64, NT = 256;  // query rows, keys per tile, threads
constexpr float NEG_INF = -1e30f;

// Shared memory of one block, in bytes from a 1024-aligned base: the K stage
// [K_hi, K_lo], the V stage [Vt_hi, Vt_lo], Q, and every thread's raw
// slots.  K_hi / K_lo: DH / 32 boxes of BK key rows x 128 bytes (32 dh
// values); Vt_hi / Vt_lo: BK / 32 boxes of DH rows x 128 bytes (32 keys).
// Element (row n, k) of a box sits at n * 128 + ((k / 4) ^ (n % 8)) * 16 +
// (k % 4) * 4: the 128-byte swizzle.  Q: rows of QS floats (4 of padding: a
// fragment's 8 rows x 4 columns fall in 32 banks), each 8-column group in
// the order 0 4 1 5 2 6 3 7, so that a thread's A-fragment pair (column c,
// c + 4) is one 8-byte word.  Raw slots: unit u of thread t at
// (u * NT + t) * 16 bytes, holding the 4 raw K or V values the thread copies
// and later splits.  At dh = 128 the block takes 232,448 bytes, all a block
// may have.
template <int DH>
struct Smem {
  static constexpr int TILE = BK * DH * 4;  // one of K_hi, K_lo, Vt_hi, Vt_lo; the raw slots
  static constexpr int KBOX = BK * 128, VBOX = DH * 128;
  static constexpr int KHI = 0, KLO = TILE, VHI = 2 * TILE, VLO = 3 * TILE;
  static constexpr int QS = DH + 4, Q = 4 * TILE, RAW = Q + BQ * QS * 4;
  static constexpr size_t BYTES = 1024 + RAW + TILE;
  // units a thread splits a tile, of K (16-byte chunks) and of V (4 keys of
  // a V^T row each)
  static constexpr int UNITS = BK * DH / 4 / NT;
  static_assert(UNITS * NT * 4 == BK * DH && UNITS >= 2, "units split evenly");
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies 16 (4) bytes global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32, to nearest with ties away from zero, as PTX's
// cvt.rna.tf32.f32 rounds it (sm_90 has no instruction for it: ptxas
// expands it into five), for every finite x and +-inf
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi = rna_tf32(x), lo = x - hi exactly (13 significant bits
// at most), which the tensor cores read as TF32, dropping its last 2 (with
// -DSWA_TF32_RNA_LO, lo rounded to nearest by cvt.rna.tf32.f32, as mix.cu
// splits).  A NaN or +-inf x has a NaN lo, and a finite value that rounds
// past FLT_MAX an infinite one, so every product they take part in is NaN
// or infinite.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
#ifdef SWA_TF32_RNA_LO
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
#else
  lo = __float_as_uint(x - __uint_as_float(hi));
#endif
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D (64 x 32, fp32) (+)= A (64 x 8, TF32 registers) * B (8 x 32, smem, K-major)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (64 x 64, fp32) (+)= A (64 x 8, TF32 registers) * B (8 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#ifdef SWA_TF32_PROFILE
// Profile build (nvcc -DSWA_TF32_PROFILE): thread 0 of every warpgroup adds
// the SM clock cycles it spends in each phase of the tile loop to g_prof,
// which repro_swa_tf32_profile reads back and clears.
enum Phase {
  BARRIER, S_ISSUE, SPLIT, S_WAIT, SOFTMAX, PV_ISSUE, PV_WAIT, COPY, EPILOGUE, N_PHASES
};
__device__ unsigned long long g_prof[N_PHASES + 2];  // + tiles, warpgroups
#define PROF(i)                      \
  do {                               \
    const long long t_ = clock64();  \
    prof[i] += t_ - prof_t;          \
    prof_t = t_;                     \
  } while (0)
#else
#define PROF(i) \
  do {          \
  } while (0)
#endif

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  if constexpr (N == 32) wgmma_n32(d, a, b, accumulate);
  else wgmma_n64(d, a, b, accumulate);
}

// A thread's unit u: the 16 bytes of key n's row at dh 4c .. 4c + 3, of K
// (a warp's lanes along the row: key n = n0 + u * KROWS) or of V (a warp's
// lanes on 16 keys x 2 adjacent chunks, so that its copy reads 32-byte
// sectors and its 4-byte stores into two V^T rows fall in 32 banks: warp
// unit wu = warp + 8u takes chunk pair wu % (DH / 8) of 16-key block
// wu / (DH / 8)).  Each address is a per-thread base plus a step that the
// unit's number fixes, so a thread's units need few registers.
template <int DH>
struct Units {
  using L = Smem<DH>;
  static constexpr int KROWS = NT / (DH / 4);  // key rows a K unit step spans
  static constexpr int CP = DH / 8;            // chunk pairs of a key row
  uint32_t raw;         // this thread's raw slot 0
  uint32_t k_st;        // K_hi byte of unit 0
  uint32_t v_st[2][4];  // Vt_hi byte of V^T row 4 cc + i (pair 0), a key of an even / odd block
  int k_n0, k_c0, v_w, v_jj, v_cc;

  __device__ Units(int tid) {
    raw = L::RAW + tid * 16;
    k_n0 = tid / (DH / 4);
    k_c0 = tid % (DH / 4);
    k_st = L::KHI + (k_c0 / 8) * L::KBOX + k_n0 * 128 + (((k_c0 % 8) ^ (k_n0 % 8)) << 4);
    v_w = tid / 32 % 8;  // < 8: the unit's block and pair fold at compile time
    v_jj = tid % 32 / 2;
    v_cc = tid % 2;
    // key jj of a 16-key block sits at V^T column 16 (block % 2) + p
    const int p = 8 * (v_jj / 8) + (v_jj % 2) * 4 + v_jj % 8 / 2;
#pragma unroll
    for (int odd = 0; odd < 2; ++odd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = 16 * odd + p, row = 4 * v_cc + i;  // + 8 cp rows, a multiple of 8
        v_st[odd][i] = L::VHI + row * 128 + (((kp / 4) ^ row) << 4) + (kp % 4) * 4;
      }
  }
  // V unit u's 16-key block and chunk pair
  __device__ __forceinline__ int v_block(int u) const { return v_w / CP + 8 * u / CP; }
  __device__ __forceinline__ int v_pair(int u) const { return v_w % CP + 8 * u % CP; }

  // Starts the copies of this thread's raw K (or V) units of the tile at
  // key k0 into its slots; keys past S are zero-filled.
  template <bool IS_V>
  __device__ __forceinline__ void load(uint8_t* base, const float* src, long long stride,
                                       int k0, int S) const {
#pragma unroll
    for (int u = 0; u < L::UNITS; ++u) {
      const int t = IS_V ? k0 + 16 * v_block(u) + v_jj : k0 + k_n0 + u * KROWS;
      const int col = 4 * (IS_V ? 2 * v_pair(u) + v_cc : k_c0);
      cp_async16(base + raw + u * NT * 16, t < S ? src + t * stride + col : src, t < S);
    }
    cp_async_commit();
  }

  __device__ __forceinline__ float4 read(const uint8_t* base, int u) const {
    return *reinterpret_cast<const float4*>(base + raw + u * NT * 16);
  }

  // Splits unit u (from read) into the hi / lo tiles: into K as it is
  // (K-major already), or transposed into V^T, whose keys are permuted
  // within each group of 8 (key 2m at m, 2m + 1 at m + 4).
  template <bool IS_V>
  __device__ __forceinline__ void store(uint8_t* base, int u, float4 r) const {
    uint4 hi, lo;
    split(r.x, hi.x, lo.x);
    split(r.y, hi.y, lo.y);
    split(r.z, hi.z, lo.z);
    split(r.w, hi.w, lo.w);
    if (IS_V) {
      const int blk = v_block(u);
      uint8_t* p = base + (blk / 2) * L::VBOX + 8 * v_pair(u) * 128;
      const uint32_t h4[4] = {hi.x, hi.y, hi.z, hi.w}, l4[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t off = blk % 2 ? v_st[1][i] : v_st[0][i];
        *reinterpret_cast<uint32_t*>(p + off) = h4[i];
        *reinterpret_cast<uint32_t*>(p + off + L::TILE) = l4[i];  // Vt_lo follows
      }
    } else {
      uint8_t* p = base + k_st + u * KROWS * 128;
      *reinterpret_cast<uint4*>(p) = hi;
      *reinterpret_cast<uint4*>(p + L::TILE) = lo;  // K_lo follows
    }
  }
};

// out[b, s, h, col] in plain fp32 over the row's window, keys in order:
// the value of an output the split left NaN
template <int DH>
__device__ __forceinline__ float attend_fp32(const float* q, const float* kg, const float* vg,
                                             long long stride, int s, int col, int window) {
  const float scale = 1.f / sqrtf((float)DH);
  const int t0 = max(0, s - window + 1);
  float m = -INFINITY;
  for (int t = t0; t <= s; ++t) {
    float dot = 0.f;
    for (int d = 0; d < DH; ++d) dot = fmaf(q[d], kg[t * stride + d], dot);
    m = fmaxf(m, dot * scale);
  }
  float l = 0.f, o = 0.f;
  for (int t = t0; t <= s; ++t) {
    float dot = 0.f;
    for (int d = 0; d < DH; ++d) dot = fmaf(q[d], kg[t * stride + d], dot);
    const float p = expf(dot * scale - m);
    l += p;
    o = fmaf(p, vg[t * stride + col], o);
  }
  return o / fmaxf(l, 1e-30f);
}

template <int DH>
__global__ void __launch_bounds__(NT, 1)
swa_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int S, int H, int G,
                int window, float scale_log2) {
  using L = Smem<DH>;
  constexpr int KS = DH / 8, SU = 2 * KS;        // k-steps of S = Q K^T, units a tile
  constexpr int NW = DH < 64 ? DH : 64;          // O columns per partial product
  constexpr int NH = DH / NW, PU = BK / 8 * NH;  // column parts, P V units a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const float* Qs = reinterpret_cast<const float*>(base + L::Q);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  // the KV tiles that hold a key of some row's window (t > s - window)
  const int k_lo = max(0, q0 - window + 1) / BK * BK;
  const int n_tiles = (min(S, q0 + BQ) - k_lo + BK - 1) / BK;
  const long long row0 = (long long)b * S, stride = (long long)G * DH;
  const float* kg = k + row0 * stride + g * DH;  // key t of this head's group: kg + t * stride
  const float* vg = v + row0 * stride + g * DH;

  // Q rows q0 .. q0 + 127, column c of row r at r * QS + 8 (c / 8) +
  // 2 (c % 4) + (c % 8) / 4
#pragma unroll 8
  for (int i = 0; i < BQ * DH / NT; ++i) {
    const int x = tid + i * NT, r = x / DH, c = x % DH;
    const bool ok = q0 + r < S;
    cp_async4(base + L::Q + (r * L::QS + (c & ~7) + 2 * (c % 4) + (c % 8) / 4) * 4,
              ok ? q + ((row0 + q0 + r) * H + h) * DH + c : q, ok);
  }
  const Units<DH> un(tid);
  un.template load<false>(base, kg, stride, k_lo, S);
  cp_async_wait_all();
#pragma unroll
  for (int u = 0; u < L::UNITS; ++u) un.template store<false>(base, u, un.read(base, u));
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // wgmma reads the tiles
  un.template load<true>(base, vg, stride, k_lo, S);

  // a thread holds rows ra and rb = ra + 8 of its warp's 16, and in every
  // 8-column chunk c of a fragment the columns 8c + 2tq and 8c + 2tq + 1
  const int ra = wg * 64 + warp * 16 + gq, rb = ra + 8;
  const int qa = q0 + ra, qb = q0 + rb;
  const int wg_lo = q0 + wg * 64, wg_hi = wg_lo + 63;
  const uint32_t khi_s = smem_u32(base + L::KHI), klo_s = smem_u32(base + L::KLO);
  const uint32_t vhi_s = smem_u32(base + L::VHI), vlo_s = smem_u32(base + L::VLO);
  // A fragment of S's k-step kk: rows ra, rb, columns 8kk + tq and + 4, one
  // 8-byte word a row
  const float* qf = Qs + ra * L::QS + 2 * tq;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // m in log2 units
#ifdef SWA_TF32_PROFILE
  long long prof[N_PHASES] = {}, prof_t = clock64();
#endif

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();  // this thread's raw V of tile j
    __syncthreads();      // the K stage holds tile j; the V stage is free
    PROF(BARRIER);
    const int k0 = k_lo + j * BK;
    const bool more = j + 1 < n_tiles;

    // S = Q K^T (64 x 64 per warpgroup): unit u = (k-step kk, 32-key half
    // sh), each unit's three products into one of two partials; meanwhile
    // this thread splits its V units of tile j into the V stage, then starts
    // the copy of its K units of tile j + 1.  Q's fragment (split once a
    // k-step, for both halves) and the next raw unit are read a k-step ahead.
    float sc[BK / 2], sp[2][16];
    uint32_t qh[2][4], ql[2][4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    float2 fa = *reinterpret_cast<const float2*>(qf);
    float2 fb = *reinterpret_cast<const float2*>(qf + 8 * L::QS);
    float4 unit = un.read(base, 0);
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int kk = u / 2, sh = u % 2;
      if (sh == 0) {
        split(fa.x, qh[kk % 2][0], ql[kk % 2][0]);
        split(fb.x, qh[kk % 2][1], ql[kk % 2][1]);
        split(fa.y, qh[kk % 2][2], ql[kk % 2][2]);
        split(fb.y, qh[kk % 2][3], ql[kk % 2][3]);
        if (kk + 1 < KS) {
          fa = *reinterpret_cast<const float2*>(qf + 8 * (kk + 1));
          fb = *reinterpret_cast<const float2*>(qf + 8 * L::QS + 8 * (kk + 1));
        }
      }
      const uint32_t koff = (kk / 4) * L::KBOX + sh * 32 * 128 + (kk % 4) * 32;
      fence_regs(sp[u % 2]);
      wgmma_fence();
      wgmma_n32(sp[u % 2], ql[kk % 2], desc_k128(khi_s + koff), 0);
      wgmma_n32(sp[u % 2], qh[kk % 2], desc_k128(klo_s + koff), 1);
      wgmma_n32(sp[u % 2], qh[kk % 2], desc_k128(khi_s + koff), 1);
      wgmma_commit();
      PROF(S_ISSUE);
      if (sh == 1 && kk < L::UNITS) {
        un.template store<true>(base, kk, unit);
        PROF(SPLIT);
        if (kk + 1 < L::UNITS) unit = un.read(base, kk + 1);
        else if (more) un.template load<false>(base, kg, stride, k0 + BK, S);
        PROF(COPY);
      }
      if (u > 0) {
        const int pk = (u - 1) / 2, ps = (u - 1) % 2;
        wgmma_wait<1>();
        PROF(S_WAIT);
        fence_regs(sp[(u - 1) % 2]);
        fence_regs(qh[pk % 2]);
        fence_regs(ql[pk % 2]);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          sc[16 * ps + i] = __fadd_rn(sc[16 * ps + i], sp[(u - 1) % 2][i]);
      }
    }
    wgmma_wait<0>();
    PROF(S_WAIT);
    fence_regs(sp[(SU - 1) % 2]);
    fence_regs(qh[(KS - 1) % 2]);
    fence_regs(ql[(KS - 1) % 2]);
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[16 + i] = __fadd_rn(sc[16 + i], sp[(SU - 1) % 2][i]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // the V stage holds tile j; the K stage is free
    PROF(BARRIER);

    // mask only a tile that crosses the diagonal, the window's far edge or
    // S for some row of this warpgroup, scaling it into log2 units there;
    // an inside tile stays raw and takes the scale f in the exponent's fma
    const bool inside = k0 + BK - 1 <= wg_lo && k0 > wg_hi - window && k0 + BK <= S;
    const float f = inside ? scale_log2 : 1.f;
    if (!inside) {
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * c + 2 * tq + e;
          const bool ka = kp <= qa && kp > qa - window && kp < S;
          const bool kb = kp <= qb && kp > qb - window && kp < S;
          sc[4 * c + e] = ka ? sc[4 * c + e] * scale_log2 : NEG_INF;
          sc[4 * c + 2 + e] = kb ? sc[4 * c + 2 + e] * scale_log2 : NEG_INF;
        }
      }
    }

    // online softmax: row max over the quad of threads that share a row
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    mx_a = fmaxf(m_a, mx_a * f);
    mx_b = fmaxf(m_b, mx_b * f);
    const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      sc[4 * c] = exp2f(fmaf(sc[4 * c], f, -m_a));
      sc[4 * c + 1] = exp2f(fmaf(sc[4 * c + 1], f, -m_a));
      sc[4 * c + 2] = exp2f(fmaf(sc[4 * c + 2], f, -m_b));
      sc[4 * c + 3] = exp2f(fmaf(sc[4 * c + 3], f, -m_b));
      sum_a += sc[4 * c] + sc[4 * c + 1];
      sum_b += sc[4 * c + 2] + sc[4 * c + 3];
    }
    // l stays a per-thread partial sum (alpha is the same over the quad);
    // the quad's partials are added once, in the epilogue
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      o[4 * c] *= alpha_a;
      o[4 * c + 1] *= alpha_a;
      o[4 * c + 2] *= alpha_b;
      o[4 * c + 3] *= alpha_b;
    }
    if (more) {
      cp_async_wait_all();  // this thread's raw K of tile j + 1
      unit = un.read(base, 0);
    }
    PROF(SOFTMAX);

    // O += P V: unit u = (8-key k-step kk, column part nh); P's fragment for
    // keys 8kk .. 8kk + 7 is (row, key 2tq), (row + 8, 2tq), (row, 2tq + 1),
    // (row + 8, 2tq + 1): wgmma's (row, k = tq), (row + 8, tq), (row,
    // tq + 4), (row + 8, tq + 4) under V^T's key permutation.  Meanwhile
    // this thread splits its K units of tile j + 1 into the K stage, then
    // starts the copy of its V units of tile j + 1.
    float op[2][NW / 2];
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int kk = u / NH, nh = u % NH;
      if (nh == 0) {
        split(sc[4 * kk], ph[kk % 2][0], pl[kk % 2][0]);
        split(sc[4 * kk + 2], ph[kk % 2][1], pl[kk % 2][1]);
        split(sc[4 * kk + 1], ph[kk % 2][2], pl[kk % 2][2]);
        split(sc[4 * kk + 3], ph[kk % 2][3], pl[kk % 2][3]);
      }
      const uint32_t voff = (kk / 4) * L::VBOX + nh * NW * 128 + (kk % 4) * 32;
      fence_regs(op[u % 2]);
      wgmma_fence();
      wgmma_tf32<NW>(op[u % 2], pl[kk % 2], desc_k128(vhi_s + voff), 0);
      wgmma_tf32<NW>(op[u % 2], ph[kk % 2], desc_k128(vlo_s + voff), 1);
      wgmma_tf32<NW>(op[u % 2], ph[kk % 2], desc_k128(vhi_s + voff), 1);
      wgmma_commit();
      PROF(PV_ISSUE);
      if (more && u < L::UNITS) {
        un.template store<false>(base, u, unit);
        PROF(SPLIT);
        if (u + 1 < L::UNITS) unit = un.read(base, u + 1);
        else un.template load<true>(base, vg, stride, k0 + BK, S);
        PROF(COPY);
      }
      if (u > 0) {
        const int pk = (u - 1) / NH, pn = (u - 1) % NH;
        wgmma_wait<1>();
        PROF(PV_WAIT);
        fence_regs(op[(u - 1) % 2]);
        fence_regs(ph[pk % 2]);
        fence_regs(pl[pk % 2]);
#pragma unroll
        for (int i = 0; i < NW / 2; ++i)
          o[pn * (NW / 2) + i] = __fadd_rn(o[pn * (NW / 2) + i], op[(u - 1) % 2][i]);
      }
    }
    wgmma_wait<0>();
    PROF(PV_WAIT);
    fence_regs(op[(PU - 1) % 2]);
    fence_regs(ph[((PU - 1) / NH) % 2]);
    fence_regs(pl[((PU - 1) / NH) % 2]);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i)
      o[(NH - 1) * (NW / 2) + i] = __fadd_rn(o[(NH - 1) * (NW / 2) + i], op[(PU - 1) % 2][i]);
    if (more) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    PROF(PV_ISSUE);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  float* out_a = out + ((row0 + qa) * H + h) * DH + 2 * tq;
  float* out_b = out_a + 8LL * H * DH;
  bool nan = false;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const float2 ya = make_float2(o[4 * c] * inv_a, o[4 * c + 1] * inv_a);
    const float2 yb = make_float2(o[4 * c + 2] * inv_b, o[4 * c + 3] * inv_b);
    if (qa < S) *reinterpret_cast<float2*>(out_a + 8 * c) = ya;
    if (qb < S) *reinterpret_cast<float2*>(out_b + 8 * c) = yb;
    nan = nan || (qa < S && (isnan(ya.x) || isnan(ya.y))) ||
          (qb < S && (isnan(yb.x) || isnan(yb.y)));
  }
  if (nan) {  // recompute this thread's NaN outputs in plain fp32
#pragma unroll 1
    for (int i = 0; i < DH / 2; ++i) {
      const int s = i < DH / 4 ? qa : qb, col = 8 * (i % (DH / 4) / 2) + 2 * tq + i % 2;
      float* y = out + ((row0 + s) * H + h) * DH + col;
      if (s < S && isnan(*y))
        *y = attend_fp32<DH>(q + ((row0 + s) * H + h) * DH, kg, vg, stride, s, col, window);
    }
  }
#ifdef SWA_TF32_PROFILE
  PROF(EPILOGUE);
  if (threadIdx.x % 128 == 0) {
    for (int i = 0; i < N_PHASES; ++i) atomicAdd(&g_prof[i], (unsigned long long)prof[i]);
    atomicAdd(&g_prof[N_PHASES], (unsigned long long)n_tiles);
    atomicAdd(&g_prof[N_PHASES + 1], 1ull);
  }
#endif
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* out, long long B, long long S,
           long long H, long long G, long long window, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(swa_tf32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<DH>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)DH));
  dim3 grid((unsigned int)((S + BQ - 1) / BQ), (unsigned int)H, (unsigned int)B);
  // a window past S attends to every earlier key, as a window of S does
  const int win = (int)(window < S ? window : S);
  swa_tf32_kernel<DH><<<grid, NT, Smem<DH>::BYTES, stream>>>(q, k, v, out, (int)S, (int)H,
                                                             (int)G, win, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, dh), k/v (B, S, G, dh), out (B, S, H, dh), all fp32,
// contiguous, q and k 16-byte aligned, dh in {32, 64, 128}, H % G == 0.
// Launches on `stream` and returns the CUDA error code of the launch.
extern "C" int repro_swa_attention_tf32_f32(const float* q, const float* k, const float* v,
                                            float* out, long long B, long long S, long long H,
                                            long long G, long long dh, long long window,
                                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 32: return launch<32>(q, k, v, out, B, S, H, G, window, st);
    case 64: return launch<64>(q, k, v, out, B, S, H, G, window, st);
    case 128: return launch<128>(q, k, v, out, B, S, H, G, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef SWA_TF32_PROFILE
// Copies the profile counters (cycles per phase in the order of Phase, then
// tiles and warpgroups) into host[0 .. N_PHASES + 2) and clears them.
extern "C" int repro_swa_tf32_profile(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[N_PHASES + 2] = {};
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif
