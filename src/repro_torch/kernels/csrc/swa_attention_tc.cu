// swa_attention_tc: sliding-window causal attention, forward only, with GQA,
// on the H100's tensor cores, bf16 in and out,
//
//     out[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, g] / sqrt(dh)) v[b, t, g]
//     over t with t <= s and t > s - window, g = h / (H / G),
//
// in the model's (B, S, H, dh) / (B, S, G, dh) layout, dh in {32, 64, 128}.
// The scores, the online softmax (m, l, acc) and both products accumulate in
// fp32; masked scores are -1e30 (not -inf), l is summed from the fp32 P and
// clamped at 1e-30 before the final division, as in the TPU kernel.  The one
// numerical change: P enters P V rounded to bf16 (the TPU kernel's
// jnp.dot(p, v) also feeds the MXU bf16 passes at JAX's default precision).
//
// Replaces the TPU kernel src/repro/kernels/swa/kernel.py:76
// (swa_attention_pallas, body _swa_fwd_kernel at :30) for bf16 inputs; fp32
// inputs take the split-TF32 kernel of swa_attention_tf32.cu.
//
// Bound on the H100: operations.  The work is 4 dh flops per in-window
// (query, key) pair and head: at S = 32768, window 4096, H = 48, dh = 128
// that is 125.8 M pairs, 3.09 TFLOP, 3.13 ms at the bf16 tensor-core peak
// (989 TFLOP/s), against 0.87 GB of q/k/v/out (0.26 ms at 3.35 TB/s).  Only
// the tensor cores (wgmma) come near the operations bound, and they must
// not wait for the copies.
//
// Design.  One block per (128-query tile, head, batch): two consumer
// warpgroups of 64 query rows each and one producer warp.  The producer's
// lane 0 loads the Q tile once and then the K and V tiles of 128 keys that
// intersect the block's window, first to last, with TMA into a ring of two
// stages of 128B-swizzled shared memory (64B-swizzled at dh = 32), each with
// its own "full" mbarrier for K and for V and an "empty" one that the eight
// consumer warps release; it reads the (B*S, H*dh) / (B*S, G*dh) rows of the
// model layout through 2-D tensor maps, so KV head g is read in place by all
// H/G heads of its group.  Each consumer warpgroup computes S = Q K^T with
// wgmma m64n128k16 (both operands in shared memory, K-major), masks only
// the tiles that cross the causal diagonal, the window's far edge or S,
// runs the online softmax on the fp32 accumulator fragment (exp2 with the
// scale folded into log2(e); the row max and the row sum over the four
// threads of a row), rounds P to bf16 in registers, where it already has
// the layout of wgmma's A operand, and accumulates O += P V with wgmma
// m64n{dh}k16 (V in shared memory, MN-major through the transpose bit).
// While the consumers work on one stage, the producer fills the other.  The
// epilogue divides by l and stores bf16 rows within S.  Rows past S in a
// K/V tile (the next batch's rows, or TMA's zero fill past B*S) are masked.
// This reaches about half the bound: the two warpgroups run their softmax at
// the same time, on the same stage, while the tensor cores wait (PERF.md has
// the cycle profile of a -DSWA_TC_PROFILE build); ping-pong scheduling of the
// warpgroups is the next step.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// taken from the CUDA driver through cudaGetDriverEntryPoint(ByVersion), so
// the library links against the CUDA runtime alone (no -lcuda).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128, BK = 128;         // query rows per block, keys per tile
constexpr int CONSUMERS = 2;              // warpgroups of 64 query rows
constexpr int NT = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int STAGES = 2;                 // K/V ring depth
constexpr float NEG_INF = -1e30f;

// Shared-memory tile geometry: a tile of 128 rows x DH bf16 is stored as
// DH / ATOM boxes of 128 rows x ATOM columns, one swizzle row per tile row.
template <int DH>
struct Tile {
  static constexpr int ATOM = DH < 64 ? DH : 64;
  static constexpr int ROW_BYTES = ATOM * 2;          // 128 (64 at dh = 32)
  static constexpr int BOXES = DH / ATOM;
  static constexpr int BOX_BYTES = 128 * ROW_BYTES;
  static constexpr int BYTES = BOXES * BOX_BYTES;
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // 128B / 64B swizzle
  static constexpr size_t SMEM = (size_t)BYTES * (1 + 2 * STAGES) + 1024 + 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A wait
// that cannot complete (a fault in the pipeline) traps after ~2^28 polls, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// TMA: the box at (column c0, row c1) of a 2-D tensor map into shared
// memory, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(bar), "r"(c0), "r"(c1) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode.
template <int DH>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (Tile<DH>::LAYOUT << 62);
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

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#ifdef SWA_TC_PROFILE
// Profile build (nvcc -DSWA_TC_PROFILE, see chip_smoke.py): thread 0 of every
// consumer warpgroup adds the SM clock cycles it spends in each phase of the
// tile loop to g_prof, which repro_swa_tc_profile reads back and clears.
enum Phase { WAIT_Q, WAIT_K, S_GEMM, SOFTMAX, WAIT_V, PV_GEMM, EPILOGUE, N_PHASES };
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) * B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 registers) * B (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DH == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (DH == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

template <int DH>
__global__ void __launch_bounds__(NT, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out, int S, int H,
              int G, int window, float scale_log2) {
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + T::BYTES, sV = sK + STAGES * T::BYTES;
  const uint32_t bars = sV + STAGES * T::BYTES;  // q_full, k_full[], v_full[], empty[]
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  // the KV tiles that hold a key of some row's window (t > s - window)
  const int k_lo = max(0, q0 - window + 1) / BK * BK;
  const int n_tiles = (min(S, q0 + BQ) - k_lo + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {  // the producer warp
    if (lane == 0) {
      const int row0 = b * S;
      mbar_expect_tx(q_full, T::BYTES);
#pragma unroll
      for (int x = 0; x < T::BOXES; ++x)
        tma_load(sQ + x * T::BOX_BYTES, &tm_q, q_full, h * DH + x * T::ATOM, row0 + q0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);  // the first round passes
        const int row = row0 + k_lo + j * BK;
        mbar_expect_tx(k_full(s), T::BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(sK + s * T::BYTES + x * T::BOX_BYTES, &tm_k, k_full(s), g * DH + x * T::ATOM,
                   row);
        mbar_expect_tx(v_full(s), T::BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(sV + s * T::BYTES + x * T::BOX_BYTES, &tm_v, v_full(s), g * DH + x * T::ATOM,
                   row);
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64); a
  // thread holds rows qa and qb = qa + 8 of its warp's 16, and in every
  // 8-column chunk c of a fragment the columns 8c + cq and 8c + cq + 1
  const int wg = warp / 4;
  const int qa = q0 + wg * 64 + (warp % 4) * 16 + lane / 4, qb = qa + 8;
  const int cq = 2 * (lane % 4);
  const int wg_lo = q0 + wg * 64, wg_hi = wg_lo + 63;
  const uint32_t q_slab = sQ + wg * 64 * T::ROW_BYTES;

  float o[DH / 2], sc[64];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // m in log2 units
#ifdef SWA_TC_PROFILE
  long long prof[N_PHASES] = {}, prof_t = clock64();
#endif

  mbar_wait(q_full, 0);
  PROF(WAIT_Q);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int k0 = k_lo + j * BK;

    // S = Q K^T: 64 x 128 per warpgroup, K-major operands, dh in steps of 16
    mbar_wait(k_full(s), parity);
    PROF(WAIT_K);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk * 16 / T::ATOM) * T::BOX_BYTES + (kk * 16 % T::ATOM) * 2;
      wgmma_ss_n128(sc, smem_desc<DH>(q_slab + off, 16, 8 * T::ROW_BYTES),
                    smem_desc<DH>(sK + s * T::BYTES + off, 16, 8 * T::ROW_BYTES), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    PROF(S_GEMM);

    // mask only a tile that crosses the diagonal, the window's far edge or
    // S for some row of this warpgroup, scaling it into log2 units there;
    // an inside tile stays raw and takes the scale f in the exponent's fma
    const bool inside = k0 + BK - 1 <= wg_lo && k0 > wg_hi - window && k0 + BK <= S;
    const float f = inside ? scale_log2 : 1.f;
    if (!inside) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * c + cq + e;
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
    for (int c = 0; c < 16; ++c) {
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
    for (int c = 0; c < 16; ++c) {
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

    // P in bf16: the accumulator columns 16kk .. 16kk + 15 are wgmma's
    // register A fragment for keys 16kk .. 16kk + 15
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    PROF(SOFTMAX);

    // O += P V: keys in steps of 16, V (keys x dh) MN-major
    mbar_wait(v_full(s), parity);
    PROF(WAIT_V);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<DH>(o, pa[kk],
                   smem_desc<DH>(sV + s * T::BYTES + kk * 16 * T::ROW_BYTES, T::BOX_BYTES,
                                 8 * T::ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    PROF(PV_GEMM);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  bf16* out_a = out + (((long long)b * S + qa) * H + h) * DH + cq;
  bf16* out_b = out_a + 8LL * H * DH;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    if (qa < S)
      *reinterpret_cast<__nv_bfloat162*>(out_a + 8 * c) =
          __floats2bfloat162_rn(o[4 * c] * inv_a, o[4 * c + 1] * inv_a);
    if (qb < S)
      *reinterpret_cast<__nv_bfloat162*>(out_b + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2] * inv_b, o[4 * c + 3] * inv_b);
  }
#ifdef SWA_TC_PROFILE
  PROF(EPILOGUE);
  if (threadIdx.x % 128 == 0) {
    for (int i = 0; i < N_PHASES; ++i) atomicAdd(&g_prof[i], (unsigned long long)prof[i]);
    atomicAdd(&g_prof[N_PHASES], (unsigned long long)n_tiles);
    atomicAdd(&g_prof[N_PHASES + 1], 1ull);
  }
#endif
}

// cuTensorMapEncodeTiled, from the CUDA driver at run time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// error codes of this file beside the cudaError_t values
constexpr int ERR_NO_ENCODE = 9999;     // no cuTensorMapEncodeTiled in the CUDA driver
constexpr int ERR_ENCODE_BASE = 10000;  // + the CUresult of a failed encode

int encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return ERR_NO_ENCODE;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A (rows, cols) row-major bf16 array as a 2-D tensor map with boxes of
// 128 rows x `box_cols` columns.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, long long rows, long long cols,
           int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)BK};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE_BASE + (int)r;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, long long B, long long S,
           long long H, long long G, long long window, cudaStream_t stream) {
  using T = Tile<DH>;
  EncodeTiled fn;
  int err = encode_fn(&fn);
  if (err != 0) return err;
  const CUtensorMapSwizzle swizzle =
      T::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  if ((err = encode(fn, &mq, q, B * S, H * DH, T::ATOM, swizzle)) != 0) return err;
  if ((err = encode(fn, &mk, k, B * S, G * DH, T::ATOM, swizzle)) != 0) return err;
  if ((err = encode(fn, &mv, v, B * S, G * DH, T::ATOM, swizzle)) != 0) return err;
  cudaError_t st = cudaFuncSetAttribute(swa_tc_kernel<DH>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (st != cudaSuccess) return (int)st;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)DH));
  dim3 grid((unsigned int)((S + BQ - 1) / BQ), (unsigned int)H, (unsigned int)B);
  // a window past S attends to every earlier key, as a window of S does
  const int win = (int)(window < S ? window : S);
  swa_tc_kernel<DH><<<grid, NT, T::SMEM, stream>>>(mq, mk, mv, (bf16*)out, (int)S, (int)H,
                                                  (int)G, win, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, dh), k/v (B, S, G, dh), out (B, S, H, dh), all bf16,
// contiguous and 16-byte aligned, dh in {32, 64, 128}, H % G == 0,
// B * S < 2^31.  Launches on `stream` and returns the CUDA error code of the
// launch, or 9999 / 10000 + CUresult when a tensor map cannot be made.
extern "C" int repro_swa_attention_tc_bf16(const void* q, const void* k, const void* v,
                                           void* out, long long B, long long S, long long H,
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

#ifdef SWA_TC_PROFILE
// Copies the profile counters (cycles per phase in the order of Phase, then
// tiles and warpgroups) into host[0 .. N_PHASES + 2) and clears them.
extern "C" int repro_swa_tc_profile(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[N_PHASES + 2] = {};
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
}
#endif
