// slstm.cuh: what the sLSTM recurrence's forward (slstm.cu) and backward
// (slstm_bwd.cu) kernels share: the cluster plan a head width takes, the
// lanes of a unit, the model dtypes' widening and rounding, the mbarriers,
// distributed shared memory stores and bulk copies of their rings and
// exchanges, and the gates' arithmetic.  The backward recomputes a step's
// gates and state from the values the forward saved with these same
// functions, so it sees the forward's bits.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kTile = 32;    // steps a ring stage
constexpr int kStages = 4;   // ring stages
// rows the saving forward keeps a step, in order: the pre-activations of
// gates i, f, z, o and the state c, n, m before the step (fp32)
constexpr int kSaveRows = 7;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float widen(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
};

template <>
struct Elem<uint16_t> {
  static __device__ __forceinline__ float load(const uint16_t* p) {
    return bf16rows::widen(__ldg(p));
  }
  static __device__ __forceinline__ float widen(uint16_t x) { return bf16rows::widen(x); }
  // to nearest even, as __float2bfloat16_rn, by cvt.rn.bf16x2.f32 (one
  // F2FP, shorter on the chain than the F2F of the scalar conversion)
  static __device__ __forceinline__ float round(float x) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x), "f"(0.f));
    return __uint_as_float(r & 0xffff0000u);
  }
  // the bf16 word of a value already rounded by round()
  static __device__ __forceinline__ uint16_t narrow(float x) {
    return (uint16_t)(__float_as_uint(x) >> 16);
  }
};

constexpr int kParts = 8;              // lanes a unit: parts of k
constexpr int kUnitsWarp = 32 / kParts;  // units a consumer warp

// CTAs of a cluster by head width (mirrored in kernels/slstm/ops.py
// CLUSTER, checked against repro_slstm_layout on the card): a lane keeps
// 4 dh / kParts fp32 values of R in registers (<= 96)
template <int DH>
struct Plan;
template <>
struct Plan<32> { static constexpr int kCluster = 2; };
template <>
struct Plan<64> { static constexpr int kCluster = 4; };
template <>
struct Plan<128> { static constexpr int kCluster = 8; };
template <>
struct Plan<192> { static constexpr int kCluster = 8; };

// distributed shared memory, mbarriers and bulk copies (PTX, sm_90)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address `addr` of this CTA's shared memory in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// this phase's one arrival, expecting `bytes` of transactions
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; acquires at cluster
// scope, so the st.async values it counted are visible
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the same at CTA scope (the ring's copies and releases)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 4 bytes into another CTA's shared memory, completing 4 bytes of the
// transaction count of its mbarrier `bar` (both cluster addresses)
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// 16 bytes (addr 16-byte aligned) likewise, completing 16 bytes of `bar`'s count
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, float d,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(__float_as_uint(c)),
      "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory into this
// CTA's shared memory, completing `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 2^v in one MUFU.EX2, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 1 / d in one MUFU.RCP (within an ulp; 1 / inf is 0, as the division's)
__device__ __forceinline__ float rcp_approx(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// 1 / d by rcp.approx and one Newton step; d finite or NaN
__device__ __forceinline__ float rcp(float d) {
  const float r = rcp_approx(d);
  return fmaf(r, fmaf(-d, r, 1.f), r);
}

// max of two values, NaN if either is (torch.maximum, jnp.maximum)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// gate g's activation of its pre-activation x: i as it is, log_f =
// -softplus(-x), tanh(x), sigmoid(x); `k` = -log2(e) (f, o) or -2 log2(e)
// (z), `d0` = 2 (f) or 1.  Branch-free: every lane runs every line
__device__ __forceinline__ float gate_act(float x, int g, float k, float d0) {
  const float e = ex2(fabsf(x) * k);          // exp(-|x|), exp(-2|x|) for z
  const float r = rcp(__fadd_rn(d0, e));      // 1 / (2 + e) for f, else 1 / (1 + e)
  const float s = __fmul_rn(e, r);            // f: e / (2 + e) in [0, 1/3]
  const float s2 = __fmul_rn(s, s);
  float p = fmaf(s2, 1.f / 13.f, 1.f / 11.f);  // atanh(s) / s = sum s^2i / (2i + 1)
  p = fmaf(s2, p, 1.f / 9.f);
  p = fmaf(s2, p, 1.f / 7.f);
  p = fmaf(s2, p, 1.f / 5.f);
  p = fmaf(s2, p, 1.f / 3.f);
  p = fmaf(s2, p, 1.f);
  const float log_f = __fsub_rn(fminf(x, 0.f), __fmul_rn(__fadd_rn(s, s), p));
  const float tanh_z = copysignf(__fmul_rn(__fsub_rn(1.f, e), r), x);
  const float sig_o = __fmul_rn(x >= 0.f ? 1.f : e, r);  // NaN x: e r, NaN
  return g == 0 ? x : g == 1 ? log_f : g == 2 ? tanh_z : sig_o;
}

// the two exps of a step from the gates i (ip) and log_f (lf) and the
// stabilizer m before the step: exp(pre_i - m') and exp(log_f + m - m'),
// m' = max(log_f + m, pre_i).  One of them is exp(0) = 1, the other
// exp(-|d|), d = log_f + m - pre_i, one ex2.approx (NaN d: f_s NaN, i_s 1)
struct Exps {
  float lfm, m_new, i_s, f_s;
};

__device__ __forceinline__ Exps step_exps(float ip, float lf, float m) {
  Exps x;
  x.lfm = __fadd_rn(lf, m);
  x.m_new = nan_max(x.lfm, ip);
  const float d = __fsub_rn(x.lfm, ip);
  const float e = ex2(__fmul_rn(-fabsf(d), kLog2e));
  x.i_s = d >= 0.f ? e : 1.f;
  x.f_s = d >= 0.f ? 1.f : e;
  return x;
}

}  // namespace
