// scan.cuh: what the selective scan's forward (selective_scan.cu) and
// backward (selective_scan_bwd.cu) kernels share: the lane layout of a
// channel's states, the input dtypes' widening and rounding, the mbarriers
// and TMA copies of their rings, the exp, and the tensor maps of x, dt
// (and dy) rows.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kLanes = 8;              // lanes of a channel
constexpr int kChans = 32 / kLanes;    // channels a warp: a unit of a block's range
constexpr int kMaxWarps = 8;           // consumer warps a block (and one producer)
constexpr int kTile = 32;              // steps a tile: one packed row a producer lane
constexpr int kMaxState = 16;
constexpr int kSlots = kMaxState / kLanes;  // states a lane
constexpr int kBarBytes = 256;         // the mbarriers of a block's ring
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSlots == 2, "a lane loads its pairs in one 8- or 16-byte load");

// an input dtype: its widening and rounding, and a (b, c) pair as staged
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Pair = float2;
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
  static __device__ __forceinline__ Pair pack(float b, float c) { return make_float2(b, c); }
  static __device__ __forceinline__ float b_of(Pair p) { return p.x; }
  static __device__ __forceinline__ float c_of(Pair p) { return p.y; }
  static __device__ __forceinline__ Pair zero() { return make_float2(0.f, 0.f); }
  // a lane's kSlots pairs at p (16-byte aligned)
  static __device__ __forceinline__ void load(const Pair* p, Pair (&out)[kSlots]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = make_float2(v.x, v.y), out[1] = make_float2(v.z, v.w);
  }
  // NP pairs from the 16-byte aligned rows b and c of NP values each
  template <int NP>
  static __device__ __forceinline__ void pack_row(const float* b, const float* c, Pair* out) {
#pragma unroll
    for (int k = 0; k < NP; k += 4) {
      const float4 u = *reinterpret_cast<const float4*>(b + k);
      const float4 v = *reinterpret_cast<const float4*>(c + k);
      reinterpret_cast<float4*>(out + k)[0] = make_float4(u.x, v.x, u.y, v.y);
      reinterpret_cast<float4*>(out + k)[1] = make_float4(u.z, v.z, u.w, v.w);
    }
  }
};

template <>
struct Elem<uint16_t> {
  using Pair = uint32_t;  // b in the low half, c in the high half
  static __device__ __forceinline__ float widen(uint16_t v) { return bf16rows::widen(v); }
  static __device__ __forceinline__ float round(float v) {
    return bf16rows::widen(bf16rows::narrow(v));
  }
  static __device__ __forceinline__ uint16_t narrow(float v) { return bf16rows::narrow(v); }
  static __device__ __forceinline__ Pair pack(uint16_t b, uint16_t c) {
    return (uint32_t)b | ((uint32_t)c << 16);
  }
  static __device__ __forceinline__ float b_of(Pair p) { return __uint_as_float(p << 16); }
  static __device__ __forceinline__ float c_of(Pair p) {
    return __uint_as_float(p & 0xFFFF0000u);
  }
  static __device__ __forceinline__ Pair zero() { return 0u; }
  // a lane's kSlots pairs at p (8-byte aligned)
  static __device__ __forceinline__ void load(const Pair* p, Pair (&out)[kSlots]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = v.x, out[1] = v.y;
  }
  // NP pairs from the 16-byte aligned rows b and c of NP values each
  template <int NP>
  static __device__ __forceinline__ void pack_row(const uint16_t* b, const uint16_t* c,
                                                  Pair* out) {
#pragma unroll
    for (int k = 0; k < NP; k += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(b + k);
      const uint4 v = *reinterpret_cast<const uint4*>(c + k);
      const uint32_t bw[4] = {u.x, u.y, u.z, u.w}, cw[4] = {v.x, v.y, v.z, v.w};
      uint32_t w[8];
#pragma unroll
      for (int m = 0; m < 4; ++m) {  // (b, c) of the low halves, then the high ones
        w[2 * m] = __byte_perm(bw[m], cw[m], 0x5410);
        w[2 * m + 1] = __byte_perm(bw[m], cw[m], 0x7632);
      }
      reinterpret_cast<uint4*>(out + k)[0] = make_uint4(w[0], w[1], w[2], w[3]);
      reinterpret_cast<uint4*>(out + k)[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
};

__host__ __device__ inline uint32_t align128(uint32_t v) { return (v + 127) & ~127u; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits until the barrier's phase of parity `parity` has completed.  A wait
// that cannot complete (a fault in the pipeline) traps after 2^32 clocks
// (~2 s), so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

// TMA: the box at (column c0, step c1, batch row c2) of a 3-D tensor map
// into shared memory, completing `bar`'s transaction count
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// TMA, 1-D: `bytes` (a multiple of 16) from 16-byte aligned global memory
__device__ __forceinline__ void tma_bulk(uint32_t dst, uintptr_t src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<const void*>(src)), "r"(bytes), "r"(bar) : "memory");
}

// 2^v in one MUFU.EX2, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
// cuTensorMapEncodeTiled, from the CUDA driver at run time (no -lcuda)
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

// Makes the device's primary context current on the calling thread, which
// the CUDA driver's encode needs: autograd runs a backward (and a checkpointed
// layer's forward again) on a worker thread of its own, where no runtime
// call may have made it current yet (the encode then fails with
// CUDA_ERROR_INVALID_CONTEXT).
inline int context_current() {
  int device;
  cudaError_t e = cudaGetDevice(&device);
  return (int)(e != cudaSuccess ? e : cudaSetDevice(device));
}

// a (B, S, ld) row-major array of T as a 3-D tensor map of 4-byte words
// (a row of ld E / 4: the boxes copy bytes) with boxes of `box` words x
// kTile steps of one batch row, zeros outside
template <typename T>
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
           int64_t ld, uint32_t box) {
  const cuuint64_t dims[3] = {(cuuint64_t)(ld * sizeof(T) / 4), (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(T), (cuuint64_t)(S * ld) * sizeof(T)};
  const cuuint32_t boxes[3] = {box, (cuuint32_t)kTile, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(ptr), dims, strides, boxes, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE_BASE + (int)r;
}

}  // namespace
