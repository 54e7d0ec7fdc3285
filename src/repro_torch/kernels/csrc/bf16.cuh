// bf16 rows for the simulation kernels' bf16 entries (trigger_sq.cu,
// mix.cu, mix_sparse.cu): values are read as their 16-bit words, widened
// to fp32 exactly (a bf16 is the top half of an fp32), and results are
// rounded back to nearest even by __float2bfloat16_rn, the conversion
// torch's own CUDA cast from float32 to bfloat16 uses.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16rows {

__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

__device__ __forceinline__ uint16_t narrow(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// V consecutive values of a row starting at `p`: one 16-byte load for V = 8
// (p 16-byte aligned), V 2-byte loads for V = 1
template <int V>
__device__ __forceinline__ void load(const uint16_t* __restrict__ p, float (&x)[V]) {
  if constexpr (V == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[2 * t] = __uint_as_float(w[t] << 16);
      x[2 * t + 1] = __uint_as_float(w[t] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) x[t] = widen(__ldg(p + t));
  }
}

template <int V>
__device__ __forceinline__ void store(uint16_t* __restrict__ p, const float (&x)[V]) {
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      w[t] = (uint32_t)narrow(x[2 * t]) | ((uint32_t)narrow(x[2 * t + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) p[t] = narrow(x[t]);
  }
}

}  // namespace bf16rows
