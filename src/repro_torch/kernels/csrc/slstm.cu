// slstm: the time loop of an xLSTM sLSTM block (xlstm-125m's four sLSTM
// layers), over the input projections pre_x (B, S, 4, H, dh) of every step
// (gates i, f, z, o), the per-head recurrent weights R (4, H, dh, dh) and the
// bias (4, H, dh), all in the model's dtype T (fp32 or bf16), from an fp32
// state (c, n, h, m) of (B, H, dh) each:
//
//     rec[g, j] = round(sum_k round(h[k]) R[g, k, j])           (fp32 sum)
//     pre[g, j] = fp32(round(round(pre_x[t, g, j] + rec[g, j]) + bias[g, j]))
//     log_f     = -softplus(-pre_f)       softplus(x) = max(x, 0) + log1p(exp(-|x|))
//     m'        = max(log_f + m, pre_i)
//     c'        = exp(log_f + m - m') c + exp(pre_i - m') tanh(pre_z)
//     n'        = exp(log_f + m - m') n + exp(pre_i - m')
//     h'        = (1 / (1 + exp(-pre_o))) c' / max(n', 1e-6)
//
// for t in 0..S-1, round() being T's rounding (none for fp32), as the
// reference's _slstm_cell rounds (src/repro/models/ssm.py:316-330; the plain
// version is kernels/slstm/ref.py).  hs (B, S, H, dh) gets each step's fp32
// h'; the final state is written to c1, n1, h1, m1.
//
// Replaces no TPU kernel: the reference's sLSTM is a jax.lax.scan over time
// (src/repro/models/ssm.py:336-355).  The recurrence is nonlinear, so it has
// no parallel form; a plain loop issues ~20 launches a step.
//
// Design: one thread block cluster a (batch row, head), of kCluster CTAs;
// CTA `rank` owns the U = dh / kCluster units j0 .. j0 + U - 1 of all four
// gates, and keeps its slice of R (4 x dh x U values) in registers, widened
// to fp32, for the whole sequence: thread (g, u, s) holds R[g, k, j0 + u] for
// the kSplit-th part s of k, and sums its products in four interleaved
// partial sums (a fixed order); with kSplit = 2 the two halves meet by one
// shuffle.  Thread (g, u, 0) then forms gate g's pre-activation of unit u
// and its own nonlinearity (log_f = -softplus(-f), tanh(z), sigmoid(o); i
// as it is), so the four gates' transcendental chains run side by side,
// and the unit's owner thread combines them with its state.  Each CTA holds the whole rounded h of the previous step in
// shared memory, double-buffered: step t reads buffer t & 1, the U owner
// threads (one a unit, its c, n, m in registers) run the gates and send
// their new rounded h into buffer (t + 1) & 1 of every CTA of the cluster
// by st.async over distributed shared memory, each store completing 4 bytes
// of that buffer's mbarrier transaction count in the receiving CTA; a CTA
// starts step t + 1 when its own mbarrier has seen all dh values of h
// arrive (one-way signals, no cluster-wide barrier a step).  A CTA sends
// step t's h only after all its threads have read buffer t & 1 (the
// __syncthreads before the gates), and a sender reaches step t + 1's send
// into that buffer only after receiving the receiver's step-t h, so two
// buffers suffice.  The owner threads load the next step's pre_x while the
// step computes.  No atomics and fixed orders: the same inputs give the
// same bits from run to run.
// The gates' products and sums are rounded one by one (no contraction into
// FMAs), expf / log1pf / tanhf the accurate ones, max propagating NaN as
// torch.maximum does.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<uint16_t> {
  static __device__ __forceinline__ float load(const uint16_t* p) {
    return bf16rows::widen(__ldg(p));
  }
  static __device__ __forceinline__ float round(float x) {
    return bf16rows::widen(bf16rows::narrow(x));
  }
};

// CTAs of a cluster and parts of k a product is cut into, by head width:
// a thread keeps dh / kSplit fp32 values of R in registers (<= 96)
template <int DH>
struct Plan;
template <>
struct Plan<32> { static constexpr int kCluster = 1, kSplit = 1; };
template <>
struct Plan<64> { static constexpr int kCluster = 1, kSplit = 1; };
template <>
struct Plan<128> { static constexpr int kCluster = 2, kSplit = 2; };
template <>
struct Plan<192> { static constexpr int kCluster = 4, kSplit = 2; };

template <int DH>
__host__ __device__ constexpr int threads_of() {
  return 4 * (DH / Plan<DH>::kCluster) * Plan<DH>::kSplit;
}

// distributed shared memory and mbarriers (PTX, sm_90)
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

// this phase's one arrival, expecting `bytes` of transactions
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; acquires at cluster
// scope, so the st.async values it counted are visible
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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

// 4 bytes into another CTA's shared memory, completing 4 bytes of the
// transaction count of its mbarrier `bar` (both cluster addresses)
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// max of two values, NaN if either is (torch.maximum, jnp.maximum)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

template <typename T, int DH>
__global__ void __launch_bounds__(threads_of<DH>(), 1)
slstm_kernel(const T* __restrict__ pre_x, const T* __restrict__ r,
             const T* __restrict__ bias, const float* __restrict__ c0,
             const float* __restrict__ n0, const float* __restrict__ h0,
             const float* __restrict__ m0, float* __restrict__ hs, float* __restrict__ c1,
             float* __restrict__ n1, float* __restrict__ h1, float* __restrict__ m1,
             int64_t S, int H) {
  constexpr int NC = Plan<DH>::kCluster;
  constexpr int KS = Plan<DH>::kSplit;
  constexpr int U = DH / NC;
  constexpr int KL = DH / KS;
  constexpr int kThreads = threads_of<DH>();
  static_assert(KL % 4 == 0 && (U * KS) % 32 == 0 && DH % NC == 0, "plan");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;  // b H + head
  const int b = bh / H, head = bh - b * H;
  const int j0 = rank * U;
  const int tid = threadIdx.x;
  const int ks = tid % KS;
  const int o = tid / KS;
  const int g = o / U, u = o - g * U;

  __shared__ __align__(16) float hbuf[2][DH];
  __shared__ float act[4][U];  // each gate's activation of each unit
  __shared__ __align__(8) uint64_t full[2];  // buffer b's h has arrived

  float w[KL];
  {
    const T* rp = r + ((int64_t)(g * H + head) * DH + ks * KL) * DH + j0 + u;
#pragma unroll
    for (int k = 0; k < KL; ++k) w[k] = Elem<T>::load(rp + (int64_t)k * DH);
  }

  const bool owner = tid < U;  // owns unit tid's state
  const bool lead = ks == 0;   // forms gate g's activation of unit u
  const int64_t gate_stride = (int64_t)H * DH;
  const int64_t step = 4 * gate_stride;
  const int64_t sidx = (int64_t)bh * DH + j0 + tid;
  // this thread's (g, u) in pre_x's step 0
  const T* pp = pre_x + (int64_t)b * S * step + g * gate_stride + (int64_t)head * DH + j0 + u;
  float* hp = hs + ((int64_t)b * S * H + head) * DH + j0 + tid;
  float c = 0.f, n = 0.f, m = 0.f, hl = 0.f;
  float bi = 0.f, px = 0.f, nx = 0.f;
  if (owner) {
    c = c0[sidx];
    n = n0[sidx];
    m = m0[sidx];
    hl = h0[sidx];
  }
  if (lead) {
    bi = Elem<T>::load(bias + g * gate_stride + (int64_t)head * DH + j0 + u);
    px = Elem<T>::load(pp);
  }
  for (int k = tid; k < DH; k += kThreads)
    hbuf[0][k] = Elem<T>::round(h0[(int64_t)bh * DH + k]);
  if (tid == 0) {  // the first phase of each buffer: DH values to arrive
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_addr(&full[0]), DH * 4);
    mbar_expect(smem_addr(&full[1]), DH * 4);
  }
  // an owner's unit in buffer 0 of every CTA, and each CTA's mbarriers
  uint32_t dst[NC], bar[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    dst[q] = map_rank(smem_addr(&hbuf[0][j0 + (owner ? tid : 0)]), q);
    bar[q] = map_rank(smem_addr(&full[0]), q);
  }
  cluster.sync();  // every CTA of the cluster running, its mbarriers armed

  for (int64_t t = 0; t < S; ++t) {
    const int cur = (int)(t & 1);
    if (t > 0) {
      // step t's h, sent during step t - 1: phase (t - 1) / 2 of full[cur].
      // Then arm its next phase (step t + 2's h): no CTA sends that before
      // this CTA has sent step t's, after its __syncthreads below
      mbar_wait(smem_addr(&full[cur]), (uint32_t)(((t - 1) >> 1) & 1));
      if (tid == 0 && t + 2 < S) mbar_expect(smem_addr(&full[cur]), DH * 4);
    }
    if (lead && t + 1 < S) nx = Elem<T>::load(pp + (t + 1) * step);
    const float* hb = &hbuf[cur][ks * KL];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int k = 0; k < KL; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hb + k);
      a0 = fmaf(hv.x, w[k], a0);
      a1 = fmaf(hv.y, w[k + 1], a1);
      a2 = fmaf(hv.z, w[k + 2], a2);
      a3 = fmaf(hv.w, w[k + 3], a3);
    }
    float acc = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
    if constexpr (KS == 2) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
    if (lead) {
      // warps are whole in g (4 U kSplit threads, U kSplit a multiple of 32)
      const float pre =
          Elem<T>::round(__fadd_rn(Elem<T>::round(__fadd_rn(px, Elem<T>::round(acc))), bi));
      float a = pre;  // i: log i = pre_i
      if (g == 1) {   // log_f = -softplus(-pre_f)
        const float xf = -pre;
        a = -__fadd_rn(fmaxf(xf, 0.f), log1pf(expf(-fabsf(xf))));
      } else if (g == 2) {
        a = tanhf(pre);
      } else if (g == 3) {  // sigmoid as XLA expands it
        a = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-pre)));
      }
      act[g][u] = a;
      px = nx;
    }
    __syncthreads();
    if (owner) {
      const float i_p = act[0][tid];
      const float lfm = __fadd_rn(act[1][tid], m);
      const float m_new = nan_max(lfm, i_p);
      const float i_s = expf(__fsub_rn(i_p, m_new));
      const float f_s = expf(__fsub_rn(lfm, m_new));
      c = __fadd_rn(__fmul_rn(f_s, c), __fmul_rn(i_s, act[2][tid]));
      n = __fadd_rn(__fmul_rn(f_s, n), i_s);
      m = m_new;
      hl = __fdiv_rn(__fmul_rn(act[3][tid], c), nan_max(n, 1e-6f));
      hp[t * gate_stride] = hl;
      if (t + 1 < S) {
        const float hr = Elem<T>::round(hl);
        const uint32_t off = (uint32_t)((cur ^ 1) * DH * 4);
#pragma unroll
        for (int q = 0; q < NC; ++q) st_async(dst[q] + off, hr, bar[q] + (cur ^ 1) * 8);
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still address its memory
  if (owner) {
    c1[sidx] = c;
    n1[sidx] = n;
    h1[sidx] = hl;
    m1[sidx] = m;
  }
}

#ifdef SLSTM_SYNC_PROBE
// a probe built only with -DSLSTM_SYNC_PROBE, no part of the model's
// library: the kernel's launch shape and per-step synchronisation alone.
// Each step every CTA waits for its buffer's values, its threads meet at a
// block barrier, and thread 0 sends one value into every CTA of its cluster
// by st.async, S times; out (B H kCluster) gets each CTA's last sum
template <int DH>
__global__ void __launch_bounds__(threads_of<DH>(), 1)
slstm_sync_kernel(float* __restrict__ out, int64_t S) {
  constexpr int NC = Plan<DH>::kCluster;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  __shared__ __align__(16) float buf[2][NC];
  __shared__ __align__(8) uint64_t full[2];
  if (threadIdx.x < NC) buf[0][threadIdx.x] = 0.f;
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_addr(&full[0]), NC * 4);
    mbar_expect(smem_addr(&full[1]), NC * 4);
  }
  uint32_t dst[NC], bar[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    dst[q] = map_rank(smem_addr(&buf[0][rank]), q);
    bar[q] = map_rank(smem_addr(&full[0]), q);
  }
  cluster.sync();
  for (int64_t t = 0; t < S; ++t) {
    const int cur = (int)(t & 1);
    if (t > 0) {
      mbar_wait(smem_addr(&full[cur]), (uint32_t)(((t - 1) >> 1) & 1));
      if (threadIdx.x == 0 && t + 2 < S) mbar_expect(smem_addr(&full[cur]), NC * 4);
    }
    __syncthreads();
    if (threadIdx.x == 0 && t + 1 < S) {
      const float v = buf[cur][rank] + 1.f;
      const uint32_t off = (uint32_t)((cur ^ 1) * NC * 4);
#pragma unroll
      for (int q = 0; q < NC; ++q) st_async(dst[q] + off, v, bar[q] + (cur ^ 1) * 8);
    }
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int q = 0; q < NC; ++q) sum += buf[(S - 1) & 1][q];
    out[(int64_t)blockIdx.y * NC + rank] = sum;
  }
}
#endif  // SLSTM_SYNC_PROBE

template <int DH>
cudaLaunchConfig_t config_of(int64_t B, int64_t H, cudaStream_t st,
                             cudaLaunchAttribute* attr) {
  constexpr int NC = Plan<DH>::kCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NC, (unsigned)(B * H), 1);
  cfg.blockDim = dim3(threads_of<DH>(), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int DH>
cudaError_t launch_dh(const void* pre_x, const void* r, const void* bias, const void* c0,
                      const void* n0, const void* h0, const void* m0, void* hs, void* c1,
                      void* n1, void* h1, void* m1, int64_t B, int64_t S, int64_t H,
                      cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config_of<DH>(B, H, st, attr);
  return cudaLaunchKernelEx(
      &cfg, slstm_kernel<T, DH>, static_cast<const T*>(pre_x), static_cast<const T*>(r),
      static_cast<const T*>(bias), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(h0),
      static_cast<const float*>(m0), static_cast<float*>(hs), static_cast<float*>(c1),
      static_cast<float*>(n1), static_cast<float*>(h1), static_cast<float*>(m1), S, (int)H);
}

template <typename T>
int launch(const void* pre_x, const void* r, const void* bias, const void* c0,
           const void* n0, const void* h0, const void* m0, void* hs, void* c1, void* n1,
           void* h1, void* m1, int64_t B, int64_t S, int64_t H, int64_t dh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32:
      err = launch_dh<T, 32>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, B, S, H, st);
      break;
    case 64:
      err = launch_dh<T, 64>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, B, S, H, st);
      break;
    case 128:
      err = launch_dh<T, 128>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, B, S, H,
                              st);
      break;
    case 192:
      err = launch_dh<T, 192>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, B, S, H,
                              st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef SLSTM_SYNC_PROBE
template <int DH>
cudaError_t sync_dh(void* out, int64_t B, int64_t S, int64_t H, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config_of<DH>(B, H, st, attr);
  return cudaLaunchKernelEx(&cfg, slstm_sync_kernel<DH>, static_cast<float*>(out), S);
}
#endif  // SLSTM_SYNC_PROBE

}  // namespace

extern "C" {

int repro_slstm_f32(const void* pre_x, const void* r, const void* bias, const void* c0,
                    const void* n0, const void* h0, const void* m0, void* hs, void* c1,
                    void* n1, void* h1, void* m1, int64_t B, int64_t S, int64_t H,
                    int64_t dh, void* stream) {
  return launch<float>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, B, S, H, dh,
                       stream);
}

int repro_slstm_bf16(const void* pre_x, const void* r, const void* bias, const void* c0,
                     const void* n0, const void* h0, const void* m0, void* hs, void* c1,
                     void* n1, void* h1, void* m1, int64_t B, int64_t S, int64_t H,
                     int64_t dh, void* stream) {
  return launch<uint16_t>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, B, S, H, dh,
                          stream);
}

#ifdef SLSTM_SYNC_PROBE
// out: B H kCluster fp32
int repro_slstm_sync_loop(void* out, int64_t B, int64_t S, int64_t H, int64_t dh,
                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32: err = sync_dh<32>(out, B, S, H, st); break;
    case 64: err = sync_dh<64>(out, B, S, H, st); break;
    case 128: err = sync_dh<128>(out, B, S, H, st); break;
    case 192: err = sync_dh<192>(out, B, S, H, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif  // SLSTM_SYNC_PROBE

}  // extern "C"
