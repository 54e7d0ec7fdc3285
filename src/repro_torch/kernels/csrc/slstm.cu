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
// h'; the final state is written to c1, n1, h1, m1.  The saving variant
// (kSave, for training) also writes each step's fp32 pre[0..3] and the state
// c, n, m before the step into save (B, S, 7, H, dh), the rows the backward
// kernel (slstm_bwd.cu) reads; its hs and state are the serving kernel's,
// bit for bit.  What both share with the backward is in slstm.cuh.
//
// Replaces no TPU kernel: the reference's sLSTM is a jax.lax.scan over time
// (src/repro/models/ssm.py:336-355).  The recurrence is nonlinear, so it has
// no parallel form; a plain loop issues ~20 launches a step.  Bound on the
// H100: neither the bytes nor the operations (0.0721 ms of fp32 FMAs at
// xlstm-125m's (1, 4096, 4, 192)) but the serial chain of steps, each a
// product on one CTA of the cluster and the cluster's signalling (PERF.md §6
// row 6: the serial floor): each step's product needs the whole h of the
// step before.
//
// Design: one thread block cluster a (batch row, head), of kCluster CTAs;
// CTA `rank` owns the U = dh / kCluster units j0 .. j0 + U - 1 of all four
// gates.  A CTA is W = U / 4 consumer warps and one producer warp.
//   - Lanes: a consumer warp owns 4 whole units, lane part + 8 uw holding,
//     for unit uw, R[g, k, j] of all four gates g over its part of k (the
//     16-byte chunks part, part + 8, ... of h: the 8 parts read 8 distinct
//     chunks, 128 bytes, at once) in registers, widened to fp32, for the
//     whole sequence.  A lane reads dh / 8 values of h a step for 4 dh / 8
//     FMAs.  Its sum of each gate is two partial sums (the chunks' x and z
//     terms, their y and w terms) in chunk order, then added; the unit's 8
//     lanes then reduce and scatter the four sums by shuffles: xor 4 (lanes
//     of part & 4 keep gates 2, 3, the others 0, 1), xor 2 (part & 2 keeps
//     the second of its two), xor 1 (both lanes add, the same bits), so lane
//     part ends with gate (part / 2) % 4 of its unit: a fixed order, and the
//     unit's gates meet in its warp, no block barrier needed.
//   - Gates: every lane forms its gate's pre-activation and takes its
//     nonlinearity in one branch-free block (two lanes a gate, side by side):
//     e = exp(-|x|) (exp(-2|x|) for z) by one ex2.approx of a pre-scaled
//     argument and d = 1 + e (2 + e for f) inverted by rcp.approx and one
//     Newton step; then tanh = sign(x) (1 - e) / (1 + e), sigmoid = 1 / (1 +
//     e) or e / (1 + e), log_f = min(x, 0) - log1p(e) with log1p(e) = 2
//     atanh(e / (2 + e)) by its series in (e / (2 + e))^2 <= 1/9 to the 13th
//     power (truncation under 2^-26).  Every lane of the unit then takes
//     the four gates (from parts 0, 2, 4, 6) by shuffles and combines them
//     with its copy of the unit's c, n, m (registers; the same bits in each
//     lane): of exp(pre_i - m') and exp(log_f + m - m') one is 1 and the
//     other exp(-|log_f + m - pre_i|), one ex2.approx; h by one rcp.approx.
//     No IEEE division or libm call is left on a step's chain, and bf16
//     rounding is one F2FP (cvt.rn.bf16x2.f32).
//   - h: each CTA holds the whole rounded h of the previous step in shared
//     memory, double-buffered.  Lane part < kCluster of a unit sends its new
//     h, rounded, into buffer (t + 1) & 1 of CTA part by one 4-byte st.async
//     over distributed shared memory, completing 4 bytes of that buffer's
//     mbarrier transaction count there, and part 0 stores it, fp32, to hs
//     (the warp's 4 units: one 16-byte span).  A warp starts step t + 1
//     when its CTA's mbarrier has seen all dh values arrive: the step's only
//     synchronisation.  Two buffers suffice: a sender writes h_{t+2} into
//     buffer t & 1 of CTA q only after it has received all of h_{t+1}, which
//     includes every warp of CTA q's units; each of those warps sent its
//     h_{t+1} only after its step-t product had read buffer t & 1 (the sent
//     values depend on the loads).  For the same reason no warp waits on a
//     phase two ahead of its own: the phase after its step needs its own send.
//     Warp 0 re-arms the buffer's mbarrier (arrive.expect_tx) for h_{t+2}
//     right after its wait for h_t, before its own send of h_{t+1}.
//   - pre_x: the producer warp stages the CTA's slice, 4 gates x U units of
//     kTile steps, into a ring of kStages stages by 1-D bulk copies, one a
//     (step, gate) row of U T values (16-byte aligned and whole 16-byte
//     chunks for every dh and kCluster here: row starts are multiples of U
//     elements from a 16-byte aligned base), under a `landed` mbarrier a stage
//     (the copies' bytes) and an `empty` one (each consumer warp's release
//     after the tile's last step).  A step reads its pre_x from shared memory.
//   Nothing is loaded from device memory on a step's path, and nothing there
//   waits for a whole block.
// Measured on the H100 (PERF.md): two consumer warps share a sub-partition on
// two of the four (6 warps), and a step is the product's issue and the chain
// of shuffles, MUFU and F2FP after it, then the round trip of the sends; a
// cluster of 4 at dh 192 (12 warps) was slower, and so were one lane sending
// to every CTA and a warp's 4 h gathered for 16-byte sends.
// No atomics and fixed orders: the same inputs give the same bits from run to
// run.  The gates' products and sums are rounded one by one (no contraction
// into FMAs) but for the recurrent sums and the approximations' Newton steps
// and series; max propagates NaN (max.NaN) as torch.maximum does; a NaN
// input gives NaN where the plain loop's does.  ex2.approx flushes results
// below 2^-126 to 0.
#include "slstm.cuh"

namespace cg = cooperative_groups;

namespace {

// the launch shape and the shared memory of one CTA: the two h buffers,
// the mbarriers (full[2], landed[kStages], empty[kStages]) and the ring
template <typename T, int DH>
struct Shape {
  static constexpr int NC = Plan<DH>::kCluster;
  static constexpr int U = DH / NC;          // units a CTA
  static constexpr int UW = kUnitsWarp;      // units a consumer warp
  static constexpr int W = U / UW;           // consumer warps
  static constexpr int CH = DH / 4 / kParts; // 16-byte chunks of h a lane
  static constexpr int kThreads = (W + 1) * 32;
  static constexpr uint32_t kRow = U * sizeof(T);  // one (step, gate) row of pre_x
  static constexpr uint32_t kStage = kTile * 4 * kRow;
  static constexpr uint32_t kBars = 2 * DH * 4;
  static constexpr uint32_t kRing = (kBars + 8 * (2 + 2 * kStages) + 127) & ~127u;
  static constexpr uint32_t kSmem = kRing + kStages * kStage;
  static_assert(DH % NC == 0 && U % UW == 0 && DH % (4 * kParts) == 0, "plan");
  static_assert(UW * kParts == 32 && kParts == 8, "whole units a warp; the 3-level reduction");
  static_assert(kRow % 16 == 0, "a pre_x row is whole 16-byte chunks: bulk copies");
  static_assert(NC <= 8 && W >= 1, "a portable cluster; sender lanes below the warp's");
};

// kSave: also write, for each step t, the four gates' fp32 pre-activations
// and the state (c, n, m) before the step into save (B, S, kSaveRows, H,
// DH), the rows the backward kernel (slstm_bwd.cu) reads
template <typename T, int DH, bool kSave>
__global__ void __launch_bounds__(Shape<T, DH>::kThreads, 1)
slstm_kernel(const T* __restrict__ pre_x, const T* __restrict__ r,
             const T* __restrict__ bias, const float* __restrict__ c0,
             const float* __restrict__ n0, const float* __restrict__ h0,
             const float* __restrict__ m0, float* __restrict__ hs, float* __restrict__ c1,
             float* __restrict__ n1, float* __restrict__ h1, float* __restrict__ m1,
             float* __restrict__ save, int64_t S, int H) {
  using L = Shape<T, DH>;
  constexpr int NC = L::NC, U = L::U, UW = L::UW, W = L::W, CH = L::CH;
  extern __shared__ __align__(128) unsigned char smem[];
  float* hbuf = reinterpret_cast<float*>(smem);  // [2][DH]
  const uint32_t full = smem_addr(smem + L::kBars);  // full[2], landed[kStages], empty[kStages]
  const uint32_t landed = full + 16, empty = landed + 8 * kStages;
  const uint32_t ring = smem_addr(smem + L::kRing);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;  // b H + head
  const int b = bh / H, head = bh - b * H;
  const int j0 = rank * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t gate_stride = (int64_t)H * DH;
  const int64_t tiles = (S + kTile - 1) / kTile;

  for (int k = threadIdx.x; k < DH; k += L::kThreads)
    hbuf[k] = Elem<T>::round(h0[(int64_t)bh * DH + k]);
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(landed + 8 * s, 1);
      mbar_init(empty + 8 * s, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the first phase of each h buffer: h_2 into buffer 0, h_1 into buffer 1
    mbar_expect(full, DH * 4);
    mbar_expect(full + 8, DH * 4);
  }
  cluster.sync();  // every CTA of the cluster running, its mbarriers armed

  if (warp == W) {  // the producer: tile i into stage i % kStages
    const T* src0 = pre_x + (int64_t)b * S * 4 * gate_stride + (int64_t)head * DH + j0;
    for (int64_t i = 0; i < tiles; ++i) {
      const int s = (int)(i % kStages);
      if (i >= kStages) mbar_wait(empty + 8 * s, (uint32_t)((i / kStages - 1) & 1));
      const int steps = (int)min((int64_t)kTile, S - i * kTile);
      if (lane == 0) mbar_expect(landed + 8 * s, (uint32_t)steps * 4 * L::kRow);
      __syncwarp();
      for (int row = lane; row < steps * 4; row += 32)  // row = step 4 + gate
        bulk_copy(ring + s * L::kStage + row * L::kRow,
                  src0 + (i * kTile * 4 + row) * gate_stride, L::kRow, landed + 8 * s);
    }
  } else {
    // lane = part + kParts unit; after the product's reduction the lane
    // holds gate g = (part / 2) % 4 of its unit
    const int part = lane % kParts, uw = lane / kParts, g = (part >> 1) & 3;
    const bool hi2 = (part & 4) != 0, hi1 = (part & 2) != 0;
    const int ul = warp * UW + uw;  // the lane's unit in the CTA
    const bool owner = part == 0;
    float w[4][4 * CH];  // R[g, k, j] of the lane's chunks of k, every gate
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      const T* rp = r + (int64_t)(gg * H + head) * DH * DH + j0 + ul;
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[gg][4 * c + q] = Elem<T>::load(rp + (int64_t)(4 * (part + kParts * c) + q) * DH);
    }
    const float bi = Elem<T>::load(bias + g * gate_stride + (int64_t)head * DH + j0 + ul);
    const float kx = g == 2 ? -2.f * kLog2e : -kLog2e;
    const float d0 = g == 1 ? 2.f : 1.f;
    const int64_t sidx = (int64_t)bh * DH + j0 + ul;
    float c = c0[sidx], n = n0[sidx], m = m0[sidx], hl = h0[sidx];
    // lane part < NC sends its unit's h into CTA part: the unit's slot in
    // buffer 0 there, and that CTA's full[0]
    const uint32_t to = part < NC ? (uint32_t)part : 0u;
    const uint32_t dst = map_rank(smem_addr(hbuf + j0 + ul), to);
    const uint32_t bar = map_rank(full, to);
    float* hp = hs + ((int64_t)b * S * H + head) * DH + j0 + ul;
    // the saving variant: lane part < 7 keeps one row of its unit a step,
    // the pre-activation of its gate (even parts) or c, n, m (parts 1, 3, 5)
    const int save_row = (part & 1) ? 4 + (part >> 1) : g;
    float* sp = kSave ? save + ((int64_t)b * S * kSaveRows * H + head) * DH + j0 + ul +
                            save_row * gate_stride
                      : nullptr;
    const T* ring_lane = reinterpret_cast<const T*>(smem + L::kRing) + g * U + ul;

    for (int64_t i = 0; i < tiles; ++i) {
      const int s = (int)(i % kStages);
      const int steps = (int)min((int64_t)kTile, S - i * kTile);
      mbar_wait(landed + 8 * s, (uint32_t)((i / kStages) & 1));
      const T* px_row = ring_lane + (size_t)s * (L::kStage / sizeof(T));
      for (int st = 0; st < steps; ++st) {
        const int64_t t = i * kTile + st;
        const int cur = (int)(t & 1);
        const float px = Elem<T>::widen(px_row[st * 4 * U]);
        if (t > 0) {
          // h_t, sent during step t - 1: phase (t - 1) / 2 of full[cur].
          // Then arm its next phase (h_{t+2}), before this warp's own send
          mbar_wait_cluster(full + 8 * cur, (uint32_t)(((t - 1) >> 1) & 1));
          if (warp == 0 && lane == 0 && t + 2 < S) mbar_expect(full + 8 * cur, DH * 4);
        }
        // the lane's part of every gate's sum: chunks part, part + kParts,
        // ... of h, two partial sums a gate
        const float* hb = hbuf + cur * DH + 4 * part;
        float a[4][2];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) a[gg][0] = a[gg][1] = 0.f;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const float4 hv = *reinterpret_cast<const float4*>(hb + 4 * kParts * k);
#pragma unroll
          for (int gg = 0; gg < 4; ++gg) {
            a[gg][0] = fmaf(hv.x, w[gg][4 * k], a[gg][0]);
            a[gg][1] = fmaf(hv.y, w[gg][4 * k + 1], a[gg][1]);
            a[gg][0] = fmaf(hv.z, w[gg][4 * k + 2], a[gg][0]);
            a[gg][1] = fmaf(hv.w, w[gg][4 * k + 3], a[gg][1]);
          }
        }
        float sum[4];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) sum[gg] = __fadd_rn(a[gg][0], a[gg][1]);
        // the 8 parts' sums, reduced and scattered: lanes of part & 4 keep
        // gates 2, 3 (else 0, 1), of part & 2 the second of those, then the
        // pair of lanes part, part ^ 1 adds (the same bits in both)
        float k0 = __fadd_rn(hi2 ? sum[2] : sum[0],
                             __shfl_xor_sync(kFull, hi2 ? sum[0] : sum[2], 4));
        float k1 = __fadd_rn(hi2 ? sum[3] : sum[1],
                             __shfl_xor_sync(kFull, hi2 ? sum[1] : sum[3], 4));
        float acc = __fadd_rn(hi1 ? k1 : k0, __shfl_xor_sync(kFull, hi1 ? k0 : k1, 2));
        acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, 1));
        const float pre =
            Elem<T>::round(__fadd_rn(Elem<T>::round(__fadd_rn(px, Elem<T>::round(acc))), bi));
        if constexpr (kSave) {
          if (part < kParts - 1)
            sp[t * kSaveRows * gate_stride] =
                (part & 1) ? (part == 1 ? c : part == 3 ? n : m) : pre;
        }
        const float act = gate_act(pre, g, kx, d0);
        // every lane of the unit takes its four gates (parts 0, 2, 4, 6) and
        // combines them with its copy of the state: the same bits in each
        const int u0 = lane & ~(kParts - 1);
        const float ip = __shfl_sync(kFull, act, u0);
        const float lf = __shfl_sync(kFull, act, u0 + 2);
        const float z = __shfl_sync(kFull, act, u0 + 4);
        const float o = __shfl_sync(kFull, act, u0 + 6);
        const Exps x = step_exps(ip, lf, m);
        c = __fadd_rn(__fmul_rn(x.f_s, c), __fmul_rn(x.i_s, z));
        n = __fadd_rn(__fmul_rn(x.f_s, n), x.i_s);
        m = x.m_new;
        hl = __fmul_rn(__fmul_rn(o, c), rcp_approx(nan_max(n, 1e-6f)));
        if (t + 1 < S && part < NC)
          st_async(dst + (uint32_t)((cur ^ 1) * DH * 4), Elem<T>::round(hl), bar + 8 * (cur ^ 1));
        if (owner) hp[t * gate_stride] = hl;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }
    if (owner) {
      c1[sidx] = c;
      n1[sidx] = n;
      h1[sidx] = hl;
      m1[sidx] = m;
    }
  }
  cluster.sync();  // no CTA leaves while another may still address its memory
}

#ifdef SLSTM_SYNC_PROBE
// a probe built only with -DSLSTM_SYNC_PROBE, no part of the model's
// library: a launch shape's per-step synchronisation alone, S steps, in a
// cluster of NC CTAs of blockDim.x / 32 warps (the two shapes of the serial
// floors at dh 192: the yardstick's and this design's).  kPerWarp false: each step
// every CTA waits for its buffer's NC values, its threads meet at a block
// barrier, and thread 0 sends one value into every CTA of its cluster by
// st.async (the protocol of the earlier design, a block barrier a step);
// true: each warp waits, and lane part + 8 u (part < NC) of each warp sends 4
// bytes of unit u into CTA part (this design's).  out (B H NC) gets each
// CTA's last sum
template <int NC, bool kPerWarp>
__global__ void slstm_sync_kernel(float* __restrict__ out, int64_t S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vals = kPerWarp ? NC * warps * 4 : NC;  // floats a step into a CTA
  __shared__ __align__(16) float buf[2][NC * 32 * 4];
  __shared__ __align__(8) uint64_t full[2];
  for (int k = threadIdx.x; k < vals; k += blockDim.x) buf[0][k] = 0.f;
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_addr(&full[0]), vals * 4);
    mbar_expect(smem_addr(&full[1]), vals * 4);
  }
  // a sender's slot in buffer 0 of the CTAs it sends to, and their full[0]:
  // lane part + 8 u < NC of each warp CTA part (kPerWarp), else thread 0
  // every CTA
  const bool sender = kPerWarp ? lane % 8 < NC : threadIdx.x == 0;
  const int slot = kPerWarp ? (rank * warps + warp) * 4 + lane / 8 : rank;
  constexpr int kTo = kPerWarp ? 1 : NC;  // CTAs a sender sends to
  uint32_t dst[kTo], bar[kTo];
#pragma unroll
  for (int p = 0; p < kTo; ++p) {
    const uint32_t to = kPerWarp ? (uint32_t)(lane % 8 < NC ? lane % 8 : 0) : (uint32_t)p;
    dst[p] = map_rank(smem_addr(&buf[0][slot]), to);
    bar[p] = map_rank(smem_addr(&full[0]), to);
  }
  cluster.sync();
  for (int64_t t = 0; t < S; ++t) {
    const int cur = (int)(t & 1);
    if (t > 0) {
      mbar_wait_cluster(smem_addr(&full[cur]), (uint32_t)(((t - 1) >> 1) & 1));
      if (threadIdx.x == 0 && t + 2 < S) mbar_expect(smem_addr(&full[cur]), vals * 4);
    }
    if (!kPerWarp) __syncthreads();
    if (sender && t + 1 < S) {
      const float v = buf[cur][slot] + 1.f;
      const uint32_t off = (uint32_t)((cur ^ 1) * NC * 32 * 4 * 4);
#pragma unroll
      for (int p = 0; p < kTo; ++p) st_async(dst[p] + off, v, bar[p] + (cur ^ 1) * 8);
    }
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int k = 0; k < vals; ++k) sum += buf[(S - 1) & 1][k];
    out[(int64_t)blockIdx.y * NC + rank] = sum;
  }
}

template <int NC, bool kPerWarp>
cudaError_t sync_nc(void* out, int64_t B, int64_t S, int64_t H, int64_t warps,
                    cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(NC, (unsigned)(B * H), 1);
  cfg.blockDim = dim3((unsigned)(warps * 32), 1, 1);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, slstm_sync_kernel<NC, kPerWarp>, static_cast<float*>(out),
                            S);
}
#endif  // SLSTM_SYNC_PROBE

template <typename T, int DH, bool kSave>
cudaError_t launch_dh(const void* pre_x, const void* r, const void* bias, const void* c0,
                      const void* n0, const void* h0, const void* m0, void* hs, void* c1,
                      void* n1, void* h1, void* m1, void* save, int64_t B, int64_t S,
                      int64_t H, cudaStream_t st) {
  using L = Shape<T, DH>;
  auto kernel = slstm_kernel<T, DH, kSave>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(L::NC, (unsigned)(B * H), 1);
  cfg.blockDim = dim3(L::kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(pre_x), static_cast<const T*>(r),
      static_cast<const T*>(bias), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(h0),
      static_cast<const float*>(m0), static_cast<float*>(hs), static_cast<float*>(c1),
      static_cast<float*>(n1), static_cast<float*>(h1), static_cast<float*>(m1),
      static_cast<float*>(save), S, (int)H);
}

// the serving kernel (save null) or its saving variant
template <typename T, int DH>
cudaError_t launch_variant(const void* pre_x, const void* r, const void* bias, const void* c0,
                           const void* n0, const void* h0, const void* m0, void* hs, void* c1,
                           void* n1, void* h1, void* m1, void* save, int64_t B, int64_t S,
                           int64_t H, cudaStream_t st) {
  if (save == nullptr)
    return launch_dh<T, DH, false>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, save,
                                   B, S, H, st);
  return launch_dh<T, DH, true>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, save, B,
                                S, H, st);
}

// the layout at head width DH: cluster, consumer warps a CTA, lanes a unit,
// steps a ring stage, ring stages
template <int DH>
void layout_dh(int64_t* out) {
  using L = Shape<float, DH>;
  out[0] = L::NC;
  out[1] = L::W;
  out[2] = kParts;
  out[3] = kTile;
  out[4] = kStages;
}

// pre_x 16-byte aligned (its rows arrive by bulk copies); save null (the
// serving kernel) or (B, S, kSaveRows, H, dh) fp32 (the saving variant)
template <typename T>
int launch(const void* pre_x, const void* r, const void* bias, const void* c0,
           const void* n0, const void* h0, const void* m0, void* hs, void* c1, void* n1,
           void* h1, void* m1, void* save, int64_t B, int64_t S, int64_t H, int64_t dh,
           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (B * H > 65535 || (reinterpret_cast<uintptr_t>(pre_x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32:
      err = launch_variant<T, 32>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, save, B,
                                  S, H, st);
      break;
    case 64:
      err = launch_variant<T, 64>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, save, B,
                                  S, H, st);
      break;
    case 128:
      err = launch_variant<T, 128>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, save, B,
                                   S, H, st);
      break;
    case 192:
      err = launch_variant<T, 192>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, save, B,
                                   S, H, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// save: null for the serving kernel, else the saving variant's rows
int repro_slstm_f32(const void* pre_x, const void* r, const void* bias, const void* c0,
                    const void* n0, const void* h0, const void* m0, void* hs, void* c1,
                    void* n1, void* h1, void* m1, void* save, int64_t B, int64_t S, int64_t H,
                    int64_t dh, void* stream) {
  return launch<float>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, save, B, S, H, dh,
                       stream);
}

int repro_slstm_bf16(const void* pre_x, const void* r, const void* bias, const void* c0,
                     const void* n0, const void* h0, const void* m0, void* hs, void* c1,
                     void* n1, void* h1, void* m1, void* save, int64_t B, int64_t S,
                     int64_t H, int64_t dh, void* stream) {
  return launch<uint16_t>(pre_x, r, bias, c0, n0, h0, m0, hs, c1, n1, h1, m1, save, B, S, H,
                          dh, stream);
}

// the kernel's layout at head width dh into out[0..4] (layout_dh), which
// kernels/slstm/ops.py mirrors for the host (layout()); cudaErrorInvalidValue
// for a dh not built
int repro_slstm_layout(int64_t dh, void* out) {
  int64_t* o = static_cast<int64_t*>(out);
  switch (dh) {
    case 32: layout_dh<32>(o); break;
    case 64: layout_dh<64>(o); break;
    case 128: layout_dh<128>(o); break;
    case 192: layout_dh<192>(o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

#ifdef SLSTM_SYNC_PROBE
// out: B H cluster fp32; warps in 1..32; (cluster, per_warp) (4, 0), the
// yardstick's protocol, or (8, 1), this design's at dh 192
int repro_slstm_sync_loop(void* out, int64_t B, int64_t S, int64_t H, int64_t cluster,
                          int64_t warps, int64_t per_warp, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (B * H > 65535 || warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster == 4 && per_warp == 0)
    err = sync_nc<4, false>(out, B, S, H, warps, st);
  else if (cluster == 8 && per_warp != 0)
    err = sync_nc<8, true>(out, B, S, H, warps, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif  // SLSTM_SYNC_PROBE

}  // extern "C"
