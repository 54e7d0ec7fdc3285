// selective_scan: the selective scan of the Mamba (SSM) heads of a hybrid
// block (hymba-1.5b), over x, dt (B, S, di), b, c (B, S, n), a_log (di, n):
//
//     a[d, j]    = -exp(a_log[d, j])                               (fp32)
//     h[t, d, j] = exp(dt[t, d] a[d, j]) h[t-1, d, j] + round(dt[t, d] x[t, d]) b[t, j]
//     y[t, d]    = sum_j h[t, d, j] c[t, j]
//
// per batch row, h starting at 0; round() is the input dtype's rounding of
// the product (a bf16 product is rounded to bf16 before it is widened, as the
// reference computes dt * x in the model's dtype), everything else fp32.  y
// is (B, S, di) fp32.
//
// Replaces no TPU kernel: the reference's scan is src/repro/models/ssm.py:87,
// an XLA jax.lax.associative_scan over (B, S, di, n) fp32 tensors, not a
// Pallas kernel.  A plain PyTorch copy would hold three such tensors (6.7 GB
// each at hymba's (1, 32768, 3200, 16)), and a per-step loop costs ~7 launches
// a step; so this kernel keeps the state in registers and reads each input
// once.
//
// Bound on the H100: the exps.  The function reads x and dt (B S di each)
// and b and c (B S n each) and writes y (B S di fp32): 0.25 ms at hymba's
// shape in bf16.  It takes B S di n exps, 1.68e9 there: at 16 a clock per SM
// (MUFU.EX2, cc 9.0) on 132 SMs at 1.98 GHz, 0.40 ms.
//
// Design: one launch walks time once, and takes each exp once.  A channel's
// n <= 16 states are split over kLanes = 8 lanes of one warp (kSlots = 2
// consecutive states a lane, in registers), so a warp holds kChans = 4
// channels and B di n recurrences run side by side (51200 at hymba's B = 1).
// A block holds a range of whole units of kChans channels of a batch row
// (the host plan kernels/scan/ops.py::scan_plan sizes the ranges from the SM
// count: one block an SM at B = 1, 6 or 7 units), one consumer warp a unit
// and one producer warp, and walks all S steps in tiles of kTile steps
// through a ring of kStages stages:
//   - the producer stages tile i into stage i % kStages once the consumers
//     have released it (its `empty` mbarrier), by TMA: one tensor box each
//     of dt and x, kTile rows x the block's channels from the 16-byte bound
//     below the first (rows of dt and x lie `ld` elements apart, on 16-byte
//     bounds: the wrapper copies rows that are not into a padded buffer),
//     and one bulk copy each of the tile's b and c, all counted on the
//     stage's `landed` mbarrier.  kLag tiles later it packs that tile's
//     (b, c) pairs (two bf16 in a 32-bit word, or two floats) and arrives on
//     the stage's `full` mbarrier;
//   - a consumer warp runs, in one block of code, tile i's steps, the sums
//     of y of tile i - 1 and the (dt, dt x) pairs of tile i + 1 (dt widened,
//     dt x rounded, once a step and channel), so that none waits on another.
//     A step's decay is one MUFU.EX2, ex2.approx.ftz(dt a2) with a2 = a
//     log2(e) formed once a (channel, state); the update h = fma(decay, h,
//     (dt x) b); a lane's part of y is fma(c, h, .) over its states in order;
//     the exps and inputs of a tile's steps depend on the staged inputs
//     alone, so they issue ahead of the one chain, h.  Then it releases the
//     stage and stores its parts, and each lane later sums 4 steps' parts of
//     its channel's 8 lanes pairwise in lane order, ((p0 + p1) + (p2 + p3)) +
//     ((p4 + p5) + (p6 + p7)), and writes them to y.
// The exps do not set the pace at this width: measured on the H100 a tile
// takes about 2.2 times its exps' time on the busiest SM sub-partition (two
// consumer warps, 64 MUFU.EX2 a warp and tile), on the issue of the other
// instructions beside each exp and on shared-memory traffic (each lane
// reads its states' b and c every step, so the bf16 pairs are packed to
// halve those bytes).
// No block-wide barrier inside the loop: warps meet only on the ring's
// mbarriers.  No atomics and fixed orders: the same inputs give the same bits
// from run to run.  Decays below 2^-126 flush to 0 (ftz) where expf keeps a
// subnormal: a finite state moves by under 2^-126 of itself, and a state
// that is already infinite becomes NaN where the plain loop keeps an inf.
// So an output is non-finite where the plain loop's is, but an inf there may
// read NaN here.  An a that overflows a2 is held at -FLT_MAX (dt = 0 still
// gives a decay of 1).
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
constexpr int kStages = 8;             // the ring's tiles
constexpr int kLag = 2;                // tiles in flight before the producer packs one
constexpr int kStepsPerLane = kTile / kLanes;  // steps of y each lane sums
constexpr int kRow = kTile + 4;        // floats of a lane's parts of y, padded off the banks
constexpr int kPreRow = 2 * kTile + 4; // floats of a channel's (dt, dt x) pairs, padded
constexpr int kMaxState = 16;
constexpr int kSlots = kMaxState / kLanes;  // states a lane
constexpr int kBarBytes = 256;         // the mbarriers: full, empty, landed x kStages
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == 32 && kStepsPerLane == 4, "one row a producer lane; 4 steps of y a lane");
static_assert(kSlots == 2, "a lane loads its pairs in one 8- or 16-byte load");
static_assert(kLag < kStages, "the producer reuses a stage only after packing its tile");
static_assert(3 * 8 * kStages <= kBarBytes, "the mbarriers fit their bytes");

// an input dtype: its widening and rounding, and a (b, c) pair as staged
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Pair = float2;
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
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

// byte offsets of a block's shared memory (kernels/scan/ops.py::smem_bytes
// sums the same): the ring's mbarriers; kStages stages, each the raw dt and
// x rows of a tile (a row slot holds the block's channels widened to
// 16-byte bounds), its raw b and c and its packed (b, c) pairs (a step's row
// padded by 16 bytes, off the banks); a consumer warp's (dt, dt x) of each
// step and its lanes' parts of y, each double-buffered
struct Smem {
  uint32_t row, box, tile, pairs, pair_row, stage, dt, x, b, c, bc, pre, red, total;
};

__host__ __device__ inline uint32_t align128(uint32_t v) { return (v + 127) & ~127u; }

// a row slot holds the block's channels from the 16-byte bound below the
// first, as a TMA box (`box` 4-byte words) lays them
__host__ __device__ inline Smem smem_layout(int warps, int n, int m, int elem, int pair) {
  Smem s;
  s.row = ((warps * kChans * elem + 15) & ~15) + 16;
  s.box = s.row / 4;
  s.tile = ((kTile * n * elem + 15) & ~15) + 16;
  s.pairs = kLanes * m;  // a step's pairs, padded past n
  s.pair_row = s.pairs * pair + 16;
  uint32_t o = 0;
  s.dt = o, o = align128(o + kTile * s.row);
  s.x = o, o = align128(o + kTile * s.row);
  s.b = o, o += s.tile;
  s.c = o, o += s.tile;
  s.bc = o, o += kTile * s.pair_row;
  s.stage = align128(o);
  o = kBarBytes + kStages * s.stage;  // after the mbarriers
  s.pre = o, o += warps * 2 * kChans * kPreRow * 4;
  s.red = o, o += warps * 2 * 32 * kRow * 4;
  s.total = o;
  return s;
}

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

// grid (groups, B); block g holds the units [g U / groups, (g + 1) U /
// groups) of kChans channels (U = ceil(di / kChans)) of batch row
// blockIdx.y: warps 0 .. busy - 1 consume (one a unit), warp `busy`
// produces; dt and x arrive through the tensor maps tm_dt and tm_x
template <typename T>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 1) selective_scan_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dt,
    const T* __restrict__ bm, const T* __restrict__ cm, const T* __restrict__ a_log,
    float* __restrict__ y, int64_t S, int64_t di, int n, int64_t groups) {
  using E = Elem<T>;
  using P = typename E::Pair;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ES = sizeof(T);
  const int warps = blockDim.x / 32 - 1;
  constexpr int M = kSlots;
  const Smem L = smem_layout(warps, n, M, ES, (int)sizeof(P));
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t units = (di + kChans - 1) / kChans;
  const int64_t u_lo = (int64_t)blockIdx.x * units / groups;
  const int64_t u_hi = ((int64_t)blockIdx.x + 1) * units / groups;
  const int64_t d_lo = u_lo * kChans;
  const int cb = (int)(min(di, u_hi * kChans) - d_lo);  // the block's channels
  const int busy = (int)(u_hi - u_lo);                   // its consumer warps
  const int64_t row0 = (int64_t)blockIdx.y * S;  // the batch row's first (b, t) row
  const int64_t tiles = (S + kTile - 1) / kTile;
  // full[kStages], empty[kStages], landed[kStages]
  const uint32_t bars = smem_u32(smem);
  const uint32_t ring = bars + kBarBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 32);                // every producer lane
      mbar_init(bars + 8 * (kStages + s), busy);  // lane 0 of each consumer
      mbar_init(bars + 8 * (2 * kStages + s), 1); // the copies' bytes
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (w == busy) {  // the producer
    for (int64_t i = 0; i < tiles + kLag; ++i) {
      if (i < tiles) {
        const int s = (int)(i % kStages);
        const int steps = (int)min((int64_t)kTile, S - i * kTile);
        const uint32_t st = ring + s * L.stage;
        if (i >= kStages) mbar_wait(bars + 8 * (kStages + s), (uint32_t)((i / kStages - 1) & 1));
        // one tensor box of dt and of x (steps past S and columns past the
        // row arrive as zeros), and the aligned spans of b and c
        if (lane == 0) {
          const uint32_t bar = bars + 8 * (2 * kStages + s);
          const uintptr_t len = (uintptr_t)steps * n * ES;
          const uintptr_t ab = reinterpret_cast<uintptr_t>(bm + (row0 + i * kTile) * n);
          const uintptr_t ac = reinterpret_cast<uintptr_t>(cm + (row0 + i * kTile) * n);
          const uintptr_t b0 = ab & ~(uintptr_t)15, c0 = ac & ~(uintptr_t)15;
          const uint32_t nb = (uint32_t)(((ab + len + 15) & ~(uintptr_t)15) - b0);
          const uint32_t nc = (uint32_t)(((ac + len + 15) & ~(uintptr_t)15) - c0);
          mbar_expect_tx(bar, 2 * kTile * L.row + nb + nc);
          // the box starts on the 16-byte bound below the block's first
          // channel (a TMA box starts on one); the maps count 4-byte words
          const int word = (int)((d_lo * ES) & ~(int64_t)15) / 4;
          tma_box(st + L.dt, &tm_dt, bar, word, (int)(i * kTile), (int)blockIdx.y);
          tma_box(st + L.x, &tm_x, bar, word, (int)(i * kTile), (int)blockIdx.y);
          tma_bulk(st + L.b, b0, nb, bar);
          tma_bulk(st + L.c, c0, nc, bar);
        }
      }
      const int64_t j = i - kLag;  // the tile to pack: its copies are done
      if (j < 0) continue;
      const int s = (int)(j % kStages);
      mbar_wait(bars + 8 * (2 * kStages + s), (uint32_t)((j / kStages) & 1));
      const int steps = (int)min((int64_t)kTile, S - j * kTile);
      const unsigned char* st = smem + kBarBytes + s * L.stage;
      const uintptr_t ob = reinterpret_cast<uintptr_t>(bm + (row0 + j * kTile) * n) & 15;
      const uintptr_t oc = reinterpret_cast<uintptr_t>(cm + (row0 + j * kTile) * n) & 15;
      const T* rb = reinterpret_cast<const T*>(st + L.b + ob) + lane * n;
      const T* rc = reinterpret_cast<const T*>(st + L.c + oc) + lane * n;
      // lane s packs step s's (b, c) pairs, zero past n and past S: rows of
      // exactly kLanes M = 16 values on 16-byte bounds (hymba's) in 16-byte
      // loads
      P* bc = reinterpret_cast<P*>(const_cast<unsigned char*>(st) + L.bc + lane * L.pair_row);
      if (lane < steps && n == kLanes * M && (ob | oc | (n * ES) % 16) == 0) {
        E::template pack_row<kLanes * M>(rb, rc, bc);
      } else {
#pragma unroll
        for (int k = 0; k < kLanes * M; ++k) {
          const bool on = lane < steps && k < n;
          bc[k] = on ? E::pack(rb[on ? k : 0], rc[on ? k : 0]) : E::zero();
        }
      }
      mbar_arrive(bars + 8 * s);  // releases this lane's writes and copies
    }
    return;
  }
  if (w > busy) return;

  // the scan's lane: channel c of the warp, states l M .. l M + M - 1
  const int c = lane / kLanes, l = lane % kLanes, ch = w * kChans + c;
  float a2[M], h[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = l * M + k;
    a2[k] = 0.f, h[k] = 0.f;
    if (ch < cb && j < n) {
      const float a = -expf(E::widen(a_log[(d_lo + ch) * n + j]));
      const float v = __fmul_rn(a, kLog2e);
      a2[k] = isinf(v) && !isinf(a) ? -FLT_MAX : v;
    }
  }
  float* pre = reinterpret_cast<float*>(smem + L.pre) + w * 2 * kChans * kPreRow;
  float* red = reinterpret_cast<float*>(smem + L.red) + w * 2 * 32 * kRow;
  // the (dt, dt x) lane: channel pc of the warp (clamped into the block's
  // row slot: its values are zeroed past cb), steps 4 q .. 4 q + 3
  const int pc = lane % kChans, q = lane / kChans, pch = w * kChans + pc;
  // the block's first channel's offset in a row slot (rows on 16-byte bounds)
  const uint32_t off = (uint32_t)(d_lo * ES) & 15;
  // tile i's (dt, dt x) into buffer i & 1 of pre: zero past cb, past S and
  // past the last tile (whose stage then is stale, and unread)
  auto form = [&](int64_t i) {
    const int64_t t0 = i * kTile;
    const int steps = i < tiles ? (int)min((int64_t)kTile, S - t0) : 0;
    const unsigned char* st = smem + kBarBytes + (int)(i % kStages) * L.stage;
    float v[2 * kStepsPerLane];
#pragma unroll
    for (int k = 0; k < kStepsPerLane; ++k) {
      const int ss = kStepsPerLane * q + k;
      const unsigned char* slot = st + (uint32_t)ss * L.row + pch * ES + off;
      const float f = E::widen(*reinterpret_cast<const T*>(slot + L.dt));
      const float xv = E::widen(*reinterpret_cast<const T*>(slot + L.x));
      const bool on = pch < cb && ss < steps;
      v[2 * k] = on ? f : 0.f;
      v[2 * k + 1] = on ? E::round(__fmul_rn(f, xv)) : 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(pre + ((int)(i & 1) * kChans + pc) * kPreRow +
                                            2 * kStepsPerLane * q);
#pragma unroll
    for (int k = 0; k < kStepsPerLane / 2; ++k)
      dst[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  };

  mbar_wait(bars, 0);
  form(0);
  for (int64_t i = 0; i <= tiles; ++i) {
    const int s = (int)(i % kStages);
    const int64_t t0 = i * kTile;
    if (i + 1 < tiles)
      mbar_wait(bars + 8 * ((i + 1) % kStages), (uint32_t)(((i + 1) / kStages) & 1));
    __syncwarp();

    // One block of code, no branch: tile i's steps (past S: dt = dt x = 0,
    // so h holds; past the last tile they run on a stale stage and are
    // dropped), y of tile i - 1's steps 8 l .. 8 l + 7 of channel ch, its 4
    // lanes' parts summed in a fixed order (before the first tile the
    // stores are off), and tile i + 1's (dt, dt x).  None waits on another,
    // so each fills the others' gaps.
    float part[kTile];
    {
      const P* bc = reinterpret_cast<const P*>(smem + kBarBytes + s * L.stage + L.bc) + l * M;
      const float* pr = pre + ((int)(i & 1) * kChans + c) * kPreRow;
#pragma unroll
      for (int s2 = 0; s2 < kTile; s2 += 2) {
        const float4 p = *reinterpret_cast<const float4*>(pr + 2 * s2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ss = s2 + e;
          const float dtv = e ? p.z : p.x, dtx = e ? p.w : p.y;
          P pairs[M];
          E::load(reinterpret_cast<const P*>(
              reinterpret_cast<const unsigned char*>(bc) + ss * L.pair_row), pairs);
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < M; ++k) {
            const float decay = ex2(__fmul_rn(dtv, a2[k]));
            h[k] = __fmaf_rn(decay, h[k], __fmul_rn(dtx, E::b_of(pairs[k])));
            acc = k == 0 ? __fmul_rn(h[k], E::c_of(pairs[k]))
                         : __fmaf_rn(E::c_of(pairs[k]), h[k], acc);
          }
          part[ss] = acc;
        }
      }
      const float* rp =
          red + ((int)((i + 1) & 1) * 32 + c * kLanes) * kRow + kStepsPerLane * l;
      float sum[kStepsPerLane];
#pragma unroll
      for (int k = 0; k < kStepsPerLane; k += 4) {
        float4 v[kLanes];
#pragma unroll
        for (int u = 0; u < kLanes; ++u) v[u] = *reinterpret_cast<const float4*>(rp + u * kRow + k);
#pragma unroll
        for (int width = 1; width < kLanes; width *= 2)  // pairwise in lane order
#pragma unroll
          for (int u = 0; u < kLanes; u += 2 * width)
            v[u] = make_float4(
                __fadd_rn(v[u].x, v[u + width].x), __fadd_rn(v[u].y, v[u + width].y),
                __fadd_rn(v[u].z, v[u + width].z), __fadd_rn(v[u].w, v[u + width].w));
        sum[k] = v[0].x, sum[k + 1] = v[0].y, sum[k + 2] = v[0].z, sum[k + 3] = v[0].w;
      }
      const int64_t t1 = t0 - kTile + kStepsPerLane * l;  // tile i - 1's step
      const int64_t done = i > 0 && ch < cb ? min((int64_t)kStepsPerLane, S - t1) : 0;
      float* yp = y + (row0 + t1) * di + d_lo + ch;
#pragma unroll
      for (int k = 0; k < kStepsPerLane; ++k)
        if (k < done) yp[k * di] = sum[k];
      form(i + 1);
    }
    if (i == tiles) break;
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));  // stage i is read
    float* rw = red + ((int)(i & 1) * 32 + lane) * kRow;
#pragma unroll
    for (int s4 = 0; s4 < kTile; s4 += 4)
      *reinterpret_cast<float4*>(rw + s4) =
          make_float4(part[s4], part[s4 + 1], part[s4 + 2], part[s4 + 3]);
  }
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

// ld: elements between rows of x and dt, ld E a multiple of 16 and their
// bases 16-byte aligned (the TMA's bounds); warps: consumer warps a block,
// at least the largest block's units
template <typename T>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const void* a_log,
           void* y, int64_t B, int64_t S, int64_t di, int64_t ld, int64_t n, int64_t groups,
           int64_t warps, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaSuccess;
  const int64_t units = (di + kChans - 1) / kChans;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt);
  if (n < 1 || n > kMaxState || warps < 1 || warps > kMaxWarps || groups < 1 ||
      groups > units || groups > 0x7fffffff || B > 65535 || S > 0x7fffffff || ld < di ||
      (ld * (int64_t)sizeof(T)) % 16 != 0 || (bases & 15) != 0 ||
      (units + groups - 1) / groups > warps)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn;
  int err = encode_fn(&fn);
  if (err != 0) return err;
  const Smem L = smem_layout((int)warps, (int)n, kSlots, (int)sizeof(T),
                             (int)sizeof(typename Elem<T>::Pair));
  CUtensorMap tm_x, tm_dt;
  if ((err = encode<T>(fn, &tm_x, x, B, S, ld, L.box)) != 0) return err;
  if ((err = encode<T>(fn, &tm_dt, dt, B, S, ld, L.box)) != 0) return err;
  auto kernel = selective_scan_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)groups, (unsigned)B), (unsigned)((warps + 1) * 32), L.total,
           static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_dt, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(a_log), static_cast<float*>(y), S, di, (int)n, groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_selective_scan_f32(const void* x, const void* dt, const void* bm, const void* cm,
                             const void* a_log, void* y, int64_t B, int64_t S, int64_t di,
                             int64_t ld, int64_t n, int64_t groups, int64_t warps,
                             void* stream) {
  return launch<float>(x, dt, bm, cm, a_log, y, B, S, di, ld, n, groups, warps, stream);
}

int repro_selective_scan_bf16(const void* x, const void* dt, const void* bm, const void* cm,
                              const void* a_log, void* y, int64_t B, int64_t S, int64_t di,
                              int64_t ld, int64_t n, int64_t groups, int64_t warps,
                              void* stream) {
  return launch<uint16_t>(x, dt, bm, cm, a_log, y, B, S, di, ld, n, groups, warps, stream);
}

}  // extern "C"
