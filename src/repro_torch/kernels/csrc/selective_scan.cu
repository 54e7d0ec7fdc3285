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
// Under autograd the wrapper launches selective_scan_save_kernel: the same
// body (scan_block<T, true>, the same y bit for bit) that also stores h at
// each tile's start, the checkpoints that selective_scan_bwd.cu recomputes
// a tile's states from; selective_scan_kernel (scan_block<T, false>, the
// launch that serves) stores none.
// No block-wide barrier inside the loop: warps meet only on the ring's
// mbarriers.  No atomics and fixed orders: the same inputs give the same bits
// from run to run.  Decays below 2^-126 flush to 0 (ftz) where expf keeps a
// subnormal: a finite state moves by under 2^-126 of itself, and a state
// that is already infinite becomes NaN where the plain loop keeps an inf.
// So an output is non-finite where the plain loop's is, but an inf there may
// read NaN here.  An a that overflows a2 is held at -FLT_MAX (dt = 0 still
// gives a decay of 1).
#include "scan.cuh"

namespace {

constexpr int kStages = 8;             // the ring's tiles
constexpr int kLag = 2;                // tiles in flight before the producer packs one
constexpr int kStepsPerLane = kTile / kLanes;  // steps of y each lane sums
constexpr int kRow = kTile + 4;        // floats of a lane's parts of y, padded off the banks
constexpr int kPreRow = 2 * kTile + 4; // floats of a channel's (dt, dt x) pairs, padded
static_assert(kTile == 32 && kStepsPerLane == 4, "one row a producer lane; 4 steps of y a lane");
static_assert(kLag < kStages, "the producer reuses a stage only after packing its tile");
static_assert(3 * 8 * kStages <= kBarBytes, "the mbarriers fit their bytes");

// byte offsets of a block's shared memory (kernels/scan/ops.py::smem_bytes
// sums the same): the ring's mbarriers; kStages stages, each the raw dt and
// x rows of a tile (a row slot holds the block's channels widened to
// 16-byte bounds), its raw b and c and its packed (b, c) pairs (a step's row
// padded by 16 bytes, off the banks); a consumer warp's (dt, dt x) of each
// step and its lanes' parts of y, each double-buffered
struct Smem {
  uint32_t row, box, tile, pairs, pair_row, stage, dt, x, b, c, bc, pre, red, total;
};

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

// grid (groups, B); block g holds the units [g U / groups, (g + 1) U /
// groups) of kChans channels (U = ceil(di / kChans)) of batch row
// blockIdx.y: warps 0 .. busy - 1 consume (one a unit), warp `busy`
// produces; dt and x arrive through the tensor maps tm_dt and tm_x.  With
// kSave the consumers also store each tile's starting state into ckpt
// (B, ceil(S / kTile), di, n) fp32, the backward's checkpoints; without it
// (selective_scan_kernel, the launch that serves) ckpt is not touched.
template <typename T, bool kSave>
__device__ __forceinline__ void scan_block(
    const CUtensorMap& tm_x, const CUtensorMap& tm_dt, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ a_log, float* __restrict__ y,
    float* __restrict__ ckpt, int64_t S, int64_t di, int n, int64_t groups,
    unsigned char* smem) {
  using E = Elem<T>;
  using P = typename E::Pair;
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
    if constexpr (kSave) {  // h is tile i's starting state
      if (i < tiles && ch < cb) {
        float* cp = ckpt + (((int64_t)blockIdx.y * tiles + i) * di + d_lo + ch) * n;
#pragma unroll
        for (int k = 0; k < M; ++k)
          if (l * M + k < n) cp[l * M + k] = h[k];
      }
    }
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

template <typename T>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 1) selective_scan_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dt,
    const T* __restrict__ bm, const T* __restrict__ cm, const T* __restrict__ a_log,
    float* __restrict__ y, float* __restrict__ ckpt, int64_t S, int64_t di, int n,
    int64_t groups) {  // ckpt unused: the saving variant's signature
  extern __shared__ __align__(128) unsigned char smem[];
  scan_block<T, false>(tm_x, tm_dt, bm, cm, a_log, y, nullptr, S, di, n, groups, smem);
}

template <typename T>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 1) selective_scan_save_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dt,
    const T* __restrict__ bm, const T* __restrict__ cm, const T* __restrict__ a_log,
    float* __restrict__ y, float* __restrict__ ckpt, int64_t S, int64_t di, int n,
    int64_t groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  scan_block<T, true>(tm_x, tm_dt, bm, cm, a_log, y, ckpt, S, di, n, groups, smem);
}


// ld: elements between rows of x and dt, ld E a multiple of 16 and their
// bases 16-byte aligned (the TMA's bounds); warps: consumer warps a block,
// at least the largest block's units; ckpt: null, or the (B, ceil(S /
// kTile), di, n) fp32 checkpoints the saving kernel fills
template <typename T>
int launch(const void* x, const void* dt, const void* bm, const void* cm, const void* a_log,
           void* y, void* ckpt, int64_t B, int64_t S, int64_t di, int64_t ld, int64_t n,
           int64_t groups, int64_t warps, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaSuccess;
  const int64_t units = (di + kChans - 1) / kChans;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt);
  if (n < 1 || n > kMaxState || warps < 1 || warps > kMaxWarps || groups < 1 ||
      groups > units || groups > 0x7fffffff || B > 65535 || S > 0x7fffffff || ld < di ||
      (ld * (int64_t)sizeof(T)) % 16 != 0 || (bases & 15) != 0 ||
      (units + groups - 1) / groups > warps)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn;
  int err = ckpt != nullptr ? context_current() : 0;  // the saving forward runs under autograd
  if (err != 0 || (err = encode_fn(&fn)) != 0) return err;
  const Smem L = smem_layout((int)warps, (int)n, kSlots, (int)sizeof(T),
                             (int)sizeof(typename Elem<T>::Pair));
  CUtensorMap tm_x, tm_dt;
  if ((err = encode<T>(fn, &tm_x, x, B, S, ld, L.box)) != 0) return err;
  if ((err = encode<T>(fn, &tm_dt, dt, B, S, ld, L.box)) != 0) return err;
  const dim3 grid((unsigned)groups, (unsigned)B);
  const unsigned threads = (unsigned)((warps + 1) * 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = ckpt == nullptr ? selective_scan_kernel<T> : selective_scan_save_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, L.total, st>>>(
      tm_x, tm_dt, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(a_log), static_cast<float*>(y), static_cast<float*>(ckpt), S, di,
      (int)n, groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ckpt: null for the serving launch (selective_scan_kernel), else the
// checkpoints the saving launch fills (selective_scan_save_kernel)
int repro_selective_scan_f32(const void* x, const void* dt, const void* bm, const void* cm,
                             const void* a_log, void* y, void* ckpt, int64_t B, int64_t S,
                             int64_t di, int64_t ld, int64_t n, int64_t groups, int64_t warps,
                             void* stream) {
  return launch<float>(x, dt, bm, cm, a_log, y, ckpt, B, S, di, ld, n, groups, warps, stream);
}

int repro_selective_scan_bf16(const void* x, const void* dt, const void* bm, const void* cm,
                              const void* a_log, void* y, void* ckpt, int64_t B, int64_t S,
                              int64_t di, int64_t ld, int64_t n, int64_t groups, int64_t warps,
                              void* stream) {
  return launch<uint16_t>(x, dt, bm, cm, a_log, y, ckpt, B, S, di, ld, n, groups, warps,
                          stream);
}

}  // extern "C"
