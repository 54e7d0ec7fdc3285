// selective_scan_bwd: the gradient of the selective scan (selective_scan.cu)
// over x, dt (B, S, di), b, c (B, S, n), a_log (di, n) and dy (B, S, di)
// fp32, the gradient of y.  With u = round(dt x), a = -exp(a_log) and the
// forward's h (h[t] = exp(dt[t] a) h[t-1] + u[t] b[t]), time walks back:
//
//     g[t, d, j]  = dy[t, d] c[t, j] + exp(dt[t+1, d] a[d, j]) g[t+1, d, j]
//     dc[t, j]    = sum_d dy[t, d] h[t, d, j]
//     db[t, j]    = sum_d g[t, d, j] u[t, d]
//     du[t, d]    = sum_j g[t, d, j] b[t, j]
//     ddt[t, d]   = du[t, d] x[t, d] + sum_j g h[t-1] exp(dt[t] a) a   (the decay's part)
//     dx[t, d]    = du[t, d] dt[t, d]
//     da_log[d, j] = a[d, j] sum_{B, t} g h[t-1] exp(dt[t] a) dt[t]
//
// The rounding of u passes the gradient through, as a cast does: du is
// rounded to the inputs' dtype, each product of it (dx, and ddt's first
// part) is rounded, and so is the decay's part before the two are added,
// as autograd rounds them in bf16 (in fp32 every rounding is exact).
// Everything else is fp32, and each gradient is returned in its input's
// dtype.
//
// Replaces no TPU kernel: the reference trains hymba through jax.grad of
// src/repro/models/ssm.py:87, the XLA associative scan, whose transpose XLA
// derives (a reverse associative scan over (B, S, di, n) fp32 tensors).
//
// Bound on the H100, at hymba's (1, 32768, 3200, 16) in bf16: the fp32
// issue, 0.60 ms.  The operations a (t, d, j), besides its exp, are 12
// fp32 instructions, each an FMA or a product (the recompute of h 3, the
// reverse step 9, db's and dc's sums over the channels an fma each), 1.68e9
// (t, d, j) there: 0.60 ms at 128 a clock on 132 SMs at 1.98 GHz (as FLOPs,
// an FMA two, 19 a (t, d, j): 0.48 ms at 67 TFLOP/s); the exps B S di n,
// 0.40 ms at 16 a clock (as for the forward); the bytes the function moves,
// x, dt, dy (fp32), b, c and a_log read, the checkpoints (4 n bytes a
// channel every kTile steps) read, dx, ddt, db, dc and da_log written, 1.47
// GB, 0.44 ms at 3.35 TB/s.  The blocks' partials of db and dc (2 groups B
// S n fp32, written and read again) are this design's scratch, not the
// function's bytes.  At the train shape (2, 2048, 3200, 16) the issue bounds
// bf16 (0.075 ms) and the bytes fp32 (0.087 ms);
// chip_smoke.py::scan_bwd_bound computes each row's.
//
// What paced the first design (one block an SM of 7 consumer warps, each
// tile's 33 states and 32 decays a lane in registers, the walk unrolled over
// the whole tile): its code, 8976 SASS instructions (143 KB) in bf16, and
// two warps a scheduler to hide the latencies; measured by clock64() stamps
// on the H100, a 32-step tile took ~34,900 clocks a warp, the recompute
// ~270 a step and every phase far above its issue.  This design:
//   - two blocks an SM (__launch_bounds__ with kBlocksPerSm) of at most
//     kBwdWarps warps, no producer warp: 14 warps an SM where the plan
//     gives two blocks of 7, 4 on two of an SM's schedulers, so at most 128
//     registers a thread (a producer warp as well left the walk 128 and it
//     spilled); the groups' starting states and da wait in shared memory;
//   - the forward's lanes (kLanes = 8 lanes a channel, kSlots = 2 states a
//     lane, kChans = 4 channels a warp, a block a range of whole units of a
//     batch row, one warp a unit);
//   - thread 0 stages tile i into stage r % kStages (r = the tiles walked
//     so far: the tiles arrive in reverse order) once the barrier after
//     tile r - kStages has freed it, by TMA: one tensor box each of dt, x
//     and dy (rows `ld` and `ldy` elements apart on 16-byte bounds: the
//     wrapper copies rows that are not) and one bulk copy each of the
//     tile's b and c;
//   - a warp forms its channels' (dt, u) once a step into shared memory; a
//     lane loads the tile's starting state from the checkpoints the saving
//     forward stored (selective_scan_save_kernel) and runs the tile forward
//     to the starts of its kGroups groups of kGroup steps; then, group by
//     group from the last, it recomputes the group's 9 states into
//     registers and walks the group back with g carried in registers.  The
//     recompute uses the forward's instructions, so the states are the
//     forward's bits; each decay is taken in the first run, the group's
//     recompute and the walk (three exps in place of one held in a
//     register), and the walk's unrolled body is one group, not the tile;
//   - two instances (kWhole): at n = kMaxState (hymba's) a lane reads its
//     two states of b and c in one load each, unguarded (a short last
//     tile's rows past S zeroed first); at any n value by value, guarded;
//   - du and the decay's part of ddt sum a lane's states in order; a
//     channel's 8 lanes sum them pairwise in lane order, ((p0 + p1) + (p2 +
//     p3)) + ((p4 + p5) + (p6 + p7)), scattered by shuffles as the walk
//     goes (xor 1 after each pair of steps, xor 2 after each four, xor 4
//     at the group's end, each lane keeping half of what it holds), so that
//     lane l ends with step l's du and ddt part; it forms that step's dx
//     and ddt into the block's tile of rows in shared memory;
//   - each step's db and dc parts sum over the warp's 4 channels by
//     shuffles, ((c0 + c1) + (c2 + c3)) (xor 8 keeps db or dc, xor 16 one
//     state of two), and each lane stores one of the warp's 32 sums, after
//     the next step's loads (a store before them would hold them back);
//   - after the tile one barrier of the block's warps; then they sum each
//     (step, state) of db and dc over the warps pairwise in warp order,
//     ((w0 + w1) + (w2 + w3)) + ((w4 + w5) + (w6 + 0)) (with the warps' own
//     sums, the first design's pairwise sum over the block's channels, bit
//     for bit), write the block's partial to `part` (2, groups, B, S, n)
//     fp32, and store the tile's dx and ddt rows, a unit of 4 channels a
//     thread where di is a multiple of 4.  The sums and the rows of a tile
//     are double-buffered, so the next tile's walk overlaps them;
//   - da sums in a lane's registers over each tile's steps (in reverse
//     order), the tiles' sums compensated (Kahan), and is written once, to
//     `da_part` (B, di, n) fp32.
// Measured on the H100 at hymba's train shape, a tile takes ~15,000-17,000
// clocks a warp at 14 warps an SM, the walk about a third of it.
// A second launch (selective_scan_bwd_sum_kernel) sums the partials: db and
// dc over the groups in block order, compensated, da over the batch rows in
// order (then da_log = da a), each rounded once to the input's dtype.  No
// atomics and fixed orders: the same inputs give the same bits from run to
// run, and at the same plan the first design's bits.  (Sequential fp32 sums
// over a block's channels, the groups and S steps took several times the
// plain backward's error against fp64.)
// Non-finite values: a gradient is non-finite where the plain backward's is
// (kernels/scan/ref.py::selective_scan_bwd_ref: the same products, summed in
// another order), but an inf there may read NaN: decays below 2^-126 flush
// to 0, as in the forward, and 0 x inf is NaN.
#include <type_traits>

#include "scan.cuh"

namespace {

constexpr int kStages = 2;       // the ring's tiles
constexpr int kBwdWarps = 7;     // warps a block at most
constexpr int kBlocksPerSm = 2;  // blocks an SM: 2 x 7 warps, at most 128 registers a thread
constexpr int kGroup = 8;        // steps a group: the walk's unrolled body
constexpr int kGroups = kTile / kGroup;
constexpr int kFmRow = kTile + 2;  // (dt, u) pairs of a channel, padded off the banks
constexpr int kSums = 2 * kMaxState;  // a warp's db and dc sums of a step
constexpr int kWarpLeaves = 8;   // the pairwise sum over a block's warps, padded
static_assert(kBwdWarps <= kWarpLeaves, "a block's warps fit the sum's leaves");
static_assert(kGroup == kLanes, "a group's steps scatter one to a lane of the channel");
static_assert(kGroup >= kSlots, "a group's starting state parks in its own steps");
static_assert(2 * 8 * kStages <= kBarBytes, "the mbarriers fit their bytes");

// byte offsets of a block's shared memory (exported by
// repro_selective_scan_bwd_layout; kernels/scan/ops.py::bwd_smem_bytes sums
// the same for the host): the ring's mbarriers (landed x kStages);
// kStages stages, each a tile's raw dt, x and dy rows (a row slot holds the
// block's channels from the 16-byte bound below the first) and its raw b
// and c; each warp's (dt, u) of its channels' steps; then, double-buffered,
// the warps' db and dc sums of a tile ([warp][step][kSums]) and the tile's
// dx and ddt rows of the block's channels ([dx | ddt][step][channel], in
// the inputs' dtype); each lane's da and its compensation (kept out of the
// registers, which the walk needs: 14 warps an SM put 4 on a scheduler, at
// most 128 registers a thread)
struct BwdSmem {
  uint32_t row, box, rowf, boxf, tile, stage, dt, x, dy, b, c, fm, red, out, orow, da, total;
};

__host__ __device__ inline BwdSmem bwd_layout(int warps, int n, int elem) {
  BwdSmem s;
  s.row = ((warps * kChans * elem + 15) & ~15) + 16;
  s.box = s.row / 4;
  s.rowf = (warps * kChans * 4 + 15) & ~15;  // dy's rows start on the block's first channel
  s.boxf = s.rowf / 4;
  s.tile = ((kTile * n * elem + 15) & ~15) + 16;
  uint32_t o = 0;
  s.dt = o, o = align128(o + kTile * s.row);
  s.x = o, o = align128(o + kTile * s.row);
  s.dy = o, o = align128(o + kTile * s.rowf);
  s.b = o, o += s.tile;
  s.c = o, o += s.tile;
  s.stage = align128(o);
  o = kBarBytes + kStages * s.stage;  // after the mbarriers
  s.fm = o, o += warps * kChans * kFmRow * 8;
  s.red = o, o += 2 * warps * kTile * kSums * 4;
  s.orow = warps * kChans * elem;
  s.out = o, o += 2 * 2 * kTile * s.orow;
  s.da = o, o += warps * 32 * 2 * kSlots * 4;
  s.total = o;
  return s;
}

// the block's busy warps meet (named barrier 1: its idle warps have left)
__device__ __forceinline__ void busy_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// a lane keeps v[i] if `hi` is false, else v[j], and adds what its partner
// (lane ^ width) keeps of the same pair: both lanes hold the pair's sum, the
// lower lane's value first (fp32 addition commutes, so the bits are the
// same on either side)
__device__ __forceinline__ float keep_add(float vi, float vj, bool hi, int width) {
  const float keep = hi ? vj : vi, send = hi ? vi : vj;
  return __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, width));
}

// a lane's kSlots consecutive values of a staged b or c row (widened), at p
// on a 4-byte (bf16) or 8-byte (fp32) bound: one load
template <typename T>
__device__ __forceinline__ void load_slots(const T* p, float (&v)[kSlots]) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(w << 16), v[1] = __uint_as_float(w & 0xFFFF0000u);
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  }
}

// grid (groups, B), the forward's: block g holds the units [g U / groups,
// (g + 1) U / groups) of batch row blockIdx.y, warps 0 .. busy - 1 one
// each; thread 0 also issues the ring's copies.  kWhole: n = kMaxState, and
// b and c are read a lane's two states in one load (a short tile's rows
// past S zeroed first); else value by value, zero past n and past S.  Two
// instances, so that each takes the registers its own walk needs.
template <typename T, int kWhole>
__global__ void __launch_bounds__(kBwdWarps * 32, kBlocksPerSm) selective_scan_bwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dt,
    const __grid_constant__ CUtensorMap tm_dy, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ a_log, const float* __restrict__ ckpt,
    float* __restrict__ part, float* __restrict__ part_dc, float* __restrict__ da_part,
    T* __restrict__ dx, T* __restrict__ ddt, int64_t S, int64_t di, int n, int64_t groups) {
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ES = sizeof(T);
  constexpr int M = kSlots;
  const int warps = blockDim.x / 32;
  const BwdSmem L = bwd_layout(warps, n, ES);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t units = (di + kChans - 1) / kChans;
  const int64_t u_lo = (int64_t)blockIdx.x * units / groups;
  const int64_t u_hi = ((int64_t)blockIdx.x + 1) * units / groups;
  const int d_lo = (int)(u_lo * kChans);
  const int cb = (int)(min(di, u_hi * kChans) - d_lo);  // the block's channels
  const int busy = (int)(u_hi - u_lo);                   // its warps
  const int64_t row0 = (int64_t)blockIdx.y * S;  // the batch row's first (b, t) row
  const int tiles = (int)((S + kTile - 1) / kTile);
  const uint32_t bars = smem_u32(smem);  // landed[kStages]: the copies' bytes
  const uint32_t ring = bars + kBarBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (w >= busy) return;

  // tile tiles - 1 - r (the tiles arrive in reverse order) into stage r %
  // kStages, by TMA: one tensor box each of dt, x and dy, starting on the
  // 16-byte bound below the block's first channel (dy's, fp32, is one: d_lo
  // is a multiple of kChans; the maps count 4-byte words), and one bulk copy
  // each of its b and c.  Thread 0 issues tile r + kStages once the
  // warps' barrier after tile r has freed its stage.
  auto issue = [&](int r) {
    if (r >= tiles) return;
    const int64_t t0 = (int64_t)(tiles - 1 - r) * kTile;
    const int s = r % kStages;
    const int steps = (int)min((int64_t)kTile, S - t0);
    const uint32_t st = ring + s * L.stage, bar = bars + 8 * s;
    const int word = ((d_lo * ES) & ~15) / 4;
    const uintptr_t len = (uintptr_t)steps * n * ES;
    const uintptr_t ab = reinterpret_cast<uintptr_t>(bm + (row0 + t0) * n);
    const uintptr_t ac = reinterpret_cast<uintptr_t>(cm + (row0 + t0) * n);
    const uintptr_t b0 = ab & ~(uintptr_t)15, c0 = ac & ~(uintptr_t)15;
    const uint32_t nb = (uint32_t)(((ab + len + 15) & ~(uintptr_t)15) - b0);
    const uint32_t nc = (uint32_t)(((ac + len + 15) & ~(uintptr_t)15) - c0);
    mbar_expect_tx(bar, 2 * kTile * L.row + kTile * L.rowf + nb + nc);
    tma_box(st + L.dt, &tm_dt, bar, word, (int)t0, (int)blockIdx.y);
    tma_box(st + L.x, &tm_x, bar, word, (int)t0, (int)blockIdx.y);
    tma_box(st + L.dy, &tm_dy, bar, d_lo, (int)t0, (int)blockIdx.y);
    tma_bulk(st + L.b, b0, nb, bar);
    tma_bulk(st + L.c, c0, nc, bar);
  };
  if (threadIdx.x == 0)
    for (int r = 0; r < kStages; ++r) issue(r);

  // the lane: channel c of the warp, states l M .. l M + M - 1
  const int c = lane / kLanes, l = lane % kLanes, ch = w * kChans + c;
  const bool live = ch < cb;
  const int64_t d = (int64_t)d_lo + ch;
  // da: each tile's sum over its steps, then the tiles' sums compensated
  // (Kahan, the error of a sum of S / kTile terms held near one rounding),
  // in the lane's own shared memory: da[k] at k 32, its compensation at (M + k) 32
  float* da = reinterpret_cast<float*>(smem + L.da) + w * 32 * 2 * M + lane;
  float a[M], a2[M], carry[M], next[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = l * M + k;
    a[k] = 0.f, a2[k] = 0.f, da[k * 32] = 0.f, da[(M + k) * 32] = 0.f, carry[k] = 0.f;
    if (live && j < n) {
      a[k] = -expf(E::widen(a_log[d * n + j]));
      const float v = __fmul_rn(a[k], kLog2e);
      a2[k] = isinf(v) && !isinf(a[k]) ? -FLT_MAX : v;
    }
  }
  // the checkpoint of tile i: its starting state (zero past cb and n)
  auto load_state = [&](int i, float (&h0)[M]) {
    const float* cp = ckpt + (((int64_t)blockIdx.y * tiles + i) * di + d) * n + l * M;
#pragma unroll
    for (int k = 0; k < M; ++k) h0[k] = live && l * M + k < n ? cp[k] : 0.f;
  };
  const uint32_t off = (uint32_t)(d_lo * ES) & 15;  // the first channel's offset in a row slot
  const int rowf = (int)L.rowf / 4;
  float2* fm = reinterpret_cast<float2*>(smem + L.fm) + w * kChans * kFmRow;  // the warp's (dt, u)
  const float2* fmc = fm + c * kFmRow;                                        // the lane's channel's
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int red_buf = warps * kTile * kSums;  // a buffer's floats
  // the lane's one of the warp's kSums sums of a step: db (c even) or dc
  // (c odd) of state l M + c / 2
  float* red_w = red + w * kTile * kSums + (c & 1) * kMaxState + l * M + (c >> 1);
  const int threads = busy * 32;  // the busy warps' threads
  const int64_t bsn = (int64_t)gridDim.y * S * n;
  const bool whole_units = di % kChans == 0;  // rows stored a unit of kChans channels a thread

  load_state(tiles - 1, next);
  for (int r = 0; r < tiles; ++r) {
    const int i = tiles - 1 - r;
    const int s = r % kStages, buf = r & 1;
    const int t0 = i * kTile;
    const int steps = (int)min((int64_t)kTile, S - t0);
    mbar_wait(bars + 8 * s, (uint32_t)((r / kStages) & 1));
    const unsigned char* st = smem + kBarBytes + s * L.stage;
    const uintptr_t ob = reinterpret_cast<uintptr_t>(bm + (row0 + t0) * n) & 15;
    const uintptr_t oc = reinterpret_cast<uintptr_t>(cm + (row0 + t0) * n) & 15;
    const T* rb = reinterpret_cast<const T*>(st + L.b + ob);
    const T* rc = reinterpret_cast<const T*>(st + L.c + oc);
    const unsigned char* sx = st + L.x + ch * ES + off;
    const float* sdy = reinterpret_cast<const float*>(st + L.dy) + ch;

    if constexpr (kWhole) {
      if (steps < kTile) {  // a short tile: its rows of b and c past S read as zeros
        T* zb = const_cast<T*>(rb);
        T* zc = const_cast<T*>(rc);
        for (int o = steps * kMaxState + lane; o < kTile * kMaxState; o += 32) zb[o] = zc[o] = T(0);
        // before the ring's next copy into the stage
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
    }
    // the warp's (dt, u) of each step, once: lane (q, p) forms channel p's
    // steps 4 q .. 4 q + 3 (past S dt = x = 0)
    {
      const int p = lane % kChans, q = lane / kChans;
      const unsigned char* slot = st + (w * kChans + p) * ES + off;
#pragma unroll
      for (int k = 0; k < kTile / 8; ++k) {
        const int ss = (kTile / 8) * q + k;
        const float dtv = E::widen(*reinterpret_cast<const T*>(slot + L.dt + ss * L.row));
        const float xv = E::widen(*reinterpret_cast<const T*>(slot + L.x + ss * L.row));
        fm[p * kFmRow + ss] = make_float2(dtv, E::round(__fmul_rn(dtv, xv)));
      }
    }
    __syncwarp();

    // group g's starting state, parked in the lane's own slots of this
    // tile's db and dc sums at the group's first M steps, which only the
    // group's walk writes, after its recompute has read them
    auto parked = [&](int g, int k) {
      return red_w + buf * red_buf + (kGroup * g + k) * kSums;
    };
    // b and c of step ss: the lane's two states
    auto load = [&](const T* row, int ss, float (&v)[M]) {
      if constexpr (kWhole) {
        load_slots(row + ss * kMaxState + l * M, v);
      } else {
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const int j = l * M + k;
          const bool on = ss < steps && j < n;
          v[k] = on ? E::widen(row[on ? ss * n + j : 0]) : 0.f;
        }
      }
    };
    float dat[M] = {0.f, 0.f};  // da of this tile's steps
    // the tile's states, as the forward took them, up to the last group's
    // start (past S: dt = u = 0 and b = 0, so h holds)
    {
      float h[M] = {next[0], next[1]};
#pragma unroll
      for (int k = 0; k < M; ++k) *parked(0, k) = next[k];
#pragma unroll
      for (int ss = 0; ss < kTile - kGroup; ++ss) {
        const float2 p = fmc[ss];
        float bv[M];
        load(rb, ss, bv);
#pragma unroll
        for (int k = 0; k < M; ++k) {
          h[k] = __fmaf_rn(ex2(__fmul_rn(p.x, a2[k])), h[k], __fmul_rn(p.y, bv[k]));
          if ((ss + 1) % kGroup == 0) *parked((ss + 1) / kGroup, k) = h[k];
        }
      }
    }

    // back over the groups, g carried from the step after
#pragma unroll 1
    for (int gi = kGroups - 1; gi >= 0; --gi) {
      const int s0 = gi * kGroup;
      float hs[kGroup + 1][M];
#pragma unroll
      for (int k = 0; k < M; ++k)
        hs[0][k] = *parked(gi, k);
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        const int ss = s0 + e;
        const float2 p = fmc[ss];
        float bv[M];
        load(rb, ss, bv);
#pragma unroll
        for (int k = 0; k < M; ++k) {
          hs[e + 1][k] = __fmaf_rn(ex2(__fmul_rn(p.x, a2[k])), hs[e][k], __fmul_rn(p.y, bv[k]));
        }
      }
      // du and ddt's part of the group's steps over the channel's lanes,
      // pairwise in lane order, scattered as the walk goes: xor 1 after each
      // pair of steps, xor 2 after each four, xor 4 at the end, each lane
      // keeping half of what it holds; lane l keeps step s0 + l
      float du_o = 0.f, dd_o = 0.f, du1[kGroup / 2], dd1[kGroup / 2];
      float du2[kGroup / 4], dd2[kGroup / 4];
      float sums = 0.f;  // the step after's db or dc sum, stored after this step's loads
#pragma unroll
      for (int e = kGroup - 1; e >= 0; --e) {
        const int ss = s0 + e;
        const float2 p = fmc[ss];
        const float dtv = p.x, u = p.y;
        const float dyv = sdy[ss * rowf];
        float bv[M], cv[M];
        load(rb, ss, bv);
        load(rc, ss, cv);
        if (e < kGroup - 1) red_w[buf * red_buf + (ss + 1) * kSums] = sums;
        float du = 0.f, dd = 0.f, pb[M], pc[M];
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const float decay = ex2(__fmul_rn(dtv, a2[k]));  // as the recompute took it
          const float g = __fmaf_rn(dyv, cv[k], carry[k]);
          const float q = __fmul_rn(__fmul_rn(g, hs[e][k]), decay);  // g h[t-1] decay
          du = k == 0 ? __fmul_rn(g, bv[k]) : __fmaf_rn(g, bv[k], du);
          dd = k == 0 ? __fmul_rn(q, a[k]) : __fmaf_rn(q, a[k], dd);
          dat[k] = __fmaf_rn(q, dtv, dat[k]);
          carry[k] = __fmul_rn(decay, g);
          pb[k] = live ? __fmul_rn(g, u) : 0.f;
          pc[k] = live ? __fmul_rn(dyv, hs[e + 1][k]) : 0.f;
        }
        // db and dc over the warp's channels, ((c0 + c1) + (c2 + c3)): xor 8
        // keeps db (c even) or dc (c odd), xor 16 state l M or l M + 1
        const float v0 = keep_add(pb[0], pc[0], c & 1, 8);
        const float v1 = keep_add(pb[1], pc[1], c & 1, 8);
        sums = keep_add(v0, v1, c >> 1, 16);
        if (e % 2) {
          du_o = du, dd_o = dd;
        } else {
          du1[e / 2] = keep_add(du, du_o, l & 1, 1);
          dd1[e / 2] = keep_add(dd, dd_o, l & 1, 1);
          if (e % 4 == 0) {
            du2[e / 4] = keep_add(du1[e / 2], du1[e / 2 + 1], l & 2, 2);
            dd2[e / 4] = keep_add(dd1[e / 2], dd1[e / 2 + 1], l & 2, 2);
          }
        }
      }
      red_w[buf * red_buf + s0 * kSums] = sums;
      const float du3 = keep_add(du2[0], du2[1], l & 4, 4);
      const float dd3 = keep_add(dd2[0], dd2[1], l & 4, 4);
      const int ss = s0 + l;
      if (live && ss < steps) {  // step ss's dx and ddt into the block's rows
        const float dtv = fmc[ss].x;
        const float xv = E::widen(*reinterpret_cast<const T*>(sx + ss * L.row));
        const float du_r = E::round(du3), dd_r = E::round(dd3);
        T* o = reinterpret_cast<T*>(smem + L.out + ((buf * 2) * kTile + ss) * L.orow) + ch;
        o[0] = E::narrow(__fmul_rn(du_r, dtv));
        o[kTile * L.orow / ES] = E::narrow(__fadd_rn(E::round(__fmul_rn(du_r, xv)), dd_r));
      }
    }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float acc = da[k * 32], y = __fsub_rn(dat[k], da[(M + k) * 32]);
      const float t = __fadd_rn(acc, y);
      da[(M + k) * 32] = __fsub_rn(__fsub_rn(t, acc), y), da[k * 32] = t;
    }
    busy_sync(threads);
    if (threadIdx.x == 0) issue(r + kStages);  // every warp has read stage s
    if (i > 0) load_state(i - 1, next);  // the next tile's starting state

    // the block's partials of db and dc: its warps' sums pairwise in warp
    // order over kWarpLeaves leaves (zero past its warps), which with the
    // warps' sums is its channels pairwise in channel order.  Warp w sums
    // steps w, w + busy, ...: lane t slot t of the step (db, then dc, of
    // state t % kMaxState), contiguous in shared memory
    const float* rs = red + buf * red_buf + threadIdx.x % kSums;
    float* pw = (threadIdx.x / kMaxState % 2 ? part_dc : part) + (int64_t)blockIdx.x * bsn +
                (row0 + t0) * n + threadIdx.x % kMaxState;
    const bool state = (int)(threadIdx.x % kMaxState) < n;
    for (int row = threadIdx.x / kSums; row < steps; row += threads / kSums) {
      float v[kWarpLeaves];
#pragma unroll
      for (int q = 0; q < kWarpLeaves; ++q) v[q] = q < busy ? rs[(q * kTile + row) * kSums] : 0.f;
#pragma unroll
      for (int width = 1; width < kWarpLeaves; width *= 2)
#pragma unroll
        for (int q = 0; q < kWarpLeaves; q += 2 * width) v[q] = __fadd_rn(v[q], v[q + width]);
      if (state) pw[row * n] = v[0];
    }
    // the tile's dx and ddt rows: a unit of kChans channels a thread (its
    // bytes aligned in both memories where di is a multiple of kChans; 8
    // threads a row, of dx and ddt of a step in turn), or a channel a thread
    const unsigned char* rows = smem + L.out + buf * 2 * kTile * L.orow;
    if (whole_units) {
      using Unit = typename std::conditional<ES == 2, uint2, uint4>::type;
      static_assert(sizeof(Unit) == kChans * ES, "a unit's channels in one store");
      static_assert(kBwdWarps <= 8, "a row's units fit 8 threads");
      const int q = threadIdx.x % 8;
      if (q < busy) {
        for (int row = threadIdx.x / 8; row < 2 * steps; row += threads / 8) {
          const int which = row % 2, ss = row / 2;
          T* dst = (which ? ddt : dx) + (row0 + t0 + ss) * di + d_lo + q * kChans;
          *reinterpret_cast<Unit*>(dst) = *reinterpret_cast<const Unit*>(
              rows + (which * kTile + ss) * L.orow + q * sizeof(Unit));
        }
      }
    } else {
      for (int o = threadIdx.x; o < 2 * steps * cb; o += threads) {
        const int which = o / (steps * cb), rem = o % (steps * cb);
        const int ss = rem / cb, q = rem % cb;
        (which ? ddt : dx)[(row0 + t0 + ss) * di + d_lo + q] = *reinterpret_cast<const T*>(
            rows + (which * kTile + ss) * L.orow + q * ES);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < M; ++k)
    if (live && l * M + k < n)
      da_part[((int64_t)blockIdx.y * di + d) * n + l * M + k] = da[k * 32];
}

// db and dc: the groups' partials summed in block order; da_log: da_part
// summed over the batch rows in order, times a; each rounded once
template <typename T>
__global__ void __launch_bounds__(256) selective_scan_bwd_sum_kernel(
    const float* __restrict__ part, const float* __restrict__ da_part,
    const T* __restrict__ a_log, T* __restrict__ db, T* __restrict__ dc, T* __restrict__ da_log,
    int64_t B, int64_t S, int64_t di, int64_t n, int64_t groups) {
  using E = Elem<T>;
  const int64_t bsn = B * S * n, total = 2 * bsn + di * n;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (int64_t)gridDim.x * blockDim.x) {
    if (o < 2 * bsn) {
      const int64_t which = o / bsn, r = o % bsn;
      const float* src = part + which * groups * bsn + r;
      float acc = src[0], comp = 0.f;  // compensated (Kahan), in block order
      for (int64_t g = 1; g < groups; ++g) {
        const float y = __fsub_rn(src[g * bsn], comp), t = __fadd_rn(acc, y);
        comp = __fsub_rn(__fsub_rn(t, acc), y), acc = t;
      }
      (which ? dc : db)[r] = E::narrow(acc);
    } else {
      const int64_t r = o - 2 * bsn;
      float acc = da_part[r];
      for (int64_t b = 1; b < B; ++b) acc = __fadd_rn(acc, da_part[b * di * n + r]);
      da_log[r] = E::narrow(__fmul_rn(acc, -expf(E::widen(a_log[r]))));
    }
  }
}

// ld, ldy: elements between rows of x and dt, and of dy, each row's bytes a
// multiple of 16 and the bases 16-byte aligned (the TMA's bounds); groups
// and warps: the plan (kernels/scan/ops.py::device_plan(..., backward=True));
// part (2, groups, B, S, n) and da_part (B, di, n) fp32 scratch
template <typename T>
int launch_bwd(const void* x, const void* dt, const void* bm, const void* cm,
               const void* a_log, const void* dy, const void* ckpt, void* part, void* da_part,
               void* dx, void* ddt, void* db, void* dc, void* da_log, int64_t B, int64_t S,
               int64_t di, int64_t ld, int64_t ldy, int64_t n, int64_t groups, int64_t warps,
               void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaSuccess;
  const int64_t units = (di + kChans - 1) / kChans;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
                          reinterpret_cast<uintptr_t>(dy);
  const uintptr_t grads = reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(ddt);
  if (n < 1 || n > kMaxState || warps < 1 || warps > kBwdWarps || groups < 1 ||
      groups > units || groups > 0x7fffffff || B > 65535 || S > 0x7fffffff || ld < di ||
      ldy < di || (ld * (int64_t)sizeof(T)) % 16 != 0 || (ldy * 4) % 16 != 0 ||
      (bases & 15) != 0 || (grads % (kChans * sizeof(T))) != 0 ||
      (units + groups - 1) / groups > warps)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn;
  int err = context_current();
  if (err != 0 || (err = encode_fn(&fn)) != 0) return err;
  const BwdSmem L = bwd_layout((int)warps, (int)n, (int)sizeof(T));
  CUtensorMap tm_x, tm_dt, tm_dy;
  if ((err = encode<T>(fn, &tm_x, x, B, S, ld, L.box)) != 0) return err;
  if ((err = encode<T>(fn, &tm_dt, dt, B, S, ld, L.box)) != 0) return err;
  if ((err = encode<float>(fn, &tm_dy, dy, B, S, ldy, L.boxf)) != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool whole = n == kMaxState && ((reinterpret_cast<uintptr_t>(bm) |
                                         reinterpret_cast<uintptr_t>(cm)) & 15) == 0;
  auto kernel = whole ? selective_scan_bwd_kernel<T, 1> : selective_scan_bwd_kernel<T, 0>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)groups, (unsigned)B), (unsigned)(warps * 32), L.total, st>>>(
      tm_x, tm_dt, tm_dy, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(a_log), static_cast<const float*>(ckpt),
      static_cast<float*>(part), static_cast<float*>(part) + groups * B * S * n,
      static_cast<float*>(da_part), static_cast<T*>(dx), static_cast<T*>(ddt), S, di, (int)n,
      groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t total = 2 * B * S * n + di * n;
  const int64_t blocks = (total + 255) / 256 < 132 * 16 ? (total + 255) / 256 : 132 * 16;
  selective_scan_bwd_sum_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(da_part),
      static_cast<const T*>(a_log), static_cast<T*>(db), static_cast<T*>(dc),
      static_cast<T*>(da_log), B, S, di, n, groups);
  return (int)cudaGetLastError();
}

// the walk's resident blocks an SM on the current device at `warps` warps
// and n = kMaxState (its kWhole instance; cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename T>
int occupancy(int64_t warps, int64_t* out) {
  const BwdSmem L = bwd_layout((int)warps, kMaxState, (int)sizeof(T));
  auto kernel = selective_scan_bwd_kernel<T, 1>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, (int)(warps * 32),
                                                      L.total);
  *out = blocks;
  return (int)e;
}

}  // namespace

extern "C" {

int repro_selective_scan_bwd_f32(const void* x, const void* dt, const void* bm, const void* cm,
                                 const void* a_log, const void* dy, const void* ckpt,
                                 void* part, void* da_part, void* dx, void* ddt, void* db,
                                 void* dc, void* da_log, int64_t B, int64_t S, int64_t di,
                                 int64_t ld, int64_t ldy, int64_t n, int64_t groups,
                                 int64_t warps, void* stream) {
  return launch_bwd<float>(x, dt, bm, cm, a_log, dy, ckpt, part, da_part, dx, ddt, db, dc,
                           da_log, B, S, di, ld, ldy, n, groups, warps, stream);
}

int repro_selective_scan_bwd_bf16(const void* x, const void* dt, const void* bm,
                                  const void* cm, const void* a_log, const void* dy,
                                  const void* ckpt, void* part, void* da_part, void* dx,
                                  void* ddt, void* db, void* dc, void* da_log, int64_t B,
                                  int64_t S, int64_t di, int64_t ld, int64_t ldy, int64_t n,
                                  int64_t groups, int64_t warps, void* stream) {
  return launch_bwd<uint16_t>(x, dt, bm, cm, a_log, dy, ckpt, part, da_part, dx, ddt, db, dc,
                              da_log, B, S, di, ld, ldy, n, groups, warps, stream);
}

// the layout at `warps` warps, n states and `elem`-byte inputs into
// out[0..3]: (a block's dynamic shared memory, kStages, kBwdWarps,
// kBlocksPerSm), which kernels/scan/ops.py mirrors for the host
// (bwd_layout()); cudaErrorInvalidValue outside the kernel's range
int repro_selective_scan_bwd_layout(int64_t warps, int64_t n, int64_t elem, void* out) {
  if (warps < 1 || warps > kBwdWarps || n < 1 || n > kMaxState || (elem != 2 && elem != 4))
    return (int)cudaErrorInvalidValue;
  int64_t* o = static_cast<int64_t*>(out);
  o[0] = bwd_layout((int)warps, (int)n, (int)elem).total;
  o[1] = kStages;
  o[2] = kBwdWarps;
  o[3] = kBlocksPerSm;
  return (int)cudaSuccess;
}

// the walk kernel's resident blocks an SM on the current device at `warps`
// warps and `elem`-byte inputs, into out[0]
int repro_selective_scan_bwd_occupancy(int64_t warps, int64_t elem, void* out) {
  if (warps < 1 || warps > kBwdWarps || (elem != 2 && elem != 4))
    return (int)cudaErrorInvalidValue;
  int64_t* o = static_cast<int64_t*>(out);
  return elem == 2 ? occupancy<uint16_t>(warps, o) : occupancy<float>(warps, o);
}

}  // extern "C"
