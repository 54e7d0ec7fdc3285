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
// S n fp32, 1.11 GB there at 132 groups, written and read again) are this
// design's scratch, not the function's bytes.  At the train shape (2,
// 2048, 3200, 16) the issue bounds bf16 (0.075 ms) and the bytes fp32
// (0.087 ms); chip_smoke.py::scan_bwd_bound computes each row's.
//
// Design: the forward's layout (kLanes = 8 lanes a channel, kSlots = 2
// states a lane, kChans = 4 channels a warp, a block a range of whole
// units of a batch row, one consumer warp a unit, at most kBwdWarps, and
// one producer warp),
// and one walk over time, backwards, in tiles of kTile steps:
//   - the producer stages tile i into stage r % kStages (r = the tiles
//     walked so far: the tiles arrive in reverse order) once the consumers
//     have released it, by TMA: one tensor box each of dt, x and dy (rows
//     `ld` and `ldy` elements apart on 16-byte bounds: the wrapper copies
//     rows that are not) and one bulk copy each of the tile's b and c;
//   - a consumer lane loads the tile's starting state from the checkpoints
//     the saving forward stored (selective_scan_save_kernel), recomputes the
//     tile's 33 states and 32 decays forward, as the forward took them (the
//     same instructions: the states are bit for bit the forward's), keeping
//     them in registers, then walks the tile backwards with g carried in
//     registers: each decay's exp is taken once;
//   - du and the decay's part of ddt sum a lane's states in order, then a
//     channel's 8 lanes pairwise in lane order by shuffles,
//     ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)); lane 0 of the
//     channel keeps them, and after the tile lane s of the warp writes step
//     s's dx and ddt of the warp's channels;
//   - the db and dc parts of each (step, state) go to shared memory a
//     channel apart; after the tile the block's consumer threads sum them
//     over its channels pairwise in channel order and write the block's
//     partial of each (step, state) to `part` (2, groups, B, S, n) fp32;
//   - da sums in a lane's registers over each tile's steps (in reverse
//     order), the tiles' sums compensated (Kahan), and is written once, to
//     `da_part` (B, di, n) fp32.
// A second launch (selective_scan_bwd_sum_kernel) sums the partials: db and
// dc over the groups in block order, compensated, da over the batch rows in
// order (then da_log = da a), each rounded once to the input's dtype.  No
// atomics and fixed orders: the same inputs give the same bits from run to
// run.  (Sequential fp32 sums over a block's channels, the groups and S
// steps took several times the plain backward's error against fp64.)
// Non-finite values: a gradient is non-finite where the plain backward's is
// (kernels/scan/ref.py::selective_scan_bwd_ref: the same products, summed in
// another order), but an inf there may read NaN: decays below 2^-126 flush
// to 0, as in the forward, and 0 x inf is NaN.
#include "scan.cuh"

namespace {

constexpr int kStages = 4;  // the ring's tiles
// consumer warps a block at most: with the producer, 8 warps, 2 on each of
// an SM's four sub-partitions, each warp up to 255 registers of its
// partition's 16384 (9 warps put 3 on one, which caps them at 168 and spills
// the tile's 65 states and 64 decays a lane keeps)
constexpr int kBwdWarps = 7;
constexpr int kLeaves = 32;  // the pairwise sum over a block's channels: kBwdWarps kChans, padded
static_assert(kBwdWarps * kChans <= kLeaves, "a block's channels fit the sum's leaves");
static_assert(2 * 8 * kStages <= kBarBytes, "the mbarriers fit their bytes");

// byte offsets of a block's shared memory (exported by
// repro_selective_scan_bwd_layout; kernels/scan/ops.py::bwd_smem_bytes sums
// the same for the host): the ring's mbarriers (landed, empty x
// kStages); kStages stages, each a tile's raw dt, x and dy rows (a row slot
// holds the block's channels from the 16-byte bound below the first) and
// its raw b and c; the db and the dc parts of a tile, a channel's `chan`
// floats apart (16 banks off); each warp's (du, ddt part) of its channels'
// steps
struct BwdSmem {
  uint32_t row, box, rowf, boxf, tile, stage, dt, x, dy, b, c, chan, red, out, total;
};

__host__ __device__ inline BwdSmem bwd_layout(int warps, int n, int elem) {
  BwdSmem s;
  s.row = ((warps * kChans * elem + 15) & ~15) + 16;
  s.box = s.row / 4;
  s.rowf = ((warps * kChans * 4 + 15) & ~15) + 16;
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
  s.chan = ((kTile * n + 31) & ~31) + 16;
  s.red = o, o += 2 * warps * kChans * s.chan * 4;
  s.out = o, o += warps * kTile * kChans * 2 * 4;
  s.total = o;
  return s;
}

__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// grid (groups, B), the forward's: block g holds the units [g U / groups,
// (g + 1) U / groups) of batch row blockIdx.y; warps 0 .. busy - 1
// consume, warp `busy` produces
template <typename T>
__global__ void __launch_bounds__((kBwdWarps + 1) * 32, 1) selective_scan_bwd_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dt,
    const __grid_constant__ CUtensorMap tm_dy, const T* __restrict__ bm,
    const T* __restrict__ cm, const T* __restrict__ a_log, const float* __restrict__ ckpt,
    float* __restrict__ part, float* __restrict__ da_part, T* __restrict__ dx,
    T* __restrict__ ddt, int64_t S, int64_t di, int n, int64_t groups) {
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ES = sizeof(T);
  constexpr int M = kSlots;
  const int warps = blockDim.x / 32 - 1;
  const BwdSmem L = bwd_layout(warps, n, ES);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t units = (di + kChans - 1) / kChans;
  const int64_t u_lo = (int64_t)blockIdx.x * units / groups;
  const int64_t u_hi = ((int64_t)blockIdx.x + 1) * units / groups;
  const int64_t d_lo = u_lo * kChans;
  const int cb = (int)(min(di, u_hi * kChans) - d_lo);  // the block's channels
  const int busy = (int)(u_hi - u_lo);                   // its consumer warps
  const int64_t row0 = (int64_t)blockIdx.y * S;  // the batch row's first (b, t) row
  const int64_t tiles = (S + kTile - 1) / kTile;
  // landed[kStages], empty[kStages]
  const uint32_t bars = smem_u32(smem);
  const uint32_t ring = bars + kBarBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                 // the copies' bytes
      mbar_init(bars + 8 * (kStages + s), busy);  // lane 0 of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (w == busy) {  // the producer: tiles in reverse order
    if (lane == 0) {
      // the boxes start on the 16-byte bound below the block's first channel
      // (dy's, fp32, is one: d_lo is a multiple of kChans); the maps count
      // 4-byte words
      const int word = (int)((d_lo * ES) & ~(int64_t)15) / 4;
      for (int64_t r = 0; r < tiles; ++r) {
        const int64_t i = tiles - 1 - r;
        const int s = (int)(r % kStages);
        const int steps = (int)min((int64_t)kTile, S - i * kTile);
        const uint32_t st = ring + s * L.stage;
        if (r >= kStages) mbar_wait(bars + 8 * (kStages + s), (uint32_t)((r / kStages - 1) & 1));
        const uint32_t bar = bars + 8 * s;
        const uintptr_t len = (uintptr_t)steps * n * ES;
        const uintptr_t ab = reinterpret_cast<uintptr_t>(bm + (row0 + i * kTile) * n);
        const uintptr_t ac = reinterpret_cast<uintptr_t>(cm + (row0 + i * kTile) * n);
        const uintptr_t b0 = ab & ~(uintptr_t)15, c0 = ac & ~(uintptr_t)15;
        const uint32_t nb = (uint32_t)(((ab + len + 15) & ~(uintptr_t)15) - b0);
        const uint32_t nc = (uint32_t)(((ac + len + 15) & ~(uintptr_t)15) - c0);
        mbar_expect_tx(bar, 2 * kTile * L.row + kTile * L.rowf + nb + nc);
        tma_box(st + L.dt, &tm_dt, bar, word, (int)(i * kTile), (int)blockIdx.y);
        tma_box(st + L.x, &tm_x, bar, word, (int)(i * kTile), (int)blockIdx.y);
        tma_box(st + L.dy, &tm_dy, bar, (int)d_lo, (int)(i * kTile), (int)blockIdx.y);
        tma_bulk(st + L.b, b0, nb, bar);
        tma_bulk(st + L.c, c0, nc, bar);
      }
    }
    return;
  }
  if (w > busy) return;

  // the lane: channel c of the warp, states l M .. l M + M - 1
  const int c = lane / kLanes, l = lane % kLanes, ch = w * kChans + c;
  const bool live = ch < cb;
  const int64_t d = d_lo + ch;
  // da: each tile's sum over its steps, then the tiles' sums compensated
  // (Kahan, the error of a sum of S / kTile terms held near one rounding)
  float a[M], a2[M], da[M], da_c[M], carry[M], next[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int j = l * M + k;
    a[k] = 0.f, a2[k] = 0.f, da[k] = 0.f, da_c[k] = 0.f, carry[k] = 0.f;
    if (live && j < n) {
      a[k] = -expf(E::widen(a_log[d * n + j]));
      const float v = __fmul_rn(a[k], kLog2e);
      a2[k] = isinf(v) && !isinf(a[k]) ? -FLT_MAX : v;
    }
  }
  // the checkpoint of tile i: its starting state (zero past cb and n)
  auto load_state = [&](int64_t i, float (&h0)[M]) {
    const float* cp = ckpt + (((int64_t)blockIdx.y * tiles + i) * di + d) * n + l * M;
#pragma unroll
    for (int k = 0; k < M; ++k) h0[k] = live && l * M + k < n ? cp[k] : 0.f;
  };
  const uint32_t off = (uint32_t)(d_lo * ES) & 15;  // the first channel's offset in a row slot
  const int rowf = (int)L.rowf / 4;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* red_b = red + ch * L.chan;                          // this channel's db parts
  float* red_c = red + (warps * kChans + ch) * L.chan;       // and its dc parts
  float* out = reinterpret_cast<float*>(smem + L.out) + w * kTile * kChans * 2;
  const int threads = busy * 32;  // the consumers
  const int64_t bsn = (int64_t)gridDim.y * S * n;

  load_state(tiles - 1, next);
  for (int64_t r = 0; r < tiles; ++r) {
    const int64_t i = tiles - 1 - r;
    const int s = (int)(r % kStages);
    const int64_t t0 = i * kTile;
    const int steps = (int)min((int64_t)kTile, S - t0);
    float hs[kTile + 1][M], dec[kTile][M];
#pragma unroll
    for (int k = 0; k < M; ++k) hs[0][k] = next[k];
    if (i > 0) load_state(i - 1, next);  // in flight over this tile
    mbar_wait(bars + 8 * s, (uint32_t)((r / kStages) & 1));
    const unsigned char* st = smem + kBarBytes + s * L.stage;
    const uintptr_t ob = reinterpret_cast<uintptr_t>(bm + (row0 + t0) * n) & 15;
    const uintptr_t oc = reinterpret_cast<uintptr_t>(cm + (row0 + t0) * n) & 15;
    const T* rb = reinterpret_cast<const T*>(st + L.b + ob);
    const T* rc = reinterpret_cast<const T*>(st + L.c + oc);
    const unsigned char* sdt = st + L.dt + ch * ES + off;
    const unsigned char* sx = st + L.x + ch * ES + off;
    const float* sdy = reinterpret_cast<const float*>(st + L.dy) + ch;

    // the tile's states and decays, as the forward took them (past S: dt =
    // x = 0 and b = 0, so h holds)
#pragma unroll
    for (int ss = 0; ss < kTile; ++ss) {
      const float dtv = E::widen(*reinterpret_cast<const T*>(sdt + ss * L.row));
      const float xv = E::widen(*reinterpret_cast<const T*>(sx + ss * L.row));
      const float u = E::round(__fmul_rn(dtv, xv));
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int j = l * M + k;
        const bool on = ss < steps && j < n;
        const float bv = on ? E::widen(rb[on ? ss * n + j : 0]) : 0.f;
        dec[ss][k] = ex2(__fmul_rn(dtv, a2[k]));
        hs[ss + 1][k] = __fmaf_rn(dec[ss][k], hs[ss][k], __fmul_rn(u, bv));
      }
    }

    // back over the tile, g carried from the step after
    float dat[M] = {0.f, 0.f};
#pragma unroll
    for (int ss = kTile - 1; ss >= 0; --ss) {
      const float dtv = E::widen(*reinterpret_cast<const T*>(sdt + ss * L.row));
      const float xv = E::widen(*reinterpret_cast<const T*>(sx + ss * L.row));
      const float u = E::round(__fmul_rn(dtv, xv));
      const float dyv = sdy[ss * rowf];
      float du = 0.f, dd = 0.f;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int j = l * M + k;
        const bool on = ss < steps && j < n;
        const float bv = on ? E::widen(rb[on ? ss * n + j : 0]) : 0.f;
        const float cv = on ? E::widen(rc[on ? ss * n + j : 0]) : 0.f;
        const float g = __fmaf_rn(dyv, cv, carry[k]);
        const float q = __fmul_rn(__fmul_rn(g, hs[ss][k]), dec[ss][k]);  // g h[t-1] decay
        du = k == 0 ? __fmul_rn(g, bv) : __fmaf_rn(g, bv, du);
        dd = k == 0 ? __fmul_rn(q, a[k]) : __fmaf_rn(q, a[k], dd);
        dat[k] = __fmaf_rn(q, dtv, dat[k]);
        carry[k] = __fmul_rn(dec[ss][k], g);
        if (j < n) {
          red_b[ss * n + j] = live ? __fmul_rn(g, u) : 0.f;
          red_c[ss * n + j] = live ? __fmul_rn(dyv, hs[ss + 1][k]) : 0.f;
        }
      }
#pragma unroll
      for (int width = 1; width < kLanes; width *= 2) {  // pairwise in lane order
        du = __fadd_rn(du, __shfl_xor_sync(0xffffffffu, du, width));
        dd = __fadd_rn(dd, __shfl_xor_sync(0xffffffffu, dd, width));
      }
      if (l == 0) out[(ss * kChans + c) * 2] = du, out[(ss * kChans + c) * 2 + 1] = dd;
    }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float y = __fsub_rn(dat[k], da_c[k]), t = __fadd_rn(da[k], y);
      da_c[k] = __fsub_rn(__fsub_rn(t, da[k]), y), da[k] = t;
    }
    __syncwarp();

    // dx and ddt: lane ss writes step ss of the warp's channels
    if (lane < steps) {
      const int ss = lane;
#pragma unroll
      for (int cc = 0; cc < kChans; ++cc) {
        const int chc = w * kChans + cc;
        if (chc >= cb) break;
        const unsigned char* slot = st + (uint32_t)ss * L.row + chc * ES + off;
        const float dtv = E::widen(*reinterpret_cast<const T*>(slot + L.dt));
        const float xv = E::widen(*reinterpret_cast<const T*>(slot + L.x));
        const float du = E::round(out[(ss * kChans + cc) * 2]);
        const float dd = E::round(out[(ss * kChans + cc) * 2 + 1]);
        const int64_t o = (row0 + t0 + ss) * di + d_lo + chc;
        dx[o] = E::narrow(__fmul_rn(du, dtv));
        ddt[o] = E::narrow(__fadd_rn(E::round(__fmul_rn(du, xv)), dd));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));  // stage s is read

    // the block's partials of db and dc: its channels summed pairwise in
    // channel order, ((c0 + c1) + (c2 + c3)) + ..., over kLeaves leaves
    // (zero past its channels)
    consumers_sync(threads);
    for (int o = threadIdx.x; o < 2 * kTile * n; o += threads) {
      const int which = o / (kTile * n), rem = o % (kTile * n);  // rem = step n + state
      if (rem / n >= steps) continue;
      const float* src = red + which * warps * kChans * L.chan + rem;
      float v[kLeaves];
#pragma unroll
      for (int q = 0; q < kLeaves; ++q) v[q] = q < busy * kChans ? src[q * L.chan] : 0.f;
#pragma unroll
      for (int width = 1; width < kLeaves; width *= 2)
#pragma unroll
        for (int q = 0; q < kLeaves; q += 2 * width) v[q] = __fadd_rn(v[q], v[q + width]);
      part[(which * groups + blockIdx.x) * bsn + (row0 + t0) * n + rem] = v[0];
    }
    consumers_sync(threads);
  }
#pragma unroll
  for (int k = 0; k < M; ++k)
    if (live && l * M + k < n) da_part[((int64_t)blockIdx.y * di + d) * n + l * M + k] = da[k];
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
  if (n < 1 || n > kMaxState || warps < 1 || warps > kBwdWarps || groups < 1 ||
      groups > units || groups > 0x7fffffff || B > 65535 || S > 0x7fffffff || ld < di ||
      ldy < di || (ld * (int64_t)sizeof(T)) % 16 != 0 || (ldy * 4) % 16 != 0 ||
      (bases & 15) != 0 || (units + groups - 1) / groups > warps)
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
  auto kernel = selective_scan_bwd_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)groups, (unsigned)B), (unsigned)((warps + 1) * 32), L.total, st>>>(
      tm_x, tm_dt, tm_dy, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(a_log), static_cast<const float*>(ckpt),
      static_cast<float*>(part), static_cast<float*>(da_part), static_cast<T*>(dx),
      static_cast<T*>(ddt), S, di, (int)n, groups);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t total = 2 * B * S * n + di * n;
  const int64_t blocks = (total + 255) / 256 < 132 * 16 ? (total + 255) / 256 : 132 * 16;
  selective_scan_bwd_sum_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(da_part),
      static_cast<const T*>(a_log), static_cast<T*>(db), static_cast<T*>(dc),
      static_cast<T*>(da_log), B, S, di, n, groups);
  return (int)cudaGetLastError();
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

// the layout at `warps` consumer warps, n states and `elem`-byte inputs into
// out[0..2]: (a block's dynamic shared memory, kStages, kBwdWarps), which
// kernels/scan/ops.py mirrors for the host (bwd_layout()); cudaErrorInvalidValue
// outside the kernel's range
int repro_selective_scan_bwd_layout(int64_t warps, int64_t n, int64_t elem, void* out) {
  if (warps < 1 || warps > kBwdWarps || n < 1 || n > kMaxState || (elem != 2 && elem != 4))
    return (int)cudaErrorInvalidValue;
  int64_t* o = static_cast<int64_t*>(out);
  o[0] = bwd_layout((int)warps, (int)n, (int)elem).total;
  o[1] = kStages;
  o[2] = kBwdWarps;
  return (int)cudaSuccess;
}

}  // extern "C"
