// mix_sparse: consensus mixing over the padded neighbor list (ELL),
//
//     out[i] = p_diag[i] * w[i] + sum_{s < d_max} p_off[i, s] * w[idx[i, s]]
//
// with the slots summed in order s = 0..d_max-1 in fp32.  Padded slots
// index the row itself and carry zero weight.
//
// Replaces the TPU kernel src/repro/kernels/mixing/kernel.py:74
// (mix_sparse_pallas, body _mix_sparse_kernel): there every row of one
// (m, block_n) column block is VMEM-resident and a sequential slot loop
// gathers from it, so the (m, d_max, D) gather never exists.
//
// Bound on the H100, for each route below: the function needs W read
// once and OUT written once (2 m D 4 bytes) and the slot lists (m d_max 8
// bytes) against 2 nnz(P) D + m D flops at the fp32 rate off the tensor
// cores; bytes bound a sparse fabric (the fleet's, d_max 47), operations
// a dense one (rgg r=0.4, d_max 516).  A kernel that gathers every slot's
// row from global memory moves m (d_max + 1) D 4 bytes through L2
// instead, most of them rows it multiplies by zero.
//
// Design: the TPU kernel's idea at the size of one SM.  A host-built plan
// (kernels/mixing/plan.py) cuts the rows into groups of neighbouring rows
// whose union of read rows fits one block's shared memory, and sends each
// table to one of two staged kernels by its d_max; rows whose own reads
// fit no slab go to a third.  In every route the arithmetic is the plain
// version's: __fmul_rn / __fadd_rn (never contracted into an FMA), slots
// in order.  A zero-weight slot may be left out only where the row it
// reads is known finite (0 * w[j] is then +-0 and leaving it out keeps
// the sum's value; a zero's sign may differ, as +0 + -0 does); else it is
// taken, so 0 * inf gives NaN as in the reference.
//
// 1. mix_sparse_kernel (sparse tables, d_max <= 109): a 512-thread block
//    takes one group (<= 64 rows) and four 128-column chunks of W:
//    a. once, it loads its rows' slot lists and each warp compacts them
//       to the slots of nonzero weight, in order (weight and union
//       position side by side, one 8-byte read a slot);
//    b. per chunk, it copies the chunk of every union row (<= 220 rows)
//       into shared memory with cp.async (8 or 4 bytes a copy: rows of an
//       odd or 7850-wide W are not 16-byte aligned, so neither 16-byte
//       copies nor TMA apply), and __syncthreads_or tells the block
//       whether the whole slab is finite;
//    c. a warp takes an output row's chunk, four columns a lane, and runs
//       its compacted slots from shared memory (every slot, read from
//       global memory, on a slab holding inf or NaN).
//    The lists share shared memory with the slab, so its row cap falls as
//    d_max grows.  Two blocks share an SM, so one computes while the
//    other copies.  ~3x its byte bound on the fleet fabric (PERF.md).
// 2. mix_sparse_wide_kernel (dense tables): the slot lists stay in device
//    memory, so a group holds up to 256 rows and its union up to 800 rows
//    at 64 columns (1600 at 32) whatever d_max is.  First
//    compact_slots_kernel writes each staged row's nonzero-weight slots,
//    in order, as (weight, slab offset) pairs to scratch (a warp a row,
//    a ballot per 32 slots), once a call.  Then a 1024-thread block (one
//    per SM, <= 200 KB of slab) takes one group and one 64-column chunk
//    (two columns a lane; 32, one a lane, where the plan chooses it):
//    it stages the union's chunk as in 1b, and a warp takes one output
//    row at a time: the row's compacted slots come 32 at a time, one a
//    lane (the next 32 loaded while these run), into the warp's list in
//    shared memory and back two slots per broadcast read, beside the slab
//    values they weight.  On a slab holding inf or NaN the row takes
//    every slot from p_off / slot_pos.  Shared memory sets the pace:
//    per kept slot a lane reads its slab values and the warp reads the
//    slot's weight and offset as a broadcast, so 64 columns (one
//    broadcast for twice the columns) beat 32 where both stage alike.
//    On the dense rgg r=0.4 fabric at m=1024 the route is ~10x its
//    operations bound and ~1.6x faster than CSR torch.sparse.mm; on rgg
//    r=0.4 at m=4096, whose groups hold ~7 rows, ~1.35x slower than CSR
//    over its rows (PERF.md).
// 3. mix_sparse_direct_kernel (rows reading more rows than a wide slab
//    holds): a 256-thread block takes 4 listed rows and a 1024-column
//    chunk, 4 columns 256 apart a thread, straight from global memory.
//    A pass over W first flags its finite rows (m bytes,
//    row_finite_kernel); per 256 slots the block then keeps, in order in
//    shared memory, the slots of nonzero weight or into a row holding inf
//    or NaN, and every thread runs the kept list with its gathers
//    unrolled: L2 gathers fall to the weighted slots, and no gather waits
//    on the slot's own index load.  Bound by L2 gathers, like CSR
//    torch.sparse.mm over the same rows, and ~1.06x its time (PERF.md).
// Blocks are numbered groups-fastest (rows-fastest in 3), so the blocks
// in flight share a few column chunks whose m x chunk x 4 bytes stay in
// L2: W comes from device memory about once, and from L2 about (union
// rows / group rows) times.
// Cells: a batched run mixes C cells over one shared neighbor table and so
// one plan, with p_diag (C, m), p_off (C, m, d_max), W and OUT (C, m, D)
// each cell's own.  Every kernel takes the cells on its slowest grid axis
// (blockIdx.z; blockIdx.y in the two helper passes), with 64-bit cell
// offsets, and the helpers' scratch is per cell (kept (C, n_rows, stride),
// n_kept (C, n_rows), finite (C, m)).  A cell's blocks do the solo launch's
// arithmetic on its slices, so each cell's output is bit-equal to a launch
// on that cell alone, and the plan does not depend on C.
// Rectangular source: W may hold n_src >= m rows per cell (a shard's
// [own rows ; halo rows] buffer in the sharded engine); output row i's self
// term is W row i and the table indexes [0, n_src).  Only W's cell stride
// and the finite flags (C, n_src) see n_src; a square call passes n_src = m.
//
// bf16 rows (repro_mix_sparse_bf16): the train step's neighbor schedule on
// bf16 parameter leaves (launch/steps.py: the edge-coloring rounds as ELL
// slots, d_max = the rounds), one cell, no plan.  The direct route alone:
// a 256-thread block takes 4 output rows and 2048 columns, 8 a thread
// (16-byte loads), and walks each row's slots in order straight from
// device memory, every slot taken, zero weights included: the plain slot
// loop's arithmetic to the bit (__fmul_rn / __fadd_rn), so 0 * inf gives
// NaN as there, and a zero's sign is the plain version's too.  Bound:
// memory, m D 2 bytes read and written each; the rows a block reads again
// for its slots come from L2 (a ring's 4 replicas: 2048 columns of 4 rows).
// 64-bit offsets: rows reach 3.0e8 columns.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

// CHUNK, ROWS_MAX and SMEM_BUDGET are those of kernels/mixing/plan.py (tier 1)
constexpr int NT = 512, CHUNK = 128, QUADS = CHUNK / 4, LANES = NT / QUADS, WARPS = NT / 32;
constexpr int ROWS_MAX = 64, SMEM_BUDGET = 110 * 1024, UNION_MAX = SMEM_BUDGET / (4 * CHUNK);
constexpr int CHUNKS_PER_BLOCK = 4;

struct Slot {  // one slot of a row's list: weight and union position
  float p;
  int q;
};

// copies V floats (4 V bytes) global -> shared; zero-fills when !valid
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(4 * V), "r"(valid ? 4 * V : 0)
               : "memory");
}

template <int V>
__device__ __forceinline__ void store4(float* row, long long col, long long D, const float4& a) {
  if (V == 2) {
    if (col < D) *reinterpret_cast<float2*>(row + col) = float2{a.x, a.y};
    if (col + 2 < D) *reinterpret_cast<float2*>(row + col + 2) = float2{a.z, a.w};
  } else {
    if (col < D) row[col] = a.x;
    if (col + 1 < D) row[col + 1] = a.y;
    if (col + 2 < D) row[col + 2] = a.z;
    if (col + 3 < D) row[col + 3] = a.w;
  }
}

// a += p * y, each product and sum rounded (never an FMA)
__device__ __forceinline__ void axpy(float4& a, float p, const float4& y) {
  a.x = __fadd_rn(a.x, __fmul_rn(p, y.x));
  a.y = __fadd_rn(a.y, __fmul_rn(p, y.y));
  a.z = __fadd_rn(a.z, __fmul_rn(p, y.z));
  a.w = __fadd_rn(a.w, __fmul_rn(p, y.w));
}

__device__ __forceinline__ float4 scale(float p, const float4& x) {
  return float4{__fmul_rn(p, x.x), __fmul_rn(p, x.y), __fmul_rn(p, x.z), __fmul_rn(p, x.w)};
}

template <int V>
__global__ void __launch_bounds__(NT, 2)
mix_sparse_kernel(const int64_t* __restrict__ idx, const float* __restrict__ p_diag,
                  const float* __restrict__ p_off, const float* __restrict__ w,
                  float* __restrict__ out, const int* __restrict__ rows,
                  const int* __restrict__ row_ptr, const int* __restrict__ uni,
                  const int* __restrict__ uni_ptr, const int* __restrict__ slot_pos,
                  const int* __restrict__ self_pos, int m, int n_src, int d_max, long long D,
                  int umax, int rmax, int n_chunks) {
  // this block's cell: its slices of the weights, W and OUT
  const long long cell = blockIdx.z;
  p_diag += cell * m;
  p_off += cell * m * d_max;
  w += cell * n_src * D;
  out += cell * m * D;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_rows[ROWS_MAX], s_self[ROWS_MAX], s_uni[UNION_MAX];
  __shared__ float s_pd[ROWS_MAX];
  const int g = blockIdx.x;
  const int r0 = row_ptr[g], nr = row_ptr[g + 1] - r0;
  const int u0 = uni_ptr[g], nu = uni_ptr[g + 1] - u0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lane_row = tid / QUADS, quad = tid % QUADS;  // rows lane_row + LANES k, columns 4 quad ..

  // the slab [umax][CHUNK]; before the first chunk the same space holds the
  // rows' full slot lists
  const int list = rmax * d_max;
  float* slab = smem;
  Slot* full = reinterpret_cast<Slot*>(smem);
  Slot* kept = reinterpret_cast<Slot*>(smem + (umax * CHUNK > 2 * list ? umax * CHUNK : 2 * list));
  int* cnt = reinterpret_cast<int*>(kept + list);

  // 1. rows, union and slot lists, then each row's nonzero slots in order
  for (int e = tid; e < nu; e += NT) s_uni[e] = uni[u0 + e];
  for (int e = tid; e < nr; e += NT) {
    const int i = rows[r0 + e];
    s_rows[e] = i;
    s_self[e] = self_pos[i];
    s_pd[e] = p_diag[i];
  }
  for (int e = tid; e < nr * d_max; e += NT) {
    const int r = e / d_max;
    const long long at = (long long)rows[r0 + r] * d_max + (e - r * d_max);
    cp_async<1>(&full[e].p, p_off + at, true);
    cp_async<1>(&full[e].q, slot_pos + at, true);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int r = warp; r < nr; r += WARPS) {
    int n = 0;
    for (int s0 = 0; s0 < d_max; s0 += 32) {
      const int s = s0 + lane;
      const Slot slot = s < d_max ? full[r * d_max + s] : Slot{0.f, 0};
      const bool keep = slot.p != 0.f;  // NaN weights stay
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) kept[r * d_max + n + __popc(ballot & ((1u << lane) - 1u))] = slot;
      n += __popc(ballot);
    }
    if (lane == 0) cnt[r] = n;
  }
  __syncthreads();  // the full lists are dead: the slab's space is free

  constexpr int PER_ROW = CHUNK / V;
  const float4* slab4 = reinterpret_cast<const float4*>(slab);
  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y) {
    const long long c0 = (long long)c * CHUNK;
    // 2. the union's chunk into shared memory; is all of it finite?
    for (int e = tid; e < nu * PER_ROW; e += NT) {
      const int u = e / PER_ROW, q = (e % PER_ROW) * V;
      const bool valid = c0 + q < D;
      cp_async<V>(slab + u * CHUNK + q, valid ? w + (long long)s_uni[u] * D + c0 + q : w, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    bool bad = false;
    for (int e = tid; e < nu * PER_ROW; e += NT) {
      const float* v = slab + (e / PER_ROW) * CHUNK + (e % PER_ROW) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) bad |= !isfinite(v[k]);
    }
    const bool finite = !__syncthreads_or(bad);

    // 3. each row from shared memory, slots in order
    const long long col = c0 + 4 * quad;
    for (int r = lane_row; r < nr; r += LANES) {
      const long long i = s_rows[r];
      float4 a = scale(s_pd[r], slab4[s_self[r] * QUADS + quad]);
      if (finite) {
        const Slot* sl = kept + r * d_max;
        const int n = cnt[r];
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const Slot slot = sl[k];
          axpy(a, slot.p, slab4[slot.q * QUADS + quad]);
        }
      } else {
        for (int s = 0; s < d_max; ++s)
          axpy(a, __ldg(p_off + i * d_max + s),
               slab4[__ldg(slot_pos + i * d_max + s) * QUADS + quad]);
      }
      store4<V>(out + i * D, col, D, a);
    }
    __syncthreads();  // the next chunk overwrites the slab
  }
}

// wide tier: a 1024-thread block (one per SM) takes one group and one
// chunk of 32 L columns, a warp one output row at a time, L columns a lane
constexpr int WIDE_NT = 1024, WIDE_WARPS = WIDE_NT / 32;
constexpr int WIDE_SMEM_MAX = 200 * 1024;  // plan.WIDE_BUDGET

template <int L>
struct Cols {  // L consecutive floats of one lane
  float v[L];
};

template <int L>
__device__ __forceinline__ Cols<L> ld_cols(const float* p) {
  Cols<L> c;
  if constexpr (L == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    c.v[0] = t.x;
    c.v[1] = t.y;
  } else {
    c.v[0] = *p;
  }
  return c;
}

// each listed row's nonzero-weight slots, in order, as (weight bits,
// offset of the row in a CH-column slab): a warp a row, 32 slots at a time
constexpr int COMPACT_NT = 256;

__global__ void __launch_bounds__(COMPACT_NT)
compact_slots_kernel(const float* __restrict__ p_off, const int* __restrict__ slot_pos,
                     const int* __restrict__ rows, int m, int n_rows, int d_max, int stride,
                     int CH, int2* __restrict__ kept, int* __restrict__ n_kept) {
  const int r = blockIdx.x * (COMPACT_NT / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= n_rows) return;
  const long long cell = blockIdx.y;  // this cell's weights and scratch
  p_off += cell * m * d_max;
  kept += cell * n_rows * stride;
  n_kept += cell * n_rows;
  const long long i = rows[r];
  int2* out = kept + (long long)r * stride;
  int n = 0;
  for (int s0 = 0; s0 < d_max; s0 += 32) {
    const int s = s0 + lane;
    const float p = s < d_max ? __ldg(p_off + i * d_max + s) : 0.f;
    const bool keep = p != 0.f;  // NaN weights stay
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep)
      out[n + __popc(ballot & ((1u << lane) - 1u))] =
          int2{__float_as_int(p), __ldg(slot_pos + i * d_max + s) * CH};
    n += __popc(ballot);
  }
  if (lane == 0) n_kept[r] = n;
}

template <int L>
__device__ __forceinline__ void axpy_cols(Cols<L>& a, float p, const float* y) {
  const Cols<L> v = ld_cols<L>(y);
#pragma unroll
  for (int t = 0; t < L; ++t) a.v[t] = __fadd_rn(a.v[t], __fmul_rn(p, v.v[t]));
}

template <int V, int L>
__global__ void __launch_bounds__(WIDE_NT, 1)
mix_sparse_wide_kernel(const float* __restrict__ p_diag, const float* __restrict__ p_off,
                       const float* __restrict__ w, float* __restrict__ out,
                       const int* __restrict__ rows, const int* __restrict__ row_ptr,
                       const int* __restrict__ uni, const int* __restrict__ uni_ptr,
                       const int* __restrict__ slot_pos, const int* __restrict__ self_pos,
                       const int2* __restrict__ kept, const int* __restrict__ n_kept, int m,
                       int n_src, int n_rows, int d_max, int stride, long long D,
                       int n_chunks) {
  constexpr int CH = 32 * L, PER_ROW = CH / V;
  // this block's cell: its slices of the weights, W, OUT and the scratch
  const long long cell = blockIdx.z;
  p_diag += cell * m;
  p_off += cell * m * d_max;
  w += cell * n_src * D;
  out += cell * m * D;
  kept += cell * n_rows * stride;
  n_kept += cell * n_rows;
  extern __shared__ __align__(16) float slab[];  // [union rows][CH]
  const int g = blockIdx.x;
  const int r0 = row_ptr[g], nr = row_ptr[g + 1] - r0;
  const int u0 = uni_ptr[g], nu = uni_ptr[g + 1] - u0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // per warp: 32 slots of its current row, two per int4
  __shared__ int4 lists[WIDE_WARPS][16];
  int2* mine = reinterpret_cast<int2*>(lists[warp]);
  const int4* mine4 = lists[warp];

  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y) {
    const long long c0 = (long long)c * CH;
    // 1. the union's chunk into shared memory; is all of it finite?
    for (int e = tid; e < nu * PER_ROW; e += WIDE_NT) {
      const int u = e / PER_ROW, q = (e % PER_ROW) * V;
      const bool valid = c0 + q < D;
      cp_async<V>(slab + u * CH + q, valid ? w + (long long)uni[u0 + u] * D + c0 + q : w,
                  valid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    bool bad = false;
    for (int e = tid; e < nu * PER_ROW; e += WIDE_NT) {
      const float* v = slab + (e / PER_ROW) * CH + (e % PER_ROW) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) bad |= !isfinite(v[k]);
    }
    const bool finite = !__syncthreads_or(bad);

    // 2. a warp per output row, L columns a lane.  On a finite slab the
    // row's compacted slots come 32 at a time, one a lane (the next 32
    // loaded while these run), into the warp's list in shared memory and
    // back two per broadcast read; on a slab holding inf or NaN the row
    // takes every slot
    const float* col = slab + L * lane;
    for (int r = warp; r < nr; r += WIDE_WARPS) {
      const long long i = rows[r0 + r];
      Cols<L> a = ld_cols<L>(col + self_pos[i] * CH);
      const float pd = __ldg(p_diag + i);
#pragma unroll
      for (int t = 0; t < L; ++t) a.v[t] = __fmul_rn(pd, a.v[t]);
      if (finite) {
        const int2* list = kept + (long long)(r0 + r) * stride;
        const int n = n_kept[r0 + r];
        int2 next = lane < n ? __ldg(list + lane) : int2{0, 0};
        for (int k0 = 0; k0 < n; k0 += 32) {
          mine[lane] = next;
          if (k0 + 32 + lane < n) next = __ldg(list + k0 + 32 + lane);
          __syncwarp();
          const int cnt = min(32, n - k0);
          int k = 0;
#pragma unroll 4
          for (; k + 1 < cnt; k += 2) {
            const int4 two = mine4[k / 2];
            axpy_cols<L>(a, __int_as_float(two.x), col + two.y);
            axpy_cols<L>(a, __int_as_float(two.z), col + two.w);
          }
          if (k < cnt) {
            const int2 one = mine[k];
            axpy_cols<L>(a, __int_as_float(one.x), col + one.y);
          }
          __syncwarp();  // the next 32 overwrite the list
        }
      } else {
        const float* pr = p_off + i * d_max;
        const int* qr = slot_pos + i * d_max;
#pragma unroll 4
        for (int s = 0; s < d_max; ++s) axpy_cols<L>(a, __ldg(pr + s), col + __ldg(qr + s) * CH);
      }
      const long long c_out = c0 + L * lane;
      float* o = out + i * D + c_out;
      if constexpr (L == 2 && V == 2) {
        if (c_out < D) *reinterpret_cast<float2*>(o) = float2{a.v[0], a.v[1]};
      } else {
#pragma unroll
        for (int t = 0; t < L; ++t)
          if (c_out + t < D) o[t] = a.v[t];
      }
    }
    __syncthreads();  // the next chunk overwrites the slab
  }
}

// one flag a row of w (n_src rows a cell): are all its values finite?
constexpr int FINITE_NT = 256;

__global__ void __launch_bounds__(FINITE_NT)
row_finite_kernel(const float* __restrict__ w, int n_src, long long D,
                  unsigned char* __restrict__ finite) {
  // row blockIdx.x of cell blockIdx.y
  const long long at = (long long)blockIdx.y * n_src + blockIdx.x;
  finite += at;
  const float* row = w + at * D;
  bool bad = false;
  for (long long c = threadIdx.x; c < D; c += FINITE_NT) bad |= !isfinite(__ldg(row + c));
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) *finite = !bad;
}

// rows that no slab holds: 4 listed rows and 1024 columns a block
constexpr int DIRECT_NT = 256, DIRECT_ROWS = 4, DIRECT_CHUNK = 4 * DIRECT_NT;

__global__ void __launch_bounds__(DIRECT_NT)
mix_sparse_direct_kernel(const int64_t* __restrict__ idx, const float* __restrict__ p_diag,
                         const float* __restrict__ p_off, const float* __restrict__ w,
                         float* __restrict__ out, const int* __restrict__ rows,
                         const unsigned char* __restrict__ finite, int m, int n_src,
                         int n_rows, int d_max, long long D) {
  // this block's cell: its slices of the weights, W, OUT and the flags
  const long long cell = blockIdx.z;
  p_diag += cell * m;
  p_off += cell * m * d_max;
  w += cell * n_src * D;
  out += cell * m * D;
  finite += cell * n_src;
  // the slots of the current 256 that are taken, in order, and the count
  // each warp keeps of them
  __shared__ float s_p[DIRECT_NT];
  __shared__ long long s_j[DIRECT_NT];
  __shared__ int s_warp[DIRECT_NT / 32 + 1];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * DIRECT_ROWS;
  const long long c0 = (long long)blockIdx.y * DIRECT_CHUNK + tid;
  for (int r = r0; r < r0 + DIRECT_ROWS && r < n_rows; ++r) {
    const long long i = rows[r];
    const float* wi = w + i * D;
    const float pd = __ldg(p_diag + i);
    float acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long c = c0 + q * DIRECT_NT;
      acc[q] = c < D ? __fmul_rn(pd, __ldg(wi + c)) : 0.f;
    }
    for (int s0 = 0; s0 < d_max; s0 += DIRECT_NT) {
      // each thread one slot: 0 * w[j] is +-0 on a finite row, and leaving
      // it out keeps the sum's value; on a row holding inf or NaN it is
      // NaN, so the slot is taken
      const int s = s0 + tid;
      float p = 0.f;
      long long j = 0;
      bool take = false;
      if (s < d_max) {
        p = __ldg(p_off + i * d_max + s);
        j = __ldg(idx + i * d_max + s);
        take = p != 0.f || !__ldg(finite + j);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, take);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int at = __popc(ballot & ((1u << lane) - 1u)), n = 0;
      for (int k = 0; k < DIRECT_NT / 32; ++k) {
        at += k < warp ? s_warp[k] : 0;
        n += s_warp[k];
      }
      if (take) {
        s_p[at] = p;
        s_j[at] = j;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float pk = s_p[k];
        const float* wj = w + s_j[k] * D;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long c = c0 + q * DIRECT_NT;
          if (c < D) acc[q] = __fadd_rn(acc[q], __fmul_rn(pk, __ldg(wj + c)));
        }
      }
      __syncthreads();  // the next 256 overwrite the list
    }
    float* oi = out + i * D;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long c = c0 + q * DIRECT_NT;
      if (c < D) oi[c] = acc[q];
    }
  }
}

}  // namespace

// idx: (m, d_max) int64 into [0, n_src), shared by the cells; p_diag:
// (cells, m) fp32, p_off: (cells, m, d_max) fp32, w: (cells, n_src, D) fp32
// with n_src >= m, out: (cells, m, D) fp32, all row-major,
// 1 <= cells <= 65535; the plan's int32 tables (rows, row_ptr,
// uni, uni_ptr, slot_pos, self_pos) from kernels/mixing/plan.py with
// n_groups staged groups, the largest union umax rows and the largest group
// rmax rows.  Launches on `stream` and returns the CUDA error of the launch
// (0 on success).
extern "C" int repro_mix_sparse_f32(const int64_t* idx, const float* p_diag,
                                    const float* p_off, const float* w, float* out,
                                    const int* rows, const int* row_ptr, const int* uni,
                                    const int* uni_ptr, const int* slot_pos,
                                    const int* self_pos, long long cells, long long m,
                                    long long n_src, long long n_groups, long long d_max,
                                    long long D, long long umax, long long rmax,
                                    void* stream) {
  if (umax > UNION_MAX || rmax > ROWS_MAX || cells < 1 || cells > 65535 || n_src < m)
    return (int)cudaErrorInvalidValue;
  const long long list = rmax * d_max;
  const size_t smem = 4 * ((umax * CHUNK > 2 * list ? umax * CHUNK : 2 * list) + 2 * list + rmax);
  const bool v2 = D % 2 == 0 && (uintptr_t)w % 8 == 0 && (uintptr_t)out % 8 == 0;
  auto kernel = v2 ? mix_sparse_kernel<2> : mix_sparse_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (int)((D + CHUNK - 1) / CHUNK);
  dim3 grid((unsigned int)n_groups,
            (unsigned int)((n_chunks + CHUNKS_PER_BLOCK - 1) / CHUNKS_PER_BLOCK),
            (unsigned int)cells);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(idx, p_diag, p_off, w, out, rows, row_ptr,
                                                  uni, uni_ptr, slot_pos, self_pos, (int)m,
                                                  (int)n_src, (int)d_max, D, (int)umax, (int)rmax,
                                                  n_chunks);
  return (int)cudaGetLastError();
}

// The wide tier: the plan's groups (same tables as above, n_rows rows
// in all) cut for a chunk of 32 or 64 columns, with unions of at most
// umax rows; kept (cells x n_rows x stride int2, stride even and >= d_max)
// and n_kept (cells x n_rows int32) are scratch for the compacted slot
// lists.
extern "C" int repro_mix_sparse_wide_f32(const float* p_diag, const float* p_off,
                                         const float* w, float* out, const int* rows,
                                         const int* row_ptr, const int* uni,
                                         const int* uni_ptr, const int* slot_pos,
                                         const int* self_pos, void* kept, int* n_kept,
                                         long long cells, long long m, long long n_src,
                                         long long n_groups, long long n_rows, long long d_max,
                                         long long stride, long long D, long long umax,
                                         long long chunk, void* stream) {
  if ((chunk != 32 && chunk != 64) || umax * chunk * 4 > WIDE_SMEM_MAX || stride % 2 ||
      stride < d_max || (uintptr_t)kept % 16 || cells < 1 || cells > 65535 || n_src < m)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  dim3 compact_grid((unsigned int)((n_rows + COMPACT_NT / 32 - 1) / (COMPACT_NT / 32)),
                    (unsigned int)cells);
  compact_slots_kernel<<<compact_grid, COMPACT_NT, 0, st>>>(
      p_off, slot_pos, rows, (int)m, (int)n_rows, (int)d_max, (int)stride, (int)chunk,
      (int2*)kept, n_kept);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 4 * umax * chunk;
  const bool v2 = D % 2 == 0 && (uintptr_t)w % 8 == 0 && (uintptr_t)out % 8 == 0;
  auto kernel = chunk == 64 ? (v2 ? mix_sparse_wide_kernel<2, 2> : mix_sparse_wide_kernel<1, 2>)
                            : (v2 ? mix_sparse_wide_kernel<2, 1> : mix_sparse_wide_kernel<1, 1>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_chunks = (D + chunk - 1) / chunk;
  dim3 grid((unsigned int)n_groups, (unsigned int)(n_chunks < 65535 ? n_chunks : 65535),
            (unsigned int)cells);
  kernel<<<grid, WIDE_NT, smem, st>>>(p_diag, p_off, w, out, rows, row_ptr, uni, uni_ptr,
                                      slot_pos, self_pos, (const int2*)kept, n_kept, (int)m,
                                      (int)n_src, (int)n_rows, (int)d_max, (int)stride, D,
                                      (int)n_chunks);
  return (int)cudaGetLastError();
}

// The rows of W listed in rows (n_rows int32 ids) that no slab holds,
// mixed from device memory, after a pass that flags the finite rows of w
// (cells x n_src rows) in finite (cells x n_src bytes, scratch); other
// arguments as above.
extern "C" int repro_mix_sparse_direct_f32(const int64_t* idx, const float* p_diag,
                                           const float* p_off, const float* w, float* out,
                                           const int* rows, unsigned char* finite,
                                           long long cells, long long n_rows, long long m,
                                           long long n_src, long long d_max, long long D,
                                           void* stream) {
  if (cells < 1 || cells > 65535 || n_src < m) return (int)cudaErrorInvalidValue;
  row_finite_kernel<<<dim3((unsigned int)n_src, (unsigned int)cells), FINITE_NT, 0,
                      (cudaStream_t)stream>>>(w, (int)n_src, D, finite);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned int)((n_rows + DIRECT_ROWS - 1) / DIRECT_ROWS),
            (unsigned int)((D + DIRECT_CHUNK - 1) / DIRECT_CHUNK), (unsigned int)cells);
  mix_sparse_direct_kernel<<<grid, DIRECT_NT, 0, (cudaStream_t)stream>>>(
      idx, p_diag, p_off, w, out, rows, finite, (int)m, (int)n_src, (int)n_rows, (int)d_max, D);
  return (int)cudaGetLastError();
}

namespace {

constexpr int SPB_NT = 256, SPB_ROWS = 4;

// columns [c, c + V) of rows 4 blockIdx.y ..; V = 8 when D % 8 == 0 and W
// and OUT are 16-byte aligned, else 1
template <int V>
__global__ void __launch_bounds__(SPB_NT)
mix_sparse_bf16_kernel(const int64_t* __restrict__ idx, const float* __restrict__ p_diag,
                       const float* __restrict__ p_off, const uint16_t* __restrict__ w,
                       uint16_t* __restrict__ out, int m, int d_max, long long D) {
  const long long c = ((long long)blockIdx.x * SPB_NT + threadIdx.x) * V;
  if (c >= D) return;
  const int r0 = blockIdx.y * SPB_ROWS;
  for (int i = r0; i < r0 + SPB_ROWS && i < m; ++i) {
    float acc[V], x[V];
    const float pd = __ldg(p_diag + i);
    bf16rows::load<V>(w + (long long)i * D + c, x);
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = __fmul_rn(pd, x[q]);
    for (int s = 0; s < d_max; ++s) {
      const long long at = (long long)i * d_max + s;
      const float p = __ldg(p_off + at);
      bf16rows::load<V>(w + __ldg(idx + at) * D + c, x);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(p, x[q]));
    }
    bf16rows::store<V>(out + (long long)i * D + c, acc);
  }
}

}  // namespace

// idx: (m, d_max) int64 into [0, n_src); p_diag: (m,) fp32, p_off: (m,
// d_max) fp32; w: (n_src, D) bf16 with n_src >= m, out: (m, D) bf16 (as
// 16-bit words), all row-major, one cell; w and out must not overlap.
// Launches on `stream` and returns the CUDA error of the launch.
extern "C" int repro_mix_sparse_bf16(const int64_t* idx, const float* p_diag,
                                     const float* p_off, const uint16_t* w, uint16_t* out,
                                     long long m, long long n_src, long long d_max,
                                     long long D, void* stream) {
  if (m < 1 || n_src < m || d_max < 0 || D < 1 || (m + SPB_ROWS - 1) / SPB_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 8 == 0 && (((uintptr_t)w | (uintptr_t)out) & 15u) == 0;
  const int v = vec ? 8 : 1;
  const long long blocks = (D + (long long)SPB_NT * v - 1) / ((long long)SPB_NT * v);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)blocks, (unsigned int)((m + SPB_ROWS - 1) / SPB_ROWS));
  if (vec)
    mix_sparse_bf16_kernel<8><<<grid, SPB_NT, 0, (cudaStream_t)stream>>>(
        idx, p_diag, p_off, w, out, (int)m, (int)d_max, D);
  else
    mix_sparse_bf16_kernel<1><<<grid, SPB_NT, 0, (cudaStream_t)stream>>>(
        idx, p_diag, p_off, w, out, (int)m, (int)d_max, D);
  return (int)cudaGetLastError();
}
