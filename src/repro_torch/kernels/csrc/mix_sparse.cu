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
// Bound on the H100: memory.  The function needs W read once and OUT
// written once (2 m D 4 bytes) against ~2 nnz(P) D flops.  A kernel that
// gathers every slot's row from global memory moves m (d_max + 1) D 4
// bytes through L2 instead, most of them rows it multiplies by zero.
//
// Design: the TPU kernel's idea at the size of one SM.  A host-built plan
// (kernels/mixing/plan.py) cuts the rows into groups of neighbouring rows;
// a 512-thread block takes one group and four 128-column chunks of W:
//   1. once, it loads the group's rows, its union (the sorted rows the
//      group reads) and its rows' slot lists, and each warp compacts its
//      rows' lists to the slots of nonzero weight, in order (weight and
//      union position side by side, one 8-byte read a slot);
//   2. per chunk, it copies the chunk of every union row (<= 220 rows)
//      into shared memory with cp.async (8 or 4 bytes a copy: rows of an
//      odd or 7850-wide W are not 16-byte aligned, so neither 16-byte
//      copies nor TMA apply); each thread checks the values it copied, and
//      __syncthreads_or tells the block whether the whole slab is finite;
//   3. a warp takes an output row's chunk, four columns a lane, and runs
//      its slots from shared memory in order with __fmul_rn / __fadd_rn
//      (never contracted into an FMA), the plain version's arithmetic; the
//      row is written straight to out[i].  On a
//      finite slab it takes the compacted list: 0 * w[j] is then +-0 and
//      leaving it out keeps the sum's value (a zero's sign may differ, as
//      +0 + -0 does).  On a slab holding inf or NaN it takes every slot,
//      read from global memory, so 0 * inf gives NaN as in the reference.
// Blocks are numbered groups-fastest and take chunks y, y + gridDim.y, ..
// so the blocks in flight share a few column chunks whose m x 128 x 4
// bytes stay in L2: W comes from device memory about once, and from L2
// about (union rows / group rows) times.  Two blocks share an SM, so one
// computes while the other copies.
//
// A row whose own neighbourhood does not fit one slab (more than ~170
// distinct rows read at d_max 47; plan.limits) cannot be staged.  The plan
// lists such rows apart, and a second kernel, mix_sparse_direct_kernel,
// mixes them straight from global memory: a 256-thread block takes 4 listed rows and
// a 1024-column chunk, 4 columns 256 apart a thread, every slot taken in
// order with the same __fmul_rn / __fadd_rn arithmetic.  Its blocks are
// numbered rows-fastest, so the blocks in flight share one column chunk
// of W in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// CHUNK, ROWS_MAX and SMEM_BUDGET are those of kernels/mixing/plan.py
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
                  const int* __restrict__ self_pos, int d_max, long long D, int umax,
                  int rmax, int n_chunks) {
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

// rows that do not fit a slab: 4 listed rows and 1024 columns a block
constexpr int DIRECT_NT = 256, DIRECT_ROWS = 4, DIRECT_CHUNK = 4 * DIRECT_NT;

__global__ void __launch_bounds__(DIRECT_NT)
mix_sparse_direct_kernel(const int64_t* __restrict__ idx, const float* __restrict__ p_diag,
                         const float* __restrict__ p_off, const float* __restrict__ w,
                         float* __restrict__ out, const int* __restrict__ rows, int n_rows,
                         int d_max, long long D) {
  const int r0 = blockIdx.x * DIRECT_ROWS;
  const long long c0 = (long long)blockIdx.y * DIRECT_CHUNK + threadIdx.x;
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
    const int64_t* ii = idx + i * d_max;
    const float* pi = p_off + i * d_max;
    for (int s = 0; s < d_max; ++s) {
      const float p = __ldg(pi + s);
      const float* wj = w + __ldg(ii + s) * D;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long c = c0 + q * DIRECT_NT;
        if (c < D) acc[q] = __fadd_rn(acc[q], __fmul_rn(p, __ldg(wj + c)));
      }
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

// idx: (m, d_max) int64, p_diag: (m,) fp32, p_off: (m, d_max) fp32,
// w and out: (m, D) fp32, all row-major; the plan's int32 tables (rows,
// row_ptr, uni, uni_ptr, slot_pos, self_pos) from kernels/mixing/plan.py
// with n_groups staged groups, the largest union umax rows and the
// largest group rmax rows.  Launches on `stream` and returns the CUDA error
// of the launch (0 on success).
extern "C" int repro_mix_sparse_f32(const int64_t* idx, const float* p_diag,
                                    const float* p_off, const float* w, float* out,
                                    const int* rows, const int* row_ptr, const int* uni,
                                    const int* uni_ptr, const int* slot_pos,
                                    const int* self_pos, long long n_groups,
                                    long long d_max, long long D, long long umax,
                                    long long rmax, void* stream) {
  if (umax > UNION_MAX || rmax > ROWS_MAX) return (int)cudaErrorInvalidValue;
  const long long list = rmax * d_max;
  const size_t smem = 4 * ((umax * CHUNK > 2 * list ? umax * CHUNK : 2 * list) + 2 * list + rmax);
  const bool v2 = D % 2 == 0 && (uintptr_t)w % 8 == 0 && (uintptr_t)out % 8 == 0;
  auto kernel = v2 ? mix_sparse_kernel<2> : mix_sparse_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (int)((D + CHUNK - 1) / CHUNK);
  dim3 grid((unsigned int)n_groups,
            (unsigned int)((n_chunks + CHUNKS_PER_BLOCK - 1) / CHUNKS_PER_BLOCK));
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(idx, p_diag, p_off, w, out, rows, row_ptr,
                                                  uni, uni_ptr, slot_pos, self_pos, (int)d_max,
                                                  D, (int)umax, (int)rmax, n_chunks);
  return (int)cudaGetLastError();
}

// The rows of W listed in rows (n_rows int32 ids) that the plan could not
// stage, mixed from global memory; other arguments as above.
extern "C" int repro_mix_sparse_direct_f32(const int64_t* idx, const float* p_diag,
                                           const float* p_off, const float* w, float* out,
                                           const int* rows, long long n_rows, long long d_max,
                                           long long D, void* stream) {
  dim3 grid((unsigned int)((n_rows + DIRECT_ROWS - 1) / DIRECT_ROWS),
            (unsigned int)((D + DIRECT_CHUNK - 1) / DIRECT_CHUNK));
  mix_sparse_direct_kernel<<<grid, DIRECT_NT, 0, (cudaStream_t)stream>>>(
      idx, p_diag, p_off, w, out, rows, (int)n_rows, (int)d_max, D);
  return (int)cudaGetLastError();
}
