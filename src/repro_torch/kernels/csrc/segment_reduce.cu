// segment_sum_tiles and segment_minmax_tiles: per-group partial folds of one
// factorized morsel.
//
// Replaces the TPU kernels in src/repro/kernels/segment_reduce.py:
// segment_sum_tiles (body _sum_kernel, _onehot) and segment_minmax_tiles
// (body _minmax_kernel).
//
// segment_sum_tiles: sums (G, S) int32 of 8-bit limb planes per group, plus
// the group counts (G,), over rows < n_rows.  The host keeps every limb sum
// below 2^26 (SUM_ROW_CAP rows), so int32 addition is exact in any order and
// atomics give the same bits as the TPU's one-hot matmul.
//   Bound: bytes.  Reads gidx (4·N) and limbs (4·N·S) once, writes the sums
//   and counts: 4·(N·(S+1) + G·(S+1)) bytes at 3.35 TB/s.
//
// segment_minmax_tiles: per-group min or max of each of M columns (fns picks
// per column), float32 or int32.  Empty groups hold the identities: +inf /
// -inf for float32, INT32_MAX / INT32_MIN for int32.
//   Bound: bytes.  Reads gidx (4·N) and vals (4·N·M), writes 4·G·M.
//   float32 reduces through the order-preserving key b >= 0 ? b : b ^ 0x7FFFFFFF
//   and is decoded after.  That order puts -0.0 below +0.0 and a NaN beyond
//   the infinities, where numpy's sequential fold keeps the later of two tied
//   zeros and propagates NaN; the backend therefore never sends a float32
//   column that holds NaN, ±inf or -0.0 (the plain version defines the same
//   key order for any input).
//
// Design: the TPU kernels walk the row tiles in order and carry the
// accumulators from one grid step to the next.  Blocks on Hopper run in no
// order, so each block takes a range of rows, folds it into shared memory
// with int32 atomicAdd / atomicMin / atomicMax, and then folds its partials
// into the output with global atomics.  Columns tile over gridDim.y so that
// shared memory stays within the default 48 KB for any G.  Rows whose group
// id lies outside [0, G) are skipped, as the one-hot never matches them.
#include "common.cuh"

#define ROWS_PER_BLOCK 2048
#define COLS_MAX 32
#define SHARED_INTS 12288  // 48 KB

// --- segment sum -------------------------------------------------------------
__global__ void segment_sum_kernel(const int32_t* __restrict__ gidx, const int32_t* __restrict__ limbs, int S,
                                   int n_rows, int G, int cpb, int32_t* __restrict__ sums,
                                   int32_t* __restrict__ counts) {
  extern __shared__ int32_t sh[];
  const int c0 = blockIdx.y * cpb;
  const int cols = dacp_imax(0, dacp_imin(cpb, S - c0));
  int32_t* sh_sum = sh;
  int32_t* sh_cnt = sh + G * cpb;
  const bool do_count = blockIdx.y == 0;
  for (int i = threadIdx.x; i < G * (cpb + 1); i += blockDim.x) sh[i] = 0;
  __syncthreads();

  const int64_t r0 = (int64_t)blockIdx.x * ROWS_PER_BLOCK;
  const int64_t r1 = dacp_min64(r0 + ROWS_PER_BLOCK, (int64_t)n_rows);
  if (cols > 0) {
    const int64_t n_el = (r1 - r0) * cols;
    for (int64_t e = threadIdx.x; e < n_el; e += blockDim.x) {
      const int64_t r = r0 + e / cols;
      const int c = (int)(e % cols);
      const int g = gidx[r];
      if (g >= 0 && g < G) atomicAdd(&sh_sum[g * cpb + c], limbs[r * S + c0 + c]);
    }
  }
  if (do_count) {
    for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      const int g = gidx[r];
      if (g >= 0 && g < G) atomicAdd(&sh_cnt[g], 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * cols; i += blockDim.x) {
    const int g = i / cols;
    const int c = i % cols;
    const int32_t v = sh_sum[g * cpb + c];
    if (v != 0) atomicAdd(&sums[(int64_t)g * S + c0 + c], v);
  }
  if (do_count) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      const int32_t v = sh_cnt[g];
      if (v != 0) atomicAdd(&counts[g], v);
    }
  }
}

// gidx (N,), limbs (N, S) row-major; sums (G, S) and counts (G,) must be
// zero on entry.
DACP_API int dacp_segment_sum(const int32_t* gidx, const int32_t* limbs, int S, int n_rows, int G, int32_t* sums,
                              int32_t* counts, void* stream) {
  if (S < 0 || n_rows < 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const int cpb = dacp_imin(COLS_MAX, SHARED_INTS / G - 1);
  if (cpb < 1) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return dacp_last_error();
  const dim3 grid((unsigned)((n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK), (unsigned)dacp_imax(1, (S + cpb - 1) / cpb));
  const size_t shmem = sizeof(int32_t) * (size_t)G * (cpb + 1);
  segment_sum_kernel<<<grid, DACP_THREADS, shmem, (cudaStream_t)stream>>>(gidx, limbs, S, n_rows, G, cpb, sums,
                                                                         counts);
  return dacp_last_error();
}

// --- segment min / max ---------------------------------------------------------
// Bit j set: column j of the launch takes the max, else the min.
struct FnBits {
  uint32_t w[COLS_MAX / 32];
};

__device__ __forceinline__ bool is_max(const FnBits& f, int c) { return (f.w[c >> 5] >> (c & 31)) & 1u; }

// Identity key of a column: the key of +inf / -inf for float32, the int32
// extremes for int32.
__device__ __forceinline__ int32_t identity_key(bool f32, bool mx) {
  if (f32) return mx ? dacp_f32_key((int32_t)0xFF800000u) : (int32_t)0x7F800000;
  return mx ? INT32_MIN : INT32_MAX;
}

// vals and out are viewed at column c0 with row stride ld; this launch owns
// m <= COLS_MAX columns.
__global__ void minmax_init_kernel(int32_t* __restrict__ out, int ld, int m, int G, bool f32, FnBits fns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * m) return;
  const int c = i % m;
  out[(int64_t)(i / m) * ld + c] = identity_key(f32, is_max(fns, c));
}

__global__ void minmax_kernel(const int32_t* __restrict__ gidx, const int32_t* __restrict__ vals, int ld, int m,
                              int n_rows, int G, bool f32, FnBits fns, int32_t* __restrict__ out) {
  extern __shared__ int32_t sh[];  // (G, m) keys
  for (int i = threadIdx.x; i < G * m; i += blockDim.x) sh[i] = identity_key(f32, is_max(fns, i % m));
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * ROWS_PER_BLOCK;
  const int64_t r1 = dacp_min64(r0 + ROWS_PER_BLOCK, (int64_t)n_rows);
  const int64_t n_el = (r1 - r0) * m;
  for (int64_t e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int64_t r = r0 + e / m;
    const int c = (int)(e % m);
    const int g = gidx[r];
    if (g < 0 || g >= G) continue;
    const int32_t v = vals[r * ld + c];
    const int32_t k = f32 ? dacp_f32_key(v) : v;
    if (is_max(fns, c)) {
      atomicMax(&sh[g * m + c], k);
    } else {
      atomicMin(&sh[g * m + c], k);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * m; i += blockDim.x) {
    const int c = i % m;
    int32_t* dst = &out[(int64_t)(i / m) * ld + c];
    if (is_max(fns, c)) {
      atomicMax(dst, sh[i]);
    } else {
      atomicMin(dst, sh[i]);
    }
  }
}

__global__ void minmax_decode_kernel(int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = dacp_f32_key(out[i]);
}

// gidx (N,), vals (N, M) row-major float32 (is_f32 = 1) or int32, out (G, M)
// of the same dtype; fns[j] != 0 takes the max of column j.  Columns run in
// chunks of COLS_MAX: one init and one fold kernel per chunk, then one decode
// for float32.
DACP_API int dacp_segment_minmax(const int32_t* gidx, const void* vals, int M, int n_rows, int G, int is_f32,
                                 const int* fns, void* out, void* stream) {
  if (M < 0 || n_rows < 0 || G <= 0 || (int64_t)G * COLS_MAX > SHARED_INTS * 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool f32 = is_f32 != 0;
  const int32_t* v = (const int32_t*)vals;
  int32_t* o = (int32_t*)out;
  const unsigned row_blocks = (unsigned)((n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  for (int c0 = 0; c0 < M; c0 += COLS_MAX) {
    const int m = dacp_imin(COLS_MAX, M - c0);
    FnBits bits = {};
    for (int c = 0; c < m; ++c)
      if (fns[c0 + c]) bits.w[c >> 5] |= 1u << (c & 31);
    minmax_init_kernel<<<(G * m + DACP_THREADS - 1) / DACP_THREADS, DACP_THREADS, 0, s>>>(o + c0, M, m, G, f32, bits);
    if (row_blocks > 0) {
      const size_t shmem = sizeof(int32_t) * (size_t)G * m;
      if (shmem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(minmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
        if (e != cudaSuccess) return (int)e;
      }
      minmax_kernel<<<row_blocks, DACP_THREADS, shmem, s>>>(gidx, v + c0, M, m, n_rows, G, f32, bits, o + c0);
    }
  }
  if (f32 && M > 0) {
    const int64_t n = (int64_t)G * M;
    minmax_decode_kernel<<<(unsigned)((n + DACP_THREADS - 1) / DACP_THREADS), DACP_THREADS, 0, s>>>(o, n);
  }
  return dacp_last_error();
}
