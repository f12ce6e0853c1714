// segment_sum_tiles and segment_minmax_tiles: per-group partial folds of one
// factorized morsel.
//
// Replaces the TPU kernels in src/repro/kernels/segment_reduce.py:
// segment_sum_tiles (body _sum_kernel, _onehot) and segment_minmax_tiles
// (body _minmax_kernel).  The TPU kernels walk the row tiles in order and
// carry the accumulators from one grid step to the next; blocks on Hopper
// run in no order, so each block folds its rows into shared memory and then
// folds its partials into the output with global atomics.  Rows whose group
// id lies outside [0, G) are skipped, as the one-hot never matches them.
//
// segment_sum_tiles: sums (G, S) int32 of 8-bit limb planes per group, plus
// the group counts (G,), over rows < n_rows.  The host keeps every limb sum
// below 2^26 (SUM_ROW_CAP rows), so int32 addition is exact in any order and
// atomics give the same bits as the TPU's one-hot matmul.
//   Bound: bytes.  Reads gidx (4·N) and limbs (4·N·S) once, writes the sums
//   and counts: 4·(N·(S+1) + G·(S+1)) bytes at 3.35 TB/s, 0.7 µs at one
//   65536-row morsel of 8 limbs — far below a launch, so what counts is
//   filling the card and not serialising on hot groups.  Group ids are
//   skewed (Zipf over 200 stations: a fifth of the rows in one group), and
//   same-address shared atomics of one warp serialise.
//   Design: a grid-stride loop over at most two blocks per SM (256 blocks
//   for a 65536-row morsel), one thread per row: it reads its group id
//   once and its limbs with 16-byte loads where the rows allow, and the
//   count rides along as one more column.  Before any shared atomic the
//   warp aggregates: __match_any_sync on the group id, then a shuffle tree
//   over each set of lanes that share it (dacp_peer_sum in dataplane.cuh),
//   so the set's lowest lane adds once per column — a warp whose 32 rows
//   are all one station does 9 shared atomics instead of 288.  Each half of
//   the block keeps its own (G, cols + 1) bins where two copies fit in
//   48 KB; the block then flushes the nonzero bins with global atomics.
//   Columns tile over gridDim.y (at most 32 a block) so that the bins fit
//   for any G the gate takes.
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
//   Design: each block takes 2048 rows, one element per thread and step,
//   and folds them with int32 atomicMin / atomicMax into shared keys.
#include "dataplane.cuh"

#define ROWS_PER_BLOCK 2048
#define COLS_MAX 32
#define SHARED_INTS 12288  // 48 KB

// --- segment sum -------------------------------------------------------------
#define SUM_THREADS 256
#define SUM_CHUNK 8  // limb columns a thread folds at once (two int4 loads)

// VEC: every row's limbs of this launch start 16-byte aligned (limbs
// aligned, S and the column offsets multiples of 4), so full chunks load as
// two int4.  bins: copies × G × ld ints, ld = cols + 1 (the count last).
template <bool VEC>
__global__ void __launch_bounds__(SUM_THREADS)
    segment_sum_kernel(const int32_t* __restrict__ gidx, const int32_t* __restrict__ limbs, int S, int n_rows, int G,
                       int cpb, int ld, int copies, int32_t* __restrict__ sums, int32_t* __restrict__ counts) {
  extern __shared__ int32_t sh[];
  const int c0 = blockIdx.y * cpb;
  const int cols = dacp_imax(0, dacp_imin(cpb, S - c0));
  const int n_bins = G * ld;
  const bool do_count = blockIdx.y == 0;
  for (int i = threadIdx.x; i < copies * n_bins; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  int32_t* bins = sh + (copies > 1 && threadIdx.x >= blockDim.x / 2 ? n_bins : 0);

  const int lane = threadIdx.x & 31;
  const int n_chunks = dacp_imax(1, (cols + SUM_CHUNK - 1) / SUM_CHUNK);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // the whole warp walks the rows together: the aggregation needs all 32 lanes
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n_rows; base += stride) {
    const int64_t r = base + lane;
    int g = r < n_rows ? gidx[r] : -1;
    const bool ok = g >= 0 && g < G;
    if (!ok) g = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const int32_t* row = limbs + r * S + c0;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int c = ch * SUM_CHUNK;
      const int n = dacp_imin(SUM_CHUNK, cols - c);
      int32_t v[SUM_CHUNK + 1];
      if (VEC && ok && n == SUM_CHUNK) {
        const int4 a = *reinterpret_cast<const int4*>(row + c);
        const int4 b = *reinterpret_cast<const int4*>(row + c + 4);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < SUM_CHUNK; ++j) v[j] = ok && j < n ? row[c + j] : 0;
      }
      v[SUM_CHUNK] = ok && do_count && ch == 0 ? 1 : 0;
      if (dacp_peer_sum(peers, v) && ok) {
        int32_t* dst = bins + g * ld;
#pragma unroll
        for (int j = 0; j < SUM_CHUNK; ++j)
          if (j < n && v[j] != 0) atomicAdd(&dst[c + j], v[j]);
        if (v[SUM_CHUNK] != 0) atomicAdd(&dst[ld - 1], v[SUM_CHUNK]);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int32_t v = copies > 1 ? sh[i] + sh[n_bins + i] : sh[i];
    if (v == 0) continue;
    const int g = i / ld, j = i % ld;
    if (j == ld - 1) {
      if (do_count) atomicAdd(&counts[g], v);
    } else if (j < cols) {
      atomicAdd(&sums[(int64_t)g * S + c0 + j], v);
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
  const int y_blocks = dacp_imax(1, (S + cpb - 1) / cpb);
  const int ld = dacp_imin(cpb, S) + 1;
  const int copies = 2 * G * ld <= SHARED_INTS ? 2 : 1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t row_blocks = ((int64_t)n_rows + SUM_THREADS - 1) / SUM_THREADS;
  const dim3 grid((unsigned)dacp_min64(row_blocks, 2 * (int64_t)sms), (unsigned)y_blocks);
  const size_t shmem = sizeof(int32_t) * (size_t)copies * G * ld;
  const bool vec = ((uintptr_t)limbs % 16 == 0) && S % 4 == 0 && (y_blocks == 1 || cpb % 4 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    segment_sum_kernel<true><<<grid, SUM_THREADS, shmem, s>>>(gidx, limbs, S, n_rows, G, cpb, ld, copies, sums, counts);
  } else {
    segment_sum_kernel<false><<<grid, SUM_THREADS, shmem, s>>>(gidx, limbs, S, n_rows, G, cpb, ld, copies, sums, counts);
  }
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
