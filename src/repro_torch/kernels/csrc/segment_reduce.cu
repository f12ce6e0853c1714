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
//   float32 reduces in the order of the key b >= 0 ? b : b ^ 0x7FFFFFFF
//   (dacp_f32_key).  That order puts -0.0 below +0.0 and a NaN beyond
//   the infinities, where numpy's sequential fold keeps the later of two tied
//   zeros and propagates NaN; the backend therefore never sends a float32
//   column that holds NaN, ±inf or -0.0 (the plain version defines the same
//   key order for any input).
//   A call moves 0.5 MB at the aggregate COOK's morsel (65536 rows, one
//   column, 200 Zipf-skewed stations): 0.16 µs at 3.35 TB/s, far below two
//   launches, so what counts is few launches, a full card and no
//   serialising on the hot group.
//   Design: a grid-stride loop over blocks of 1024 threads, at most one
//   block per SM (64 blocks at the morsel), one row a thread, each
//   thread's next row loaded while its row folds.  A shared bin folds the
//   min of the key for a min column and of ~key for a max column (~
//   reverses the order), so both start from one identity and every atomic
//   is a min.  Each row goes straight to a shared atomicMin: Hopper's
//   shared atomics absorb the hot group's conflicts more cheaply than the
//   warp aggregation of segment_sum_tiles (__match_any_sync and a shuffle
//   tree), and the fold pays per block and per row step, not per row
//   (PERF.md keeps the runs).  A block flushes
//   only the bins it moved off the identity, and flushes values, not keys:
//   the key order on float32 bits is the signed order on non-negative
//   patterns and the reversed unsigned order below them, so an int32
//   atomicMin / atomicMax or, for a negative pattern, an unsigned
//   atomicMax / atomicMin folds the value in place, and no pass decodes
//   the output.  A call is two launches: minmax_init_kernel (the output's
//   identities) and minmax_kernel.
#include "dataplane.cuh"

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
  int sms = 0;
  const cudaError_t e = dacp_sm_count(&sms);
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
#define MM_THREADS 1024  // a block's threads, and the fewest rows that earn a block
#define MM_BLOCKS_PER_SM 1  // the grid's cap: blocks per SM
#define MM_SHARED_INTS (4 * SHARED_INTS)  // 192 KB of bins: COLS_MAX columns of 1536 groups
#define MM_GROUP_COLS 1024  // columns one init + fold launch pair covers: 32 chunks of COLS_MAX
#define MM_NV 4             // columns a warp folds at once when a launch has more than one

// Bit j set: column j of the launch group takes the max, else the min.
struct FnBits {
  uint32_t w[MM_GROUP_COLS / 32];
};

__device__ __forceinline__ bool is_max(const FnBits& f, int c) { return (f.w[c >> 5] >> (c & 31)) & 1u; }

// A shared bin folds the min of x = key (a min column) or ~key (a max
// column, whose order ~ reverses), so one identity serves both: the key of
// +inf for float32 (~ of -inf's key is the same bits), INT32_MAX for int32.
__device__ __forceinline__ int32_t bin_identity(bool f32) { return f32 ? 0x7F800000 : INT32_MAX; }

// out[p] := the min (mx: the max) of out[p] and b in the key order, on the
// value bits themselves.  int32 and non-negative float32 patterns order as
// signed ints; negative float32 patterns lie below them and order as
// reversed unsigned ints.  Each atomic below computes exactly that min
// (max) whatever out[p] holds, so they commute, and the output needs no
// decode afterwards.
__device__ __forceinline__ void fold_value(int32_t* p, int32_t b, bool f32, bool mx) {
  if (!f32 || b >= 0) {
    mx ? atomicMax(p, b) : atomicMin(p, b);
  } else {
    unsigned* u = reinterpret_cast<unsigned*>(p);
    mx ? atomicMin(u, (unsigned)b) : atomicMax(u, (unsigned)b);
  }
}

// The launch group's (G, m) columns of out (row stride ld) to their
// identities: +inf / -inf for float32, INT32_MAX / INT32_MIN for int32.
__global__ void minmax_init_kernel(int32_t* __restrict__ out, int ld, int m, int G, bool f32,
                                   const __grid_constant__ FnBits fns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * m) return;
  const int c = i % m;
  const bool mx = is_max(fns, c);
  out[(int64_t)(i / m) * ld + c] = f32 ? (mx ? (int32_t)0xFF800000u : 0x7F800000) : (mx ? INT32_MIN : INT32_MAX);
}

// One launch group of m_all columns of vals and out (row stride ld);
// blockIdx.y takes the chunk of COLS_MAX columns at c0.  NV: columns
// folded at once.
template <bool F32, int NV>
__global__ void __launch_bounds__(MM_THREADS)
    minmax_kernel(const int32_t* __restrict__ gidx, const int32_t* __restrict__ vals, int ld, int m_all, int n_rows,
                  int G, const __grid_constant__ FnBits fns, int32_t* __restrict__ out) {
  extern __shared__ int32_t sh[];  // (G, m) bins
  const int t = threadIdx.x;
  const int c0 = blockIdx.y * COLS_MAX;
  const int m = dacp_imin(COLS_MAX, m_all - c0);
  const int32_t ident = bin_identity(F32);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t r = (int64_t)blockIdx.x * blockDim.x + t;
  // a row's group id and first NV values; the next row's are in flight
  // while this one folds, and the first row's while the bins are set
  auto fetch = [&](int64_t row, int& row_g, int32_t(&row_b)[NV]) {
    const bool in = row < n_rows;
#pragma unroll
    for (int j = 0; j < NV; ++j) row_b[j] = in && j < m ? vals[row * ld + c0 + j] : 0;
    row_g = in ? gidx[row] : -1;
  };
  int g;
  int32_t b[NV];
  fetch(r, g, b);
  for (int i = t; i < G * m; i += blockDim.x) sh[i] = ident;
  __syncthreads();

  for (; r < n_rows; r += stride) {
    int g_next;
    int32_t b_next[NV];
    fetch(r + stride, g_next, b_next);
    if (g >= 0 && g < G) {
      for (int cc = 0; cc < m; cc += NV) {
        if (cc > 0) {  // a later chunk of a wide launch
#pragma unroll
          for (int j = 0; j < NV; ++j) b[j] = cc + j < m ? vals[r * ld + c0 + cc + j] : 0;
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = cc + j;
          if (c >= m) break;
          const int32_t key = F32 ? dacp_f32_key(b[j]) : b[j];
          atomicMin(&sh[g * m + c], is_max(fns, c0 + c) ? ~key : key);
        }
      }
    }
    g = g_next;
#pragma unroll
    for (int j = 0; j < NV; ++j) b[j] = b_next[j];
  }
  __syncthreads();

  // only the bins this block moved off the identity reach global memory,
  // as values: ~ back for a max column, the key decoded for float32
  for (int i = t; i < G * m; i += blockDim.x) {
    const int32_t v = sh[i];
    if (v == ident) continue;
    const int c = i % m;
    const bool mx = is_max(fns, c0 + c);
    const int32_t key = mx ? ~v : v;
    fold_value(&out[(int64_t)(i / m) * ld + c0 + c], F32 ? dacp_f32_key(key) : key, F32, mx);
  }
}

// gidx (N,), vals (N, M) row-major float32 (is_f32 = 1) or int32, out (G, M)
// of the same dtype; fns[j] != 0 takes the max of column j.  Columns run in
// groups of MM_GROUP_COLS: per group one init and one fold launch, the
// fold's blockIdx.y walking the group's chunks of COLS_MAX.
DACP_API int dacp_segment_minmax(const int32_t* gidx, const void* vals, int M, int n_rows, int G, int is_f32,
                                 const int* fns, void* out, void* stream) {
  if (M < 0 || n_rows < 0 || G <= 0 || (int64_t)G * COLS_MAX > MM_SHARED_INTS) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = dacp_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const bool f32 = is_f32 != 0;
  const int32_t* v = (const int32_t*)vals;
  int32_t* o = (int32_t*)out;
  const int64_t row_blocks = ((int64_t)n_rows + MM_THREADS - 1) / MM_THREADS;
  for (int c0 = 0; c0 < M; c0 += MM_GROUP_COLS) {
    const int mg = dacp_imin(MM_GROUP_COLS, M - c0);
    FnBits bits = {};
    for (int c = 0; c < mg; ++c)
      if (fns[c0 + c]) bits.w[c >> 5] |= 1u << (c & 31);
    minmax_init_kernel<<<(G * mg + DACP_THREADS - 1) / DACP_THREADS, DACP_THREADS, 0, s>>>(o + c0, M, mg, G, f32, bits);
    if (row_blocks == 0) continue;  // the identities are the result
    decltype(&minmax_kernel<true, 1>) kernel =
        f32 ? (M == 1 ? minmax_kernel<true, 1> : minmax_kernel<true, MM_NV>)
            : (M == 1 ? minmax_kernel<false, 1> : minmax_kernel<false, MM_NV>);
    const size_t shmem = sizeof(int32_t) * (size_t)G * dacp_imin(COLS_MAX, mg);
    if (shmem > 48 * 1024) {  // always to the most any launch asks, so that racing callers agree
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SHARED_INTS * 4);
      if (e != cudaSuccess) return (int)e;
    }
    // a grid-stride loop over the rows: at most MM_BLOCKS_PER_SM blocks per SM
    const dim3 grid((unsigned)dacp_min64(row_blocks, (int64_t)sms * MM_BLOCKS_PER_SM),
                    (unsigned)((mg + COLS_MAX - 1) / COLS_MAX));
    kernel<<<grid, MM_THREADS, shmem, s>>>(gidx, v + c0, M, mg, n_rows, G, bits, o + c0);
  }
  return dacp_last_error();
}
