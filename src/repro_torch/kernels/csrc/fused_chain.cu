// fused_chain_tiles: a whole filter -> project -> compaction -> segment fold
// chain over one morsel in one launch.
//
// Replaces the TPU kernel src/repro/kernels/fused_pipeline.py
// fused_chain_tiles (body _kernel, with _mm_fold).
//
// What it computes, for each tile of `tile` rows:
//   1. the predicate mask `col <op> threshold` on the filter column's planes
//      (or every row, kind "none"), masked to rows < n_rows;
//   2. the f32 and i32 projection programs on the af / ai rows (element-wise,
//      so a surviving row carries the value the per-op path computes after
//      filtering: same interpreter, same host-NaN rule, denormals kept);
//   3. the surviving rows of [pass planes | computed f32 bits | computed i32 |
//      gidx?] at the front of their tile in row order, the rest of the tile
//      zero, and the tile's survivor count;
//   4. with `segmented`, the per-group fold of the survivors: 8-bit-limb sums
//      of the limb table plus an in-kernel 4-limb split of each summed
//      computed i32 column (top limb by arithmetic shift), group counts,
//      f32 / i32 min or max per column, and each group's smallest surviving
//      row index.  Without it the group outputs keep their initial values:
//      zeros, the min/max identities and 2^31-1.
//
// Bound: bytes.  The function reads each input table once and writes ctab,
// the counts and the group outputs once; a few f32 operations per row and
// column are far below the card's 67 TFLOP/s.
//
// Design: the TPU kernel compacts with a one-hot int32 matmul on the MXU and
// carries the group state from one grid step to the next.  Neither carries
// over.  Here a block of `tile` threads walks `tiles_per_block` tiles, one
// row per thread: the predicate and the stable block prefix sum of
// filter_select.cu give each survivor its slot, and the survivor writes its
// own ctab row, running the postfix programs of project_arith.cu (passed as
// __grid_constant__ parameters, so a new literal rebuilds nothing).  The
// segment fold goes into shared-memory accumulators with int32 atomics and
// then into the outputs with global atomics; float32 min/max reduce through
// the order-preserving key of segment_reduce.cu and a last kernel decodes
// them.  This is exact because integer addition and min/max commute: the
// host keeps limb sums below 2^26 (SUM_ROW_CAP rows) and sends no float32
// min/max column that holds NaN, ±inf or -0.0.  The host computes the shared
// footprint from the plan and refuses a plan above the card's 227 KB before
// any launch.  Skewed groups serialise the shared atomics, as in
// segment_reduce.cu.
#include "dataplane.cuh"

#define CSUM_MAX 64
#define MM_COLS_MAX 256
// 227 KB (232448 bytes) of shared memory per block, less the 128 static bytes
// of warp_total.
#define SHARED_MAX_BYTES 232320

// Bit j set: column j takes the max, else the min.
struct MmBits {
  uint32_t w[MM_COLS_MAX / 32];
};

__device__ __forceinline__ bool mm_is_max(const MmBits& f, int c) { return (f.w[c >> 5] >> (c & 31)) & 1u; }

struct FusedArgs {
  const int32_t* pred;
  const int32_t* gidx;
  const int32_t* pass;
  const int32_t* limb;
  const int32_t* mmf;  // float32 bits
  const int32_t* mmi;
  const float* af;
  const int32_t* ai;
  int32_t* ctab;
  int32_t* counts;
  int32_t* gsum;
  int32_t* gcnt;
  int32_t* gmmf;  // order-preserving keys until the decode kernel
  int32_t* gmmi;
  int32_t* gfirst;
  int64_t n_tiles;
  int n_rows;
  int P, Dp, L, Mf, Mi, Af, Ai, Dc, LS;
  int nf, ni, ncs;
  int with_gidx;
  int G;
  int tiles_per_block;
  int op, kind;
  int32_t t_hi, t_lo;
  int csums[CSUM_MAX];
  MmBits fns_f, fns_i;
};

__device__ __forceinline__ int32_t mm_identity(bool f32, bool mx) {
  if (f32) return mx ? dacp_f32_key((int32_t)0xFF800000u) : (int32_t)0x7F800000;
  return mx ? INT32_MIN : INT32_MAX;
}

template <bool SEG>
__global__ void fused_chain_kernel(const __grid_constant__ FusedArgs a, const __grid_constant__ Program pf,
                                   const __grid_constant__ Program pi) {
  extern __shared__ int32_t sh[];  // SEG: [G·LS sums | G counts | G·Mf f-keys | G·Mi i-vals | G first rows]
  __shared__ int warp_total[32];
  const int tile = blockDim.x;
  const int t = threadIdx.x;
  const int G = a.G;
  int32_t* s_sum = sh;
  int32_t* s_cnt = s_sum + G * a.LS;
  int32_t* s_f = s_cnt + G;
  int32_t* s_i = s_f + G * a.Mf;
  int32_t* s_first = s_i + G * a.Mi;
  if (SEG) {
    for (int i = t; i < G * (a.LS + 1); i += tile) sh[i] = 0;
    for (int i = t; i < G * a.Mf; i += tile) s_f[i] = mm_identity(true, mm_is_max(a.fns_f, i % a.Mf));
    for (int i = t; i < G * a.Mi; i += tile) s_i[i] = mm_identity(false, mm_is_max(a.fns_i, i % a.Mi));
    for (int i = t; i < G; i += tile) s_first[i] = INT32_MAX;
    __syncthreads();
  }

  for (int k = 0; k < a.tiles_per_block; ++k) {
    const int64_t tile_idx = (int64_t)blockIdx.x * a.tiles_per_block + k;
    if (tile_idx >= a.n_tiles) break;  // uniform across the block
    const int64_t base = tile_idx * tile;
    const int64_t row = base + t;
    const bool m = row < a.n_rows && dacp_pred_rt(a.op, a.kind, a.pred + row * a.P, a.t_hi, a.t_lo);
    int total;
    const int slot = dacp_block_slot(m, warp_total, &total);

    if (m) {
      int32_t* dst = a.ctab + (base + slot) * a.Dc;
      const int32_t* src = a.pass + row * a.Dp;
      for (int d = 0; d < a.Dp; ++d) dst[d] = src[d];
      if (a.nf > 0) {
        int32_t* out = dst + a.Dp;
        dacp_run_program(pf, a.af + row * a.Af, [out](int c, float v) { out[c] = __float_as_int(v); });
      }
      int32_t* icols = dst + a.Dp + a.nf;
      if (a.ni > 0) dacp_run_program(pi, a.ai + row * a.Ai, [icols](int c, int32_t v) { icols[c] = v; });
      if (a.with_gidx) dst[a.Dc - 1] = a.gidx[row];
      if (SEG) {
        const int g = a.gidx[row];
        if (g >= 0 && g < G) {
          int32_t* gs = s_sum + g * a.LS;
          const int32_t* limbs = a.limb + row * a.L;
          for (int c = 0; c < a.L; ++c) {
            const int32_t v = limbs[c];
            if (v != 0) atomicAdd(&gs[c], v);
          }
          for (int j = 0; j < a.ncs; ++j) {
            const int32_t v = icols[a.csums[j]];  // this thread's own store above
            int32_t* q = gs + a.L + 4 * j;
            atomicAdd(&q[0], v & 0xFF);
            atomicAdd(&q[1], (v >> 8) & 0xFF);
            atomicAdd(&q[2], (v >> 16) & 0xFF);
            atomicAdd(&q[3], v >> 24);  // signed top limb (arithmetic shift)
          }
          atomicAdd(&s_cnt[g], 1);
          for (int j = 0; j < a.Mf; ++j) {
            const int32_t key = dacp_f32_key(a.mmf[row * a.Mf + j]);
            if (mm_is_max(a.fns_f, j)) {
              atomicMax(&s_f[g * a.Mf + j], key);
            } else {
              atomicMin(&s_f[g * a.Mf + j], key);
            }
          }
          for (int j = 0; j < a.Mi; ++j) {
            const int32_t v = a.mmi[row * a.Mi + j];
            if (mm_is_max(a.fns_i, j)) {
              atomicMax(&s_i[g * a.Mi + j], v);
            } else {
              atomicMin(&s_i[g * a.Mi + j], v);
            }
          }
          atomicMin(&s_first[g], (int32_t)row);
        }
      }
    }
    if (t >= total) {
      int32_t* dst = a.ctab + row * a.Dc;
      for (int d = 0; d < a.Dc; ++d) dst[d] = 0;
    }
    if (t == 0) a.counts[tile_idx] = total;
  }

  if (SEG) {
    __syncthreads();
    for (int i = t; i < G * a.LS; i += tile) {
      const int32_t v = s_sum[i];
      if (v != 0) atomicAdd(&a.gsum[i], v);
    }
    for (int g = t; g < G; g += tile) {
      if (s_cnt[g] != 0) {
        atomicAdd(&a.gcnt[g], s_cnt[g]);
        atomicMin(&a.gfirst[g], s_first[g]);
      }
    }
    for (int i = t; i < G * a.Mf; i += tile) {
      if (s_cnt[i / a.Mf] == 0) continue;
      if (mm_is_max(a.fns_f, i % a.Mf)) {
        atomicMax(&a.gmmf[i], s_f[i]);
      } else {
        atomicMin(&a.gmmf[i], s_f[i]);
      }
    }
    for (int i = t; i < G * a.Mi; i += tile) {
      if (s_cnt[i / a.Mi] == 0) continue;
      if (mm_is_max(a.fns_i, i % a.Mi)) {
        atomicMax(&a.gmmi[i], s_i[i]);
      } else {
        atomicMin(&a.gmmi[i], s_i[i]);
      }
    }
  }
}

// Group outputs to their initial values: zero sums and counts, the min/max
// identities (float32 as keys) and 2^31-1 first rows.
__global__ void fused_init_kernel(const __grid_constant__ FusedArgs a) {
  const int64_t n_sum = (int64_t)a.G * a.LS;
  const int64_t n_f = (int64_t)a.G * a.Mf;
  const int64_t n_i = (int64_t)a.G * a.Mi;
  const int64_t total = n_sum + n_f + n_i + 2 * (int64_t)a.G;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (int64_t)gridDim.x * blockDim.x) {
    int64_t j = i;
    if (j < n_sum) { a.gsum[j] = 0; continue; }
    j -= n_sum;
    if (j < a.G) { a.gcnt[j] = 0; continue; }
    j -= a.G;
    if (j < n_f) { a.gmmf[j] = mm_identity(true, mm_is_max(a.fns_f, (int)(j % a.Mf))); continue; }
    j -= n_f;
    if (j < n_i) { a.gmmi[j] = mm_identity(false, mm_is_max(a.fns_i, (int)(j % a.Mi))); continue; }
    j -= n_i;
    a.gfirst[j] = INT32_MAX;
  }
}

__global__ void fused_decode_kernel(int32_t* __restrict__ keys, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = dacp_f32_key(keys[i]);
}

static size_t fused_shared_bytes(int G, int LS, int Mf, int Mi) {
  return sizeof(int32_t) * (size_t)G * (size_t)(LS + 2 + Mf + Mi);
}

// Row tables are row-major int32 (mmf and af float32) with N rows, N a
// multiple of tile.  code_* / lits_* are the f32 and i32 postfix programs
// (one launch each, writing nf / ni columns); csums index the i32 outputs
// that the fold sums; fns_*[j] != 0 takes the max of column j.  Writes ctab
// (N, Dp + nf + ni + with_gidx), counts (N / tile), gsum (G, L + 4·ncs),
// gcnt (G), gmmf (G, Mf), gmmi (G, Mi) and gfirst (G).
DACP_API int dacp_fused_chain(const int32_t* pred, int P, const int32_t* gidx, const int32_t* pass, int Dp,
                              const int32_t* limb, int L, const void* mmf, int Mf, const int32_t* mmi, int Mi,
                              const float* af, int Af, const int32_t* ai, int Ai, int64_t N, int tile, int n_rows,
                              int32_t t_hi, int32_t t_lo, int op, int kind, const int* code_f, int n_code_f,
                              const uint32_t* lits_f, int n_lits_f, int nf, const int* code_i, int n_code_i,
                              const uint32_t* lits_i, int n_lits_i, int ni, const int* csums, int ncs,
                              const int* fns_f, const int* fns_i, int with_gidx, int segmented, int G,
                              int tiles_per_block, int32_t* ctab, int32_t* counts, int32_t* gsum, int32_t* gcnt,
                              void* gmmf, int32_t* gmmi, int32_t* gfirst, void* stream) {
  if (tile <= 0 || tile > 1024 || (tile & 31) || N < 0 || N % tile || op < 0 || op > 5 || kind < 0 || kind > 3 ||
      P < (kind == KIND_I64 ? 2 : 1) || Dp < 0 || L < 0 || Mf < 1 || Mi < 1 || Mf > MM_COLS_MAX ||
      Mi > MM_COLS_MAX || Af < 1 || Ai < 1 || nf < 0 || ni < 0 || ncs < 0 || ncs > CSUM_MAX || G <= 0 ||
      tiles_per_block < 1)
    return (int)cudaErrorInvalidValue;
  if ((nf > 0 && !dacp_program_ok(code_f, n_code_f, n_lits_f, Af, nf, true)) ||
      (ni > 0 && !dacp_program_ok(code_i, n_code_i, n_lits_i, Ai, ni, false)))
    return (int)cudaErrorInvalidValue;
  const int LS = L + 4 * ncs;
  const size_t shmem = segmented ? fused_shared_bytes(G, LS, Mf, Mi) : 0;
  if (shmem > SHARED_MAX_BYTES) return (int)cudaErrorInvalidValue;

  FusedArgs a = {};
  a.pred = pred;
  a.gidx = gidx;
  a.pass = pass;
  a.limb = limb;
  a.mmf = (const int32_t*)mmf;
  a.mmi = mmi;
  a.af = af;
  a.ai = ai;
  a.ctab = ctab;
  a.counts = counts;
  a.gsum = gsum;
  a.gcnt = gcnt;
  a.gmmf = (int32_t*)gmmf;
  a.gmmi = gmmi;
  a.gfirst = gfirst;
  a.n_tiles = N / tile;
  a.n_rows = n_rows;
  a.P = P;
  a.Dp = Dp;
  a.L = L;
  a.Mf = Mf;
  a.Mi = Mi;
  a.Af = Af;
  a.Ai = Ai;
  a.Dc = Dp + nf + ni + (with_gidx ? 1 : 0);
  a.LS = LS;
  a.nf = nf;
  a.ni = ni;
  a.ncs = ncs;
  a.with_gidx = with_gidx ? 1 : 0;
  a.G = G;
  a.tiles_per_block = tiles_per_block;
  a.op = op;
  a.kind = kind;
  a.t_hi = t_hi;
  a.t_lo = t_lo;
  for (int j = 0; j < ncs; ++j) {
    if (csums[j] < 0 || csums[j] >= ni) return (int)cudaErrorInvalidValue;
    a.csums[j] = csums[j];
  }
  for (int j = 0; j < Mf; ++j)
    if (fns_f[j]) a.fns_f.w[j >> 5] |= 1u << (j & 31);
  for (int j = 0; j < Mi; ++j)
    if (fns_i[j]) a.fns_i.w[j >> 5] |= 1u << (j & 31);
  Program prog_f = {};
  Program prog_i = {};
  if (nf > 0) dacp_program_load(&prog_f, code_f, n_code_f, lits_f, n_lits_f);
  if (ni > 0) dacp_program_load(&prog_i, code_i, n_code_i, lits_i, n_lits_i);

  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_init = (int64_t)G * (LS + Mf + Mi + 2);
  fused_init_kernel<<<(unsigned)((n_init + DACP_THREADS - 1) / DACP_THREADS), DACP_THREADS, 0, s>>>(a);
  if (a.n_tiles > 0) {
    const unsigned grid = (unsigned)((a.n_tiles + tiles_per_block - 1) / tiles_per_block);
    if (segmented) {
      if (shmem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(fused_chain_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)shmem);
        if (e != cudaSuccess) return (int)e;
      }
      fused_chain_kernel<true><<<grid, tile, shmem, s>>>(a, prog_f, prog_i);
    } else {
      fused_chain_kernel<false><<<grid, tile, 0, s>>>(a, prog_f, prog_i);
    }
  }
  const int64_t n_f = (int64_t)G * Mf;
  fused_decode_kernel<<<(unsigned)((n_f + DACP_THREADS - 1) / DACP_THREADS), DACP_THREADS, 0, s>>>(a.gmmf, n_f);
  return dacp_last_error();
}
