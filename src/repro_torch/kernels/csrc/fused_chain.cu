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
//      zeros, the min/max identities and 2^31-1;
//   5. with float sums (a mean's partial sum, a float column's sum), each
//      group's float64 sums over its survivors in row order
//      (fsum_fold_kernel, below).
//
// Bound: bytes.  The function reads each input table once and writes ctab,
// the counts and the group outputs once; a few f32 operations per row and
// column are far below the card's 67 TFLOP/s.  At the fused aggregate
// COOK's 65536-row morsel that is about 5 MB (1.5 µs at 3.35 TB/s), so
// what counts is filling the card, not serialising on hot groups, and few
// launches.
//
// Design: the TPU kernel compacts with a one-hot int32 matmul on the MXU and
// carries the group state from one grid step to the next.  Neither carries
// over.  Here a grid-stride loop of at most two blocks per SM (one block
// per SM when the accumulators leave room for one; chip_smoke.py prints the
// grid the profiler saw) walks the tiles, `tile` threads a block, one row
// per thread.  A thread first prefetches its row of every input table into
// L1, so that the chain's dependent loads (predicate, pass planes, the
// programs' columns, limbs, min/max columns) wait on one round trip, not
// one each.  The predicate and the stable block prefix sum of
// filter_select.cu give each survivor its slot, and the survivor builds its
// compacted row, running the postfix programs of project_arith.cu (passed
// as __grid_constant__ parameters, so a new literal rebuilds nothing).  The
// rows are staged in shared memory, and the block writes the tile's whole
// (tile, Dc) block of ctab, zero tail included, as contiguous 16-byte
// stores.  A plan whose staging does not fit beside its accumulators (they
// alone may fill the 227 KB) writes each row where it belongs instead;
// staging beats those direct stores by 2% on the main morsel and 11% on
// the wide envelope.  The segment fold is warp-aggregated before it touches
// shared memory (the station ids are Zipf-skewed: a fifth of the rows in
// one group): __match_any_sync on the group id, then dacp_peer_sum over
// 8-column chunks of [limbs | csum limbs] plus the count, and dacp_peer_min
// over the min/max keys (a max column folds the bitwise complement, whose
// order is the reverse) and the first row, so a set of lanes that share a
// group issues one shared atomic per column, not one per row; rows outside
// the fold (filtered out, or no group) each form a set of their own, so
// they add no rounds to the trees.  Each block then
// folds the groups it saw into the outputs with global atomics; float32
// min/max reduce through the order-preserving key of segment_reduce.cu,
// and the last block to finish (a ticket the init kernel zeroes) decodes
// them.  This is exact because integer addition and min/max commute: the
// host keeps limb sums below 2^26 (SUM_ROW_CAP rows) and sends no float32
// min/max column that holds NaN, ±inf or -0.0.  The host computes the
// shared footprint from the plan and refuses a plan above the card's
// 227 KB before any launch.  A call is two launches: fused_init_kernel
// (the group outputs to their identities, 1.5 µs) and the chain; a plan
// with float sums adds fsum_fold_kernel.
//
// Tried and dropped (NVIDIA H100 80GB HBM3, 700 W, main morsel): one block
// per SM walking two tiles each, so half the flushes: the chain took
// 0.0214 ms against 0.0158 ms with a block per tile; a 4-wide min/max fold
// for plans with at most four such columns (no gain).  Of the chain's
// 0.0148 ms, probe builds put 0.004 in the fold, 0.004 in the flush's
// global atomics and 0.0014 in the programs.
#include <mutex>
#include <vector>

#include "dataplane.cuh"

#define CSUM_MAX 64
#define MM_COLS_MAX 256
#define FSUM_MAX 64
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
  int32_t* ticket;     // blocks done; the init kernel zeroes it
  int32_t* nonfinite;  // the float sums' flag; the init kernel zeroes it
  int64_t n_tiles;
  int n_rows;
  int P, Dp, L, Mf, Mi, Af, Ai, Dc, LS;
  int nf, ni, ncs;
  int with_gidx;
  int G;
  int op, kind;
  int32_t t_hi, t_lo;
  int csums[CSUM_MAX];
  MmBits fns_f, fns_i;
};

__device__ __forceinline__ int32_t mm_identity(bool f32, bool mx) {
  if (f32) return mx ? dacp_f32_key((int32_t)0xFF800000u) : (int32_t)0x7F800000;
  return mx ? INT32_MIN : INT32_MAX;
}

#define SUM_CHUNK 8  // columns a warp folds at once (and the count beside them)

template <bool SEG, bool STAGE>
__global__ void fused_chain_kernel(const __grid_constant__ FusedArgs a, const __grid_constant__ Program pf,
                                   const __grid_constant__ Program pi) {
  // SEG: [G·LS sums | G counts | G·Mf f-keys | G·Mi i-vals | G first rows], then (STAGE) tile × Dc staged rows
  extern __shared__ __align__(16) int32_t sh[];
  __shared__ int warp_total[32];
  const int tile = blockDim.x;
  const int t = threadIdx.x;
  const int G = a.G;
  int32_t* s_sum = sh;
  int32_t* s_cnt = s_sum + G * a.LS;
  int32_t* s_f = s_cnt + G;
  int32_t* s_i = s_f + G * a.Mf;
  int32_t* s_first = s_i + G * a.Mi;
  int32_t* s_stage = sh + (SEG ? (G * (a.LS + 2 + a.Mf + a.Mi) + 3) / 4 * 4 : 0);
  if (SEG) {
    for (int i = t; i < G * (a.LS + 1); i += tile) sh[i] = 0;
    for (int i = t; i < G * a.Mf; i += tile) s_f[i] = mm_identity(true, mm_is_max(a.fns_f, i % a.Mf));
    for (int i = t; i < G * a.Mi; i += tile) s_i[i] = mm_identity(false, mm_is_max(a.fns_i, i % a.Mi));
    for (int i = t; i < G; i += tile) s_first[i] = INT32_MAX;
    __syncthreads();
  }
  const int n_mm = a.Mf + a.Mi + 1;  // min/max columns and the first row
  const bool vec = ((uintptr_t)a.limb % 16 == 0) && a.L % 4 == 0;

  for (int64_t tile_idx = blockIdx.x; tile_idx < a.n_tiles; tile_idx += gridDim.x) {
    const int64_t base = tile_idx * tile;
    const int64_t row = base + t;
    if (row < a.n_rows) {  // every table's row at once: the loads below then hit L1
      const void* rows[8] = {a.pred + row * a.P, a.pass + row * a.Dp, a.af + row * a.Af, a.ai + row * a.Ai,
                             a.limb + row * a.L, a.mmf + row * a.Mf, a.mmi + row * a.Mi, a.gidx + row};
#pragma unroll
      for (int i = 0; i < 8; ++i) asm volatile("prefetch.global.L1 [%0];" ::"l"(rows[i]));
    }
    const bool m = row < a.n_rows && dacp_pred_rt(a.op, a.kind, a.pred + row * a.P, a.t_hi, a.t_lo);
    int total;
    const int slot = dacp_block_slot(m, warp_total, &total);

    int32_t* dst = STAGE ? s_stage + slot * a.Dc : a.ctab + (base + slot) * a.Dc;
    int32_t* icols = dst + a.Dp + a.nf;
    if (m) {
      const int32_t* src = a.pass + row * a.Dp;
      for (int d = 0; d < a.Dp; ++d) dst[d] = src[d];
      if (a.nf > 0) {
        int32_t* out = dst + a.Dp;
        dacp_run_program(pf, a.af + row * a.Af, [out](int c, float v) { out[c] = __float_as_int(v); });
      }
      if (a.ni > 0) dacp_run_program(pi, a.ai + row * a.Ai, [icols](int c, int32_t v) { icols[c] = v; });
      if (a.with_gidx) dst[a.Dc - 1] = a.gidx[row];
    }
    if (SEG) {
      int g = m ? a.gidx[row] : -1;
      if (g < 0 || g >= G) g = -1;
      const bool ok = g >= 0;
      unsigned peers = __match_any_sync(0xffffffffu, g);
      if (!ok) peers = 1u << (t & 31);  // rows outside the fold stay out of the trees' rounds
      // sums: [limbs | 4 limbs of each csum column], the count riding in the first chunk
      for (int c0 = 0; c0 < a.LS || c0 == 0; c0 += SUM_CHUNK) {
        int32_t v[SUM_CHUNK + 1];
        if (ok && vec && c0 + SUM_CHUNK <= a.L) {
          const int4 lo = *reinterpret_cast<const int4*>(a.limb + row * a.L + c0);
          const int4 hi = *reinterpret_cast<const int4*>(a.limb + row * a.L + c0 + 4);
          v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
        } else {
#pragma unroll
          for (int j = 0; j < SUM_CHUNK; ++j) {
            const int c = c0 + j;
            int32_t x = 0;
            if (ok && c < a.LS) {
              if (c < a.L) {
                x = a.limb[row * a.L + c];
              } else {
                const int q = c - a.L;
                const int32_t cv = icols[a.csums[q >> 2]];  // this thread's own store above
                x = (q & 3) == 3 ? cv >> 24 : (cv >> (8 * (q & 3))) & 0xFF;  // signed top limb
              }
            }
            v[j] = x;
          }
        }
        v[SUM_CHUNK] = ok && c0 == 0 ? 1 : 0;
        if (dacp_peer_sum(peers, v) && ok) {
          int32_t* gs = s_sum + g * a.LS;
#pragma unroll
          for (int j = 0; j < SUM_CHUNK; ++j)
            if (c0 + j < a.LS && v[j] != 0) atomicAdd(&gs[c0 + j], v[j]);
          if (v[SUM_CHUNK] != 0) atomicAdd(&s_cnt[g], v[SUM_CHUNK]);
        }
      }
      // min / max: a max column folds ~key, whose order is the reverse; then the first row
      for (int c0 = 0; c0 < n_mm; c0 += SUM_CHUNK) {
        int32_t v[SUM_CHUNK];
#pragma unroll
        for (int j = 0; j < SUM_CHUNK; ++j) {
          const int c = c0 + j;
          int32_t x = INT32_MAX;
          if (ok && c < n_mm) {
            if (c < a.Mf) {
              const int32_t key = dacp_f32_key(a.mmf[row * a.Mf + c]);
              x = mm_is_max(a.fns_f, c) ? ~key : key;
            } else if (c < a.Mf + a.Mi) {
              const int32_t key = a.mmi[row * a.Mi + c - a.Mf];
              x = mm_is_max(a.fns_i, c - a.Mf) ? ~key : key;
            } else {
              x = (int32_t)row;
            }
          }
          v[j] = x;
        }
        if (dacp_peer_min(peers, v) && ok) {
#pragma unroll
          for (int j = 0; j < SUM_CHUNK; ++j) {
            const int c = c0 + j;
            if (c >= n_mm) continue;
            if (c < a.Mf) {
              if (mm_is_max(a.fns_f, c)) {
                atomicMax(&s_f[g * a.Mf + c], ~v[j]);
              } else {
                atomicMin(&s_f[g * a.Mf + c], v[j]);
              }
            } else if (c < a.Mf + a.Mi) {
              const int ci = c - a.Mf;
              if (mm_is_max(a.fns_i, ci)) {
                atomicMax(&s_i[g * a.Mi + ci], ~v[j]);
              } else {
                atomicMin(&s_i[g * a.Mi + ci], v[j]);
              }
            } else {
              atomicMin(&s_first[g], v[j]);
            }
          }
        }
      }
    }
    if (STAGE) {
      __syncthreads();  // every survivor's row is staged
      const int n_live = total * a.Dc;
      int4* out = reinterpret_cast<int4*>(a.ctab + base * a.Dc);
      const int4* in = reinterpret_cast<const int4*>(s_stage);
      for (int e = t; e < tile * a.Dc / 4; e += tile) {
        int4 v = in[e];
        const int i = 4 * e;
        if (i + 3 >= n_live) {  // the zero tail (and the row it starts in)
          v.x = i < n_live ? v.x : 0;
          v.y = i + 1 < n_live ? v.y : 0;
          v.z = i + 2 < n_live ? v.z : 0;
          v.w = i + 3 < n_live ? v.w : 0;
        }
        out[e] = v;
      }
      __syncthreads();  // the staging area is free for the next tile
    } else if (t >= total) {
      int32_t* z = a.ctab + row * a.Dc;
      for (int d = 0; d < a.Dc; ++d) z[d] = 0;
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

  // the last block to finish decodes the float32 keys
  __threadfence();
  __syncthreads();
  if (t == 0) warp_total[0] = atomicAdd(a.ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (warp_total[0]) {
    __threadfence();
    for (int i = t; i < G * a.Mf; i += tile) a.gmmf[i] = dacp_f32_key(__ldcg(&a.gmmf[i]));
  }
}

// Group outputs to their initial values: zero sums and counts, the min/max
// identities (float32 as keys) and 2^31-1 first rows.
__global__ void fused_init_kernel(const __grid_constant__ FusedArgs a) {
  const int64_t n_sum = (int64_t)a.G * a.LS;
  const int64_t n_f = (int64_t)a.G * a.Mf;
  const int64_t n_i = (int64_t)a.G * a.Mi;
  const int64_t total = n_sum + n_f + n_i + 2 * (int64_t)a.G;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.ticket = 0;
    *a.nonfinite = 0;
  }
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

// ---------------------------------------------------------------------------
// fsum_fold_kernel: each group's float64 sums over the survivors
// ---------------------------------------------------------------------------
// What it computes: for every group slot g and float-sum column c,
// fsum[g][c] = +0.0, then += widen(v) for each survivor of g in row order
// (tiles in order, then slots within the tile, which is the rows' order),
// where widen is numpy's conversion of the column to float64 (float32 and
// float16 exactly, int64 / uint64 rounded to nearest, the rest exactly):
// bit for bit the host's np.add.at(acc, gidx, values).  A group whose
// column holds a NaN or ±inf survivor reads the canonical NaN there and
// raises the nonfinite flag: the host then folds the morsel itself, since
// its x86 adds and the card's need not agree on a NaN's bits.
//
// Design: one block per group slot.  The block reads the tile counts and
// the compacted gidx column from L2, from the tile of the group's first
// surviving row (gfirst, from the chain) until it has seen the group's
// gcnt rows, so a group whose rows lie together (ISD's station-years)
// costs its own span, not the morsel's.  A sum in row order is a chain of
// dependent adds, one lane long: at the benchmark's morsel (8 stations,
// up to 8760 survivors each) the fold took 80 us in row order and 15.5 us
// in the parallel pass (NVIDIA H100 80GB HBM3, 700 W).  So the block
// first takes, in one parallel pass, each
// thread's own sum, the lowest set bit's exponent lo and the magnitude
// exponent hi (|v| < 2^hi) of the nonzero values, and their count n.
// If ceil(log2 n) + max hi <= 53 + min lo (and <= 1024), every value is an
// integer multiple of 2^(min lo) and every sum of any subset of them is
// below 2^(53 + min lo): it is a double, no add in any order rounds, and
// the block's tree sum is the exact sum that the sequential adds reach
// too (a zero sum made +0.0, as a sequence from +0.0 gives).  Float32
// values a few decades apart meet it (ISD temperatures: 33 bits to spare
// over 65536 rows).  Where a column does not, the block passes over the
// rows again: a block-wide stable prefix sum stages each window's values
// in shared memory in row order, and one lane per column adds them in
// sequence with __dadd_rn.  No atomics touch the float adds.
enum { FS_F32 = 0, FS_F64 = 1, FS_I32 = 2, FS_U32 = 3, FS_I64 = 4, FS_U64 = 5, FS_F16 = 6 };

#define FOLD_THREADS 1024
#define FOLD_UNROLL 8  // slots a thread reads at once in the parallel pass
#define FOLD_CHUNK 4   // float-sum columns one pass carries

struct FsumArgs {
  const int32_t* ctab;
  const int32_t* counts;
  const int32_t* gcnt;
  const int32_t* gfirst;
  double* fsum;  // (G, nfs)
  int32_t* nonfinite;
  int n;  // slots: N rows, tile-padded
  int tile, Dc, nfs;
  int off[FSUM_MAX];   // first plane of each column in a ctab row
  int kind[FSUM_MAX];  // FS_*
};

__device__ __forceinline__ double fsum_widen(const int32_t* row, int off, int kind) {
  const int32_t w = __ldg(row + off);
  switch (kind) {
    case FS_F32:
      return (double)__int_as_float(w);  // -ftz=false: denormals kept
    case FS_F64:
      return __hiloint2double(w, __ldg(row + off + 1));
    case FS_I32:
      return (double)w;
    case FS_U32:
      return (double)(uint32_t)w;
    case FS_I64:
      return __ll2double_rn((long long)(((uint64_t)(uint32_t)w << 32) | (uint32_t)__ldg(row + off + 1)));
    case FS_U64:
      return __ull2double_rn(((unsigned long long)(uint32_t)w << 32) | (uint32_t)__ldg(row + off + 1));
    default: {  // FS_F16: the half's bits in the plane's low 16
      const int e = (w >> 10) & 31;
      const int m = w & 1023;
      double mag;
      if (e == 31) {
        mag = __longlong_as_double(m ? 0x7FF8000000000000LL : 0x7FF0000000000000LL);
      } else {
        mag = e ? ldexp((double)(1024 + m), e - 25) : ldexp((double)m, -24);
      }
      return (w & 0x8000) ? -mag : mag;
    }
  }
}

__device__ __forceinline__ bool fsum_nonfinite(double v) {
  return (__double_as_longlong(v) & 0x7FF0000000000000LL) == 0x7FF0000000000000LL;
}

// For v != 0: lo = the exponent of v's lowest set bit, hi with |v| < 2^hi.
__device__ __forceinline__ void fsum_exps(double v, int* lo, int* hi) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(v) & 0x7FFFFFFFFFFFFFFFull;
  const int eb = (int)(b >> 52);
  unsigned long long m = b & 0xFFFFFFFFFFFFFull;
  int scale = -1074;  // subnormal: v = m * 2^-1074
  if (eb != 0) {
    m |= 1ull << 52;
    scale = eb - 1075;
  }
  *lo = scale + __ffsll((long long)m) - 1;
  *hi = scale + 64 - __clzll((long long)m);
}

// The block's fold of v by op (id its identity); every thread gets it.
// Butterflies over the lanes, then over the warps' results.
template <typename T, typename Op>
__device__ __forceinline__ T fold_block(T v, Op op, T id, T* part) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, d));
  __syncthreads();  // part is free from its last use
  if (lane == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? part[lane] : id;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__global__ void __launch_bounds__(FOLD_THREADS) fsum_fold_kernel(const __grid_constant__ FsumArgs a) {
  __shared__ double s_vals[FOLD_CHUNK][FOLD_THREADS];  // one window's values in row order
  __shared__ double s_dpart[32];
  __shared__ int s_ipart[32];
  __shared__ int warp_total[32];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int gcol = a.Dc - 1;
  const int want = a.gcnt[g];  // the group's survivors
  const int start = want > 0 ? a.gfirst[g] / a.tile * a.tile : a.n;
  const auto add = [](double x, double y) { return __dadd_rn(x, y); };
  const auto isum = [](int x, int y) { return x + y; };
  const auto imin = [](int x, int y) { return x < y ? x : y; };
  const auto imax = [](int x, int y) { return x > y ? x : y; };
  bool bad_any = false;

  for (int c0 = 0; c0 < a.nfs; c0 += FOLD_CHUNK) {
    const int nc = dacp_imin(FOLD_CHUNK, a.nfs - c0);
    double acc[FOLD_CHUNK];
    int lo[FOLD_CHUNK], hi[FOLD_CHUNK], nz[FOLD_CHUNK], bad[FOLD_CHUNK];
#pragma unroll
    for (int j = 0; j < FOLD_CHUNK; ++j) acc[j] = 0.0, lo[j] = INT32_MAX, hi[j] = INT32_MIN, nz[j] = 0, bad[j] = 0;

    // the parallel pass: each thread's sums and exponents, in any order
    int seen = 0;  // block-uniform
    for (int s0 = start; s0 < a.n && seen < want; s0 += FOLD_THREADS * FOLD_UNROLL) {
      bool hit[FOLD_UNROLL];
#pragma unroll
      for (int u = 0; u < FOLD_UNROLL; ++u) {  // both loads at once: a tile's tail rows are zero
        const int s = s0 + u * FOLD_THREADS + t;
        const int tl = s / a.tile;
        const bool in = s < a.n;
        const int cnt = in ? __ldg(a.counts + tl) : 0;
        const int gid = in ? __ldg(a.ctab + (int64_t)s * a.Dc + gcol) : -1;
        hit[u] = s - tl * a.tile < cnt && gid == g;
      }
      int h = 0;
#pragma unroll
      for (int u = 0; u < FOLD_UNROLL; ++u) {
        if (!hit[u]) continue;
        ++h;
        const int32_t* row = a.ctab + (int64_t)(s0 + u * FOLD_THREADS + t) * a.Dc;
#pragma unroll
        for (int j = 0; j < FOLD_CHUNK; ++j) {
          if (j >= nc) break;
          const double v = fsum_widen(row, a.off[c0 + j], a.kind[c0 + j]);
          if (fsum_nonfinite(v)) {
            bad[j] = 1;
          } else if (v != 0.0) {
            int l, e;
            fsum_exps(v, &l, &e);
            acc[j] = __dadd_rn(acc[j], v);
            lo[j] = dacp_imin(lo[j], l);
            hi[j] = dacp_imax(hi[j], e);
            ++nz[j];
          }
        }
      }
      seen += fold_block(h, isum, 0, s_ipart);
    }

    unsigned seq = 0;  // columns whose sum needs the rows' order
    double res = 0.0;  // thread t's column, for t < nc
#pragma unroll
    for (int j = 0; j < FOLD_CHUNK; ++j) {
      if (j >= nc) break;
      const double sum = fold_block(acc[j], add, 0.0, s_dpart);
      const int l = fold_block(lo[j], imin, (int)INT32_MAX, s_ipart);
      const int e = fold_block(hi[j], imax, (int)INT32_MIN, s_ipart);
      const int n = fold_block(nz[j], isum, 0, s_ipart);
      const int b = fold_block(bad[j], imax, 0, s_ipart);
      const int clog = n > 1 ? 32 - __clz(n - 1) : 0;
      double out = 0.0;
      if (b) {
        out = __longlong_as_double(0x7FF8000000000000LL);
        bad_any = true;
      } else if (n > 0) {
        if (clog + e <= 53 + l && clog + e <= 1024) {
          out = __dadd_rn(sum, 0.0);  // a zero sum as +0.0
        } else {
          seq |= 1u << j;
        }
      }
      if (j == t) res = out;
    }

    if (seq) {  // the ordered pass: windows staged in row order, one lane a column adds them
      double run = 0.0;
      seen = 0;
      for (int s0 = start; s0 < a.n && seen < want; s0 += FOLD_THREADS) {
        const int s = s0 + t;
        const int tl = s / a.tile;
        const bool in = s < a.n;
        const int cnt = in ? __ldg(a.counts + tl) : 0;
        const int gid = in ? __ldg(a.ctab + (int64_t)s * a.Dc + gcol) : -1;
        const bool m = s - tl * a.tile < cnt && gid == g;
        int total;
        const int slot = dacp_block_slot(m, warp_total, &total);
        if (total == 0) continue;
        seen += total;
        if (m) {
          const int32_t* row = a.ctab + (int64_t)s * a.Dc;
#pragma unroll
          for (int j = 0; j < FOLD_CHUNK; ++j)
            if ((seq >> j) & 1u) s_vals[j][slot] = fsum_widen(row, a.off[c0 + j], a.kind[c0 + j]);
        }
        __syncthreads();
        if (t < FOLD_CHUNK && ((seq >> t) & 1u)) {
          const double* vals = s_vals[t];
#pragma unroll 8
          for (int i = 0; i < total; ++i) run = __dadd_rn(run, vals[i]);
        }
        __syncthreads();  // the window's values are added
      }
      if (t < FOLD_CHUNK && ((seq >> t) & 1u)) res = run;
    }
    if (t < nc) a.fsum[(int64_t)g * a.nfs + c0 + t] = res;
  }
  if (t == 0 && bad_any) *a.nonfinite = 1;
}

static size_t fused_shared_bytes(int G, int LS, int Mf, int Mi) {
  return sizeof(int32_t) * (size_t)G * (size_t)(LS + 2 + Mf + Mi);
}

// The grid-stride loop's block cap for one (device, kernel, tile, shared
// bytes): the SM count times the blocks an SM holds, at most two.  The
// runtime queries behind it take microseconds of host time and the fused
// COOK is host-bound, so each key is asked once.  The first ask also
// raises the kernel's dynamic shared-memory limit to the most a plan uses.
struct FusedCap {
  int dev;
  const void* kernel;
  int tile;
  size_t shmem;
  int64_t cap;
};

template <typename Kernel>
static cudaError_t fused_grid_cap(Kernel* kernel, int tile, size_t shmem, int64_t* cap) {
  static std::mutex mu;
  static std::vector<FusedCap> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const FusedCap& k : known) {
    if (k.dev == dev && k.kernel == (const void*)kernel && k.tile == tile && k.shmem == shmem) {
      *cap = k.cap;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SHARED_MAX_BYTES);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, tile, shmem);
  if (e != cudaSuccess) return e;
  *cap = (int64_t)sms * dacp_imax(1, dacp_imin(2, per_sm));
  known.push_back({dev, (const void*)kernel, tile, shmem, *cap});
  return cudaSuccess;
}

// Row tables are row-major int32 (mmf and af float32) with N rows, N a
// multiple of tile.  code_* / lits_* are the f32 and i32 postfix programs
// (one launch each, writing nf / ni columns); csums index the i32 outputs
// that the fold sums; fns_*[j] != 0 takes the max of column j.  Writes ctab
// (N, Dp + nf + ni + with_gidx), counts (N / tile), gsum (G, L + 4·ncs),
// gcnt (G), gmmf (G, Mf), gmmi (G, Mi) and gfirst (G); ticket is one int32
// of scratch.  With nfs > 0 (which needs with_gidx and segmented), column
// j of the float sums starts at plane fs_off[j] of a ctab row and widens
// as fs_kind[j] (FS_*): fsum_fold_kernel writes fsum (G, nfs) float64 and
// the nonfinite flag (one int32, zeroed by the init kernel either way).
DACP_API int dacp_fused_chain(const int32_t* pred, int P, const int32_t* gidx, const int32_t* pass, int Dp,
                              const int32_t* limb, int L, const void* mmf, int Mf, const int32_t* mmi, int Mi,
                              const float* af, int Af, const int32_t* ai, int Ai, int64_t N, int tile, int n_rows,
                              int32_t t_hi, int32_t t_lo, int op, int kind, const int* code_f, int n_code_f,
                              const uint32_t* lits_f, int n_lits_f, int nf, const int* code_i, int n_code_i,
                              const uint32_t* lits_i, int n_lits_i, int ni, const int* csums, int ncs,
                              const int* fns_f, const int* fns_i, int with_gidx, int segmented, int G,
                              int32_t* ctab, int32_t* counts, int32_t* gsum, int32_t* gcnt, void* gmmf,
                              int32_t* gmmi, int32_t* gfirst, int32_t* ticket, const int* fs_off,
                              const int* fs_kind, int nfs, double* fsum, int32_t* nonfinite, void* stream) {
  if (tile <= 0 || tile > 1024 || (tile & 31) || N < 0 || N % tile || op < 0 || op > 5 || kind < 0 || kind > 3 ||
      P < (kind == KIND_I64 ? 2 : 1) || Dp < 0 || L < 0 || Mf < 1 || Mi < 1 || Mf > MM_COLS_MAX ||
      Mi > MM_COLS_MAX || Af < 1 || Ai < 1 || nf < 0 || ni < 0 || ncs < 0 || ncs > CSUM_MAX || G <= 0 ||
      ticket == nullptr || nonfinite == nullptr || nfs < 0 || nfs > FSUM_MAX)
    return (int)cudaErrorInvalidValue;
  if ((nf > 0 && !dacp_program_ok(code_f, n_code_f, n_lits_f, Af, nf, true)) ||
      (ni > 0 && !dacp_program_ok(code_i, n_code_i, n_lits_i, Ai, ni, false)))
    return (int)cudaErrorInvalidValue;
  const int LS = L + 4 * ncs;
  const size_t acc_bytes = segmented ? (fused_shared_bytes(G, LS, Mf, Mi) + 15) / 16 * 16 : 0;
  if (acc_bytes > SHARED_MAX_BYTES) return (int)cudaErrorInvalidValue;
  const int Dc = Dp + nf + ni + (with_gidx ? 1 : 0);
  FsumArgs fa = {};
  if (nfs > 0) {  // the fold reads each column's planes and the gidx column of a ctab row
    if (!with_gidx || !segmented || fsum == nullptr || N > INT32_MAX - FOLD_THREADS * FOLD_UNROLL)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < nfs; ++j) {
      const int width = fs_kind[j] == FS_F64 || fs_kind[j] == FS_I64 || fs_kind[j] == FS_U64 ? 2 : 1;
      if (fs_kind[j] < FS_F32 || fs_kind[j] > FS_F16 || fs_off[j] < 0 || fs_off[j] + width > Dc - 1)
        return (int)cudaErrorInvalidValue;
      fa.off[j] = fs_off[j];
      fa.kind[j] = fs_kind[j];
    }
    fa.ctab = ctab;
    fa.counts = counts;
    fa.gcnt = gcnt;
    fa.gfirst = gfirst;
    fa.fsum = fsum;
    fa.nonfinite = nonfinite;
    fa.n = (int)N;
    fa.tile = tile;
    fa.Dc = Dc;
    fa.nfs = nfs;
  }
  const size_t stage_bytes = sizeof(int32_t) * (size_t)tile * Dc;
  const bool stage = acc_bytes + stage_bytes <= SHARED_MAX_BYTES;  // else rows go straight to ctab
  const size_t shmem = acc_bytes + (stage ? stage_bytes : 0);

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
  a.ticket = ticket;
  a.nonfinite = nonfinite;
  a.n_tiles = N / tile;
  a.n_rows = n_rows;
  a.P = P;
  a.Dp = Dp;
  a.L = L;
  a.Mf = Mf;
  a.Mi = Mi;
  a.Af = Af;
  a.Ai = Ai;
  a.Dc = Dc;
  a.LS = LS;
  a.nf = nf;
  a.ni = ni;
  a.ncs = ncs;
  a.with_gidx = with_gidx ? 1 : 0;
  a.G = G;
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
  decltype(&fused_chain_kernel<true, true>) kernel =
      segmented ? (stage ? fused_chain_kernel<true, true> : fused_chain_kernel<true, false>)
                : (stage ? fused_chain_kernel<false, true> : fused_chain_kernel<false, false>);
  int64_t cap = 0;  // a grid-stride loop over the tiles: at most two blocks per SM
  const cudaError_t e = fused_grid_cap(kernel, tile, shmem, &cap);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)dacp_imax(1, (int)dacp_min64(a.n_tiles, cap));
  kernel<<<grid, tile, shmem, s>>>(a, prog_f, prog_i);
  if (nfs > 0) fsum_fold_kernel<<<G, FOLD_THREADS, 0, s>>>(fa);
  return dacp_last_error();
}
