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
// (the group outputs to their identities, 1.5 µs) and the chain.
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
  int32_t* ticket;  // blocks done; the init kernel zeroes it
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
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.ticket = 0;
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
// of scratch.
DACP_API int dacp_fused_chain(const int32_t* pred, int P, const int32_t* gidx, const int32_t* pass, int Dp,
                              const int32_t* limb, int L, const void* mmf, int Mf, const int32_t* mmi, int Mi,
                              const float* af, int Af, const int32_t* ai, int Ai, int64_t N, int tile, int n_rows,
                              int32_t t_hi, int32_t t_lo, int op, int kind, const int* code_f, int n_code_f,
                              const uint32_t* lits_f, int n_lits_f, int nf, const int* code_i, int n_code_i,
                              const uint32_t* lits_i, int n_lits_i, int ni, const int* csums, int ncs,
                              const int* fns_f, const int* fns_i, int with_gidx, int segmented, int G,
                              int32_t* ctab, int32_t* counts, int32_t* gsum, int32_t* gcnt, void* gmmf,
                              int32_t* gmmi, int32_t* gfirst, int32_t* ticket, void* stream) {
  if (tile <= 0 || tile > 1024 || (tile & 31) || N < 0 || N % tile || op < 0 || op > 5 || kind < 0 || kind > 3 ||
      P < (kind == KIND_I64 ? 2 : 1) || Dp < 0 || L < 0 || Mf < 1 || Mi < 1 || Mf > MM_COLS_MAX ||
      Mi > MM_COLS_MAX || Af < 1 || Ai < 1 || nf < 0 || ni < 0 || ncs < 0 || ncs > CSUM_MAX || G <= 0 ||
      ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((nf > 0 && !dacp_program_ok(code_f, n_code_f, n_lits_f, Af, nf, true)) ||
      (ni > 0 && !dacp_program_ok(code_i, n_code_i, n_lits_i, Ai, ni, false)))
    return (int)cudaErrorInvalidValue;
  const int LS = L + 4 * ncs;
  const size_t acc_bytes = segmented ? (fused_shared_bytes(G, LS, Mf, Mi) + 15) / 16 * 16 : 0;
  if (acc_bytes > SHARED_MAX_BYTES) return (int)cudaErrorInvalidValue;
  const int Dc = Dp + nf + ni + (with_gidx ? 1 : 0);
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
  return dacp_last_error();
}
