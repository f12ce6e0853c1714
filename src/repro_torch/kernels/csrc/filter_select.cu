// filter_select_planes: per-tile predicate + stable compaction of int32
// bit-planes.
//
// Replaces the TPU kernel src/repro/kernels/filter_select.py
// filter_select_planes (body _planes_kernel, with _pred_mask and _cmp64).
//
// What it computes, for each tile of `tile` rows: the predicate
// `col <op> threshold` on the predicate planes (float32 through the bit
// pattern, int32 directly, int64 as a two-word hi / sign-flipped-lo compare),
// masked to rows < n_rows; the surviving rows' D planes are copied to the
// front of their tile in row order, the remaining rows of the tile are zero,
// and the tile's survivor count is written.  Bits move unchanged, so every
// fixed-width dtype (-0.0, NaN payloads, full-range int64) survives exactly.
//
// Bound: bytes.  The function reads pred (4·N·P) and table (4·N·D) once and
// writes out (4·N·D) and the counts: 4·N·(P + 2D) bytes, at 3.35 TB/s on an
// H100 SXM.  There is no arithmetic worth counting.
//
// Design: one block of `tile` threads per tile, one row per thread for the
// predicate.  The TPU kernel compacts with a one-hot (tile × tile) integer
// matmul on the MXU; here a stable block prefix sum gives each survivor its
// slot: __ballot_sync + __popc within each warp, then the warp totals
// through shared memory (dacp_block_slot in dataplane.cuh, shared with
// fused_chain.cu).  The tile's planes are one contiguous run of tile·D
// ints, so before the predicate is read the block issues them into shared
// memory as 16-byte cp.async copies, and the two reads overlap instead of
// the row copy waiting on the slot.  Each survivor records its source row
// at its slot, and the block writes the whole output tile, survivors then
// zeros, as contiguous 16-byte stores gathered from shared memory.  A
// launch whose table or out is not 16-byte aligned (a view 4 bytes in), or
// whose column chunks are not multiples of 4 ints, takes the same path
// with 4-byte copies and stores.  A tile whose planes do not fit in 227 KB
// splits its columns over gridDim.y, every block of the tile computing the
// predicate and the slots again, and the count written once, by
// blockIdx.y == 0.  `op` and `kind` are template parameters (18 instances,
// each with and without the 16-byte path, built once) and the thresholds
// are kernel arguments, so a new literal never rebuilds anything.  CUDA
// float compares have IEEE NaN and ±0 semantics, like the bitcast compare
// of the TPU kernel.
#include "dataplane.cuh"
#include "mma.cuh"  // cp_async16, cp_async_commit, cp_async_wait

// 227 KB (232448 bytes) of shared memory per block, less the 128 static
// bytes of warp_total.
#define FS_SHARED_MAX_BYTES 232320

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(mma_smem_u32(dst)), "l"(src) : "memory");
}

// Offset in table / out of element e of a block's (tile, w) column chunk,
// rows D ints apart; the chunk is the tile's whole contiguous run when w == D.
__device__ __forceinline__ int64_t fs_offset(int e, int w, int D) {
  return w == D ? e : (int64_t)(e / w) * D + e % w;
}

// VEC: table and out are 16-byte aligned and four consecutive elements of a
// chunk are contiguous in both (w == D, or D and w multiples of 4).
template <int OP, int KIND, bool VEC>
__global__ void __launch_bounds__(1024)
    filter_select_kernel(const int32_t* __restrict__ pred, int P, const int32_t* __restrict__ table, int D, int dc,
                         int n_rows, int32_t t_hi, int32_t t_lo, int32_t* __restrict__ out,
                         int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) int32_t sh[];  // tile × dc staged planes, then tile source rows
  __shared__ int warp_total[32];
  const int tile = blockDim.x;
  const int t = threadIdx.x;
  const int d0 = blockIdx.y * dc;
  const int w = dacp_imin(dc, D - d0);  // this block's columns
  const int n_el = tile * w;
  const int64_t base = (int64_t)blockIdx.x * tile;
  const int32_t* src = table + base * D + d0;
  int32_t* dst = out + base * D + d0;
  int32_t* stage = sh;
  int* from = sh + tile * dc;

  // 1. the tile's planes to shared memory, in flight while the predicate loads
  if (VEC) {
    for (int e = 4 * t; e < n_el; e += 4 * tile) cp_async16(stage + e, src + fs_offset(e, w, D), true);
  } else {
    for (int e = t; e < n_el; e += tile) cp_async4(stage + e, src + fs_offset(e, w, D));
  }
  cp_async_commit();

  // 2. predicate and slot; each survivor records its row at its slot
  const int64_t row = base + t;
  const bool m = row < n_rows && dacp_pred<OP, KIND>(pred + row * P, t_hi, t_lo);
  int total;
  const int slot = dacp_block_slot(m, warp_total, &total);
  if (m) from[slot] = t;
  cp_async_wait<0>();
  __syncthreads();

  // 3. the output tile: survivors in row order, then zeros
  if (VEC) {
    for (int e = 4 * t; e < n_el; e += 4 * tile) {
      int o = e / w;
      int c = e - o * w;
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = o < total ? stage[from[o] * w + c] : 0;
        if (++c == w) c = 0, ++o;
      }
      *reinterpret_cast<int4*>(dst + fs_offset(e, w, D)) = make_int4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = t; e < n_el; e += tile) {
      const int o = e / w;
      dst[fs_offset(e, w, D)] = o < total ? stage[from[o] * w + e - o * w] : 0;
    }
  }
  if (t == 0 && blockIdx.y == 0) counts[blockIdx.x] = total;
}

typedef void (*FsKernel)(const int32_t*, int, const int32_t*, int, int, int, int32_t, int32_t, int32_t*, int32_t*);

template <int OP>
static FsKernel pick_kind(int kind, bool vec) {
  if (kind == KIND_F32) {
    return vec ? filter_select_kernel<OP, KIND_F32, true> : filter_select_kernel<OP, KIND_F32, false>;
  }
  if (kind == KIND_I32) {
    return vec ? filter_select_kernel<OP, KIND_I32, true> : filter_select_kernel<OP, KIND_I32, false>;
  }
  return vec ? filter_select_kernel<OP, KIND_I64, true> : filter_select_kernel<OP, KIND_I64, false>;
}

static FsKernel pick(int op, int kind, bool vec) {
  switch (op) {
    case OP_LT: return pick_kind<OP_LT>(kind, vec);
    case OP_LE: return pick_kind<OP_LE>(kind, vec);
    case OP_GT: return pick_kind<OP_GT>(kind, vec);
    case OP_GE: return pick_kind<OP_GE>(kind, vec);
    case OP_EQ: return pick_kind<OP_EQ>(kind, vec);
    default: return pick_kind<OP_NE>(kind, vec);
  }
}

// pred (N, P) int32, table (N, D) int32, both row-major; N a multiple of
// tile; tile a multiple of 32 and at most 1024.  Writes out (N, D) and
// counts (N / tile).
DACP_API int dacp_filter_select_planes(const int32_t* pred, int P, const int32_t* table, int D, int64_t N, int tile,
                                       int n_rows, int32_t t_hi, int32_t t_lo, int op, int kind, int32_t* out,
                                       int32_t* counts, void* stream) {
  if (tile <= 0 || tile > 1024 || (tile & 31) || N % tile || op < 0 || op > 5 || kind < 0 || kind > 2 ||
      P < (kind == KIND_I64 ? 2 : 1) || D < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return dacp_last_error();
  // columns a block stages beside its tile source rows; a tile wider than
  // that splits its columns in chunks of a multiple of 4 over gridDim.y
  const int fit = (FS_SHARED_MAX_BYTES / (int)sizeof(int32_t) - tile) / tile;
  const int dc = D <= fit ? D : fit / 4 * 4;
  const int chunks = D == 0 ? 1 : (D + dc - 1) / dc;
  const bool vec = (uintptr_t)table % 16 == 0 && (uintptr_t)out % 16 == 0 && (chunks == 1 || D % 4 == 0);
  const size_t shmem = sizeof(int32_t) * (size_t)tile * (dc + 1);
  const FsKernel kernel = pick(op, kind, vec);
  // the default 48 KB holds warp_total too; the opt-in is always to the
  // most any launch asks, so that racing callers agree
  if (shmem > 48 * 1024 - 32 * sizeof(int)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FS_SHARED_MAX_BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(N / tile), (unsigned)chunks);
  kernel<<<grid, tile, shmem, (cudaStream_t)stream>>>(pred, P, table, D, dc, n_rows, t_hi, t_lo, out, counts);
  return dacp_last_error();
}
