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
// Design: one block of `tile` threads per tile, one row per thread.  The
// TPU kernel compacts with a one-hot (tile × tile) integer matmul on the
// MXU; here a stable block prefix sum gives each survivor its slot:
// __ballot_sync + __popc within each warp, then the warp totals through
// shared memory (dacp_block_slot in dataplane.cuh, shared with
// fused_chain.cu).  `op` and `kind` are template parameters (18 instances,
// built once) and the thresholds are kernel arguments, so a new literal
// never rebuilds anything.  CUDA float compares have IEEE NaN and ±0
// semantics, like the bitcast compare of the TPU kernel.
#include "dataplane.cuh"

template <int OP, int KIND>
__global__ void filter_select_kernel(const int32_t* __restrict__ pred, int P, const int32_t* __restrict__ table,
                                     int D, int n_rows, int32_t t_hi, int32_t t_lo, int32_t* __restrict__ out,
                                     int32_t* __restrict__ counts) {
  __shared__ int warp_total[32];
  const int tile = blockDim.x;
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * tile;
  const int64_t row = base + t;

  const bool m = row < n_rows && dacp_pred<OP, KIND>(pred + row * P, t_hi, t_lo);
  int total;
  const int slot = dacp_block_slot(m, warp_total, &total);

  if (m) {
    const int32_t* src = table + row * D;
    int32_t* dst = out + (base + slot) * D;
    for (int d = 0; d < D; ++d) dst[d] = src[d];
  }
  if (t >= total) {
    int32_t* dst = out + row * D;
    for (int d = 0; d < D; ++d) dst[d] = 0;
  }
  if (t == 0) counts[blockIdx.x] = total;
}

template <int OP>
static void launch_op(int kind, dim3 grid, dim3 block, cudaStream_t s, const int32_t* pred, int P,
                      const int32_t* table, int D, int n_rows, int32_t t_hi, int32_t t_lo, int32_t* out,
                      int32_t* counts) {
  if (kind == KIND_F32) {
    filter_select_kernel<OP, KIND_F32><<<grid, block, 0, s>>>(pred, P, table, D, n_rows, t_hi, t_lo, out, counts);
  } else if (kind == KIND_I32) {
    filter_select_kernel<OP, KIND_I32><<<grid, block, 0, s>>>(pred, P, table, D, n_rows, t_hi, t_lo, out, counts);
  } else {
    filter_select_kernel<OP, KIND_I64><<<grid, block, 0, s>>>(pred, P, table, D, n_rows, t_hi, t_lo, out, counts);
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
  const dim3 grid((unsigned)(N / tile));
  const dim3 block(tile);
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_LT: launch_op<OP_LT>(kind, grid, block, s, pred, P, table, D, n_rows, t_hi, t_lo, out, counts); break;
    case OP_LE: launch_op<OP_LE>(kind, grid, block, s, pred, P, table, D, n_rows, t_hi, t_lo, out, counts); break;
    case OP_GT: launch_op<OP_GT>(kind, grid, block, s, pred, P, table, D, n_rows, t_hi, t_lo, out, counts); break;
    case OP_GE: launch_op<OP_GE>(kind, grid, block, s, pred, P, table, D, n_rows, t_hi, t_lo, out, counts); break;
    case OP_EQ: launch_op<OP_EQ>(kind, grid, block, s, pred, P, table, D, n_rows, t_hi, t_lo, out, counts); break;
    default: launch_op<OP_NE>(kind, grid, block, s, pred, P, table, D, n_rows, t_hi, t_lo, out, counts); break;
  }
  return dacp_last_error();
}
