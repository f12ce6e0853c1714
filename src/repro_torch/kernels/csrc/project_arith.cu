// project_tiles: projection arithmetic (+ - * /) over float32 or int32
// columns, one program evaluated per row.
//
// Replaces the TPU kernel src/repro/kernels/project_arith.py project_tiles
// (body _kernel, evaluator _eval_descr, cache _compiled).
//
// What it computes: for each row of an (N, D) table, every output column of
// a projection, out[row, k] = descriptor_k(row), with numpy's float32 /
// int32 semantics: each f32 op rounds once to nearest-even (never fused into
// an FMA), division is correctly rounded, denormals are kept, and int32
// wraps modulo 2^32.
//
// Bound: bytes.  It reads the table once (4·N·D) and writes the outputs once
// (4·N·K), at 3.35 TB/s on an H100 SXM; a few f32 operations per element are
// far below the card's 67 TFLOP/s.
//
// Design: the TPU kernel is traced and compiled per descriptor signature.
// Built by hand, that would cost an nvcc run for every new projection, so
// the host flattens each descriptor tuple into a postfix program instead
// (column loads, literal pushes, binary ops, stores; literal-only subtrees
// folded on the host as the Pallas trace folds them), and one precompiled
// kernel per dtype runs that program for each row on a fixed-depth register
// stack.  The program travels as a __grid_constant__ kernel parameter, so a
// launch needs no extra upload.  f32 uses __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, which are never contracted; the build adds -fmad=false
// -prec-div=true -ftz=false.  i32 computes in uint32_t and casts back, so it
// wraps with no signed-overflow UB.
//
// NaN bits: the GPU returns the canonical NaN 0x7FFFFFFF, while numpy on an
// x86 host returns 0xFFC00000 for an invalid operation (0/0, inf-inf, 0*inf)
// and propagates an operand NaN quieted.  So a NaN result is rewritten to the
// host's rule: the NaN operand quieted; if both operands are NaN, the second
// for add and mul and the first for sub and div (numpy's vectorised loops);
// else 0xFFC00000.  The interpreter and this rule live in dataplane.cuh,
// shared with fused_chain.cu.
#include "dataplane.cuh"

template <typename T>
__global__ void project_kernel(const T* __restrict__ table, int D, int64_t N, T* __restrict__ out, int K,
                               const __grid_constant__ Program prog) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const T* src = table + row * D;
  T* dst = out + row * K;
  dacp_run_program(prog, src, [dst](int k, T v) { dst[k] = v; });
}

// table (N, D) and out (N, K), row-major, both float32 (is_f32 = 1) or both
// int32.  The program writes some or all of the K output columns.
DACP_API int dacp_project_tiles(const void* table, int D, int64_t N, int is_f32, const int* code, int n_code,
                                const uint32_t* lits, int n_lits, void* out, int K, void* stream) {
  if (!dacp_program_ok(code, n_code, n_lits, D, K, is_f32 != 0)) return (int)cudaErrorInvalidValue;
  if (N == 0) return dacp_last_error();
  Program prog;
  dacp_program_load(&prog, code, n_code, lits, n_lits);
  const dim3 grid((unsigned)((N + DACP_THREADS - 1) / DACP_THREADS));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    project_kernel<float><<<grid, DACP_THREADS, 0, s>>>((const float*)table, D, N, (float*)out, K, prog);
  } else {
    project_kernel<int32_t><<<grid, DACP_THREADS, 0, s>>>((const int32_t*)table, D, N, (int32_t*)out, K, prog);
  }
  return dacp_last_error();
}
