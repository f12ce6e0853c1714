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
// else 0xFFC00000.
#include "common.cuh"

#define PROG_MAX 256
#define LITS_MAX 64
#define STACK_MAX 16

enum { I_COL = 0, I_LIT = 1, I_ADD = 2, I_SUB = 3, I_MUL = 4, I_DIV = 5, I_STORE = 6 };

// code[i] = opcode | (argument << 8): a column index, a literal index or an
// output column.
struct Program {
  int n;
  int code[PROG_MAX];
  uint32_t lits[LITS_MAX];
};

__device__ __forceinline__ float host_nan(int op, float a, float b) {
  const bool na = isnan(a);
  const bool nb = isnan(b);
  float pick;
  if (na && nb) {
    pick = (op == I_ADD || op == I_MUL) ? b : a;
  } else if (na) {
    pick = a;
  } else if (nb) {
    pick = b;
  } else {
    return __uint_as_float(0xFFC00000u);
  }
  return __uint_as_float(__float_as_uint(pick) | 0x00400000u);
}

__device__ __forceinline__ float apply(int op, float a, float b) {
  float r;
  if (op == I_ADD) {
    r = __fadd_rn(a, b);
  } else if (op == I_SUB) {
    r = __fsub_rn(a, b);
  } else if (op == I_MUL) {
    r = __fmul_rn(a, b);
  } else {
    r = __fdiv_rn(a, b);
  }
  return isnan(r) ? host_nan(op, a, b) : r;
}

__device__ __forceinline__ int32_t apply(int op, int32_t a, int32_t b) {
  const uint32_t ua = (uint32_t)a;
  const uint32_t ub = (uint32_t)b;
  uint32_t r;
  if (op == I_ADD) {
    r = ua + ub;
  } else if (op == I_SUB) {
    r = ua - ub;
  } else {
    r = ua * ub;  // the host never sends an int32 division
  }
  return (int32_t)r;
}

__device__ __forceinline__ float lit_value(uint32_t bits, float) { return __uint_as_float(bits); }
__device__ __forceinline__ int32_t lit_value(uint32_t bits, int32_t) { return (int32_t)bits; }

template <typename T>
__global__ void project_kernel(const T* __restrict__ table, int D, int64_t N, T* __restrict__ out, int K,
                               const __grid_constant__ Program prog) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const T* src = table + row * D;
  T* dst = out + row * K;
  T stack[STACK_MAX];
  int sp = 0;
  for (int i = 0; i < prog.n; ++i) {
    const int c = prog.code[i];
    const int op = c & 0xff;
    const int arg = c >> 8;
    if (op == I_COL) {
      stack[sp++] = src[arg];
    } else if (op == I_LIT) {
      stack[sp++] = lit_value(prog.lits[arg], T());
    } else if (op == I_STORE) {
      dst[arg] = stack[--sp];
    } else {
      const T b = stack[--sp];
      const T a = stack[--sp];
      stack[sp++] = apply(op, a, b);
    }
  }
}

// Checks a program against the table, the outputs and the stack before it
// reaches the card: every index in range, no stack underflow or overflow, an
// empty stack at the end, and no int32 division.
static bool program_ok(const int* code, int n_code, int n_lits, int D, int K, bool is_f32) {
  if (n_code < 0 || n_code > PROG_MAX || n_lits < 0 || n_lits > LITS_MAX) return false;
  int sp = 0;
  for (int i = 0; i < n_code; ++i) {
    const int op = code[i] & 0xff;
    const int arg = code[i] >> 8;
    if (op == I_COL || op == I_LIT) {
      if (arg < 0 || arg >= (op == I_COL ? D : n_lits) || sp >= STACK_MAX) return false;
      ++sp;
    } else if (op == I_STORE) {
      if (arg < 0 || arg >= K || sp < 1) return false;
      --sp;
    } else if (op >= I_ADD && op <= I_DIV) {
      if (sp < 2 || (op == I_DIV && !is_f32)) return false;
      --sp;
    } else {
      return false;
    }
  }
  return sp == 0;
}

// table (N, D) and out (N, K), row-major, both float32 (is_f32 = 1) or both
// int32.  The program writes some or all of the K output columns.
DACP_API int dacp_project_tiles(const void* table, int D, int64_t N, int is_f32, const int* code, int n_code,
                                const uint32_t* lits, int n_lits, void* out, int K, void* stream) {
  if (!program_ok(code, n_code, n_lits, D, K, is_f32 != 0)) return (int)cudaErrorInvalidValue;
  if (N == 0) return dacp_last_error();
  Program prog;
  prog.n = n_code;
  for (int i = 0; i < n_code; ++i) prog.code[i] = code[i];
  for (int i = 0; i < n_lits; ++i) prog.lits[i] = lits[i];
  const dim3 grid((unsigned)((N + DACP_THREADS - 1) / DACP_THREADS));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    project_kernel<float><<<grid, DACP_THREADS, 0, s>>>((const float*)table, D, N, (float*)out, K, prog);
  } else {
    project_kernel<int32_t><<<grid, DACP_THREADS, 0, s>>>((const int32_t*)table, D, N, (int32_t*)out, K, prog);
  }
  return dacp_last_error();
}
