// Device code shared by the row-parallel data-plane kernels: the predicate
// compare of filter_select.cu, the block-wide stable prefix sum that gives
// each surviving row its slot in its tile, the warp-aggregated folds of
// segment_reduce.cu's and fused_chain.cu's sums (and fused_chain.cu's
// min / max), and the postfix-program interpreter of project_arith.cu with
// its host-NaN rule.  fused_chain.cu runs the predicate, the prefix sum,
// the interpreter and the folds in one launch.
#pragma once

#include "common.cuh"

// ---------------------------------------------------------------------------
// predicate compare
// ---------------------------------------------------------------------------
enum { OP_LT = 0, OP_LE = 1, OP_GT = 2, OP_GE = 3, OP_EQ = 4, OP_NE = 5 };
enum { KIND_F32 = 0, KIND_I32 = 1, KIND_I64 = 2, KIND_NONE = 3 };

template <int OP, typename T>
__device__ __forceinline__ bool dacp_cmp(T a, T b) {
  if (OP == OP_LT) return a < b;
  if (OP == OP_LE) return a <= b;
  if (OP == OP_GT) return a > b;
  if (OP == OP_GE) return a >= b;
  if (OP == OP_EQ) return a == b;
  return a != b;
}

// int64 compare on two int32 words; lo / t_lo carry the low word with its
// sign bit flipped, so a signed compare is the unsigned low-word compare.
template <int OP>
__device__ __forceinline__ bool dacp_cmp64(int32_t hi, int32_t lo, int32_t t_hi, int32_t t_lo) {
  if (OP == OP_EQ) return hi == t_hi && lo == t_lo;
  if (OP == OP_NE) return hi != t_hi || lo != t_lo;
  const bool lt = hi < t_hi || (hi == t_hi && lo < t_lo);
  if (OP == OP_LT) return lt;
  if (OP == OP_GE) return !lt;
  const bool gt = hi > t_hi || (hi == t_hi && lo > t_lo);
  return OP == OP_GT ? gt : !gt;
}

// The predicate on one row's planes p: float32 through the bit pattern (IEEE
// NaN and ±0 semantics), int32 directly, int64 as a two-word compare.
template <int OP, int KIND>
__device__ __forceinline__ bool dacp_pred(const int32_t* p, int32_t t_hi, int32_t t_lo) {
  if (KIND == KIND_F32) return dacp_cmp<OP, float>(__int_as_float(p[0]), __int_as_float(t_hi));
  if (KIND == KIND_I32) return dacp_cmp<OP, int32_t>(p[0], t_hi);
  return dacp_cmp64<OP>(p[0], p[1] ^ INT32_MIN, t_hi, t_lo);
}

template <int KIND>
__device__ __forceinline__ bool dacp_pred_op(int op, const int32_t* p, int32_t t_hi, int32_t t_lo) {
  switch (op) {
    case OP_LT: return dacp_pred<OP_LT, KIND>(p, t_hi, t_lo);
    case OP_LE: return dacp_pred<OP_LE, KIND>(p, t_hi, t_lo);
    case OP_GT: return dacp_pred<OP_GT, KIND>(p, t_hi, t_lo);
    case OP_GE: return dacp_pred<OP_GE, KIND>(p, t_hi, t_lo);
    case OP_EQ: return dacp_pred<OP_EQ, KIND>(p, t_hi, t_lo);
    default: return dacp_pred<OP_NE, KIND>(p, t_hi, t_lo);
  }
}

// The same predicate with op and kind chosen at run time (uniform across a
// launch, so the switch does not diverge).  KIND_NONE passes every row.
__device__ __forceinline__ bool dacp_pred_rt(int op, int kind, const int32_t* p, int32_t t_hi, int32_t t_lo) {
  if (kind == KIND_F32) return dacp_pred_op<KIND_F32>(op, p, t_hi, t_lo);
  if (kind == KIND_I32) return dacp_pred_op<KIND_I32>(op, p, t_hi, t_lo);
  if (kind == KIND_I64) return dacp_pred_op<KIND_I64>(op, p, t_hi, t_lo);
  return true;
}

// ---------------------------------------------------------------------------
// block-wide stable prefix sum
// ---------------------------------------------------------------------------
// Every thread of the block calls it with its row's flag m.  Returns the
// number of flagged threads below this one (the row's slot in its tile) and
// sets *total to the block's count.  warp_total is __shared__ int[32].  The
// trailing barrier lets the caller reuse warp_total for the next tile.
__device__ __forceinline__ int dacp_block_slot(bool m, int* warp_total, int* total) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, m);
  const int before = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_total[warp] = __popc(ballot);
  __syncthreads();
  int offset = 0;
  int sum = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int c = warp_total[w];
    offset += (w < warp) ? c : 0;
    sum += c;
  }
  __syncthreads();
  *total = sum;
  return offset + before;
}

// ---------------------------------------------------------------------------
// warp-aggregated fold
// ---------------------------------------------------------------------------
// Folds NV values per lane over each set of lanes that share a key, so
// that a skewed group costs one shared atomic per column per warp instead
// of one per row.  Every lane of the warp calls it together with
// peers = __match_any_sync(0xffffffff, key), its values v and an
// associative, commutative op; it returns true on the lowest lane of each
// set, whose v then holds the set's fold.  A tree over each set's lanes in
// lane order: in round i every remaining lane folds in the values of the
// next remaining lane above it, and the lanes at odd positions drop out,
// so a set of k lanes takes ceil(log2 k) rounds (Westphal's reduce_peers).
// The loop count is uniform across the warp.  int32 addition, min and max
// are exact in any order (sums while they stay in range).
template <int NV, typename Op>
__device__ __forceinline__ bool dacp_peer_fold(unsigned peers, int32_t (&v)[NV], Op op) {
  const int lane = threadIdx.x & 31;
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned rank = __popc(below);             // position among the set's lanes
  unsigned above = peers & (0xfffffffeu << lane);  // remaining lanes of the set above this one
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);  // 1 + lane of the next one, 0 if none
    const int src = next > 0 ? next - 1 : lane;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int32_t t = __shfl_sync(0xffffffffu, v[j], src);
      if (next > 0) v[j] = op(v[j], t);
    }
    above &= __ballot_sync(0xffffffffu, (rank & 1u) == 0u);
    rank >>= 1;
  }
  return below == 0u;
}

template <int NV>
__device__ __forceinline__ bool dacp_peer_sum(unsigned peers, int32_t (&v)[NV]) {
  return dacp_peer_fold(peers, v, [](int32_t a, int32_t b) { return a + b; });
}

template <int NV>
__device__ __forceinline__ bool dacp_peer_min(unsigned peers, int32_t (&v)[NV]) {
  return dacp_peer_fold(peers, v, [](int32_t a, int32_t b) { return a < b ? a : b; });
}

// ---------------------------------------------------------------------------
// postfix-program interpreter
// ---------------------------------------------------------------------------
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

// NaN result of a float32 op, rewritten to numpy's bits on an x86 host: the
// NaN operand quieted (both NaN: the second for add and mul, the first for
// sub and div), else the default NaN 0xFFC00000.
__device__ __forceinline__ float dacp_host_nan(int op, float a, float b) {
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

__device__ __forceinline__ float dacp_apply(int op, float a, float b) {
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
  return isnan(r) ? dacp_host_nan(op, a, b) : r;
}

__device__ __forceinline__ int32_t dacp_apply(int op, int32_t a, int32_t b) {
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

__device__ __forceinline__ float dacp_lit_value(uint32_t bits, float) { return __uint_as_float(bits); }
__device__ __forceinline__ int32_t dacp_lit_value(uint32_t bits, int32_t) { return (int32_t)bits; }

// Runs prog over one row: src is the row's input columns, store(k, v) takes
// output column k.
template <typename T, typename Store>
__device__ __forceinline__ void dacp_run_program(const Program& prog, const T* __restrict__ src, Store store) {
  T stack[STACK_MAX];
  int sp = 0;
  for (int i = 0; i < prog.n; ++i) {
    const int c = prog.code[i];
    const int op = c & 0xff;
    const int arg = c >> 8;
    if (op == I_COL) {
      stack[sp++] = src[arg];
    } else if (op == I_LIT) {
      stack[sp++] = dacp_lit_value(prog.lits[arg], T());
    } else if (op == I_STORE) {
      store(arg, stack[--sp]);
    } else {
      const T b = stack[--sp];
      const T a = stack[--sp];
      stack[sp++] = dacp_apply(op, a, b);
    }
  }
}

// Checks a program against its input width D, output width K and the stack
// before it reaches the card: every index in range, no stack underflow or
// overflow, an empty stack at the end, and no int32 division.
static inline bool dacp_program_ok(const int* code, int n_code, int n_lits, int D, int K, bool is_f32) {
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

static inline void dacp_program_load(Program* prog, const int* code, int n_code, const uint32_t* lits, int n_lits) {
  prog->n = n_code;
  for (int i = 0; i < n_code; ++i) prog->code[i] = code[i];
  for (int i = 0; i < n_lits; ++i) prog->lits[i] = lits[i];
}
