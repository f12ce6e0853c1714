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
// far below the card's 67 TFLOP/s.  At a 65536-row morsel that is 0.3 µs,
// below a launch's own floor, so what counts there is the chain of
// dependent latencies each thread walks.
//
// Design: the TPU kernel is traced and compiled per descriptor signature.
// Built by hand, that would cost an nvcc run for every new projection, so
// the host flattens each descriptor tuple into a postfix program (column
// loads, literal pushes, binary ops, stores; literal-only subtrees folded on
// the host as the Pallas trace folds them) and one precompiled kernel per
// dtype interprets it.  The host knows the stack depth at every
// instruction, so it writes each instruction's slot into its word
// (project_arith.py annotate), pairs it with its literal, and fuses a
// literal push into the op that takes it as its right operand
// (temp + 273.15 is a load, one op and a store).  The top of the stack is
// a register and the slots below it live in shared memory, one bank per
// lane, addressed by the annotated slot: no stack is indexed in local
// memory (chip_smoke.py checks the SASS for LDL / STL), and a program that
// never holds two values touches no shared memory.  Each instruction is
// decoded by a chain of uniform tests, ordered by how often programs use
// each kind (an op with a literal first), and the next pair is read from
// the constant bank while the current one runs.  Add, sub and mul are
// computed and selected without a branch; a float32 NaN result is fixed up
// only in a warp that holds one.
//
// Measured on the H100 (PERF.md): a switch over (op, slot) naming 16
// register slots kept the stack in registers, but its f32 kernel grew to
// over 4096 instructions and a tree of compares per instruction, slower
// than the stack in local memory; staging a tile in shared memory by
// 16-byte cp.async, and 16-byte output stores, lost to direct 4-byte
// accesses at every shape measured, since a warp's 32 lanes read 32
// consecutive rows and a one-column table or output moves in whole lines.
//
// Each thread takes one row while that leaves fewer than PT_WIDE_WARPS
// warps an SM (a 65536-row morsel: 2048 warps on 132 SMs), else
// PT_WIDE_ROWS rows PT_THREADS apart, so that one decode serves four rows
// where the card is full.  Blocks walk their tiles over a grid-stride loop
// of at most PT_BLOCKS_PER_SM blocks an SM (the SM count asked of the
// runtime once per device).  The program travels as a __grid_constant__
// kernel parameter, so a launch needs no upload.
//
// Arithmetic: f32 uses __fadd_rn / __fmul_rn / __fdiv_rn, which are never
// contracted, and a - b as a + (-b), which IEEE defines as the same
// rounding; the build adds -fmad=false -prec-div=true -ftz=false.  i32
// computes in uint32_t and casts back, so it wraps with no signed-overflow
// UB.  NaN bits: the GPU returns the canonical NaN 0x7FFFFFFF, while numpy
// on an x86 host returns 0xFFC00000 for an invalid operation (0/0, inf-inf,
// 0*inf) and propagates an operand NaN quieted, so a NaN result is
// rewritten to the host's rule (dacp_host_nan in dataplane.cuh, whose
// interpreter dacp_run_program runs the unannotated programs of
// fused_chain.cu).
#include "dataplane.cuh"

#define PT_THREADS 256
#define PT_BLOCKS_PER_SM 4
// Rows a thread: one while that leaves under PT_WIDE_WARPS warps an SM, else
// PT_WIDE_ROWS.
#define PT_WIDE_ROWS 4
#define PT_WIDE_WARPS 32
// Shared memory of the deepest program at PT_WIDE_ROWS: 15 slots below the
// top, one int a row
#define PT_SHARED_MAX_BYTES ((STACK_MAX - 1) * PT_WIDE_ROWS * PT_THREADS * 4)

// Annotated instructions (project_arith.py annotate) are (word, literal)
// pairs; word = kind | slot << 4 | arg << 8.  Kinds: I_COL, the register ops
// I_ADD .. I_DIV and I_STORE as in dataplane.cuh, and with PT_LIT_BIT set
// the kinds that take the pair's literal: PT_LIT (a push) and PT_ADDL ..
// PT_DIVL (the op with a literal right operand).  The slot is the stack
// depth below the top: the depth before a push, the left operand's slot of
// a register op, the slot a store takes the top from.  The top of the
// stack is a register; the slots below it live in shared memory.
enum { PT_LIT_BIT = 8, PT_LIT = I_LIT | PT_LIT_BIT, PT_ADDL = I_ADD | PT_LIT_BIT, PT_SUBL, PT_MULL, PT_DIVL };

struct SlotProgram {
  int n;
  int2 ins[PROG_MAX + 1];  // ins[n] == {0, 0}: the read-ahead past the last
};

// One op of the program on the thread's R rows, out = a op b, op one of
// I_ADD .. I_DIV (uniform across the launch).  float32 rounds once
// (__fadd_rn etc.; sub as a + (-b), which IEEE defines as a - b); a NaN
// result takes numpy's x86 bits (dacp_host_nan), fixed up only in a warp
// that holds one.  int32 wraps, computed in uint32_t, without a branch; the
// host sends no int32 division.
template <int R>
__device__ __forceinline__ void pt_ops(int op, const float (&a)[R], const float (&b)[R], float (&out)[R]) {
  float r[R];
  if (op == I_MUL) {
#pragma unroll
    for (int j = 0; j < R; ++j) r[j] = __fmul_rn(a[j], b[j]);
  } else if (op == I_DIV) {
#pragma unroll
    for (int j = 0; j < R; ++j) r[j] = __fdiv_rn(a[j], b[j]);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) r[j] = __fadd_rn(a[j], op == I_SUB ? -b[j] : b[j]);
  }
  bool nan = false;
#pragma unroll
  for (int j = 0; j < R; ++j) nan |= isnan(r[j]);
  if (__any_sync(0xffffffffu, nan)) {
    // dacp_host_nan's rule without its branches
    const bool second = op == I_ADD || op == I_MUL;  // of two NaN operands
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool na = isnan(a[j]);
      const bool nb = isnan(b[j]);
      const uint32_t pick = ((na && !(second && nb)) ? __float_as_uint(a[j]) : __float_as_uint(b[j])) | 0x00400000u;
      r[j] = isnan(r[j]) ? __uint_as_float(na || nb ? pick : 0xFFC00000u) : r[j];
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) out[j] = r[j];
}

template <int R>
__device__ __forceinline__ void pt_ops(int op, const int32_t (&a)[R], const int32_t (&b)[R], int32_t (&out)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t ua = (uint32_t)a[j];
    const uint32_t ub = (uint32_t)b[j];
    out[j] = (int32_t)(op == I_MUL ? ua * ub : ua + (op == I_SUB ? 0u - ub : ub));
  }
}

// One statement for each of the thread's rows j.
#define PT_EACH_ROW(stmt) _Pragma("unroll") for (int j = 0; j < R; ++j) { stmt; }

// The thread's rows are row0 + j · PT_THREADS: a warp's 32 lanes touch 32
// consecutive rows, so a one-column table is read (and a one-column output
// written) in whole 128-byte lines.  sst[(s · R + j) · PT_THREADS + t] holds
// row j's slot s below the top, one bank per lane.
template <typename T, int R>
__global__ void __launch_bounds__(PT_THREADS, PT_BLOCKS_PER_SM)
    project_kernel(const T* __restrict__ table, int D, int64_t N, T* __restrict__ out, int K,
                   const __grid_constant__ SlotProgram prog) {
  extern __shared__ __align__(16) int32_t sh[];
  T* sst = reinterpret_cast<T*>(sh);
  const int t = threadIdx.x;
  constexpr int TILE = R * PT_THREADS;
  const int64_t n_tiles = (N + TILE - 1) / TILE;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * TILE + t;
    T* dst = out + row0 * K;
    bool live[R];
    const T* src[R];  // row j's inputs; a row past N reads row N - 1 and stores nothing
    PT_EACH_ROW(live[j] = row0 + j * PT_THREADS < N;
                src[j] = table + dacp_min64(row0 + j * PT_THREADS, N - 1) * D);
    T top[R];
    int2 ins = prog.ins[0];
    for (int i = 0; i < prog.n; ++i) {
      const int2 next = prog.ins[i + 1];  // read while this one runs
      const int slot = (ins.x >> 4) & 0xf;
      const int arg = ins.x >> 8;
      T* below = sst + slot * TILE + t;  // row j's slot: below[j · PT_THREADS]
      const T lit = dacp_lit_value((uint32_t)ins.y, T());
      // A chain of tests ordered by how often programs use each kind: a
      // literal op, the commonest, takes one test and its arithmetic
      // selects among add, sub and mul without a branch.
      const int kind = ins.x & 0xf;
      if (kind >= PT_ADDL) {
        T b[R];
        PT_EACH_ROW(b[j] = lit);
        pt_ops<R>(kind & 7, top, b, top);
      } else if (kind == I_COL) {
        if (slot > 0) PT_EACH_ROW(below[(j - R) * PT_THREADS] = top[j]);
        PT_EACH_ROW(top[j] = src[j][arg]);
      } else if (kind == I_STORE) {
        PT_EACH_ROW(if (live[j]) dst[(int64_t)j * PT_THREADS * K + arg] = top[j]);
        if (slot > 0) PT_EACH_ROW(top[j] = below[(j - R) * PT_THREADS]);
      } else if (kind == PT_LIT) {
        if (slot > 0) PT_EACH_ROW(below[(j - R) * PT_THREADS] = top[j]);
        PT_EACH_ROW(top[j] = lit);
      } else {  // a register op: the slot below op the top
        T a[R];
        PT_EACH_ROW(a[j] = below[j * PT_THREADS]);
        pt_ops<R>(kind, a, top, top);
      }
      ins = next;
    }
  }
}

// Checks an annotated program against its input width D, output width K and
// the stack before it reaches the card: every index in range, every slot
// the stack depth at its instruction, no stack underflow or overflow, an
// empty stack at the end, and no int32 division.  Sets *depth to the most
// slots the program holds.
static bool dacp_slot_program_ok(const int* code, int n, int D, int K, bool is_f32, int* depth) {
  if (n < 0 || n > PROG_MAX) return false;
  int sp = 0;
  *depth = 0;
  for (int i = 0; i < n; ++i) {
    const int word = code[2 * i];
    const int kind = word & 0xf;
    const int slot = (word >> 4) & 0xf;
    const int arg = word >> 8;
    if ((kind & ~PT_LIT_BIT) == I_DIV && !is_f32) return false;
    if (kind == I_COL || kind == PT_LIT) {
      if ((kind == I_COL ? arg < 0 || arg >= D : arg != 0) || sp >= STACK_MAX || slot != sp) return false;
      ++sp;
    } else if (kind == I_STORE) {
      if (arg < 0 || arg >= K || sp < 1 || slot != sp - 1) return false;
      --sp;
    } else if (kind >= I_ADD && kind <= I_DIV) {
      if (arg != 0 || sp < 2 || slot != sp - 2) return false;
      --sp;
    } else if (kind >= PT_ADDL && kind <= PT_DIVL) {
      if (arg != 0 || sp < 1 || slot != sp - 1) return false;
    } else {
      return false;
    }
    *depth = dacp_imax(*depth, sp);
  }
  return sp == 0;
}

template <typename T>
static int pt_launch(const T* table, int D, int64_t N, T* out, int K, int depth, const SlotProgram& prog,
                     cudaStream_t s) {
  int sms = 0;
  const cudaError_t e = dacp_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const bool wide = N >= (int64_t)sms * PT_WIDE_WARPS * 32;
  const int rows = wide ? PT_WIDE_ROWS * PT_THREADS : PT_THREADS;  // a tile
  const unsigned grid = (unsigned)dacp_min64((N + rows - 1) / rows, (int64_t)PT_BLOCKS_PER_SM * sms);
  const size_t shmem = sizeof(T) * (size_t)rows * dacp_imax(0, depth - 1);
  auto kernel = wide ? project_kernel<T, PT_WIDE_ROWS> : project_kernel<T, 1>;
  // above the default 48 KB, the opt-in is always to the most any launch
  // asks, so that racing callers agree
  if (shmem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PT_SHARED_MAX_BYTES);
    if (a != cudaSuccess) return (int)a;
  }
  kernel<<<grid, PT_THREADS, shmem, s>>>(table, D, N, out, K, prog);
  return dacp_last_error();
}

// table (N, D) and out (N, K), row-major, both float32 (is_f32 = 1) or both
// int32, any alignment; code is n annotated (word, literal) pairs
// (project_arith.py annotate).  The program writes some or all of the K
// output columns.
DACP_API int dacp_project_tiles(const void* table, int D, int64_t N, int is_f32, const int* code, int n, void* out,
                                int K, void* stream) {
  int depth = 0;
  if (D < 0 || K < 0 || !dacp_slot_program_ok(code, n, D, K, is_f32 != 0, &depth)) return (int)cudaErrorInvalidValue;
  if (N == 0 || n == 0) return dacp_last_error();
  SlotProgram prog = {};
  prog.n = n;
  for (int i = 0; i < n; ++i) prog.ins[i] = make_int2(code[2 * i], code[2 * i + 1]);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) return pt_launch((const float*)table, D, N, (float*)out, K, depth, prog, s);
  return pt_launch((const int32_t*)table, D, N, (int32_t*)out, K, depth, prog, s);
}
