// flash_attention: causal or full GQA attention, online softmax over kv
// tiles, float32 (m, l, acc) state.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel).  Same function: scores in float32 times
// hd^-0.5, masked with -1e30 where qpos < kpos when causal, a running max,
// l and acc in float32 (l sums the unrounded p), p rounded to v's type
// before the PV product, output acc / max(l, 1e-30) in q's type.
//
//   q, o (B, KV, G, S, hd) and k, v (B, KV, T, hd), float32 or bfloat16,
//   any element strides with the head dim contiguous, so the model hands
//   its (B, S, KV, G, hd) projections and its (B, KV, T, hd) cache without
//   a copy.  Any S and T: ragged tiles are masked here (the TPU kernel
//   asserts S % tq == 0 and T % tk == 0).  hd is 32, 64, 128 or 256.
//
//   Bound: operations.  A causal prefill does 2·2·B·H·S·T·hd/2 flops and
//   moves each of q, k, v, o once; at the serving shape (B 4, H 32, S = T =
//   1024, hd 128, bf16) that is 34 GFLOP against 42 MB, far above the
//   card's ridge, so the products belong on the tensor cores.
//
// Two kernels, chosen by dtype before launch (dispatch, not fallback):
//
// bfloat16 (flash_attn_bf16_kernel, every serving call): both products on
// the tensor cores as Hopper's warpgroup MMA, wgmma.mma_async m64nNk16 bf16
// -> f32.  One block of two warpgroups owns a (b·kv, g) pair and 128 query
// rows, 64 per warpgroup; two blocks share an SM (one at hd 256).  Q·Kᵀ
// reads Q and K from shared memory; P·V takes P from registers and V as the
// MN-major B operand (the descriptor's transpose bit), so V is never
// transposed by hand.  All loads are TMA bulk tensor copies issued by one
// thread: tensor maps built on the host from the views' strides (so the
// model's permuted q and cache slices need no copy), each box one 128-byte
// atom wide (64 bytes at hd 32) and written by the map's swizzle straight
// into wgmma's canonical layout (Swizzle<3,4,3>, resp. <2,4,3>), rows past
// S or T arriving as zeros; an mbarrier per ring stage reports the bytes
// landed.  The q tile lands once; k/v tiles of 64 rows (32 at hd 256) go
// through a two-stage ring one tile ahead of the products, one block
// barrier per tile freeing the stage for the next copy.  The scores stay
// in the accumulator fragments: the online-softmax update runs on them in
// registers (row max and sum as trees, then over the quad that shares a
// row by shuffles; p = 2^(s·c - m·c) with c = hd^-0.5·log2 e, one fma and
// one ex2 each), and p, rounded to bf16 — the rounding the TPU kernel
// applies before its PV dot — is repacked in registers as the A operand of
// the second product.  Key tiles wholly above the diagonal are never
// loaded, a warpgroup skips a tile wholly above its own rows (p would be
// exactly 0 and alpha 1), and only tiles that cross the diagonal or T are
// masked.  The grid runs the last (longest) q tiles of every head first.
// The output is staged through the warp's own q rows and stored 16 bytes a
// lane.
//   Per-thread cp.async copies cost every warp its address arithmetic and
//   load-issue slots on each tile; with TMA the threads only wait, which
//   also freed the registers for a second block per SM — the two changes
//   that mattered of those measured (PERF.md).
//
// float32 (flash_attn_f32_kernel: the tests and chip_smoke.py's f32 cases,
// held to 3e-5, which bf16 or TF32 products cannot meet): scalar fmaf on
// the CUDA cores.  One block per (b·kv, g, 64 query rows) loops over
// 32-row kv tiles staged in shared memory (rows padded by one word), in
// three phases per tile separated by barriers: scores (a 4×2 register tile
// per thread), the online-softmax update (four threads per row, shuffles)
// and the PV accumulation (acc in registers, 8 rows × hd/32 columns).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver at run time

#include "attention.cuh"

namespace {

struct QStrides {  // element strides of q or o over (b, kv, g, s); hd is contiguous
  long long b, n, g, s;
};
struct KStrides {  // element strides of k or v over (b, kv, t); hd is contiguous
  long long b, n, t;
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int kGroups = 2;                 // warpgroups per block, 64 query rows each
constexpr int kThreadsTC = kGroups * 128;
constexpr int kBM = kGroups * 64;          // query rows per block
constexpr int kStages = 2;                 // k/v tiles in the ring: j in use, j + 1 landing

template <int HD>
__host__ __device__ constexpr int kv_rows() {  // kv rows per tile
  return HD == 256 ? 32 : 64;
}

// A shared tile keeps each row as atoms of E = min(hd, 64) elements (128 or
// 64 bytes): a (rows, hd) tile is hd / E column blocks of (rows, E), each
// 8 rows of a block one swizzle pattern (Swizzle<3,4,3> for 128-byte atoms,
// <2,4,3> for 64): the canonical layouts wgmma's descriptors name.
template <int HD>
struct Atom {
  static constexpr int E = HD < 64 ? HD : 64;              // elements per atom row
  static constexpr uint32_t B = E * 2;                     // bytes per atom row
  static constexpr uint32_t MASK = B == 128 ? 7 : 3;       // row bits xor-ed into the 16-byte chunk index
  static constexpr uint64_t LAYOUT = B == 128 ? 1 : 2;     // descriptor layout: 128- or 64-byte swizzle
};

template <int HD>
constexpr size_t tc_smem_bytes() {  // q, the k and v rings, their barriers, and slack to align to 1024
  return (size_t)(kBM + 2 * kStages * kv_rows<HD>()) * HD * sizeof(bf16) + kStages * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t mask) { return off ^ (((off >> 7) & mask) << 4); }

// byte offset of (row, 16-byte chunk c of the row) in a tile of `rows` rows
template <int HD>
__device__ __forceinline__ uint32_t tile_off(int rows, int row, int c) {
  using A = Atom<HD>;
  constexpr int CPA = A::B / 16;  // chunks per atom row
  return (uint32_t)(c / CPA) * rows * A::B + swizzle(row * A::B + (c % CPA) * 16, A::MASK);
}

// mbarriers in shared memory, one per ring stage: a phase completes when
// the thread that armed it has arrived and the copies it announced landed
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// TMA: one box of a tensor map into shared memory, completion on bar.  The
// map's swizzle writes the box in the tile layout above; rows past the
// tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, "
      "%6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle layout
template <int HD>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (Atom<HD>::LAYOUT << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A · B, m64nNk16 bf16 -> f32.  ss: A (64 × 16) and B (16 × N) from
// shared memory, both K-major; accumulate 0 overwrites d.  rs: A from
// registers (mma.m16n8k16's A fragment in each warp), B MN-major.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// 2^x on the special-function unit; subnormal results flush to 0, which
// moves a softmax weight by less than 2^-126 of the row's largest
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the N values of a, as a tree (N a power of 2)
template <int N>
__device__ __forceinline__ float tree_max(float (&a)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) a[i] = fmaxf(a[i], a[i + w]);
  return a[0];
}
template <int N>
__device__ __forceinline__ float tree_sum(float (&a)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) a[i] += a[i + w];
  return a[0];
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// S (64 × BN per warpgroup) (+)= Q (64 × 16) · Kᵀ (16 × BN)
template <int BN>
__device__ __forceinline__ void qk_product(float* s, uint64_t desc_q, uint64_t desc_k, int accumulate) {
  if constexpr (BN == 32) {
    wgmma_ss_n32(s, desc_q, desc_k, accumulate);
  } else {
    wgmma_ss_n64(s, desc_q, desc_k, accumulate);
  }
}

// acc (64 × HD per warpgroup) += P (64 × 16, registers) · V (16 × HD)
template <int HD>
__device__ __forceinline__ void pv_product(float* acc, const unsigned (&a)[4], uint64_t desc_v) {
  if constexpr (HD == 32) {
    wgmma_rs_n32(acc, a, desc_v);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(acc, a, desc_v);
  } else {
#pragma unroll
    for (int h = 0; h < HD / 128; ++h)  // 128 columns (two atoms) at a time
      wgmma_rs_n128(acc + 64 * h, a, desc_v + ((uint64_t)(h * 2 * kv_rows<HD>() * Atom<HD>::B) >> 4));
  }
}

// issue S = Q · K_tileᵀ for this warpgroup's 64 rows (asynchronous: the
// caller waits)
template <int HD>
__device__ __forceinline__ void issue_qk(float* s, uint32_t sQ, uint32_t tK, int g0) {
  using A = Atom<HD>;
  constexpr int BN = kv_rows<HD>();
  fence_regs<BN / 2>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t atom = kk * 16 / A::E, col = (kk * 16 % A::E) * 2;
    const uint64_t dq = smem_desc<HD>(sQ + atom * kBM * A::B + g0 * A::B + col, 16, 8 * A::B);
    const uint64_t dk = smem_desc<HD>(tK + atom * BN * A::B + col, 16, 8 * A::B);
    qk_product<BN>(s, dq, dk, kk > 0);
  }
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTC, HD <= 128 ? 2 : 1)
    flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int G, int KV, int BKV,
                           int n_qtiles, int S, int Tn, int causal, float scale_log2, QStrides os) {
  using A = Atom<HD>;
  constexpr int BN = kv_rows<HD>();
  constexpr int NT = BN / 8;   // score n-tiles of a warp
  constexpr int DT = HD / 8;   // output n-tiles of a warp
  constexpr int PS = BN / 16;  // k-steps of P·V
  constexpr uint32_t Q_BYTES = kBM * HD * 2, KV_BYTES = BN * HD * 2;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const uint32_t sQ = (smem_u32(smem) + 1023u) & ~1023u;  // swizzle patterns repeat every 1024 bytes
  const uint32_t sK = sQ + Q_BYTES;                       // kStages tiles
  const uint32_t sV = sK + kStages * KV_BYTES;            // kStages tiles
  const uint32_t full = sV + kStages * KV_BYTES;          // kStages mbarriers
  unsigned char* q_tile = smem + (sQ - smem_u32(smem));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_tile = G * BKV;
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / per_tile);  // longest q tiles first
  const int rest = (int)(blockIdx.x % per_tile);
  const int g = rest % G, bkv = rest / G;
  const int b = bkv / KV, n = bkv % KV;
  const int q0 = qt * kBM;
  bf16* ob = o + b * os.b + n * os.n + g * os.g;

  // kv positions any row of this tile may see: below the diagonal of its
  // last real row when causal (the TPU kernel's `run` condition)
  const int kv_end = causal ? min(Tn, min(q0 + kBM, S)) : Tn;
  const int n_tiles = (kv_end + BN - 1) / BN;

  // warpgroup rows g0 .. g0 + 63; this thread's rows of its warp's 16:
  // w0 + r_lo and w0 + r_lo + 8 (wgmma's accumulator layout)
  const int g0 = (warp >> 2) * 64, w0 = warp * 16;
  const int r_lo = lane >> 2, c_pair = 2 * (lane & 3);
  // tiles past this one are wholly above the warpgroup's rows: p would be
  // exactly 0 and alpha 1
  const int wg_tiles = q0 + g0 >= S ? 0 : causal ? min(n_tiles, (q0 + g0 + 63) / BN + 1) : n_tiles;

  // thread 0 issues every copy: the q tile, then each k/v tile one tile ahead
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    mbar_expect(full + st * 8, 2 * KV_BYTES + (j == 0 ? Q_BYTES : 0));
#pragma unroll
    for (int a = 0; a < HD / A::E; ++a) {
      tma_load(sK + st * KV_BYTES + a * BN * A::B, &tm_k, full + st * 8, a * A::E, j * BN, n, b);
      tma_load(sV + st * KV_BYTES + a * BN * A::B, &tm_v, full + st * 8, a * A::E, j * BN, n, b);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(full + st * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_kv(0);
#pragma unroll
    for (int a = 0; a < HD / A::E; ++a) tma_load(sQ + a * kBM * A::B, &tm_q, full, a * A::E, q0, g, n, b);
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_run[2] = {DACP_ATTN_NEG_INF, DACP_ATTN_NEG_INF};
  float l_part[2] = {0.f, 0.f};  // this thread's columns only; the quad's sum is l
  float s[NT][4];
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    mbar_wait(full + j % kStages * 8, (j / kStages) & 1);  // tile j is in
    __syncthreads();  // every warpgroup is done with tile j - 1, whose stage the next load takes
    if (tid == 0 && j + 1 < n_tiles) load_kv(j + 1);

    if (j < wg_tiles) {
      issue_qk<HD>(&s[0][0], sQ, sK + j % kStages * KV_BYTES, g0);
      wgmma_wait_all();
      fence_regs<NT * 4>(&s[0][0]);

      // mask where the tile crosses T or the diagonal
      if (k0 + BN > Tn || (causal && k0 + BN - 1 > q0 + w0)) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + t * 8 + c_pair + (e & 1);
            const int qp = q0 + w0 + r_lo + (e >> 1) * 8;
            if (kp >= Tn)
              s[t][e] = -INFINITY;  // past the end of k: contributes exactly nothing
            else if (causal && qp < kp)
              s[t][e] = DACP_ATTN_NEG_INF;
          }
      }

      // online softmax on the fragments: rows r_lo (e = 0, 1) and r_lo + 8
      // (e = 2, 3).  m is kept on the unscaled scores (the scale is
      // positive); p = 2^(s·c - m·c) with c = hd^-0.5·log2 e, one fma each.
      float mx[2], alpha[2], mc[2];
      {
        float r0[NT], r1[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          r0[t] = fmaxf(s[t][0], s[t][1]);
          r1[t] = fmaxf(s[t][2], s[t][3]);
        }
        mx[0] = fmaxf(m_run[0], tree_max(r0));
        mx[1] = fmaxf(m_run[1], tree_max(r1));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = ex2((m_run[i] - mx[i]) * scale_log2);
        m_run[i] = mx[i];
        mc[i] = -mx[i] * scale_log2;
      }
      unsigned pa[PS][4];  // p rounded to bf16: the A fragments of P · V
      {
        float r0[NT], r1[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float p0 = ex2(fmaf(s[t][0], scale_log2, mc[0])), p1 = ex2(fmaf(s[t][1], scale_log2, mc[0]));
          const float p2 = ex2(fmaf(s[t][2], scale_log2, mc[1])), p3 = ex2(fmaf(s[t][3], scale_log2, mc[1]));
          r0[t] = p0 + p1;
          r1[t] = p2 + p3;
          pa[t >> 1][(t & 1) * 2] = pack_bf16(p0, p1);
          pa[t >> 1][(t & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
        l_part[0] = l_part[0] * alpha[0] + tree_sum(r0);
        l_part[1] = l_part[1] * alpha[1] + tree_sum(r1);
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha[0];
        acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1];
        acc[d][3] *= alpha[1];
      }

      // acc += P · V on the tensor cores; V is the MN-major B operand
      const uint32_t tV = sV + j % kStages * KV_BYTES;
      fence_regs<DT * 4>(&acc[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PS; ++kk)
        pv_product<HD>(&acc[0][0], pa[kk], smem_desc<HD>(tV + kk * 16 * A::B, BN * A::B, 8 * A::B));
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs<DT * 4>(&acc[0][0]);
  }

  // out = acc / max(l, 1e-30), staged through this warp's own q rows
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[i] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + c_pair;  // element column; its 16-byte chunk is c / 8
    const uint32_t in_chunk = (c % 8) * 2;
    *reinterpret_cast<__nv_bfloat162*>(q_tile + tile_off<HD>(kBM, w0 + r_lo, c / 8) + in_chunk) =
        __floats2bfloat162_rn(acc[d][0] / den[0], acc[d][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(q_tile + tile_off<HD>(kBM, w0 + r_lo + 8, c / 8) + in_chunk) =
        __floats2bfloat162_rn(acc[d][2] / den[1], acc[d][3] / den[1]);
  }
  __syncwarp();
  constexpr int CPR = HD / 8;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    if (q0 + w0 + r < S)
      *reinterpret_cast<int4*>(ob + (q0 + w0 + r) * os.s + c * 8) =
          *reinterpret_cast<const int4*>(q_tile + tile_off<HD>(kBM, w0 + r, c));
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (the
// library links no libcuda of its own)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a bf16 view: dims innermost first (the head dim, then
// rows, then the outer indices), element strides of the outer dims, a box
// of one atom by `rows` rows.  A dimension of extent 1 takes a stride its
// index 0 never reads, so that its own (unchecked) stride cannot fail the
// encoder's 16-byte rule.
template <int HD>
static int make_map(CUtensorMap* map, const void* base, int rank, const long long* dims, const long long* strides,
                    int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t box[5], one[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    box[i] = i == 0 ? (cuuint32_t)Atom<HD>::E : i == 1 ? (cuuint32_t)rows : 1u;
    one[i] = 1;
  }
  for (int i = 1; i < rank; ++i)
    gstride[i - 1] = dims[i] > 1 ? (cuuint64_t)strides[i - 1] * sizeof(bf16)
                     : i > 1      ? gstride[i - 2]
                                  : (cuuint64_t)HD * sizeof(bf16);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base), gdim,
                            gstride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Atom<HD>::B == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int S, int Tn,
                int causal, double scale, const QStrides& qs, const KStrides& ks, const KStrides& vs,
                const QStrides& os, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<HD>();
  int rc = attn_allow_smem(flash_attn_bf16_kernel<HD>, smem);
  if (rc != 0) return rc;
  const int n_qtiles = (S + kBM - 1) / kBM;
  const long long blocks = (long long)n_qtiles * G * B * KV;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  const long long q_dims[5] = {HD, S, G, KV, B}, q_strides[4] = {qs.s, qs.g, qs.n, qs.b};
  const long long kv_dims[4] = {HD, Tn, KV, B};
  const long long k_strides[3] = {ks.t, ks.n, ks.b}, v_strides[3] = {vs.t, vs.n, vs.b};
  if ((rc = make_map<HD>(&tm_q, q, 5, q_dims, q_strides, kBM)) != 0) return rc;
  if ((rc = make_map<HD>(&tm_k, k, 4, kv_dims, k_strides, kv_rows<HD>())) != 0) return rc;
  if ((rc = make_map<HD>(&tm_v, v, 4, kv_dims, v_strides, kv_rows<HD>())) != 0) return rc;
  const float scale_log2 = scale > 0 ? (float)(1.4426950408889634 * scale)
                                     : (float)(1.4426950408889634 / sqrt((double)HD));
  flash_attn_bf16_kernel<HD><<<(unsigned)blocks, kThreadsTC, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), G, KV, B * KV, n_qtiles, S, Tn, causal, scale_log2, os);
  return dacp_last_error();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // kv rows per tile
constexpr int kLDS = kBK + 1;

template <int HD>
constexpr size_t f32_smem_bytes() {
  return (size_t)(kBQ + 2 * kBK) * (HD + attn_pad<float>()) * sizeof(float) +
         (size_t)(kBQ * kLDS + 2 * kBQ) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          float* __restrict__ o, int KV, int S, int Tn, int causal, float scale, QStrides qs,
                          KStrides ks, KStrides vs, QStrides os) {
  constexpr int LD = HD + attn_pad<float>();
  constexpr int DJ = HD / 32;  // acc columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // kBQ × LD
  float* sK = sQ + kBQ * LD;                   // kBK × LD
  float* sV = sK + kBK * LD;                   // kBK × LD
  float* sS = sV + kBK * LD;                   // kBQ × kLDS: scores, then p
  float* sAlpha = sS + kBQ * kLDS;             // kBQ
  float* sL = sAlpha + kBQ;                    // kBQ

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z / KV;
  const int n = blockIdx.z % KV;
  const float* qb = q + b * qs.b + n * qs.n + g * qs.g;
  const float* kb = k + b * ks.b + n * ks.n;
  const float* vb = v + b * vs.b + n * vs.n;
  float* ob = o + b * os.b + n * os.n + g * os.g;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * LD + d] = q0 + r < S ? qb[(q0 + r) * qs.s + d] : 0.f;
  }

  const int kv_end = causal ? min(Tn, min(q0 + kBQ, S)) : Tn;

  // phase-2 state of row tid / 4, held alike by its four threads
  float m_run = DACP_ATTN_NEG_INF, l_run = 0.f;
  float acc[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int rg = tid / 16, cl = tid % 16;  // phase 1: rows rg*4 + i, columns cl + 16*j
  const int w = tid / 32, lane = tid % 32;  // phase 3: rows w*8 + i, columns lane + 32*j

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of sK, sV and sS are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Tn;
      sK[r * LD + d] = in ? kb[(k0 + r) * ks.t + d] : 0.f;
      sV[r * LD + d] = in ? vb[(k0 + r) * vs.t + d] : 0.f;
    }
    __syncthreads();

    // phase 1: scores
    float sc[4][kBK / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[kBK / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) kv[j] = sK[(cl + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        const int r = rg * 4 + i, c = cl + 16 * j;
        float s = sc[i][j] * scale;
        if (k0 + c >= Tn)
          s = -INFINITY;  // past the end of k: contributes exactly nothing
        else if (causal && q0 + r < k0 + c)
          s = DACP_ATTN_NEG_INF;
        sS[r * kLDS + c] = s;
      }
    __syncthreads();

    // phase 2: online-softmax update, four threads per row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = sS + r * kLDS + part * (kBK / 4);
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) mx = fmaxf(mx, row[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        const float p = expf(row[j] - m_new);
        sum += p;
        row[j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (part == 0) sAlpha[r] = alpha;
    }
    __syncthreads();

    // phase 3: acc = acc · alpha + p · v
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = sAlpha[w * 8 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * LD + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = sS[(w * 8 + i) * kLDS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  if (tid % 4 == 0) sL[tid / 4] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = w * 8 + i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[(q0 + r) * os.s + lane + 32 * j] = acc[i][j] / l;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int S, int Tn, int causal,
               double user_scale, const QStrides& qs, const KStrides& ks, const KStrides& vs, const QStrides& os,
               cudaStream_t stream) {
  if (G > 65535 || B * KV > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem_bytes<HD>();
  const int rc = attn_allow_smem(flash_attn_f32_kernel<HD>, smem);
  if (rc != 0) return rc;
  const float scale = user_scale > 0 ? (float)user_scale : (float)(1.0 / sqrt((double)HD));
  const dim3 grid((S + kBQ - 1) / kBQ, G, B * KV);
  flash_attn_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q),
                                                              static_cast<const float*>(k),
                                                              static_cast<const float*>(v), static_cast<float*>(o),
                                                              KV, S, Tn, causal, scale, qs, ks, vs, os);
  return dacp_last_error();
}

template <int HD>
int launch_flash(int dtype, const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int S,
                 int Tn, int causal, double scale, const long long* st, cudaStream_t stream) {
  const QStrides qs{st[0], st[1], st[2], st[3]};
  const KStrides ks{st[4], st[5], st[6]};
  const KStrides vs{st[7], st[8], st[9]};
  const QStrides os{st[10], st[11], st[12], st[13]};
  if (dtype == DACP_ATTN_BF16)
    return launch_bf16<HD>(q, k, v, o, B, KV, G, S, Tn, causal, scale, qs, ks, vs, os, stream);
  return launch_f32<HD>(q, k, v, o, B, KV, G, S, Tn, causal, scale, qs, ks, vs, os, stream);
}

}  // namespace

// strides: 14 int64 element strides — q (b, kv, g, s), k (b, kv, t),
// v (b, kv, t), o (b, kv, g, s); the head dim is contiguous in all four.
// bfloat16 needs 16-byte aligned rows: every pointer and every stride a
// multiple of 16 bytes (the wrapper checks).  scale: the scores' scale, or
// 0 for hd^-0.5.
DACP_API int dacp_flash_attention(const void* q, const void* k, const void* v, void* o, int dtype, int B, int KV,
                                  int G, int S, int Tn, int hd, int causal, double scale, const long long* strides,
                                  void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || Tn <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != DACP_ATTN_F32 && dtype != DACP_ATTN_BF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_flash<32>(dtype, q, k, v, o, B, KV, G, S, Tn, causal, scale, strides, s);
    case 64:
      return launch_flash<64>(dtype, q, k, v, o, B, KV, G, S, Tn, causal, scale, strides, s);
    case 128:
      return launch_flash<128>(dtype, q, k, v, o, B, KV, G, S, Tn, causal, scale, strides, s);
    case 256:
      return launch_flash<256>(dtype, q, k, v, o, B, KV, G, S, Tn, causal, scale, strides, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
