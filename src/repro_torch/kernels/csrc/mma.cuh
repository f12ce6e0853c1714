// Warp-level tensor-core helpers shared by decode_attention.cu and
// mlstm_chunk.cu: 16-byte cp.async copies into shared memory, ldmatrix
// fragment loads and mma.sync m16n8k16 bf16 -> f32.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = threadIdx.x % 32,
// r = lane / 4, c = 2 · (lane % 4)):
//   A 16×16 (4 regs, 2 bf16 each): a0 (r, c..c+1), a1 (r+8, c..), a2 (r, c+8..), a3 (r+8, c+8..)
//   B 16×8  (2 regs):              b0 (k c..c+1, n r),  b1 (k c+8.., n r)
//   C 16×8  (4 floats):            c0,c1 (r, c..c+1),  c2,c3 (r+8, c..c+1)
// Two C fragments side by side (columns 0-7 and 8-15) pack, rounded to
// bf16, into exactly the A fragment of a 16×16 tile: the accumulator of one
// product is the A operand of the next without a trip through memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t mma_smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// 16 bytes global -> shared without a register round trip; with `full`
// false the 16 bytes are zero-filled and the source is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mma_smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8×8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(mma_smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(mma_smem_u32(p)));
}

// Two 8×8 b16 matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(mma_smem_u32(p)));
}

// d += a · b, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x = hi + lo to about 2^-17 relative: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in f32).  Two bf16 products into one f32 accumulator
// then carry a float32 operand at far better than TF32's 2^-11.
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// x = hi + mid + lo to float32's own precision (three 8-bit mantissas):
// three products for an operand whose error a long sum would amplify.
__device__ __forceinline__ void split3_bf16(float x, __nv_bfloat16& hi, __nv_bfloat16& mid, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}
