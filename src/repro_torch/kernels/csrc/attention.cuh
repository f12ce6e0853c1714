// Helpers shared by the attention kernels (flash_attention.cu,
// decode_attention.cu): element types, the online-softmax constants and the
// rounding of p to v's type.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

// The TPU kernels mask with -1e30, not -inf: a row whose every position so
// far is masked keeps a finite running max, and exp(m_prev - m_new) stays 1.
#define DACP_ATTN_NEG_INF (-1e30f)

// dtype codes the wrappers pass: 0 float32, 1 bfloat16
#define DACP_ATTN_F32 0
#define DACP_ATTN_BF16 1

template <typename T>
__device__ __forceinline__ float attn_to_f(T x);
template <>
__device__ __forceinline__ float attn_to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float attn_to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T attn_from_f(float x);
template <>
__device__ __forceinline__ float attn_from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 attn_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p.astype(v.dtype) before the PV product, as the TPU kernels do: round to
// T (round to nearest even) and widen back for the float32 accumulation.
template <typename T>
__device__ __forceinline__ float attn_round(float x) {
  return attn_to_f<T>(attn_from_f<T>(x));
}

// One 32-bit word of padding per shared-memory row, so that threads reading
// one column of consecutive rows hit distinct banks.
template <typename T>
__host__ __device__ constexpr int attn_pad() {
  return 4 / (int)sizeof(T);
}

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename K>
static inline int attn_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
