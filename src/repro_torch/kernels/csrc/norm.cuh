// What the two RMSNorm kernels share (gated_norm.cu, rms_norm.cu): 16-byte
// vectors of 8 channels converted to and from float32, the rounding to the
// activation type, and the row's rsqrt(mean of squares + eps) from each
// thread's partial sum of squares, as a warp-shuffle tree and, across warps,
// one word a warp in shared memory.
//
// Both kernels follow PyTorch's CUDA arithmetic of the plain version: every
// op in float32, rounded to nearest even where the plain version holds a
// bfloat16 tensor; the mean as CUDA's mean kernel takes it, the sum times
// float(outputs) / numel (the caller's mean_factor); rsqrtf as torch.rsqrt.
// The library builds with -fmad=false, so no product fuses into an add.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace dacp_norm {

using bf16 = __nv_bfloat16;

// dtype codes the wrappers pass: 0 float32, 1 bfloat16
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr int kVec = 8;  // channels a vector: 16 bytes of bfloat16
constexpr int kMaxThreads = 1024;

// 8 consecutive elements of type T at p (16-byte aligned) as float32.
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[kVec]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bfloat16 is the high half of its float32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// v held as T: float32 unchanged, bfloat16 rounded to nearest even.
template <typename T>
__device__ __forceinline__ float as_act(float v);
template <>
__device__ __forceinline__ float as_act<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float as_act<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The sum of v over each aligned run of `lanes` lanes (a power of two, at
// most 32), in every lane of the run: the xor-shuffle tree, offsets from
// lanes / 2 down to 1.
__device__ __forceinline__ float lanes_sum(float v, int lanes = 32) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float rstd_of(float sum, float mean_factor, float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(sum, mean_factor), eps));
}

// rsqrt(mean + eps) of the row the whole block holds, in every thread, from
// each thread's sum of squares ss: each warp's tree, then the first warp's
// tree over the warps' sums (zeros past the last warp).  Every thread of the
// block calls it.
__device__ __forceinline__ float block_rstd(float ss, float mean_factor, float eps) {
  __shared__ float part[kMaxThreads / 32];
  __shared__ float rstd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = lanes_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0f;
    t = lanes_sum(t);
    if (lane == 0) rstd = rstd_of(t, mean_factor, eps);
  }
  __syncthreads();
  return rstd;
}

}  // namespace dacp_norm
