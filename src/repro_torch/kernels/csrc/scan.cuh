// Block-wide scans shared by the sequence-scan kernels (ssd_scan.cu,
// mlstm_chunk.cu): one value per thread of a block of kScanThreads, the
// chunk's rows.  Each call is a barrier for the whole block and leaves
// `warp_tot` (kScanThreads / 32 floats of shared memory) free again.
#pragma once

#include "attention.cuh"  // float32 / bfloat16 element conversions

constexpr int kScanThreads = 256;

// Inclusive prefix sum over the block.
__device__ __forceinline__ float block_inclusive_sum(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  if (w == 0) {
    float t = lane < kScanThreads / 32 ? warp_tot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    if (lane < kScanThreads / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  if (w > 0) v += warp_tot[w - 1];
  __syncthreads();
  return v;
}

// Maximum over the block, handed to every thread.
__device__ __forceinline__ float block_max(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) warp_tot[w] = v;
  __syncthreads();
  float r = warp_tot[0];
#pragma unroll
  for (int i = 1; i < kScanThreads / 32; ++i) r = fmaxf(r, warp_tot[i]);
  __syncthreads();
  return r;
}
