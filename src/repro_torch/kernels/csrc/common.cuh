// Shared helpers for the data-plane kernels (plain C interface, loaded with
// ctypes).  Every entry point launches on the stream it is given, never
// synchronises, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#define DACP_API extern "C" __attribute__((visibility("default")))

// Threads per block for the row-parallel kernels.
#define DACP_THREADS 256

// Order-preserving int32 image of a float32 bit pattern: non-negative
// patterns already order as floats; negative ones flip their low 31 bits.
// The map is its own inverse (the sign bit is kept), so it also decodes.
__device__ __forceinline__ int32_t dacp_f32_key(int32_t b) { return b >= 0 ? b : (b ^ 0x7FFFFFFF); }

__host__ __device__ __forceinline__ int dacp_imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int dacp_imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int64_t dacp_min64(int64_t a, int64_t b) { return a < b ? a : b; }

static inline int dacp_last_error() { return (int)cudaGetLastError(); }

// The current device's SM count, asked of the runtime once per device: the
// grid-stride loops of the data-plane kernels cap their grids with it.
static inline cudaError_t dacp_sm_count(int* sms) {
  static std::mutex mu;
  static std::vector<int2> known;  // (device, SMs)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const int2& k : known) {
    if (k.x == dev) {
      *sms = k.y;
      return cudaSuccess;
    }
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  known.push_back(make_int2(dev, *sms));
  return cudaSuccess;
}
