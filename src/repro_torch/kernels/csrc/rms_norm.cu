// rms_norm: the model's RMSNorm over the last dim, in one pass.
//
// Replaces no TPU kernel: the JAX package computes the norm in jnp
// (repro/models/layers.py, norm_apply), and the port ran it as six PyTorch
// kernels (the cast to float32, the square, the mean, two broadcast
// multiplies, the cast back), each a pass over (rows, W) in device memory
// (about 40 bytes an element over them all).  For each row of W channels:
//
//   out = act( float(x) · rsqrt(mean(float(x)²) + eps) · float(scale) )
//
//   x (rows, W) in the activation type `act` (float32 or bfloat16), its rows
//   row_stride elements apart and each row contiguous; scale (W,) float32 or
//   bfloat16; out (rows, W) contiguous in `act`.  x's rows and scale start on
//   16-byte boundaries.
//
// The same arithmetic as the plain version on the card (norm.cuh): float32
// throughout, one rounding to `act` at the end.  Only the order of the sum of
// squares differs.
//
// Bound: bytes.  x read once and out written once: 4 bytes an element in
// bfloat16 (0.060 ms at 3.35 TB/s for 12,288 rows of 4096, the scoring
// cells' longest forward).  A row's 16-byte vectors stay in registers from
// the sum of squares to the write, so nothing is read twice.  The launch
// follows the width: a row of up to 32 vectors (W <= 256, the q/k norms'
// head dims) takes an aligned run of lanes, a power of two, and a block of
// 256 threads takes 256 / lanes rows, summed by shuffles alone; a wider row
// takes a block, summed by norm.cuh's block_rstd, one vector a thread up to
// 256 vectors (W <= 2048) and two above (so a block holds at most 512
// threads, each with 32 bytes in flight: on an H100 at 700 W, 12,288 rows
// of 7168 took 135 us against 142 at one vector a thread, rows of 2048
// 36.9 us at two against 35.9 at one).  A thread holds vectors t, t + lanes, ..., so
// a warp's loads are 512 contiguous bytes.
#include "common.cuh"
#include "norm.cuh"

namespace {

using namespace dacp_norm;

constexpr int kRowsBlock = 256;  // threads of a block that holds several rows

struct NormArgs {
  const void* x;
  const void* scale;
  void* out;
  int64_t rows, row_stride;
  int width, lanes;  // lanes: threads a row (an aligned run of a warp, or the whole block)
  float mean_factor, eps;
};

template <typename T, typename S, int V>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_kernel(NormArgs a) {
  const int per_block = blockDim.x / a.lanes;  // rows a block holds: 1 where a row takes the block
  const int t = threadIdx.x % a.lanes;
  const int64_t row = (int64_t)blockIdx.x * per_block + threadIdx.x / a.lanes;
  const bool live = row < a.rows;
  const T* xr = static_cast<const T*>(a.x) + row * a.row_stride;

  float v[V][kVec];
#pragma unroll
  for (int k = 0; k < V; ++k) {  // every load first
    const int e = (t + k * a.lanes) * kVec;
    if (live && e < a.width) load8(xr + e, v[k]);
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (live && (t + k * a.lanes) * kVec < a.width) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) ss = __fadd_rn(ss, __fmul_rn(v[k][i], v[k][i]));
    }
  }

  // the branch is the same in every thread of the block
  const float r = per_block > 1 ? rstd_of(lanes_sum(ss, a.lanes), a.mean_factor, a.eps)
                                : block_rstd(ss, a.mean_factor, a.eps);

  if (!live) return;
  T* out = static_cast<T*>(a.out) + row * a.width;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int e = (t + k * a.lanes) * kVec;
    if (e < a.width) {
      float sc[kVec];
      load8(static_cast<const S*>(a.scale) + e, sc);
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[k][i] = __fmul_rn(__fmul_rn(v[k][i], r), sc[i]);
      store8(out + e, v[k]);
    }
  }
}

template <typename T, typename S, int V>
int launch(const NormArgs& a, cudaStream_t stream) {
  const int threads = a.lanes <= 32 ? kRowsBlock : a.lanes;
  const int64_t per_block = threads / a.lanes;
  const int64_t blocks = (a.rows + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  rms_norm_kernel<T, S, V><<<(unsigned)blocks, threads, 0, stream>>>(a);
  return dacp_last_error();
}

template <typename T, typename S>
int dispatch_vecs(int vecs, const NormArgs& a, cudaStream_t s) {
  return vecs == 1 ? launch<T, S, 1>(a, s) : launch<T, S, 2>(a, s);
}

template <typename T>
int dispatch_scale(int scale_dtype, int vecs, const NormArgs& a, cudaStream_t s) {
  if (scale_dtype == kF32) return dispatch_vecs<T, float>(vecs, a, s);
  if (scale_dtype == kBF16) return dispatch_vecs<T, bf16>(vecs, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (rows, width) in `dtype` (0 float32, 1 bfloat16), rows row_stride
// elements apart; scale (width,) in `scale_dtype`; out (rows, width)
// contiguous in `dtype`.  width a multiple of 8, at most 8192; x's rows and
// scale 16-byte aligned.
DACP_API int dacp_rms_norm(const void* x, const void* scale, void* out, int dtype, int scale_dtype, int64_t rows,
                           int64_t row_stride, int width, double eps, void* stream) {
  if (rows <= 0 || width <= 0 || width % kVec != 0 || width > kMaxThreads * kVec || row_stride < width)
    return (int)cudaErrorInvalidValue;
  const int nvec = width / kVec;
  const int vecs = nvec > 256 ? 2 : 1;  // 16-byte vectors a thread
  const int per_thread = (nvec + vecs - 1) / vecs;  // threads a row needs
  int lanes = 1;
  if (per_thread <= 32) {
    while (lanes < per_thread) lanes <<= 1;
  } else {
    lanes = (per_thread + 31) / 32 * 32;
  }
  NormArgs a;
  a.x = x;
  a.scale = scale;
  a.out = out;
  a.rows = rows;
  a.row_stride = row_stride;
  a.width = width;
  a.lanes = lanes;
  // CUDA's mean kernel multiplies the sum by float(outputs) / numel, the
  // int64 count converted to float: the same factor here
  a.mean_factor = (float)rows / (float)(rows * width);
  a.eps = (float)eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_scale<float>(scale_dtype, vecs, a, s);
  if (dtype == kBF16) return dispatch_scale<bf16>(scale_dtype, vecs, a, s);
  return (int)cudaErrorInvalidValue;
}
