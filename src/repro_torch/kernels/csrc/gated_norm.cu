// gated_rmsnorm: the Mamba2 mixer's output path after the SSD scan, in one
// pass: the D skip, the SiLU gate and the RMSNorm over each B/C group.
//
// Replaces no TPU kernel: the JAX package computes this chain in jnp
// (repro/models/ssm.py, mamba_apply and _out), and the port ran it as a
// dozen PyTorch kernels, each a pass over (rows, d_inner) in device memory
// (about 82 bytes an element over them all).  For each row of (b·s) and
// each group of W = d_inner / groups channels (head h = channel / head_dim):
//
//   u   = act( y + D[h] · float(x) )
//   g   = act( u · act(silu(z)) )
//   out = act( float(g) · rsqrt(mean_group(float(g)²) + eps) · float(scale) )
//
//   y (rows, d_inner) float32, the scan's output; x (the conv output) and z
//   (the gate) (rows, d_inner) in the activation type `act` (float32 or
//   bfloat16), D (heads,) float32, scale (d_inner,) float32 or bfloat16;
//   out (rows, d_inner) in `act`.  All contiguous, 16-byte aligned.
//
// The same arithmetic as the plain version on the card, rounding point for
// rounding point: every op in float32 (PyTorch's opmath), rounded to `act`
// (round to nearest even) where the plain version holds a tensor of that
// type; silu as x / (1 + expf(-x)) with the precise expf; rsqrtf as
// torch.rsqrt; the mean as CUDA's mean kernel takes it, the sum times
// float(outputs) / numel.  The library builds with -fmad=false, so no
// product fuses into an add.  Only the order of the sum of squares differs.
//
// Bound: bytes.  y, x and z read once and out written once: 10 bytes an
// element in bfloat16 (0.263 ms at 3.35 TB/s at zamba2-7b's longest
// forward, 3 × 4096 rows of 7168).  One block per (row, group), one
// 16-byte vector of 8 channels a thread (so a group holds at most 1024 × 8
// channels), every load of the group issued before any arithmetic.  The
// gated values stay in registers from the sum of squares to the write, so
// nothing is read twice; the sum is a warp-shuffle tree, then one word a
// warp in shared memory (norm.cuh, shared with rms_norm.cu).  Group width and count come from the shapes: the
// same kernel serves zamba2-7b (2 groups of 3584), zamba2-1.2b (1 of 4096)
// and a decode step's few rows.
#include "common.cuh"
#include "norm.cuh"

namespace {

using namespace dacp_norm;

struct GatedArgs {
  const float* y;
  const void* x;
  const void* z;
  const float* D;
  const void* scale;
  void* out;
  int d_inner, width, groups, head_dim;
  float mean_factor, eps;
};

// blockIdx.x = row · groups + group; thread t holds the group's vector t
// (channels 8t to 8t + 7), the threads past W / 8 none.
template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads) gated_rmsnorm_kernel(GatedArgs a) {
  const int64_t row = blockIdx.x / a.groups;
  const int grp = blockIdx.x % a.groups;
  const int64_t base = row * a.d_inner + (int64_t)grp * a.width;  // the group's first element
  const int e = threadIdx.x * kVec;                                  // this thread's first channel in the group
  const bool holds = e < a.width;

  float yv[kVec], xv[kVec], zv[kVec];
  float ss = 0.0f;
  if (holds) {  // every load first: 64 bytes a vector in flight
    load8(a.y + base + e, yv);
    load8(static_cast<const T*>(a.x) + base + e, xv);
    load8(static_cast<const T*>(a.z) + base + e, zv);
    const float d = a.D[(grp * a.width + e) / a.head_dim];  // a vector lies in one head
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float u = as_act<T>(__fadd_rn(yv[i], __fmul_rn(d, xv[i])));
      const float zf = zv[i];
      const float gate = as_act<T>(__fdiv_rn(zf, __fadd_rn(1.0f, expf(-zf))));
      const float g = as_act<T>(__fmul_rn(u, gate));
      yv[i] = g;  // the gated value, kept for the write
      ss = __fadd_rn(ss, __fmul_rn(g, g));
    }
  }

  const float r = block_rstd(ss, a.mean_factor, a.eps);

  if (holds) {
    float sc[kVec];
    load8(static_cast<const S*>(a.scale) + (int64_t)grp * a.width + e, sc);
#pragma unroll
    for (int i = 0; i < kVec; ++i) yv[i] = __fmul_rn(__fmul_rn(yv[i], r), sc[i]);
    store8(static_cast<T*>(a.out) + base + e, yv);
  }
}

template <typename T, typename S>
int launch(const GatedArgs& a, int64_t rows, cudaStream_t stream) {
  const int threads = (a.width / kVec + 31) / 32 * 32;
  gated_rmsnorm_kernel<T, S><<<(unsigned)(rows * a.groups), threads, 0, stream>>>(a);
  return dacp_last_error();
}

template <typename T>
int dispatch_scale(int scale_dtype, const GatedArgs& a, int64_t rows, cudaStream_t s) {
  if (scale_dtype == kF32) return launch<T, float>(a, rows, s);
  if (scale_dtype == kBF16) return launch<T, bf16>(a, rows, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y (rows, d_inner) float32; x, z, out (rows, d_inner) in `dtype` (0
// float32, 1 bfloat16); D (d_inner / head_dim,) float32; scale (d_inner,)
// in `scale_dtype`; all contiguous and 16-byte aligned.  groups divides
// d_inner into groups of a multiple of 8 channels, at most 8192; head_dim
// is a multiple of 8.
DACP_API int dacp_gated_rmsnorm(const void* y, const void* x, const void* z, const void* D, const void* scale,
                                void* out, int dtype, int scale_dtype, int64_t rows, int d_inner, int groups,
                                int head_dim, double eps, void* stream) {
  if (rows <= 0 || d_inner <= 0 || groups <= 0 || d_inner % groups != 0 || head_dim <= 0 || head_dim % kVec != 0 ||
      d_inner % head_dim != 0)
    return (int)cudaErrorInvalidValue;
  const int width = d_inner / groups;
  if (width % kVec != 0 || width > kMaxThreads * kVec || rows * groups > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  GatedArgs a;
  a.y = static_cast<const float*>(y);
  a.x = x;
  a.z = z;
  a.D = static_cast<const float*>(D);
  a.scale = scale;
  a.out = out;
  a.d_inner = d_inner;
  a.width = width;
  a.groups = groups;
  a.head_dim = head_dim;
  // CUDA's mean kernel multiplies the sum by float(outputs) / numel, the
  // int64 count converted to float: the same factor here
  a.mean_factor = (float)(rows * groups) / (float)(rows * d_inner);
  a.eps = (float)eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_scale<float>(scale_dtype, a, rows, s);
  if (dtype == kBF16) return dispatch_scale<bf16>(scale_dtype, a, rows, s);
  return (int)cudaErrorInvalidValue;
}
