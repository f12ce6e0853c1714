// causal_conv_silu: the front of the Mamba2 and xLSTM blocks in one pass,
// a depthwise causal convolution over the sequence, its bias and SiLU:
//
//   y[b, t, c] = silu( bias[c] + sum_{i < K} x[b, t - (K-1) + i, c] · w[i, c] )
//
// where the state's rows (b, K-1, c), or zeros when no state is given, stand
// in for the K-1 positions before t = 0.  x, y (batch, S, C) and state in the
// activation type (float32 or bfloat16), w (K, C) and bias (C,) in the same
// type, K from 1 to 4.
//
// Replaces no TPU kernel: the JAX package computes the conv in jnp
// (repro/models/layers.py, causal_conv_silu), and the port ran it as a cat
// of the state onto x, K strided broadcast multiplies, K adds, the bias add
// and SiLU, each a pass over (batch, S, C) in device memory (about 50 bytes
// an element over them all).
//
// The same numbers as the plain version on the card, rounding point for
// rounding point: each tap's product rounded to the activation type as
// PyTorch's multiply rounds it; the products added in the plain version's
// order ((0 + p0) + p1) + ... with a rounding after each add; the bias
// added, then rounded; silu as x / (1 + expf(-x)) with the precise expf, as
// PyTorch's CUDA silu computes it, then rounded.  In float32 the products
// and sums are __fmul_rn and __fadd_rn (the library builds with
// -fmad=false: no product fuses into an add).  In bfloat16 they are the
// card's bfloat16 pair instructions, which round the exact product or sum
// once, as PyTorch's float32 ones followed by the cast do; and silu, whose
// input then has 65536 possible values, takes a fast form wherever that
// decides the rounding and the exact one elsewhere (silu_fast).  On an
// H100 at zamba2-7b's longest forward the float form of the taps, their
// roundings and the exact silu held the kernel to a quarter of its bytes
// bound (0.404 ms); the pairs, the fast silu and the tuning below bring it
// to about 79% (0.133 ms).
//
// Bound: bytes.  About 10 flops an element against the ~295 flops a byte
// the card needs to be compute-bound: x read once and y written once, 4
// bytes an element in bfloat16 (0.109 ms at 3.35 TB/s at zamba2-7b's
// longest forward, 3 × 4096 rows of 7168).  Each thread owns 8 channels
// (one 16-byte vector of bfloat16) and walks a short run of consecutive
// time steps (Tune: 4 in bfloat16, 8 in float32), keeping the last K-1
// input vectors in registers, so each input is read from device memory
// once and only the K-1 halo rows of each run again, from L2; it keeps the
// loads of the next rows (2 in bfloat16, 4 in float32) in flight while it
// computes one.  The K × 8 weights and the bias live in registers; each
// store is 16 bytes and neighbouring threads hold neighbouring channels.
// Short runs give every shape, a decode step's included, threads enough to
// fill the SMs, and few registers (72 in bfloat16) many threads an SM: on
// an H100 at zamba2-7b's forwards, bfloat16 runs of 4 beat 8 by 2% and 16
// by 8%, and 2 rows ahead beat 4 by 7-11%.  Widths that are not a multiple
// of 8, or operands off a 16-byte boundary, take the scalar path of the
// same kernel (each element loaded and stored alone, the ragged right edge
// masked).
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// dtype codes the wrapper passes: 0 float32, 1 bfloat16
#define DACP_CC_F32 0
#define DACP_CC_BF16 1

constexpr int kVec = 8;      // channels a thread: 16 bytes of bfloat16
constexpr int kThreads = 128;
constexpr int kMaxK = 4;

// Per activation type: the time steps a thread walks, and the rows it keeps
// in flight ahead of the one it computes.
template <typename T>
struct Tune;
template <>
struct Tune<bf16> {
  static constexpr int run = 4, ahead = 2;
};
template <>
struct Tune<float> {
  static constexpr int run = 8, ahead = 4;
};

struct ConvArgs {
  const void* x;
  const void* w;
  const void* bias;   // null: no bias
  const void* state;  // null: zeros before t = 0
  void* y;
  int64_t total;      // threads with work: batch · runs · vectors
  int S, C, vectors, runs;
};

// Eight consecutive channels of one row as loaded (raw bits): the unit a
// thread loads, computes and stores.
template <typename T>
struct Row;

template <>
struct Row<bf16> {
  uint32_t w[4];  // two bfloat16 a word, the lower channel in the low half

  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  __device__ __forceinline__ void load(const bf16* p) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
  }
  __device__ __forceinline__ void load_n(const bf16* p, int n) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    zero();
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      if (c < n) w[c >> 1] |= (uint32_t)q[c] << (16 * (c & 1));
  }
  __device__ __forceinline__ void store(bf16* p) const {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ void store_n(bf16* p, int n) const {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      if (c < n) q[c] = (unsigned short)(w[c >> 1] >> (16 * (c & 1)));
  }
};

template <>
struct Row<float> {
  float v[kVec];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < kVec; ++c) v[c] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ __forceinline__ void load_n(const float* p, int n) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) v[c] = c < n ? p[c] : 0.0f;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ void store_n(float* p, int n) const {
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      if (c < n) p[c] = v[c];
  }
};

// PyTorch's CUDA silu on a float32 value: x / (1 + expf(-x)), the precise
// expf, correctly rounded division.
__device__ __forceinline__ float silu_exact(float x) { return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x))); }

__device__ __forceinline__ float ex2_approx(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float rcp_approx(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// Float32 units in the last place that the fast silu may lie from the exact
// one, with room: over every bfloat16 x of its domain an H100 measured at
// most 13 (and 0 for 30428 of 32143 values).  For -16 <= x the exponent's
// argument carries at most 2^-20 of absolute error and ex2.approx 2^-22
// relative; with the rcp, the products and expf's own error, about 34 units
// at worst on paper.
constexpr int kSiluMargin = 40;

// A fast silu(x) for a bfloat16 x (ex2.approx, rcp.approx), and whether it
// decides the bfloat16 rounding of silu_exact(x): it does wherever it lies
// more than kSiluMargin units from a bfloat16 rounding midpoint, where the
// exact value must round the same way, and for x from -16 up (NaN and -inf
// excluded; +inf, zeros and subnormals come out exact).  It declines
// within the margin, about 0.1% of values; the two values of a bfloat16
// pair take the fast form together, and a declined one the exact form.  A
// bfloat16 input has 65536 values, and the card tests hold every one of
// them to the plain version.
__device__ __forceinline__ float silu_fast(float x, bool& decides) {
  const float y = __fmul_rn(x, rcp_approx(__fadd_rn(1.0f, ex2_approx(__fmul_rn(x, -1.44269504088896341f)))));
  // the low 16 bits' distance from the midpoint 0x8000, shifted by the margin, modulo 2^16
  decides = x >= -16.0f && ((__float_as_uint(y) + (0x8000u + kSiluMargin)) & 0xFFFFu) > 2u * kSiluMargin;
  return y;
}

__device__ __noinline__ float silu_exact_call(float x) { return silu_exact(x); }  // rare: one copy, called

// Two float32 values as a bfloat16 pair, each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// bfloat16 pairs, each rounded to nearest even once: the exact product of two
// bfloat16 values and the sum of two are what PyTorch's float32 arithmetic
// rounds to bfloat16 (a float32 sum of two bfloat16 values is exact, or off by
// less than can move its bfloat16 rounding).  The .rn forms are never fused.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// One output row from its K taps (tap i: the input at t - (K-1) + i), in the
// plain version's order: ((0 + p0) + p1) + ..., then the bias, then silu.
template <int K>
__device__ __forceinline__ Row<float> conv_row(const Row<float> (&win)[K > 1 ? K - 1 : 1], const Row<float>& cur,
                                               const Row<float> (&w)[K], const Row<float>& bias, bool has_bias) {
  Row<float> out;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    float s = 0.0f;  // Python's sum starts from the integer 0
#pragma unroll
    for (int i = 0; i < K; ++i) s = __fadd_rn(s, __fmul_rn(i < K - 1 ? win[i < K - 1 ? i : 0].v[c] : cur.v[c], w[i].v[c]));
    if (has_bias) s = __fadd_rn(s, bias.v[c]);
    out.v[c] = silu_exact(s);
  }
  return out;
}

template <int K>
__device__ __forceinline__ Row<bf16> conv_row(const Row<bf16> (&win)[K > 1 ? K - 1 : 1], const Row<bf16>& cur,
                                              const Row<bf16> (&w)[K], const Row<bf16>& bias, bool has_bias) {
  float xs[kVec];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t s = 0u;  // +0 in both halves
#pragma unroll
    for (int i = 0; i < K; ++i) s = add_bf16x2(s, mul_bf16x2(i < K - 1 ? win[i < K - 1 ? i : 0].w[j] : cur.w[j], w[i].w[j]));
    if (has_bias) s = add_bf16x2(s, bias.w[j]);
    xs[2 * j] = __uint_as_float(s << 16);  // a bfloat16 is the high half of its float32
    xs[2 * j + 1] = __uint_as_float(s & 0xFFFF0000u);
  }
  float ys[kVec];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bool d0, d1;
    ys[2 * j] = silu_fast(xs[2 * j], d0);
    ys[2 * j + 1] = silu_fast(xs[2 * j + 1], d1);
    if (!(d0 && d1)) {
      if (!d0) ys[2 * j] = silu_exact_call(xs[2 * j]);
      if (!d1) ys[2 * j + 1] = silu_exact_call(xs[2 * j + 1]);
    }
  }
  Row<bf16> out;
#pragma unroll
  for (int j = 0; j < 4; ++j) out.w[j] = pack_bf16x2(ys[2 * j], ys[2 * j + 1]);
  return out;
}

// One thread per (batch, run, vector): thread id = (b · runs + r) · vectors + v,
// so neighbouring threads hold neighbouring channels of one row.
template <typename T, int K, bool kVecIO>
__global__ void __launch_bounds__(kThreads) causal_conv_silu_kernel(ConvArgs a) {
  const int64_t id = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (id >= a.total) return;
  const int v = (int)(id % a.vectors);
  const int64_t br = id / a.vectors;
  const int r = (int)(br % a.runs);
  const int64_t b = br / a.runs;
  const int c0 = v * kVec;
  const int n = a.C - c0 < kVec ? a.C - c0 : kVec;  // channels held: 8 but at a ragged right edge
  const int64_t C = a.C;
  const T* x = static_cast<const T*>(a.x) + b * a.S * C + c0;  // this batch's row 0, at channel c0
  T* y = static_cast<T*>(a.y) + b * a.S * C + c0;
  constexpr int kAhead = Tune<T>::ahead;
  const int t0 = r * Tune<T>::run;
  const int t1 = t0 + Tune<T>::run < a.S ? t0 + Tune<T>::run : a.S;

  auto load = [&](Row<T>& row, const T* p) {
    if (kVecIO)
      row.load(p);
    else
      row.load_n(p, n);
  };

  Row<T> w[K], bias;
#pragma unroll
  for (int i = 0; i < K; ++i) load(w[i], static_cast<const T*>(a.w) + i * C + c0);
  const bool has_bias = a.bias != nullptr;
  if (has_bias)
    load(bias, static_cast<const T*>(a.bias) + c0);
  else
    bias.zero();

  // the K-1 inputs before t0: x's rows, else the state's, else zeros
  Row<T> win[K > 1 ? K - 1 : 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int u = t0 - (K - 1) + j;
    if (u >= 0)
      load(win[j], x + u * C);
    else if (a.state != nullptr)
      load(win[j], static_cast<const T*>(a.state) + (b * (K - 1) + (K - 1) + u) * C + c0);
    else
      win[j].zero();
  }

  // a ring of the next kAhead rows, loaded ahead: row t sits in slot
  // (t - t0) % kAhead, and the step that takes it refills the slot with row
  // t + kAhead, so kAhead loads stay in flight.  The loop body is kAhead
  // steps, one per slot, so no row moves between registers.
  Row<T> ring[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (t0 + j < t1) load(ring[j], x + (t0 + j) * C);
  for (int t = t0; t < t1; t += kAhead) {
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (t + q >= t1) break;
      const Row<T> cur = ring[q];
      if (t + q + kAhead < t1) load(ring[q], x + (t + q + kAhead) * C);
      const Row<T> out = conv_row<K>(win, cur, w, bias, has_bias);
      if (kVecIO)
        out.store(y + (t + q) * C);
      else
        out.store_n(y + (t + q) * C, n);
      if constexpr (K > 1) {  // slide the window by one row
#pragma unroll
        for (int j = 0; j + 1 < K - 1; ++j) win[j] = win[j + 1];
        win[K - 2] = cur;
      }
    }
  }
}

template <typename T, int K>
int launch_k(const ConvArgs& a, bool vec_io, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.total + kThreads - 1) / kThreads);
  if (vec_io)
    causal_conv_silu_kernel<T, K, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    causal_conv_silu_kernel<T, K, false><<<blocks, kThreads, 0, stream>>>(a);
  return dacp_last_error();
}

template <typename T>
int launch(ConvArgs a, int64_t batch, int k, bool vec_io, cudaStream_t stream) {
  a.runs = (a.S + Tune<T>::run - 1) / Tune<T>::run;
  a.total = batch * a.runs * a.vectors;
  if ((a.total + kThreads - 1) / kThreads > 2147483647LL) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1:
      return launch_k<T, 1>(a, vec_io, stream);
    case 2:
      return launch_k<T, 2>(a, vec_io, stream);
    case 3:
      return launch_k<T, 3>(a, vec_io, stream);
    case 4:
      return launch_k<T, 4>(a, vec_io, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y (batch, S, C) and state (batch, k-1, C) or null, w (k, C), bias (C,)
// or null, all contiguous in `dtype` (0 float32, 1 bfloat16); 1 <= k <= 4.
// With vec_io, C is a multiple of 8 and every operand starts on a 16-byte
// boundary.
DACP_API int dacp_causal_conv_silu(const void* x, const void* w, const void* bias, const void* state, void* y,
                                   int dtype, int64_t batch, int S, int C, int k, int vec_io, void* stream) {
  if (batch <= 0 || S <= 0 || C <= 0 || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (vec_io) {
    const void* ptrs[5] = {x, w, bias, state, y};
    if (C % kVec != 0) return (int)cudaErrorInvalidValue;
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.state = state;
  a.y = y;
  a.S = S;
  a.C = C;
  a.vectors = (C + kVec - 1) / kVec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DACP_CC_F32) return launch<float>(a, batch, k, vec_io != 0, s);
  if (dtype == DACP_CC_BF16) return launch<bf16>(a, batch, k, vec_io != 0, s);
  return (int)cudaErrorInvalidValue;
}
