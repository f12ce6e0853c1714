// decode_attention: one query token per head against a KV cache masked at
// `length`, float32 (m, l, acc) state.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _kernel).  Same function: scores in float32 times
// hd^-0.5, positions >= length masked with -1e30, a running max, l and acc
// in float32, p rounded to v's type before the PV product, output
// acc / max(l, 1e-30) in q's type.
//
//   q (B, KV, G, hd) with any element strides (head dim contiguous), k and
//   v (B, KV, T, hd) likewise, float32 or bfloat16, o (B, KV, G, hd)
//   contiguous; `length` is a host int <= T; any T (the TPU kernel asserts
//   T % tk == 0).  hd is 32, 64, 128 or 256 and G at most 32.
//
//   Bound: bytes.  Each step reads k and v up to `length` once (2·B·KV·
//   length·hd elements) for 4·B·KV·G·length·hd flops, a few flops per byte,
//   far below the card's ridge.  At the serving shape (granite-3-8b, B 4,
//   KV 8, G 4, hd 128, bf16, length 1025) that is 16.8 MB a layer, 5 µs at
//   3.35 TB/s.
//
// Design (flash-decoding): the TPU grid walks the kv axis of one (b·kv) in
// order.  Here that would be B·KV blocks, 32 at the serving shape on 132
// SMs, each streaming 0.5 MB alone.  So the positions below `length` split
// into chunks of whole 64-row tiles, one block per (chunk, b·kv), enough
// chunks to give the card about two blocks per SM.  Each block stages its
// k/v tiles in shared memory with coalesced loads, keeps the G query rows
// and its (m, l, acc) in shared memory and writes a partial (m, l, acc); a
// second kernel combines the partials of each (b·kv) with the usual
// rescaling by exp(m_i - max m) and writes the output.  The same partials
// are what the sequence-sharded decode combines across cards.
#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;  // kv rows per tile
constexpr int kLDS = kBK + 1;
constexpr int kMaxG = 32;

struct QStrides {  // element strides of q over (b, kv, g); hd is contiguous
  long long b, n, g;
};
struct KStrides {  // element strides of k or v over (b, kv, t); hd is contiguous
  long long b, n, t;
};

template <typename T, int HD>
size_t decode_smem_bytes(int G) {
  return (size_t)2 * kBK * (HD + attn_pad<T>()) * sizeof(T) + (size_t)(2 * G * HD + G * kLDS + 3 * G) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int KV, int G,
                             int length, int chunk, float scale, QStrides qs, KStrides ks, KStrides vs,
                             float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int LD = HD + attn_pad<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);  // kBK × LD
  T* sV = sK + kBK * LD;               // kBK × LD
  float* sQ = reinterpret_cast<float*>(sV + kBK * LD);  // G × HD
  float* sAcc = sQ + G * HD;                            // G × HD
  float* sS = sAcc + G * HD;                            // G × kLDS: scores, then rounded p
  float* sM = sS + G * kLDS;                            // G
  float* sL = sM + G;                                   // G
  float* sAlpha = sL + G;                               // G

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int bn = blockIdx.y;
  const int b = bn / KV, n = bn % KV;
  const T* qb = q + b * qs.b + n * qs.n;
  const T* kb = k + b * ks.b + n * ks.n;
  const T* vb = v + b * vs.b + n * vs.n;
  const T zero = attn_from_f<T>(0.f);
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, length);  // > c0: the host launches no empty chunk

  for (int i = tid; i < G * HD; i += kThreads) {
    sQ[i] = attn_to_f<T>(qb[(i / HD) * qs.g + i % HD]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = DACP_ATTN_NEG_INF;
    sL[g] = 0.f;
  }

  const int w = tid / 32, lane = tid % 32;
  for (int k0 = c0; k0 < c1; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done (and the setup above)
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < c1;  // rows past this chunk are never read
      sK[r * LD + d] = in ? kb[(k0 + r) * ks.t + d] : zero;
      sV[r * LD + d] = in ? vb[(k0 + r) * vs.t + d] : zero;
    }
    __syncthreads();

    // scores: one (row, position) pair per thread at a time
    for (int e = tid; e < G * kBK; e += kThreads) {
      const int g = e / kBK, p = e % kBK;
      const float* qr = sQ + g * HD;
      const T* kr = sK + p * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], attn_to_f<T>(kr[d]), s);
      s *= scale;
      // positions at or past `length` take the TPU kernel's mask, and so do
      // rows past this chunk that belong to the next one: the chunk's first
      // position is below `length`, so the running max is a real score and
      // every masked p is exactly 0
      sS[g * kLDS + p] = k0 + p < c1 ? s : DACP_ATTN_NEG_INF;
    }
    __syncthreads();

    // online-softmax update: one warp per row
    for (int g = w; g < G; g += kThreads / 32) {
      float* row = sS + g * kLDS;
      float mx = -INFINITY;
      for (int p = lane; p < kBK; p += 32) mx = fmaxf(mx, row[p]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int p = lane; p < kBK; p += 32) {
        const float pv = expf(row[p] - m_new);
        sum += pv;
        row[p] = attn_round<T>(pv);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc · alpha + p · v
    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD, d = e % HD;
      const float* pr = sS + g * kLDS;
      float a = sAcc[e] * sAlpha[g];
#pragma unroll 8
      for (int p = 0; p < kBK; ++p) a = fmaf(pr[p], attn_to_f<T>(sV[p * LD + d]), a);
      sAcc[e] = a;
    }
  }
  __syncthreads();

  const long long base = (long long)split * gridDim.y + bn;  // partials are (splits, B·KV, G[, HD])
  for (int g = tid; g < G; g += kThreads) {
    part_m[base * G + g] = sM[g];
    part_l[base * G + g] = sL[g];
  }
  for (int i = tid; i < G * HD; i += kThreads) part_acc[base * G * HD + i] = sAcc[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                               const float* __restrict__ part_acc, int splits, int BKV, int G, int HD,
                               T* __restrict__ o) {
  const int bn = blockIdx.x;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float m = DACP_ATTN_NEG_INF;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[((long long)s * BKV + bn) * G + g]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long row = (long long)s * BKV + bn;
      const float f = expf(part_m[row * G + g] - m);
      l = fmaf(part_l[row * G + g], f, l);
      a = fmaf(part_acc[row * G * HD + i], f, a);
    }
    o[(long long)bn * G * HD + i] = attn_from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD>
int launch_decode(const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int length, int chunk,
                  int splits, const long long* st, float* part_m, float* part_l, float* part_acc,
                  cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<T, HD>(G);
  int rc = attn_allow_smem(decode_attn_split_kernel<T, HD>, smem);
  if (rc != 0) return rc;
  const QStrides qs{st[0], st[1], st[2]};
  const KStrides ks{st[3], st[4], st[5]};
  const KStrides vs{st[6], st[7], st[8]};
  const float scale = (float)(1.0 / sqrt((double)HD));
  decode_attn_split_kernel<T, HD><<<dim3(splits, B * KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), KV, G, length, chunk, scale, qs,
      ks, vs, part_m, part_l, part_acc);
  rc = dacp_last_error();
  if (rc != 0) return rc;
  decode_attn_combine_kernel<T><<<B * KV, kThreads, 0, stream>>>(part_m, part_l, part_acc, splits, B * KV, G, HD,
                                                                  static_cast<T*>(o));
  return dacp_last_error();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int length,
                int chunk, int splits, const long long* st, float* pm, float* pl, float* pa, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_decode<T, 32>(q, k, v, o, B, KV, G, length, chunk, splits, st, pm, pl, pa, stream);
    case 64:
      return launch_decode<T, 64>(q, k, v, o, B, KV, G, length, chunk, splits, st, pm, pl, pa, stream);
    case 128:
      return launch_decode<T, 128>(q, k, v, o, B, KV, G, length, chunk, splits, st, pm, pl, pa, stream);
    case 256:
      return launch_decode<T, 256>(q, k, v, o, B, KV, G, length, chunk, splits, st, pm, pl, pa, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 9 int64 element strides — q (b, kv, g), k (b, kv, t), v (b, kv, t).
// The chunks are [s·chunk, min((s+1)·chunk, length)) for s < splits, chunk a
// multiple of 64 and (splits - 1)·chunk < length; with length 0 the wrapper
// writes zeros and launches nothing.  part_m, part_l (splits, B·KV, G) and
// part_acc (splits, B·KV, G, hd) are float32 scratch.
DACP_API int dacp_decode_attention(const void* q, const void* k, const void* v, void* o, int dtype, int B, int KV,
                                   int G, int Tn, int hd, int length, int chunk, int splits, const long long* strides,
                                   void* part_m, void* part_l, void* part_acc, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > kMaxG || length <= 0 || length > Tn || chunk <= 0 || chunk % kBK != 0 ||
      splits <= 0 || (long long)(splits - 1) * chunk >= length || (long long)splits * chunk < length ||
      splits > 65535 || B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == DACP_ATTN_F32)
    return dispatch_hd<float>(hd, q, k, v, o, B, KV, G, length, chunk, splits, strides, pm, pl, pa, s);
  if (dtype == DACP_ATTN_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, KV, G, length, chunk, splits, strides, pm, pl, pa, s);
  return (int)cudaErrorInvalidValue;
}
