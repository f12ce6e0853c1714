// flash_attention: causal or full GQA attention, online softmax over kv
// tiles, float32 (m, l, acc) state.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel).  Same function: scores in float32 times
// hd^-0.5, masked with -1e30 where qpos < kpos when causal, a running max,
// l and acc in float32, p rounded to v's type before the PV product, output
// acc / max(l, 1e-30) in q's type.
//
//   q, o (B, KV, G, S, hd) and k, v (B, KV, T, hd), float32 or bfloat16,
//   any element strides with the head dim contiguous, so the model hands
//   its (B, S, KV, G, hd) projections and its (B, KV, T, hd) cache without
//   a copy.  Any S and T: ragged tiles are masked here (the TPU kernel
//   asserts S % tq == 0 and T % tk == 0).  hd is 32, 64, 128 or 256.
//
//   Bound: operations.  A causal prefill does 2·2·B·H·S·T·hd/2 flops and
//   moves each of q, k, v, o once; at the serving shape (B 4, H 32, S = T =
//   1024, hd 128, bf16) that is 34 GFLOP against 42 MB, far above the card's
//   ridge.  This first kernel runs its products on the CUDA cores with
//   explicit float32 FMAs (the library builds with -fmad=false), not on the
//   tensor cores: its ceiling is the float32 rate, and below that the
//   shared-memory bandwidth of its operand loads.
//
// Design: the TPU grid walks the kv axis in order and carries (m, l, acc)
// in scratch from step to step.  Here one block owns one (b·kv, g, 64-row q
// tile) and loops over 32-row kv tiles itself: q stays in shared memory for
// the whole loop, each k/v tile is staged in shared memory once and read by
// all 64 rows, tiles wholly above the diagonal are never loaded when
// causal, and acc lives in registers (8 rows × hd/32 columns per thread).
// Shared rows carry one word of padding so that column reads are
// conflict-free.  Each tile runs three phases separated by barriers:
// scores (a 4×2 register tile per thread), the online-softmax update (four
// threads per row, shuffles), and the PV accumulation.
#include "attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // kv rows per tile
constexpr int kLDS = kBK + 1;

struct QStrides {  // element strides of q or o over (b, kv, g, s); hd is contiguous
  long long b, n, g, s;
};
struct KStrides {  // element strides of k or v over (b, kv, t); hd is contiguous
  long long b, n, t;
};

template <typename T, int HD>
constexpr size_t flash_smem_bytes() {
  return (size_t)(kBQ + 2 * kBK) * (HD + attn_pad<T>()) * sizeof(T) + (size_t)(kBQ * kLDS + 2 * kBQ) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                      int KV, int S, int Tn, int causal, float scale, QStrides qs, KStrides ks, KStrides vs,
                      QStrides os) {
  constexpr int LD = HD + attn_pad<T>();
  constexpr int DJ = HD / 32;  // acc columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);  // kBQ × LD
  T* sK = sQ + kBQ * LD;               // kBK × LD
  T* sV = sK + kBK * LD;               // kBK × LD
  float* sS = reinterpret_cast<float*>(sV + kBK * LD);  // kBQ × kLDS: scores, then rounded p
  float* sAlpha = sS + kBQ * kLDS;                      // kBQ
  float* sL = sAlpha + kBQ;                             // kBQ

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z / KV;
  const int n = blockIdx.z % KV;
  const T* qb = q + b * qs.b + n * qs.n + g * qs.g;
  const T* kb = k + b * ks.b + n * ks.n;
  const T* vb = v + b * vs.b + n * vs.n;
  T* ob = o + b * os.b + n * os.n + g * os.g;
  const T zero = attn_from_f<T>(0.f);

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * LD + d] = q0 + r < S ? qb[(q0 + r) * qs.s + d] : zero;
  }

  // kv positions any row of this tile may see: below the diagonal of its
  // last real row when causal (the TPU kernel's `run` condition)
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
      sK[r * LD + d] = in ? kb[(k0 + r) * ks.t + d] : zero;
      sV[r * LD + d] = in ? vb[(k0 + r) * vs.t + d] : zero;
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
      for (int i = 0; i < 4; ++i) qv[i] = attn_to_f<T>(sQ[(rg * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) kv[j] = attn_to_f<T>(sK[(cl + 16 * j) * LD + d]);
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
        row[j] = attn_round<T>(p);
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
      for (int j = 0; j < DJ; ++j) vv[j] = attn_to_f<T>(sV[c * LD + lane + 32 * j]);
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
    for (int j = 0; j < DJ; ++j) ob[(q0 + r) * os.s + lane + 32 * j] = attn_from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int S, int Tn,
                 int causal, const long long* st, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<T, HD>();
  const int rc = attn_allow_smem(flash_attn_kernel<T, HD>, smem);
  if (rc != 0) return rc;
  const QStrides qs{st[0], st[1], st[2], st[3]};
  const KStrides ks{st[4], st[5], st[6]};
  const KStrides vs{st[7], st[8], st[9]};
  const QStrides os{st[10], st[11], st[12], st[13]};
  const float scale = (float)(1.0 / sqrt((double)HD));
  const dim3 grid((S + kBQ - 1) / kBQ, G, B * KV);
  flash_attn_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), KV, S, Tn,
      causal, scale, qs, ks, vs, os);
  return dacp_last_error();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int S, int Tn,
                int causal, const long long* st, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_flash<T, 32>(q, k, v, o, B, KV, G, S, Tn, causal, st, stream);
    case 64:
      return launch_flash<T, 64>(q, k, v, o, B, KV, G, S, Tn, causal, st, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, B, KV, G, S, Tn, causal, st, stream);
    case 256:
      return launch_flash<T, 256>(q, k, v, o, B, KV, G, S, Tn, causal, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 14 int64 element strides — q (b, kv, g, s), k (b, kv, t),
// v (b, kv, t), o (b, kv, g, s); the head dim is contiguous in all four.
DACP_API int dacp_flash_attention(const void* q, const void* k, const void* v, void* o, int dtype, int B, int KV,
                                  int G, int S, int Tn, int hd, int causal, const long long* strides, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || Tn <= 0 || G > 65535 || B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DACP_ATTN_F32) return dispatch_hd<float>(hd, q, k, v, o, B, KV, G, S, Tn, causal, strides, s);
  if (dtype == DACP_ATTN_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, KV, G, S, Tn, causal, strides, s);
  return (int)cudaErrorInvalidValue;
}
