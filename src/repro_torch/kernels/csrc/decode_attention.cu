// decode_attention: one query token per head against a KV cache masked at
// `length`, float32 (m, l, acc) state.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _kernel).  Same function: scores in float32 times
// hd^-0.5, positions >= length masked with -1e30, a running max, l and acc
// in float32 (l sums the unrounded p), p rounded to v's type before the PV
// product, output acc / max(l, 1e-30) in q's type.
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
// Split-K (flash-decoding): the TPU grid walks the kv axis of one (b·kv) in
// order.  Here that would be B·KV blocks, 32 at the serving shape on 132
// SMs, each streaming 0.5 MB alone.  So the positions below `length` split
// into chunks of whole 64-row tiles, one block per (chunk, b·kv), as many
// as one wave of two blocks per SM holds (192 blocks of 192 rows at the
// serving shape), and each block writes a partial (m, l, acc) for its chunk
// into wrapper-allocated scratch.  Two kernels, chosen by dtype (dispatch,
// not fallback):
//
// bfloat16 (decode_attn_tc_kernel, every serving call): every thread issues
// 16-byte cp.async copies of q and of the k/v tiles into a ring of up to
// three 64-row stages (all of a block's tiles at once at the serving shape),
// rows past the chunk zero-filled by the copy itself.  Both products run on
// the tensor cores as mma.sync m16n8k16 bf16 -> f32, transposed so that the
// few query rows (G = 4 at the serving shape) are the n8 side of the mma and
// not a 16-row side padded with zeros: Sᵀ (positions × g) = K·Qᵀ, with K
// by ldmatrix and Qᵀ's fragments held in registers, and outᵀ (hd × g) +=
// Vᵀ·Pᵀ, with Vᵀ by ldmatrix.trans.  The accumulator fragment of Sᵀ,
// rounded to bf16 (the TPU kernel's p.astype(v.dtype)), becomes Pᵀ's B
// fragment by one movmatrix transpose in registers.  Each of the four warps
// takes 16 positions of every tile and keeps its own online softmax (base
// 2, one ex2 a score) down the columns of its fragments; the warps merge
// through shared memory into the chunk's partial at the end.  Against the
// untransposed form (G rows padded to 16, each warp forming the whole
// tile's scores) this is a fifth of the tensor-core work, which is what
// bounded the kernel: the copies alone take less time than the products
// did.  The chunks of one (b·kv) (at most 16) run as one thread block
// cluster: after a cluster barrier each block merges a slice of the output
// from every block's partial, read from the other blocks' shared memory,
// so the merge costs no second launch and no fill; merging through global
// memory by the last block of each (b·kv) instead cost about half the
// kernel's time in probe builds.  G > 8 takes 16 query rows a block and,
// past 16, a second block row (grid z).  Rows whose base or outer strides
// are off a 16-byte boundary are copied element by element instead (a host
// rule on the pointers).
//
// float32 (decode_attn_split_kernel + decode_attn_combine_kernel: the tests
// and chip_smoke.py's f32 cases, held to 3e-5, which bf16 or TF32 products
// cannot meet): scalar fmaf on the CUDA cores, k/v tiles staged in shared
// memory with coalesced loads, (m, l, acc) in shared memory, and a second
// kernel that combines the partials.
//
// Partials mode (dacp_decode_attention_partials, the sequence-sharded
// decode: each rank holds a slice of the cache and the ranks merge their
// partials): the same launch, but the merge of the chunks stops short of
// the division by l.  It writes the row's merged (m, l), m in natural units,
// and the unnormalised Σ acc_s·e^(m_s - m) as float32 in place of the
// output, so no second pass over the cache runs.
#include <cooperative_groups.h>

#include "attention.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
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

// out_m == nullptr: o = the normalised output.  Otherwise the partials
// mode: o (float32) = the unnormalised Σ acc_s·e^(m_s - m), out_m / out_l =
// the row's merged m and l (B·KV, G).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                               const float* __restrict__ part_acc, int splits, int BKV, int G, int HD,
                               T* __restrict__ o, float* __restrict__ out_m, float* __restrict__ out_l) {
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
    if (out_m == nullptr) {
      o[(long long)bn * G * HD + i] = attn_from_f<T>(a / fmaxf(l, 1e-30f));
    } else {
      o[(long long)bn * G * HD + i] = attn_from_f<T>(a);
      if (i % HD == 0) {
        out_m[(long long)bn * G + g] = m;
        out_l[(long long)bn * G + g] = l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int kMaxStages = 3;   // k/v ring depth (fewer when a chunk has fewer tiles)
constexpr int kMaxSplits = 16;  // chunks per (b·kv): blocks of one cluster (16 needs the non-portable size)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; -1e30 gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int NG>
struct TcLayout {
  static constexpr int LD = HD + 8;  // bf16 per shared row: 16 bytes of pad put ldmatrix's 8 rows on distinct banks
  static constexpr int GR = 8 * NG;  // query rows a block holds (a column n8 tile of Sᵀ each)
  static constexpr size_t kRing = (size_t)GR * LD * sizeof(bf16);        // after the q rows
  static constexpr size_t kStage = (size_t)2 * kBK * LD * sizeof(bf16);  // k then v tile
  // over the ring once the tiles are done: the four warps' states, then the
  // block's partial (m, l, acc) that the cluster reads, then merge weights
  static constexpr size_t kMerge = ((size_t)4 * GR * (2 + HD) + (size_t)GR * (2 + HD + kMaxSplits)) * sizeof(float);
  static size_t bytes(int stages) {
    const size_t r = stages * kStage;
    return kRing + (r > kMerge ? r : kMerge);
  }
};

// movmatrix: the 8×8 b16 matrix whose standard fragment this lane holds,
// transposed (an accumulator fragment of Sᵀ becomes a B fragment of Pᵀ)
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// out_m == nullptr: o (bf16) = the normalised output.  Otherwise the
// partials mode: o (float32) = the unnormalised Σ acc_s·2^(m_s - m), and
// out_m / out_l (B·KV, G) = the row's merged m (natural units) and l.
template <int HD, int NG>
__global__ void __launch_bounds__(128)
    decode_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          void* __restrict__ o, int KV, int G, int length, int chunk, int splits, int stages, int vec,
                          float scale, QStrides qs, KStrides ks, KStrides vs, float* __restrict__ part_m,
                          float* __restrict__ part_l, float* __restrict__ part_acc, float* __restrict__ out_m,
                          float* __restrict__ out_l) {
  using Lay = TcLayout<HD, NG>;
  constexpr int LD = Lay::LD, GR = Lay::GR;
  constexpr int NT = 128;
  constexpr int MH = HD / 16;  // m16 tiles of the head dim in outᵀ
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // GR × LD: this block's query rows, zero past G
  unsigned char* ring = smem + Lay::kRing;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, bn = blockIdx.y;
  const int g0 = blockIdx.z * 16;          // this block's first query row of the group
  const int Gb = min(GR, G - g0);          // and how many it holds
  const int b = bn / KV, n = bn % KV;
  const bf16* qb = q + b * qs.b + n * qs.n + g0 * qs.g;
  const bf16* kb = k + b * ks.b + n * ks.n;
  const bf16* vb = v + b * vs.b + n * vs.n;
  const int c0 = split * chunk;
  const int c1 = min(c0 + chunk, length);  // > c0: the host launches no empty chunk
  const int ntiles = (c1 - c0 + kBK - 1) / kBK;

  auto load_tile = [&](int t) {
    bf16* sK = reinterpret_cast<bf16*>(ring + (t % stages) * Lay::kStage);
    bf16* sV = sK + kBK * LD;
    const int r0 = c0 + t * kBK;
    if (vec) {
      constexpr int PIECES = HD / 8;  // 16-byte pieces per row
      for (int i = tid; i < kBK * PIECES; i += NT) {
        const int r = i / PIECES, c = (i % PIECES) * 8;
        const bool in = r0 + r < c1;  // rows past the chunk arrive as zeros
        const long long row = in ? r0 + r : c0;
        cp_async16(sK + r * LD + c, kb + row * ks.t + c, in);
        cp_async16(sV + r * LD + c, vb + row * vs.t + c, in);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int i = tid; i < kBK * HD; i += NT) {
        const int r = i / HD, c = i % HD;
        const bool in = r0 + r < c1;
        sK[r * LD + c] = in ? kb[(long long)(r0 + r) * ks.t + c] : zero;
        sV[r * LD + c] = in ? vb[(long long)(r0 + r) * vs.t + c] : zero;
      }
    }
    cp_async_commit();
  };

  // q first, then the k/v tiles: every copy of the block is in flight at once
  if (vec) {
    for (int i = tid; i < GR * (HD / 8); i += NT) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      cp_async16(sQ + r * LD + c, qb + (r < Gb ? r : 0) * qs.g + c, r < Gb);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < GR * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      sQ[r * LD + c] = r < Gb ? qb[r * qs.g + c] : zero;
    }
  }
  const int first = min(stages, ntiles);
  for (int t = 0; t < first; ++t) load_tile(t);  // q joins the first tile's copy group

  // Both products transposed, so that the few query rows are the n8 side of
  // the mma and the positions or the head dim its m16 side:
  //   Sᵀ (positions × g) = K · Qᵀ  and  outᵀ (hd × g) += Vᵀ · Pᵀ.
  // Each warp takes 16 positions of every tile and keeps its own online
  // softmax per query row (a column of its fragments); the four warps merge
  // at the end.
  float acc[MH][NG][4];
#pragma unroll
  for (int i = 0; i < MH; ++i)
#pragma unroll
    for (int j = 0; j < NG; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float m_run[NG][2], l_run[NG][2];  // query rows ng·8 + 2·(lane % 4) + {0, 1}
#pragma unroll
  for (int j = 0; j < NG; ++j) m_run[j][0] = m_run[j][1] = DACP_ATTN_NEG_INF, l_run[j][0] = l_run[j][1] = 0.f;
  uint32_t qf[MH][NG][2];  // Qᵀ's B fragments, the same for every tile
  const float sc = scale * kLog2e;
  const int p0 = warp * 16;

  for (int t = 0; t < ntiles; ++t) {
    const int pending = min(stages - 1, ntiles - 1 - t);  // copies allowed to be still in flight
    if (pending >= 2)
      cp_async_wait<2>();
    else if (pending == 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < MH; ++kk)
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          uint32_t r2[2];
          const bf16* qr = sQ + (j * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8;
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                       : "=r"(r2[0]), "=r"(r2[1])
                       : "r"(mma_smem_u32(qr)));
          qf[kk][j][0] = r2[0];
          qf[kk][j][1] = r2[1];
        }
    }
    const bf16* sK = reinterpret_cast<const bf16*>(ring + (t % stages) * Lay::kStage);
    const bf16* sV = sK + kBK * LD;

    // Sᵀ for this warp's 16 positions
    float s[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* ka = sK + (p0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < MH; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ka + kk * 16);
#pragma unroll
      for (int j = 0; j < NG; ++j) mma_bf16(s[j], a, qf[kk][j][0], qf[kk][j][1]);
    }

    // online softmax down each column (a query row), in base 2 (scores times
    // hd^-0.5·log2 e, one ex2 each); positions past the chunk take the mask
    const int pos = c0 + t * kBK + p0 + (lane >> 2);
    float alpha[NG][2];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x0 = pos < c1 ? s[j][e] * sc : DACP_ATTN_NEG_INF;
        const float x1 = pos + 8 < c1 ? s[j][2 + e] * sc : DACP_ATTN_NEG_INF;
        float mx = fmaxf(x0, x1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run[j][e], mx);
        alpha[j][e] = ex2(m_run[j][e] - m_new);
        m_run[j][e] = m_new;
        const float pa = ex2(x0 - m_new), pb = ex2(x1 - m_new);
        l_run[j][e] = l_run[j][e] * alpha[j][e] + pa + pb;  // the unrounded p, as the TPU kernel sums it
        s[j][e] = pa;
        s[j][2 + e] = pb;
      }
    // Pᵀ's B fragments: bf16(p), the TPU kernel's p.astype(v.dtype), moved
    // from the accumulator layout by an 8×8 transpose in registers
    uint32_t pf[NG][2];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      pf[j][0] = transpose8x8(pack_bf16x2(s[j][0], s[j][1]));
      pf[j][1] = transpose8x8(pack_bf16x2(s[j][2], s[j][3]));
    }
    // outᵀ = outᵀ · alpha + Vᵀ·Pᵀ: Vᵀ's A fragments by ldmatrix.trans of V
    const bf16* va = sV + (p0 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) {
      uint32_t a[4];
      ldsm_x4_trans(a, va + mh * 16);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mh][j][e] *= alpha[j][e & 1];
        mma_bf16(acc[mh][j], a, pf[j][0], pf[j][1]);
      }
    }
    if (t + stages < ntiles) {
      __syncthreads();  // every warp is done with this stage before it is refilled
      load_tile(t + stages);
    }
  }

  // merge the four warps into this chunk's partial (m, l, acc) for the
  // block's query rows: in shared memory for the cluster, and in the scratch
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_run[j][e] += __shfl_xor_sync(0xffffffffu, l_run[j][e], 4);
      l_run[j][e] += __shfl_xor_sync(0xffffffffu, l_run[j][e], 8);
      l_run[j][e] += __shfl_xor_sync(0xffffffffu, l_run[j][e], 16);
    }
  __syncthreads();  // the ring is free: every copy was waited for and every warp is done with the tiles
  float* wM = reinterpret_cast<float*>(ring);  // 4 × GR
  float* wL = wM + 4 * GR;                      // 4 × GR
  float* wA = wL + 4 * GR;                      // 4 × GR × HD
  float* bM = wA + 4 * GR * HD;                 // GR: the block's partial, read by the cluster
  float* bL = bM + GR;
  float* bA = bL + GR;    // GR × HD
  float* bF = bA + GR * HD;  // kMaxSplits × GR: each chunk's weight in the merged output
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int g = j * 8 + 2 * (lane & 3) + e;
      if (lane < 4) {
        wM[warp * GR + g] = m_run[j][e];
        wL[warp * GR + g] = l_run[j][e];
      }
#pragma unroll
      for (int mh = 0; mh < MH; ++mh) {
        const int h = mh * 16 + (lane >> 2);
        wA[(warp * GR + g) * HD + h] = acc[mh][j][e];
        wA[(warp * GR + g) * HD + h + 8] = acc[mh][j][2 + e];
      }
    }
  __syncthreads();
  const long long base = (long long)split * gridDim.y + bn;  // partials are (splits, B·KV, G[, HD])
  for (int i = tid; i < Gb * HD; i += NT) {
    const int g = i / HD, h = i % HD;
    float m = DACP_ATTN_NEG_INF;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, wM[w * GR + g]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = ex2(wM[w * GR + g] - m);
      a = fmaf(wA[(w * GR + g) * HD + h], f, a);
      l = fmaf(wL[w * GR + g], f, l);
    }
    bA[i] = a;
    part_acc[(base * G + g0 + g) * HD + h] = a;
    if (h == 0) {
      bM[g] = m;
      bL[g] = l;
      part_m[base * G + g0 + g] = m * kLn2;  // the scratch keeps m in natural units
      part_l[base * G + g0 + g] = l;
    }
  }

  // the chunks of this (b·kv) are one cluster: each block merges a slice of
  // the output from every block's partial, read from its shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (tid < Gb) {  // per row: the largest m, the rescaled l, and each chunk's weight
    float ms[kMaxSplits], ls[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {  // every chunk's (m, l) loaded at once
      ms[s] = s < splits ? *cluster.map_shared_rank(bM + tid, s) : DACP_ATTN_NEG_INF;
      ls[s] = s < splits ? *cluster.map_shared_rank(bL + tid, s) : 0.f;
    }
    float m = DACP_ATTN_NEG_INF;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) m = fmaxf(m, ms[s]);
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      ms[s] = ex2(ms[s] - m);
      l = fmaf(ls[s], ms[s], l);
    }
    const float inv = out_m == nullptr ? 1.f / fmaxf(l, 1e-30f) : 1.f;  // the partials stay unnormalised
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) bF[s * GR + tid] = ms[s] * inv;
    if (out_m != nullptr && split == 0) {  // one block of the cluster writes the row's merged (m, l)
      out_m[(long long)bn * G + g0 + tid] = m * kLn2;  // natural units, as the scratch and the plain version
      out_l[(long long)bn * G + g0 + tid] = l;
    }
  }
  __syncthreads();
  const int E = Gb * HD, per = (E + splits - 1) / splits;
  const int e1 = min(E, (split + 1) * per);
  for (int i = split * per + tid; i < e1; i += NT) {
    const int g = i / HD;
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) a = fmaf(*cluster.map_shared_rank(bA + i, s), bF[s * GR + g], a);
    const long long at = ((long long)bn * G + g0) * HD + i;
    if (out_m == nullptr)
      static_cast<bf16*>(o)[at] = __float2bfloat16_rn(a);
    else
      static_cast<float*>(o)[at] = a;
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int length, int chunk,
               int splits, const QStrides& qs, const KStrides& ks, const KStrides& vs, float scale, float* part_m,
               float* part_l, float* part_acc, float* out_m, float* out_l, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<float, HD>(G);
  int rc = attn_allow_smem(decode_attn_split_kernel<float, HD>, smem);
  if (rc != 0) return rc;
  decode_attn_split_kernel<float, HD><<<dim3(splits, B * KV), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), KV, G, length, chunk,
      scale, qs, ks, vs, part_m, part_l, part_acc);
  rc = dacp_last_error();
  if (rc != 0) return rc;
  decode_attn_combine_kernel<float><<<B * KV, kThreads, 0, stream>>>(part_m, part_l, part_acc, splits, B * KV, G, HD,
                                                                      static_cast<float*>(o), out_m, out_l);
  return dacp_last_error();
}

// rows of q, k or v can be copied 16 bytes at a time: 16-byte aligned bases
// and outer strides (of the dimensions longer than 1)
static bool rows_aligned(const void* p, const KStrides& st, int B, int KV, int Tn) {
  const long long step = (long long)sizeof(bf16);
  return (uintptr_t)p % 16 == 0 && (B == 1 || st.b * step % 16 == 0) && (KV == 1 || st.n * step % 16 == 0) &&
         (Tn == 1 || st.t * step % 16 == 0);
}

template <int HD, int NG>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int Tn, int length,
              int chunk, int splits, const QStrides& qs, const KStrides& ks, const KStrides& vs, float scale,
              float* part_m, float* part_l, float* part_acc, float* out_m, float* out_l, cudaStream_t stream) {
  if (splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const int stages = min(kMaxStages, chunk / kBK);
  const size_t smem = TcLayout<HD, NG>::bytes(stages);
  auto kernel = decode_attn_tc_kernel<HD, NG>;
  int rc = attn_allow_smem(kernel, smem);
  if (rc == 0 && splits > 8) rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != 0) return rc;
  const KStrides qrows{qs.b, qs.n, qs.g};
  const int vec = rows_aligned(k, ks, B, KV, Tn) && rows_aligned(v, vs, B, KV, Tn) && rows_aligned(q, qrows, B, KV, G);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * KV, (G + 15) / 16);  // z: groups of 16 query rows
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // one cluster per (b·kv, row group): its chunks
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                               static_cast<const bf16*>(v), o, KV, G, length, chunk, splits, stages, vec, scale, qs, ks,
                               vs, part_m, part_l, part_acc, out_m, out_l);
  if (rc != 0) return rc;
  return dacp_last_error();
}

template <int HD>
int launch_decode(int dtype, const void* q, const void* k, const void* v, void* o, int B, int KV, int G, int Tn,
                  int length, int chunk, int splits, double user_scale, const long long* st, float* pm, float* pl,
                  float* pa, float* om, float* ol, cudaStream_t stream) {
  const QStrides qs{st[0], st[1], st[2]};
  const KStrides ks{st[3], st[4], st[5]};
  const KStrides vs{st[6], st[7], st[8]};
  const float scale = user_scale > 0 ? (float)user_scale : (float)(1.0 / sqrt((double)HD));
  if (dtype == DACP_ATTN_F32)
    return launch_f32<HD>(q, k, v, o, B, KV, G, length, chunk, splits, qs, ks, vs, scale, pm, pl, pa, om, ol, stream);
  if (dtype != DACP_ATTN_BF16) return (int)cudaErrorInvalidValue;
  if (G <= 8)
    return launch_tc<HD, 1>(q, k, v, o, B, KV, G, Tn, length, chunk, splits, qs, ks, vs, scale, pm, pl, pa, om, ol,
                            stream);
  return launch_tc<HD, 2>(q, k, v, o, B, KV, G, Tn, length, chunk, splits, qs, ks, vs, scale, pm, pl, pa, om, ol,
                          stream);
}

// the checks and the head-dim dispatch of both entry points (om == nullptr: the normalised output)
int decode_entry(const void* q, const void* k, const void* v, void* o, int dtype, int B, int KV, int G, int Tn, int hd,
                 int length, int chunk, int splits, double scale, const long long* strides, void* part_m,
                 void* part_l, void* part_acc, float* om, float* ol, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > kMaxG || length <= 0 || length > Tn || chunk <= 0 || chunk % kBK != 0 ||
      splits <= 0 || (long long)(splits - 1) * chunk >= length || (long long)splits * chunk < length ||
      splits > 65535 || B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  switch (hd) {
    case 32:
      return launch_decode<32>(dtype, q, k, v, o, B, KV, G, Tn, length, chunk, splits, scale, strides, pm, pl, pa,
                                 om, ol, s);
    case 64:
      return launch_decode<64>(dtype, q, k, v, o, B, KV, G, Tn, length, chunk, splits, scale, strides, pm, pl, pa,
                                 om, ol, s);
    case 128:
      return launch_decode<128>(dtype, q, k, v, o, B, KV, G, Tn, length, chunk, splits, scale, strides, pm, pl, pa,
                                 om, ol, s);
    case 256:
      return launch_decode<256>(dtype, q, k, v, o, B, KV, G, Tn, length, chunk, splits, scale, strides, pm, pl, pa,
                                 om, ol, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 9 int64 element strides — q (b, kv, g), k (b, kv, t), v (b, kv, t).
// The chunks are [s·chunk, min((s+1)·chunk, length)) for s < splits, chunk a
// multiple of 64 and (splits - 1)·chunk < length; with length 0 the wrapper
// writes zeros and launches nothing.  part_m, part_l (splits, B·KV, G) and
// part_acc (splits, B·KV, G, hd) are float32 scratch.  bfloat16 takes at
// most 16 splits (one thread block cluster per b·kv).  scale: the scores'
// scale, or 0 for hd^-0.5.
DACP_API int dacp_decode_attention(const void* q, const void* k, const void* v, void* o, int dtype, int B, int KV,
                                   int G, int Tn, int hd, int length, int chunk, int splits, double scale,
                                   const long long* strides, void* part_m, void* part_l, void* part_acc, void* stream) {
  return decode_entry(q, k, v, o, dtype, B, KV, G, Tn, hd, length, chunk, splits, scale, strides, part_m, part_l,
                      part_acc, nullptr, nullptr, stream);
}

// The same launch, whose merge hands out the partial (m, l, acc) over
// positions < length instead of the output, for a merge across ranks:
// m and l (B, KV, G) and acc (B, KV, G, hd), float32 and contiguous, m in
// natural units (the largest score times hd^-0.5), l = Σ e^(s - m) over the
// unrounded p, acc = Σ p·v with p rounded to v's type.  The wrapper handles
// length 0 (m = -1e30, l = 0, acc = 0) and launches nothing then.
DACP_API int dacp_decode_attention_partials(const void* q, const void* k, const void* v, void* m, void* l, void* acc,
                                            int dtype, int B, int KV, int G, int Tn, int hd, int length, int chunk,
                                            int splits, double scale, const long long* strides, void* part_m,
                                            void* part_l, void* part_acc, void* stream) {
  if (m == nullptr || l == nullptr || acc == nullptr) return (int)cudaErrorInvalidValue;
  return decode_entry(q, k, v, acc, dtype, B, KV, G, Tn, hd, length, chunk, splits, scale, strides, part_m, part_l,
                      part_acc, static_cast<float*>(m), static_cast<float*>(l), stream);
}
