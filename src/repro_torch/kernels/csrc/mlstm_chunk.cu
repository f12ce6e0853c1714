// mlstm_chunk: the chunkwise stabilised mLSTM, carrying the matrix memory
// C (d, d), the normaliser n (d) and the stabiliser m across chunks.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_chunk.py (mlstm_chunk,
// body _kernel).  Same function, per chunk with cf = cumsum(log f):
//
//   w[i,j] = cf_i - cf_j + li_j (j <= i),  b_i = cf_i + m_prev,
//   m_i    = max(max_j w[i,j], b_i),       D = exp(w - m_i), inter_i = exp(b_i - m_i)
//   y_i    = [sum_j D_ij s (q_i·k_j) v_j + inter_i s (q_i C_prev)]
//            / max(|q_i·(sum_j D_ij k_j + inter_i n_prev)| s, exp(-m_i))      (s = d^-1/2)
//
// and the TPU kernel's carry update at the end of each chunk.  m starts at
// -1e30 as in the TPU kernel (the model's scan starts at -inf: both give
// exactly 0 for exp(m_prev - ...) and stay finite).
//
//   q, k, v (b, s, h, d) in float32 or bfloat16, log_i and log_f (b, s, h)
//   float32, all contiguous; y (b, s, h, d) float32 and, unlike the TPU
//   kernel, the final C (b, h, d, d), n (b, h, d) and m (b, h) in float32,
//   which prefill hands to the decode state.  Any s: the last chunk may be
//   shorter (the same as padding with log f = 0, log i = -inf).  d is 32,
//   64, 128, 256 or 384; L at most 256.
//
//   Bound: bytes in principle — at the xlstm-125m prefill shape (b 4, s
//   1024, h 4, d 384, L 256, bf16) it moves about 72 MB (0.022 ms at 3.35
//   TB/s).  This first kernel runs its products as explicit float32 FMAs on
//   the CUDA cores, so its ceiling is the float32 rate.
//
// Design: the TPU kernel keeps C (d, d) in VMEM scratch: 576 KB in float32
// at d = 384, more than any SM's shared memory.  Here the value dimension is
// split over blocks: the grid is (b·h, d / 64) and each block carries its 64
// columns of C (96 KB at d = 384) and the whole n in shared memory, walking
// the chunks itself.  The per-row quantities that need the full key
// dimension — m_i, inter_i, the scores q_i·k_j and the denominator — are
// recomputed by every block of a (b, h): q_i·(sum_j D_ij k_j) is taken as
// sum_j D_ij (q_i·k_j), the row sum of the score tiles the block forms
// anyway.  Within a chunk, 64-row query tiles meet the 64-row key tiles at
// or below the diagonal; scores accumulate over 64-wide slices of d staged
// in shared memory.  The row maximum max_j w[i,j] is taken directly over
// j <= i (256 comparisons a row), so D_ij <= 1 holds exactly.  About 172 KB
// of shared memory at d = 384: one block per SM, 96 blocks at the xlstm
// shape.
#include "scan.cuh"  // block scans; float32 / bfloat16 element conversions

namespace {

constexpr int kThreads = kScanThreads;  // also the longest chunk: one chunk row per thread
constexpr int kT = 64;         // rows per query or key tile
constexpr int kLT = kT + 1;    // row stride of the score tile
constexpr float kNeg = -1e30f;

template <int D>
struct MlstmSmem {
  static constexpr int kDS = D < 64 ? D : 64;  // width of a slice of d (keys) and of a block's value columns
  static constexpr int kC = 0;                 // D × kDS: this block's columns of C
  static constexpr int kN = kC + D * kDS;      // D: n
  static constexpr int kCf = kN + D;           // kThreads: cumulative log f of the chunk
  static constexpr int kLi = kCf + kThreads;   // kThreads: log i
  static constexpr int kMr = kLi + kThreads;   // kThreads: m_i
  static constexpr int kIn = kMr + kThreads;   // kThreads: inter_i
  static constexpr int kWk = kIn + kThreads;   // kThreads: carry weights wk_j
  static constexpr int kQ = kWk + kThreads;    // kT × (kDS+1): q slice of the query tile
  static constexpr int kK = kQ + kT * (kDS + 1);   // kT × (kDS+1): k slice of the key tile
  static constexpr int kSD = kK + kT * (kDS + 1);  // kT × kLT: s·D tile
  static constexpr int kV = kSD + kT * kLT;        // kT × kDS: v columns of the key tile
  static constexpr int kRed = kV + kT * kDS;       // 32: warp partials
  static constexpr int kTotal = kRed + 32;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ log_i, const float* __restrict__ log_f, float* __restrict__ y,
                       float* __restrict__ C_out, float* __restrict__ n_out, float* __restrict__ m_out, int H, int Sn,
                       int L, float scale) {
  using O = MlstmSmem<D>;
  constexpr int DS = O::kDS;
  constexpr int LS = DS + 1;
  constexpr int VC = DS / 16;            // value columns per thread
  constexpr int CE = DS * DS / kThreads;  // entries of one d slice of C per thread
  static_assert(DS * DS % kThreads == 0, "a slice of C must spread evenly over the block");
  extern __shared__ __align__(16) float sm[];
  float* sC = sm + O::kC;
  float* sN = sm + O::kN;
  float* sCf = sm + O::kCf;
  float* sLi = sm + O::kLi;
  float* sMr = sm + O::kMr;
  float* sIn = sm + O::kIn;
  float* sWk = sm + O::kWk;
  float* sQ = sm + O::kQ;
  float* sK = sm + O::kK;
  float* sSD = sm + O::kSD;
  float* sV = sm + O::kV;
  float* sRed = sm + O::kRed;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * DS;  // this block's value columns [v0, v0 + DS)
  const int ty = tid / 16, tx = tid % 16;
  const long long row0 = (long long)b * Sn;

  for (int e = tid; e < D * DS; e += kThreads) sC[e] = 0.f;
  for (int e = tid; e < D; e += kThreads) sN[e] = 0.f;
  float m_prev = kNeg;

  for (int c0 = 0; c0 < Sn; c0 += L) {
    const int Lc = min(L, Sn - c0);
    __syncthreads();  // the previous chunk is done with the row arrays and tiles
    const bool live = tid < Lc;
    const float li = live ? log_i[(row0 + c0 + tid) * H + h] : 0.f;
    const float lf = live ? log_f[(row0 + c0 + tid) * H + h] : 0.f;
    const float cf = block_inclusive_sum(lf, sRed);
    sCf[tid] = cf;
    sLi[tid] = li;
    __syncthreads();
    const float cf_last = sCf[Lc - 1];

    // per-row stabiliser of row tid, and the carry weights
    float mrow = kNeg;
    const int jmax = min(tid, Lc - 1);
    for (int j = 0; j <= jmax; ++j) mrow = fmaxf(mrow, (cf - sCf[j]) + sLi[j]);
    const float brow = cf + m_prev;
    const float mi = fmaxf(mrow, brow);
    const float m_carry = fmaxf(m_prev + cf_last, block_max(live ? (cf_last - cf) + li : kNeg, sRed));
    sMr[tid] = mi;
    sIn[tid] = expf(brow - mi);
    sWk[tid] = live ? expf((cf_last - cf) + li - m_carry) : 0.f;
    const float decay = expf(m_prev + cf_last - m_carry);
    __syncthreads();

    for (int i0 = 0; i0 < Lc; i0 += kT) {
      float acc[4][VC], qc[4][VC], rs[4], qn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rs[i] = qn[i] = 0.f;
#pragma unroll
        for (int j = 0; j < VC; ++j) acc[i][j] = qc[i][j] = 0.f;
      }
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
        for (int d0 = 0; d0 < D; d0 += DS) {
          __syncthreads();  // the previous slice's (and tile's) reads of sQ, sK, sSD, sV are done
          for (int e = tid; e < kT * DS; e += kThreads) {
            const int r = e / DS, dd = e % DS;
            sQ[r * LS + dd] = i0 + r < Lc ? attn_to_f<T>(q[((row0 + c0 + i0 + r) * H + h) * D + d0 + dd]) : 0.f;
            sK[r * LS + dd] = j0 + r < Lc ? attn_to_f<T>(k[((row0 + c0 + j0 + r) * H + h) * D + d0 + dd]) : 0.f;
          }
          __syncthreads();
#pragma unroll 4
          for (int dd = 0; dd < DS; ++dd) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LS + dd];
#pragma unroll
            for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * LS + dd];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
          }
          if (j0 == 0) {  // once per query tile: q·C_prev on this block's columns, and q·n_prev
#pragma unroll 4
            for (int dd = 0; dd < DS; ++dd) {
              float qv[4], cv[VC];
              const float nv = sN[d0 + dd];
#pragma unroll
              for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LS + dd];
#pragma unroll
              for (int j = 0; j < VC; ++j) cv[j] = sC[(d0 + dd) * DS + tx + 16 * j];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                qn[i] = fmaf(qv[i], nv, qn[i]);
#pragma unroll
                for (int j = 0; j < VC; ++j) qc[i][j] = fmaf(qv[i], cv[j], qc[i][j]);
              }
            }
          }
        }
        // s·D, and the row sums of (q·k)·D for the denominator
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gi = i0 + ty * 4 + i, gj = j0 + tx + 16 * c;
            float sd = 0.f;
            if (gj <= gi && gj < Lc) {
              const float dij = expf((sCf[gi] - sCf[gj]) + sLi[gj] - sMr[gi]);
              rs[i] += sc[i][c] * dij;
              sd = sc[i][c] * scale * dij;
            }
            sSD[(ty * 4 + i) * kLT + tx + 16 * c] = sd;
          }
        for (int e = tid; e < kT * DS; e += kThreads) {
          const int r = e / DS, c = e % DS;
          sV[e] = j0 + r < Lc ? attn_to_f<T>(v[((row0 + c0 + j0 + r) * H + h) * D + v0 + c]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kT; ++kk) {
          float vv[VC];
#pragma unroll
          for (int j = 0; j < VC; ++j) vv[j] = sV[kk * DS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s = sSD[(ty * 4 + i) * kLT + kk];
#pragma unroll
            for (int j = 0; j < VC; ++j) acc[i][j] = fmaf(s, vv[j], acc[i][j]);
          }
        }
      }
      // the 16 threads of a row group (lanes tx of one half warp) hold parts of each row sum
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = i0 + ty * 4 + i;
        if (gi >= Lc) continue;
        const float inter = sIn[gi];
        const float den = fmaxf(fabsf(rs[i] + inter * qn[i]) * scale, expf(-sMr[gi]));
        float* yr = y + ((row0 + c0 + gi) * H + h) * D + v0;
#pragma unroll
        for (int j = 0; j < VC; ++j) yr[tx + 16 * j] = (acc[i][j] + inter * qc[i][j] * scale) / den;
      }
    }

    // carry: C[:, cols] = decay C + sum_j wk_j k_j v_jᵀ, n = decay n + sum_j wk_j k_j
    for (int d0 = 0; d0 < D; d0 += DS) {
      float cacc[CE];
#pragma unroll
      for (int s = 0; s < CE; ++s) cacc[s] = 0.f;
      float nacc = 0.f;
      for (int j0 = 0; j0 < Lc; j0 += kT) {
        __syncthreads();  // the previous reads of sK and sV are done
        for (int e = tid; e < kT * DS; e += kThreads) {
          const int r = e / DS, c = e % DS;
          const bool ok = j0 + r < Lc;
          sK[r * LS + c] = ok ? attn_to_f<T>(k[((row0 + c0 + j0 + r) * H + h) * D + d0 + c]) * sWk[j0 + r] : 0.f;
          sV[e] = ok ? attn_to_f<T>(v[((row0 + c0 + j0 + r) * H + h) * D + v0 + c]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kT; ++kk) {
#pragma unroll
          for (int s = 0; s < CE; ++s) {
            const int e = tid + s * kThreads;
            cacc[s] = fmaf(sK[kk * LS + e / DS], sV[kk * DS + e % DS], cacc[s]);
          }
        }
        if (tid < DS)
          for (int kk = 0; kk < kT; ++kk) nacc += sK[kk * LS + tid];
      }
#pragma unroll
      for (int s = 0; s < CE; ++s) {  // each entry belongs to one thread; nobody reads sC here
        const int e = tid + s * kThreads;
        float* cp = sC + (d0 + e / DS) * DS + e % DS;
        *cp = decay * *cp + cacc[s];
      }
      if (tid < DS) sN[d0 + tid] = decay * sN[d0 + tid] + nacc;
    }
    m_prev = m_carry;
  }

  __syncthreads();
  float* co = C_out + (long long)bh * D * D;
  for (int e = tid; e < D * DS; e += kThreads) co[(e / DS) * D + v0 + e % DS] = sC[e];
  if (blockIdx.y == 0) {
    for (int e = tid; e < D; e += kThreads) n_out[(long long)bh * D + e] = sN[e];
    if (tid == 0) m_out[bh] = m_prev;
  }
}

template <typename T, int D>
int launch_mlstm(const void* q, const void* k, const void* v, const void* li, const void* lf, void* y, void* C,
                 void* n, void* m, int Bn, int H, int Sn, int L, cudaStream_t stream) {
  const size_t smem = (size_t)MlstmSmem<D>::kTotal * sizeof(float);
  const int rc = attn_allow_smem(mlstm_chunk_kernel<T, D>, smem);
  if (rc != 0) return rc;
  const dim3 grid(Bn * H, D / MlstmSmem<D>::kDS);
  const float scale = (float)(1.0 / sqrt((double)D));
  mlstm_chunk_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(li),
      static_cast<const float*>(lf), static_cast<float*>(y), static_cast<float*>(C), static_cast<float*>(n),
      static_cast<float*>(m), H, Sn, L, scale);
  return dacp_last_error();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* li, const void* lf, void* y, void* C,
               void* n, void* m, int Bn, int H, int Sn, int L, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_mlstm<T, 32>(q, k, v, li, lf, y, C, n, m, Bn, H, Sn, L, s);
    case 64:
      return launch_mlstm<T, 64>(q, k, v, li, lf, y, C, n, m, Bn, H, Sn, L, s);
    case 128:
      return launch_mlstm<T, 128>(q, k, v, li, lf, y, C, n, m, Bn, H, Sn, L, s);
    case 256:
      return launch_mlstm<T, 256>(q, k, v, li, lf, y, C, n, m, Bn, H, Sn, L, s);
    case 384:
      return launch_mlstm<T, 384>(q, k, v, li, lf, y, C, n, m, Bn, H, Sn, L, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v (B, S, H, D) in `dtype` (0 float32, 1 bfloat16); log_i, log_f
// (B, S, H), y (B, S, H, D), C (B, H, D, D), n (B, H, D) and m (B, H)
// float32; all contiguous.  L: chunk length, 1..256.
DACP_API int dacp_mlstm_chunk(const void* q, const void* k, const void* v, const void* log_i, const void* log_f,
                              void* y, void* C, void* n, void* m, int dtype, int Bn, int Sn, int H, int D, int L,
                              void* stream) {
  if (Bn <= 0 || Sn <= 0 || H <= 0 || L <= 0 || L > kThreads || (long long)Bn * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DACP_ATTN_F32) return dispatch_d<float>(D, q, k, v, log_i, log_f, y, C, n, m, Bn, H, Sn, L, s);
  if (dtype == DACP_ATTN_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, log_i, log_f, y, C, n, m, Bn, H, Sn, L, s);
  return (int)cudaErrorInvalidValue;
}
