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
//   Bound: bytes.  At the xlstm-125m prefill shape (b 4, s 1024, h 4, d
//   384, L 256, bf16) it moves about 72 MB (0.022 ms at 3.35 TB/s) for
//   about 13 GFLOP of products (0.013 ms at the bf16 tensor-core rate).
//
// Two designs, chosen by dtype (dispatch, not fallback):
//
// bfloat16 (every serving call): two kernels, counted as one launch by the
// wrapper, all products on the tensor cores (mma.sync m16n8k16 bf16 ->
// f32).  The TPU kernel walks the chunks in order because each needs the
// (C, n, m) the previous one left, and computes the chunk's outputs on the
// way.  Here the walk is split from the outputs:
//   1. mlstm_chunk_kernel_state, over (b·h, 64-row d_k block, value block):
//      the TPU kernel's carry chunk after chunk on one tile of C held in
//      registers (and the matching slice of n), leaving the state before
//      each chunk in float32 scratch and the final (C, n, m) in C, n, m;
//   2. mlstm_chunk_kernel_out, over (b·h, chunk, 128 query rows, value
//      block): every chunk's outputs from the state before it, all chunks
//      at once — 384 blocks at the serving shape against the CUDA-core
//      kernel's 96, which also recomputes the scores for each of its value
//      blocks.
// q·kᵀ has bf16 operands on both sides and is exact on the tensor cores.
// Every product with a float32 operand (k·wk, C_prev, s·D) splits that
// operand into bf16 hi + lo and issues two products into one f32
// accumulator (about 2^-17 relative, far inside the 5e-4 tolerance; TF32's
// 2^-11 would sit at it).  Row maxima, D = exp(·), the denominators and the
// carry's exponentials stay in float32.  Tiles move by 16-byte cp.async
// into shared memory padded for ldmatrix; the states between the kernels
// are float32 scratch the wrapper allocates (about 38 MB at the serving
// shape).
//
// float32 (mlstm_chunk_kernel: the tests and chip_smoke.py's f32 cases):
// the first kernel, its products as explicit float32 FMAs on the CUDA
// cores.  The TPU kernel keeps C (d, d) in VMEM scratch: 576 KB in float32
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
// of shared memory at d = 384: one block per SM.
#include "mma.cuh"
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

// ---------------------------------------------------------------------------
// bfloat16: two passes on the tensor cores
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int kJT = 64;   // key rows per tile
constexpr int kRT = 128;  // query rows per block of the output pass: 16 per warp

template <int D>
struct TwoPass {
  static constexpr int KB = D < 64 ? D : 64;    // d_k rows of a state block (16 per warp)
  static constexpr int VB = D < 128 ? D : 128;  // value columns of a block
  static constexpr int DS = D < 64 ? D : 64;    // width of a staged slice of d
  static constexpr int LK = KB + 8;             // bf16 row strides: 16 bytes of pad per row keep
  static constexpr int LV = VB + 8;             //   ldmatrix's eight rows on distinct banks
  static constexpr int NT = VB / 8;  // n8 tiles of a warp's output row
};

// Eight floats as bf16 hi and lo planes, 16 bytes each (16-byte aligned).
__device__ __forceinline__ void store_split8(bf16* hi, bf16* lo, const float (&x)[8]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bf16 h0, l0, h1, l1;
    split_bf16(x[2 * i], h0, l0);
    split_bf16(x[2 * i + 1], h1, l1);
    h[i] = pack_bf16x2(__bfloat162float(h0), __bfloat162float(h1));
    l[i] = pack_bf16x2(__bfloat162float(l0), __bfloat162float(l1));
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The chunk's cumulative log f (inclusive) and log i, one row per thread,
// into sCf / sLi; rows past Lc hold log f = 0 and log i = 0.
__device__ __forceinline__ float chunk_gates(const float* __restrict__ log_i, const float* __restrict__ log_f,
                                             long long row0, int H, int h, int Lc, float* sCf, float* sLi,
                                             float* sRed, float& li) {
  const int tid = threadIdx.x;
  const bool live = tid < Lc;
  li = live ? log_i[(row0 + tid) * H + h] : 0.f;
  const float lf = live ? log_f[(row0 + tid) * H + h] : 0.f;
  const float cf = block_inclusive_sum(lf, sRed);
  sCf[tid] = cf;
  sLi[tid] = li;
  __syncthreads();
  return cf;
}

// Pass 1, the states: the TPU kernel's carry, chunk after chunk, over one
// 64 × VB tile of C (and, for the first value block, that slice of n):
//   m_c = max(m_{c-1} + cf_last, max_j (cf_last - cf_j + li_j)),
//   C_c = e^{m_{c-1} + cf_last - m_c} C_{c-1} + sum_j e^{cf_last - cf_j + li_j - m_c} k_jᵀ v_j.
// Grid (B·H, D / KB, D / VB): the (d, d) state never sits whole in one
// block (576 KB at d = 384), and the tiles run in parallel.  The tile lives
// in registers (eight warps: four 16-row slices of d_k × two halves of the
// value columns); before chunk c it is written to slot c of the scratch for
// the output pass, and after the last chunk to C.  k·wk is float32, so it
// goes in as bf16 hi + lo: two products per key tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)  // three blocks an SM: 288 blocks at d = 384 in one wave
    mlstm_chunk_kernel_state(const bf16* __restrict__ k, const bf16* __restrict__ v, const float* __restrict__ log_i,
                             const float* __restrict__ log_f, float* __restrict__ Cs, float* __restrict__ ns,
                             float* __restrict__ mprev, float* __restrict__ C_out, float* __restrict__ n_out,
                             float* __restrict__ m_out, int H, int Sn, int L, int NC) {
  using P = TwoPass<D>;
  constexpr int KB = P::KB, VB = P::VB, LK = P::LK, LV = P::LV;
  constexpr int NTV = VB / 16;  // n8 tiles of a warp's half of the value columns
  constexpr int KP = KB / 8;    // 16-byte pieces of a k row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sKh = reinterpret_cast<bf16*>(smem);  // kJT × LK: k·wk, hi
  bf16* sKl = sKh + kJT * LK;                 // kJT × LK: k·wk, lo
  bf16* sV = sKl + kJT * LK;                  // kJT × LV
  float* sCf = reinterpret_cast<float*>(sV + kJT * LV);  // kThreads each
  float* sLi = sCf + kThreads;
  float* sWk = sLi + kThreads;
  float* sN = sWk + kThreads;     // KB: this block's slice of n
  float* sRed = sN + KB;          // 32
  float(*sNp)[9] = reinterpret_cast<float(*)[9]>(sRed + 32);  // kThreads × 9: the threads' shares of sum_j k·wk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * KB, v0 = blockIdx.z * VB;
  const int mk = warp & 3, vh = warp >> 2;  // this warp's 16 rows of d_k and half of the value columns
  const bool act = mk * 16 < KB;
  const bool with_n = blockIdx.z == 0;

  float acc[NTV][4];
#pragma unroll
  for (int j = 0; j < NTV; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (tid < KB) sN[tid] = 0.f;
  float m_prev = kNeg;

  for (int c = 0; c < NC; ++c) {
    const int c0 = c * L, Lc = min(L, Sn - c0);
    const long long row0 = (long long)b * Sn + c0;
    const long long slot = (long long)bh * NC + c;
    // the state before chunk c, for the output pass (chunk 0's is zero and never read)
    if (c > 0) {
      if (act) {
        float* cb = Cs + slot * D * D;
        const int r = k0 + mk * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < NTV; ++j) {
          const int col = v0 + vh * (VB / 2) + j * 8 + 2 * (lane & 3);
          *reinterpret_cast<float2*>(cb + (long long)r * D + col) = make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(cb + (long long)(r + 8) * D + col) = make_float2(acc[j][2], acc[j][3]);
        }
      }
      if (with_n && tid < KB) ns[slot * D + k0 + tid] = sN[tid];
    }
    if (blockIdx.y == 0 && blockIdx.z == 0 && tid == 0) mprev[slot] = m_prev;

    float li;
    const float cf = chunk_gates(log_i, log_f, row0, H, h, Lc, sCf, sLi, sRed, li);
    const float cf_last = sCf[Lc - 1];
    const bool live = tid < Lc;
    const float x = (cf_last - cf) + li;
    const float m_carry = fmaxf(m_prev + cf_last, block_max(live ? x : kNeg, sRed));
    sWk[tid] = live ? expf(x - m_carry) : 0.f;
    const float decay = expf(m_prev + cf_last - m_carry);
#pragma unroll
    for (int j = 0; j < NTV; ++j) {
      acc[j][0] *= decay;
      acc[j][1] *= decay;
      acc[j][2] *= decay;
      acc[j][3] *= decay;
    }
    __syncthreads();  // sWk

    float nacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int jt = 0; jt < Lc; jt += kJT) {
      for (int e = tid; e < kJT * (VB / 8); e += kThreads) {
        const int r = e / (VB / 8), cc = (e % (VB / 8)) * 8;
        const bool in = jt + r < Lc;
        cp_async16(sV + r * LV + cc, v + ((row0 + (in ? jt + r : 0)) * H + h) * D + v0 + cc, in);
      }
      cp_async_commit();
      for (int e = tid; e < kJT * KP; e += kThreads) {  // kThreads % KP == 0: each thread keeps its columns
        const int r = e / KP, cc = (e % KP) * 8;
        float xs[8];
        if (jt + r < Lc) {
          const uint4 raw = *reinterpret_cast<const uint4*>(k + ((row0 + jt + r) * H + h) * D + k0 + cc);
          const bf16* kv8 = reinterpret_cast<const bf16*>(&raw);
          const float w = sWk[jt + r];
#pragma unroll
          for (int i = 0; i < 8; ++i) xs[i] = __bfloat162float(kv8[i]) * w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) xs[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) nacc[i] += xs[i];
        store_split8(sKh + r * LK + cc, sKl + r * LK + cc, xs);
      }
      cp_async_wait<0>();
      __syncthreads();
      if (act) {
#pragma unroll
        for (int kk = 0; kk < kJT / 16; ++kk) {
          // A = (k·wk)ᵀ: 16 d_k rows × 16 key rows, read transposed from [key][d_k]
          const int mat = lane >> 3;
          const int ar = kk * 16 + (lane & 7) + (mat >> 1) * 8, ac = mk * 16 + (mat & 1) * 8;
          uint32_t ah[4], al[4];
          ldsm_x4_trans(ah, sKh + ar * LK + ac);
          ldsm_x4_trans(al, sKl + ar * LK + ac);
          const bf16* vr = sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LV + vh * (VB / 2) + (lane >> 4) * 8;
#pragma unroll
          for (int j = 0; j < NTV; j += 2) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, vr + j * 8);
            mma_bf16(acc[j], ah, bv[0], bv[1]);
            mma_bf16(acc[j], al, bv[0], bv[1]);
            mma_bf16(acc[j + 1], ah, bv[2], bv[3]);
            mma_bf16(acc[j + 1], al, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();
    }
    if (with_n) {  // n = decay n + sum_j k·wk over this block's d_k slice
#pragma unroll
      for (int i = 0; i < 8; ++i) sNp[tid][i] = nacc[i];
      __syncthreads();
      if (tid < KB) {
        const int grp = tid / 8, i = tid % 8;
        float sum = 0.f;
        for (int t = grp; t < kThreads; t += KP) sum += sNp[t][i];
        sN[tid] = decay * sN[tid] + sum;
      }
      __syncthreads();
    }
    m_prev = m_carry;
  }

  if (act) {
    float* cb = C_out + (long long)bh * D * D;
    const int r = k0 + mk * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NTV; ++j) {
      const int col = v0 + vh * (VB / 2) + j * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(cb + (long long)r * D + col) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(cb + (long long)(r + 8) * D + col) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  if (with_n && tid < KB) n_out[(long long)bh * D + k0 + tid] = sN[tid];
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid == 0) m_out[bh] = m_prev;
}

// Pass 2: the outputs of 128 rows of chunk c over VB value columns, from
// the state before the chunk (C_prev, n_prev, m_prev):
//   y_i = [inter_i s (q_i C_prev) + sum_{j<=i} s (q_i·k_j) D_ij v_j]
//         / max(|s (sum_j (q_i·k_j) D_ij + inter_i q_i·n_prev)|, e^{-m_i}).
// Grid (B·H·NC, ceil(L / 128), D / VB); each warp owns 16 rows.  q·kᵀ is
// exact in bf16; C_prev and s·D are float32 and go in as bf16 hi + lo.  The
// block's 128 × d query rows stay in shared memory for both products, and
// each 64-row key tile arrives whole (k over all of d, v over the block's
// columns), the next key tile's copy in flight behind the current one's
// products, so a key tile costs one wait, not one per slice of d.
template <int D>
__global__ void __launch_bounds__(kThreads)
    mlstm_chunk_kernel_out(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const float* __restrict__ log_i, const float* __restrict__ log_f,
                           const float* __restrict__ Cs, const float* __restrict__ ns, const float* __restrict__ mprev,
                           float* __restrict__ y, int H, int Sn, int L, int NC, float scale) {
  using P = TwoPass<D>;
  constexpr int VB = P::VB, DS = P::DS, LV = P::LV, NT = P::NT;
  constexpr int LQ = D + 8;   // bf16 per row of the resident q and k tiles
  constexpr int RP = D / 8;   // 16-byte pieces of a q or k row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // kRT × LQ
  bf16* sK = sQ + kRT * LQ;                  // kJT × LQ
  bf16* sV = sK + kJT * LQ;                  // kJT × LV
  bf16* sCh = sV + kJT * LV;                 // DS × LV: C_prev hi
  bf16* sCl = sCh + DS * LV;                 // DS × LV: C_prev lo
  float* sCf = reinterpret_cast<float*>(sCl + DS * LV);  // kThreads
  float* sLi = sCf + kThreads;                            // kThreads
  float* sMr = sLi + kThreads;                            // kRT: m_i
  float* sIn = sMr + kRT;                                 // kRT: inter_i
  float* sQn = sIn + kRT;                                 // kRT: q_i·n_prev
  float* sN = sQn + kRT;                                  // DS
  float* sRed = sN + DS;                                  // 32

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bhc = blockIdx.x, c = bhc % NC, bh = bhc / NC;
  const int b = bh / H, h = bh % H;
  const int i0 = blockIdx.y * kRT, v0 = blockIdx.z * VB;
  const int c0 = c * L, Lc = min(L, Sn - c0);
  if (i0 >= Lc) return;  // a row block past a short last chunk (uniform over the block)
  const long long row0 = (long long)b * Sn + c0;
  const float m_prev = mprev[bhc];

  auto stage_rows = [&](bf16* dst, const bf16* src, int r_begin, int rows) {  // rows × all of d, zero past Lc
    for (int e = tid; e < rows * RP; e += kThreads) {
      const int r = e / RP, cc = (e % RP) * 8;
      const bool in = r_begin + r < Lc;
      cp_async16(dst + r * LQ + cc, src + ((row0 + (in ? r_begin + r : 0)) * H + h) * D + cc, in);
    }
  };
  auto stage_v = [&](int jt) {
    for (int e = tid; e < kJT * (VB / 8); e += kThreads) {
      const int r = e / (VB / 8), cc = (e % (VB / 8)) * 8;
      const bool in = jt + r < Lc;
      cp_async16(sV + r * LV + cc, v + ((row0 + (in ? jt + r : 0)) * H + h) * D + v0 + cc, in);
    }
  };
  // every copy the block can start now: its q rows, then the first key tile
  stage_rows(sQ, q, i0, kRT);
  stage_rows(sK, k, 0, kJT);
  stage_v(0);
  cp_async_commit();

  float li;
  chunk_gates(log_i, log_f, row0, H, h, Lc, sCf, sLi, sRed, li);
  if (tid < kRT) {  // per-row stabiliser m_i and inter_i
    const int gi = i0 + tid;
    float mi = 0.f, inter = 0.f;
    if (gi < Lc) {
      const float cfi = sCf[gi];
      float mrow = kNeg;
      for (int j = 0; j <= gi; ++j) mrow = fmaxf(mrow, (cfi - sCf[j]) + sLi[j]);
      const float brow = cfi + m_prev;
      mi = fmaxf(mrow, brow);
      inter = expf(brow - mi);
    }
    sMr[tid] = mi;
    sIn[tid] = inter;
    sQn[tid] = 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int wr0 = i0 + warp * 16;  // this warp's first row in the chunk
  const bool rows_live = wr0 < Lc;
  const int mat = lane >> 3;
  const bf16* qa = sQ + (warp * 16 + (lane & 7) + (mat & 1) * 8) * LQ + (mat >> 1) * 8;

  if (c > 0) {  // inter_i s (q_i C_prev) and q_i·n_prev (chunk 0 starts from zeros)
    const float* cp = Cs + (long long)bhc * D * D;
    constexpr int CP = DS * (VB / 8);                  // 8-float pieces of a slice of C
    constexpr int CPT = (CP + kThreads - 1) / kThreads;  // per thread
    float4 cnext[CPT][2];  // the next slice of C, loaded while this one is multiplied
    auto load_c = [&](int d0) {
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int e = tid + u * kThreads, r = e / (VB / 8), cc = (e % (VB / 8)) * 8;
        if (e >= CP) continue;
        cnext[u][0] = *reinterpret_cast<const float4*>(cp + (long long)(d0 + r) * D + v0 + cc);
        cnext[u][1] = *reinterpret_cast<const float4*>(cp + (long long)(d0 + r) * D + v0 + cc + 4);
      }
    };
    load_c(0);
    float qn = 0.f;
    for (int d0 = 0; d0 < D; d0 += DS) {
      __syncthreads();  // the previous slice's reads are done
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int e = tid + u * kThreads, r = e / (VB / 8), cc = (e % (VB / 8)) * 8;
        if (e >= CP) continue;
        const float xs[8] = {cnext[u][0].x, cnext[u][0].y, cnext[u][0].z, cnext[u][0].w,
                             cnext[u][1].x, cnext[u][1].y, cnext[u][1].z, cnext[u][1].w};
        store_split8(sCh + r * LV + cc, sCl + r * LV + cc, xs);
      }
      if (d0 + DS < D) load_c(d0 + DS);
      if (tid < DS) sN[tid] = ns[(long long)bhc * D + d0 + tid];
      if (d0 == 0) cp_async_wait<0>();  // the q rows (and the first key tile)
      __syncthreads();
      {  // q·n_prev: two threads a row, half a slice each
        const int r = tid >> 1, half = (tid & 1) * (DS / 2);
        for (int dd = half; dd < half + DS / 2; ++dd) qn = fmaf(__bfloat162float(sQ[r * LQ + d0 + dd]), sN[dd], qn);
      }
      if (rows_live) {
#pragma unroll
        for (int kk = 0; kk < DS / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, qa + d0 + kk * 16);
          const int cr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t bh4[4], bl4[4];
            ldsm_x4_trans(bh4, sCh + cr * LV + (j + (lane >> 4)) * 8);
            ldsm_x4_trans(bl4, sCl + cr * LV + (j + (lane >> 4)) * 8);
            mma_bf16(acc[j], a, bh4[0], bh4[1]);
            mma_bf16(acc[j], a, bl4[0], bl4[1]);
            mma_bf16(acc[j + 1], a, bh4[2], bh4[3]);
            mma_bf16(acc[j + 1], a, bl4[2], bl4[3]);
          }
        }
      }
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    if ((tid & 1) == 0) sQn[tid >> 1] = qn;
  }
  __syncthreads();
  const int r_lo = warp * 16 + (lane >> 2);  // this lane's two rows in the block: r_lo, r_lo + 8
  const float f0 = sIn[r_lo] * scale, f1 = sIn[r_lo + 8] * scale;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= f0;
    acc[j][1] *= f0;
    acc[j][2] *= f1;
    acc[j][3] *= f1;
  }

  float rs[2] = {0.f, 0.f};  // this lane's share of sum_j (q_i·k_j) D_ij
  const int j_end = min(Lc, i0 + kRT);
  for (int jt = 0; jt < j_end; jt += kJT) {
    cp_async_wait<0>();  // this key tile's k and v
    __syncthreads();
    const bool act = rows_live && wr0 + 15 >= jt;  // some row of the warp at or below the tile's first key
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (act) {
      const bf16* kr = sK + ((lane & 7) + (lane >> 4) * 8) * LQ + ((lane >> 3) & 1) * 8;
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qa + kk * 16);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t bk[4];
          ldsm_x4(bk, kr + j * 8 * LQ + kk * 16);
          mma_bf16(s[j], a, bk[0], bk[1]);
          mma_bf16(s[j + 1], a, bk[2], bk[3]);
        }
      }
    }
    const bool more = jt + kJT < j_end;
    if (more) {  // the next key tile's k, behind this tile's weights and PV
      __syncthreads();
      stage_rows(sK, k, jt + kJT, kJT);
      cp_async_commit();
    }
    if (act) {
      // D-weighted scores: s·D·scale for the PV product, (q·k)·D for the denominator
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = r_lo + 8 * (e >> 1), gi = i0 + rl;
          const int gj = jt + j * 8 + 2 * (lane & 3) + (e & 1);
          float sd = 0.f;
          if (gj <= gi && gi < Lc) {
            const float dij = expf((sCf[gi] - sCf[gj]) + sLi[gj] - sMr[rl]);
            rs[e >> 1] += s[j][e] * dij;
            sd = s[j][e] * scale * dij;
          }
          s[j][e] = sd;
        }
      const bf16* vr = sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * LV + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kJT / 16; ++kk) {
        uint32_t ah[4], al[4];
        const float(&s0)[4] = s[2 * kk];
        const float(&s1)[4] = s[2 * kk + 1];
        const float fr[8] = {s0[0], s0[1], s0[2], s0[3], s1[0], s1[1], s1[2], s1[3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bf16 h0, l0, h1, l1;
          split_bf16(fr[2 * i], h0, l0);
          split_bf16(fr[2 * i + 1], h1, l1);
          ah[i] = pack_bf16x2(__bfloat162float(h0), __bfloat162float(h1));
          al[i] = pack_bf16x2(__bfloat162float(l0), __bfloat162float(l1));
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vr + kk * 16 * LV + j * 8);
          mma_bf16(acc[j], ah, bv[0], bv[1]);
          mma_bf16(acc[j], al, bv[0], bv[1]);
          mma_bf16(acc[j + 1], ah, bv[2], bv[3]);
          mma_bf16(acc[j + 1], al, bv[2], bv[3]);
        }
      }
    }
    if (more) {  // and its v, once this tile's PV is done
      __syncthreads();
      stage_v(jt + kJT);
      cp_async_commit();
    }
  }

  if (!rows_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = r_lo + 8 * r, gi = i0 + rl;
    if (gi >= Lc) continue;
    const float den = fmaxf(fabsf(rs[r] + sIn[rl] * sQn[rl]) * scale, expf(-sMr[rl]));
    float* yr = y + ((row0 + gi) * H + h) * D + v0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(yr + col) = make_float2(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
    }
  }
}

template <int D>
size_t state_smem_bytes() {
  using P = TwoPass<D>;
  return (size_t)(2 * kJT * P::LK + kJT * P::LV) * sizeof(bf16) +
         (size_t)(3 * kThreads + P::KB + 32 + 9 * kThreads) * sizeof(float);
}

template <int D>
size_t out_smem_bytes() {
  using P = TwoPass<D>;
  return (size_t)((kRT + kJT) * (D + 8) + kJT * P::LV + 2 * P::DS * P::LV) * sizeof(bf16) +
         (size_t)(2 * kThreads + 3 * kRT + P::DS + 32) * sizeof(float);
}

template <int D>
int launch_two_pass(const void* q, const void* k, const void* v, const void* li, const void* lf, void* y, void* C,
                    void* n, void* m, int Bn, int H, int Sn, int L, float* Cs, float* ns, float* mprev,
                    cudaStream_t stream) {
  using P = TwoPass<D>;
  const int NC = (Sn + L - 1) / L;
  const float* fli = static_cast<const float*>(li);
  const float* flf = static_cast<const float*>(lf);
  const size_t smem1 = state_smem_bytes<D>();
  int rc = attn_allow_smem(mlstm_chunk_kernel_state<D>, smem1);
  if (rc != 0) return rc;
  mlstm_chunk_kernel_state<D><<<dim3(Bn * H, D / P::KB, D / P::VB), kThreads, smem1, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), fli, flf, Cs, ns, mprev, static_cast<float*>(C),
      static_cast<float*>(n), static_cast<float*>(m), H, Sn, L, NC);
  rc = dacp_last_error();
  if (rc != 0) return rc;
  const size_t smem = out_smem_bytes<D>();
  rc = attn_allow_smem(mlstm_chunk_kernel_out<D>, smem);
  if (rc != 0) return rc;
  const float scale = (float)(1.0 / sqrt((double)D));
  mlstm_chunk_kernel_out<D><<<dim3(Bn * H * NC, (L + kRT - 1) / kRT, D / P::VB), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), fli, flf, Cs, ns, mprev,
      static_cast<float*>(y), H, Sn, L, NC, scale);
  return dacp_last_error();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* li, const void* lf, void* y, void* C,
               void* n, void* m, int Bn, int H, int Sn, int L, cudaStream_t stream) {
  const size_t smem = (size_t)MlstmSmem<D>::kTotal * sizeof(float);
  const int rc = attn_allow_smem(mlstm_chunk_kernel<float, D>, smem);
  if (rc != 0) return rc;
  const dim3 grid(Bn * H, D / MlstmSmem<D>::kDS);
  const float scale = (float)(1.0 / sqrt((double)D));
  mlstm_chunk_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(li), static_cast<const float*>(lf), static_cast<float*>(y), static_cast<float*>(C),
      static_cast<float*>(n), static_cast<float*>(m), H, Sn, L, scale);
  return dacp_last_error();
}

template <int D>
int launch_mlstm(int dtype, const void* q, const void* k, const void* v, const void* li, const void* lf, void* y,
                 void* C, void* n, void* m, int Bn, int H, int Sn, int L, float* const* scratch, cudaStream_t s) {
  if (dtype == DACP_ATTN_F32) return launch_f32<D>(q, k, v, li, lf, y, C, n, m, Bn, H, Sn, L, s);
  if (dtype != DACP_ATTN_BF16) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (scratch[i] == nullptr) return (int)cudaErrorInvalidValue;
  return launch_two_pass<D>(q, k, v, li, lf, y, C, n, m, Bn, H, Sn, L, scratch[0], scratch[1], scratch[2], s);
}

}  // namespace

// q, k, v (B, S, H, D) in `dtype` (0 float32, 1 bfloat16); log_i, log_f
// (B, S, H), y (B, S, H, D), C (B, H, D, D), n (B, H, D) and m (B, H)
// float32; all contiguous (bfloat16 rows 16-byte aligned).  L: chunk
// length, 1..256.  The bfloat16 kernels' float32 scratch, NC = ceil(S / L)
// chunks, slot c holding the state before chunk c: Cs (B·H, NC, D, D), ns
// (B·H, NC, D) and mprev (B·H, NC); float32 takes none (null pointers).
DACP_API int dacp_mlstm_chunk(const void* q, const void* k, const void* v, const void* log_i, const void* log_f,
                              void* y, void* C, void* n, void* m, int dtype, int Bn, int Sn, int H, int D, int L,
                              void* Cs, void* ns, void* mprev, void* stream) {
  if (Bn <= 0 || Sn <= 0 || H <= 0 || L <= 0 || L > kThreads || (long long)Bn * H * ((Sn + L - 1) / L) > 2147483647LL ||
      (long long)Bn * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const scratch[3] = {static_cast<float*>(Cs), static_cast<float*>(ns), static_cast<float*>(mprev)};
  switch (D) {
    case 32:
      return launch_mlstm<32>(dtype, q, k, v, log_i, log_f, y, C, n, m, Bn, H, Sn, L, scratch, s);
    case 64:
      return launch_mlstm<64>(dtype, q, k, v, log_i, log_f, y, C, n, m, Bn, H, Sn, L, scratch, s);
    case 128:
      return launch_mlstm<128>(dtype, q, k, v, log_i, log_f, y, C, n, m, Bn, H, Sn, L, scratch, s);
    case 256:
      return launch_mlstm<256>(dtype, q, k, v, log_i, log_f, y, C, n, m, Bn, H, Sn, L, scratch, s);
    case 384:
      return launch_mlstm<384>(dtype, q, k, v, log_i, log_f, y, C, n, m, Bn, H, Sn, L, scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
