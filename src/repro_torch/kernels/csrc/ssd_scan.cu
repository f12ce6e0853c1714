// ssd_scan: the Mamba2 SSD chunk scan, float32 state (p, n) carried across
// chunks.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan, body
// _kernel).  Same function, per chunk of L rows with cs = cumsum(dt·A):
//
//   y_i   = sum_{j<=i} exp(cs_i - cs_j) (C_i·B_j) dt_j x_j + exp(cs_i) C_i·S_prev
//   S_new = exp(cs_L) S_prev + sum_j exp(cs_L - cs_j) dt_j x_j B_jᵀ
//
//   x (b, s, h, p) and B, C (b, s, n) in float32 or bfloat16, dt (b, s, h)
//   and A (h,) float32, all contiguous; y (b, s, h, p) float32 and, unlike
//   the TPU kernel, the final state S (b, h, p, n) float32, which prefill
//   hands to the decode cache.  Any s: the last chunk may be shorter (the
//   TPU kernel asserts s % L == 0); rows past s are neither read nor
//   written.  p is 32 or 64, n 16, 32, 64 or 128, L at most 256.
//
//   Bound: bytes.  At the zamba2-1.2b prefill shape (b 4, s 1024, h 64,
//   p 64, n 64, L 256, bf16) the function moves about 107 MB (0.032 ms at
//   3.35 TB/s), 63% of it the float32 y, for 12.9 GFLOP of products below
//   the chunks' diagonals (0.013 ms at the bf16 tensor-core rate).
//
// Two designs, chosen by dtype (dispatch, not fallback):
//
// bfloat16 (every serving call): three kernels, counted as one launch by
// the wrapper, every product on the tensor cores (mma.sync m16n8k16 bf16 ->
// f32).  The TPU kernel walks the chunks in order with the state in VMEM;
// here the chunk axis is parallel and only the small carry is sequential:
//   1. ssd_scan_kernel_state, over (b, chunk, group of 4 heads): each
//      chunk's own end state local_c = sum_j w_j x_j B_jᵀ (w_j =
//      exp(cs_L - cs_j) dt_j), its total decay cs_L and its per-row and
//      per-slice decay tables, all chunks at once, into scratch the
//      wrapper allocates (about 48 MB at the serving shape);
//   2. ssd_scan_kernel_carry, one float4 of a state a thread: S_prev(c) =
//      S, then S = exp(cs_L) S + local_c, chunk after chunk, the chunks'
//      local states read four ahead of the chain (a one-element-a-thread
//      scan waiting on each load would be latency-bound); it writes each
//      S_prev as bf16 hi, mid and lo planes and the final state;
//   3. ssd_scan_kernel_out, over (b, chunk, group of 4 heads): every row's
//      y = M·x + exp(cs_i) C·S_prevᵀ.
// B and C do not depend on the head (Mamba2's one group): a block of pass
// 3 loads the chunk's B and C rows once for its heads and keeps its C rows
// in registers as mma fragments; C·Bᵀ is recomputed per head on the tensor
// cores (8 mma per 16 × 16 slice against the 16 of M·x: sharing it across
// heads would save a third of the products for 32 more accumulator
// registers per head, beyond the 191 the kernel holds).  Each of the 8
// warps owns two 16-row blocks of the chunk, rb and 15 - rb, so every warp
// meets the same number of 16-key slices at or below the diagonal.  A
// slice's C·Bᵀ accumulator becomes M in registers and is repacked as the A
// fragment of M·x.  C·Bᵀ has bf16 operands on both sides and is exact; M,
// S_prev and x·w are float32 and go in as bf16 parts, one product each
// into one f32 accumulator (bf16 alone is 2^-9 relative and TF32 2^-11,
// both beyond the 2e-4 tolerance; bf16 parts keep one instruction shape
// and one fragment layout for all three products).  M takes hi + lo (about
// 2^-17).  x·w and S_prev take hi + mid + lo (float32's own precision):
// their errors reach y through the carry, summed over every earlier chunk,
// and with two parts a head whose state barely decays (A near -0.01, 16
// chunks of 256) reached 1.15× the tolerance.  exp(cs_i - cs_j)
// is taken per element only on the diagonal slice, where j <= i is masked;
// below it the decay factors as exp(cs_i - cs_r0) · exp(cs_r0 - cs_r1) ·
// exp(cs_r1 - cs_j) with r0 the row block's first row and r1 the slice's
// end, three factors at most 1 from pass 1's tables, so nothing above the
// diagonal is ever exponentiated.  B, C, x, S_prev and the tables arrive by
// 16-byte cp.async, the next head's behind the current head's products
// (one barrier a head); y rows leave as 16-byte stores after one shuffle
// between lane pairs, and the heads of a row are contiguous in y.
//
// float32 (ssd_scan_kernel: the tests' reduced and f32 cases): the first
// kernel, its products as explicit float32 FMAs on the CUDA cores (the
// library builds with -fmad=false).  The TPU grid walks (b, h, chunk) with
// the chunk axis sequential and the state in VMEM scratch, and holds a
// chunk's whole (L, L) decay × score matrix: 256 KB in float32 at L = 256,
// more than a block's shared memory.  Here one block owns one (b, h) and
// walks the chunks itself, with S (p × n) and the chunk's cumulative dA in
// shared memory.  Within a chunk it goes over 64-row query tiles and, for
// each, the 64-row key tiles at or below the diagonal: a 64 × 64 tile of M
// is formed in shared memory and multiplied into the thread's y
// accumulators (4 rows × p/16 columns).  exp(cs_i − cs_j) is taken only
// for i >= j, where it is at most 1: above the diagonal it could overflow.
// All query tiles read S_prev first; the state update then walks the key
// tiles once more.  Shared rows of length n carry one float of padding so
// that column reads are conflict-free.
//
// Tried and dropped (NVIDIA H100 80GB HBM3, 700 W, serving shape): the
// CUDA-core kernel for bfloat16 too (0.915 ms, 3.5% of its bound: float32
// FMAs fed from shared memory, one block per (b, h) walking the chunks in
// order, C·Bᵀ recomputed by every head's block); two tensor-core kernels
// with the carry in the output kernel's prologue, each block summing the
// earlier chunks' local states from L2 and computing its decay tables
// (0.167 ms: the prologue cost 0.018 ms, and its barriers kept the block's
// one wave of 8 warps from overlapping loads with products); 1, 2 or 8
// heads a block instead of 4 (within 0.01 ms); pass 1 with 16 warps and x
// staged by cp.async (0.051 against 0.046 ms).  Pass 1 stays latency-bound
// (0.047 ms for 31 MB with two-part splits): its x loads and split (0.017
// ms) and its products (0.015 ms) follow each other for each head, in two
// rounds of 128 key rows so that its three planes leave room for two
// blocks an SM.
#include "mma.cuh"
#include "scan.cuh"  // block scans; float32 / bfloat16 element conversions

namespace {

constexpr int kThreads = kScanThreads;  // also the longest chunk: one chunk row per thread
constexpr int kT = 64;         // rows per query or key tile
constexpr int kLM = kT + 1;    // row stride of the M tile

// shared-memory layout, in floats
template <int P, int N>
struct SsdSmem {
  static constexpr int kS = 0;                     // P × (N+1): the state
  static constexpr int kCs = kS + P * (N + 1);     // kThreads: cumulative dA of the chunk
  static constexpr int kDt = kCs + kThreads;       // kThreads: dt of the chunk
  static constexpr int kCq = kDt + kThreads;       // kT × (N+1): C rows of the query tile
  static constexpr int kBk = kCq + kT * (N + 1);   // kT × (N+1): B rows of the key tile
  static constexpr int kXk = kBk + kT * (N + 1);   // kT × P: x rows of the key tile (× w in the update)
  static constexpr int kM = kXk + kT * P;          // kT × kLM
  static constexpr int kWarp = kM + kT * kLM;      // 32: warp totals of the scan
  static constexpr int kTotal = kWarp + 32;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                    const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ S_out, int H, int Sn, int L, int G) {
  using O = SsdSmem<P, N>;
  constexpr int PC = P / 16;               // y columns per thread
  constexpr int SE = P * N / kThreads;     // state entries per thread in the update
  constexpr int LN = N + 1;
  static_assert(P * N % kThreads == 0, "state entries must spread evenly over the block");
  extern __shared__ __align__(16) float sm[];
  float* sS = sm + O::kS;
  float* sCs = sm + O::kCs;
  float* sDt = sm + O::kDt;
  float* sCq = sm + O::kCq;
  float* sBk = sm + O::kBk;
  float* sXk = sm + O::kXk;
  float* sM = sm + O::kM;
  float* sWarp = sm + O::kWarp;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int ty = tid / 16, tx = tid % 16;  // tile rows ty*4 + i, columns tx + 16*j
  const float a = A[h];
  const long long row0 = (long long)b * Sn;  // (b, 0) in rows of (b, s)
  const int GN = G * N;                      // B and C rows: (b, s) then G groups of N
  Bm += (h / (H / G)) * N;                   // this head's group
  Cm += (h / (H / G)) * N;

  for (int e = tid; e < P * LN; e += kThreads) sS[e] = 0.f;

  for (int c0 = 0; c0 < Sn; c0 += L) {
    const int Lc = min(L, Sn - c0);
    __syncthreads();  // the previous chunk is done with sDt, sCs and the tiles
    const float d = tid < Lc ? dt[(row0 + c0 + tid) * H + h] : 0.f;  // dt = 0 past the chunk
    sDt[tid] = d;
    sCs[tid] = block_inclusive_sum(d * a, sWarp);
    __syncthreads();

    // y, one 64-row query tile at a time
    for (int i0 = 0; i0 < Lc; i0 += kT) {
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, k = e % N;
        sCq[r * LN + k] = i0 + r < Lc ? attn_to_f<T>(Cm[(row0 + c0 + i0 + r) * GN + k]) : 0.f;
      }
      __syncthreads();

      // from the state before the chunk: exp(cs_i) · C_i · S_prev[p, :]
      float acc[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float cv[4], sv[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sCq[(ty * 4 + i) * LN + k];
#pragma unroll
        for (int j = 0; j < PC; ++j) sv[j] = sS[(tx + 16 * j) * LN + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(sCs[i0 + ty * 4 + i]);
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] *= e;
      }

      // within the chunk: key tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();  // the previous key tile's reads of sBk, sXk and sM are done
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, k = e % N;
          sBk[r * LN + k] = j0 + r < Lc ? attn_to_f<T>(Bm[(row0 + c0 + j0 + r) * GN + k]) : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int r = e / P, p = e % P;
          sXk[e] = j0 + r < Lc ? attn_to_f<T>(x[((row0 + c0 + j0 + r) * H + h) * P + p]) : 0.f;
        }
        __syncthreads();

        float mv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) mv[i][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sCq[(ty * 4 + i) * LN + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = sBk[(tx + 16 * c) * LN + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) mv[i][c] = fmaf(cv[i], bv[c], mv[i][c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gi = i0 + ty * 4 + i, gj = j0 + tx + 16 * c;
            float m = 0.f;
            if (gi >= gj) m = mv[i][c] * expf(sCs[gi] - sCs[gj]) * sDt[gj];
            sM[(ty * 4 + i) * kLM + tx + 16 * c] = m;
          }
        __syncthreads();

#pragma unroll 4
        for (int k = 0; k < kT; ++k) {
          float xv[PC];
#pragma unroll
          for (int j = 0; j < PC; ++j) xv[j] = sXk[k * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float m = sM[(ty * 4 + i) * kLM + k];
#pragma unroll
            for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(m, xv[j], acc[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = i0 + ty * 4 + i;
        if (gi >= Lc) continue;
        float* yr = y + ((row0 + c0 + gi) * H + h) * P;
#pragma unroll
        for (int j = 0; j < PC; ++j) yr[tx + 16 * j] = acc[i][j];
      }
      __syncthreads();  // every row of this tile is done with sCq
    }

    // the state at the end of the chunk
    const float cs_last = sCs[Lc - 1];
    float sacc[SE];
#pragma unroll
    for (int s = 0; s < SE; ++s) sacc[s] = 0.f;
    for (int j0 = 0; j0 < Lc; j0 += kT) {
      __syncthreads();  // the previous key tile's reads are done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, k = e % N;
        sBk[r * LN + k] = j0 + r < Lc ? attn_to_f<T>(Bm[(row0 + c0 + j0 + r) * GN + k]) : 0.f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int r = e / P, p = e % P;
        float v = 0.f;
        if (j0 + r < Lc) {
          const float w = expf(cs_last - sCs[j0 + r]) * sDt[j0 + r];
          v = attn_to_f<T>(x[((row0 + c0 + j0 + r) * H + h) * P + p]) * w;
        }
        sXk[e] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kT; ++k) {
#pragma unroll
        for (int s = 0; s < SE; ++s) {
          const int e = tid + s * kThreads;
          sacc[s] = fmaf(sXk[k * P + e / N], sBk[k * LN + e % N], sacc[s]);
        }
      }
    }
    const float decay = expf(cs_last);
#pragma unroll
    for (int s = 0; s < SE; ++s) {  // each entry belongs to one thread: no other reader now
      const int e = tid + s * kThreads;
      float* sp = sS + (e / N) * LN + e % N;
      *sp = *sp * decay + sacc[s];
    }
  }

  __syncthreads();
  float* so = S_out + (long long)blockIdx.x * P * N;
  for (int e = tid; e < P * N; e += kThreads) so[e] = sS[(e / N) * LN + e % N];
}


// ---------------------------------------------------------------------------
// bfloat16: chunk states, then every chunk's outputs, on the tensor cores
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int kWarps = kThreads / 32;
constexpr int kRB = 16;                 // rows of a row block: one m16 tile
constexpr int kMaxRB = kThreads / kRB;  // row blocks of the longest chunk
constexpr int kHB = 4;                  // heads of one block of passes 1 and 3

template <int P, int N>
struct Tc {
  static constexpr int LN = N + 8;  // bf16 row strides: 16 bytes of pad per row keep
  static constexpr int LP = P + 8;  //   ldmatrix's eight rows on distinct banks
};

// float32 scratch of the bfloat16 passes (see dacp_ssd_scan).
struct Scratch {
  float* Ls;
  float* Tl;
  float* Tb;
  bf16* Sp;
};

// Rows [0, rows) of a (·, W) bf16 table into shared memory at row stride
// LD, 16 bytes a copy, zero from row `live` on; src points at row 0 and
// rows step by `stride` elements.
template <int W, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, long long stride, int rows,
                                           int live) {
  constexpr int PIECES = W / 8;
  for (int e = threadIdx.x; e < rows * PIECES; e += kThreads) {
    const int r = e / PIECES, cc = (e % PIECES) * 8;
    const bool in = r < live;
    cp_async16(dst + r * LD + cc, src + (in ? r : 0) * stride + cc, in);
  }
}

// Eight floats as bf16 hi, mid and lo planes `plane` elements apart, 16
// bytes each (16-byte aligned).
__device__ __forceinline__ void store_split3x8(bf16* dst, int plane, const float (&v)[8]) {
  uint32_t w[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bf16 a[3], b[3];
    split3_bf16(v[2 * i], a[0], a[1], a[2]);
    split3_bf16(v[2 * i + 1], b[0], b[1], b[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k][i] = pack_bf16x2(__bfloat162float(a[k]), __bfloat162float(b[k]));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) *reinterpret_cast<uint4*>(dst + k * plane) = make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
}

// Per-row and per-slice decay tables of one (b, h, chunk), kTables rows
// of kThreads floats in the order below; rows past the chunk hold dt = 0.
constexpr int kTables = 6;
constexpr int kHalf = kThreads / 2;  // key rows of pass 1's split planes: a chunk takes two rounds
enum { T_CS = 0, T_DT, T_BJ, T_AL, T_E, T_BETA };

// Pass 1: local_c[p, n] = sum_j w_j x_j[p] B_j[n] with w_j = exp(cs_L -
// cs_j) dt_j, T_c = cs_L and the decay tables of pass 3, for every (b,
// chunk) of the grid and the block's heads.  A = (x·w)ᵀ (p × j) is
// float32, split into bf16 hi + mid + lo planes as it is staged, 128 key
// rows at a time (two blocks an SM); B (j × n) is loaded once for the
// heads, and the next head's x is read while this head's products run.
// Each warp owns (16 rows of p) × (16 columns of n) units of the state.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel_state(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                          const bf16* __restrict__ Bm, float* __restrict__ Ls, float* __restrict__ Tl,
                          float* __restrict__ Tb, int H, int Sn, int L, int NC, int HB, int G) {
  constexpr int LN = Tc<P, N>::LN, LP = Tc<P, N>::LP;
  constexpr int MT = P / 16;
  constexpr int UNITS = MT * (N / 16);
  constexpr int UW = (UNITS + kWarps - 1) / kWarps;  // units per warp
  constexpr int XP = P / 8;                          // 16-byte pieces of an x row
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PL = kHalf * LP;             // bf16 of one plane
  bf16* sB = reinterpret_cast<bf16*>(smem);  // kThreads × LN
  bf16* sX = sB + kThreads * LN;             // 3 planes of kHalf × LP: x·w, hi, mid and lo
  float* sW = reinterpret_cast<float*>(sX + 3 * PL);  // kThreads
  float* sCs = sW + kThreads;                                  // kThreads
  float* sRed = sCs + kThreads;                                // 32

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / NC, c = blockIdx.x % NC;
  const int h0 = blockIdx.y * HB;
  const int nh = min(HB, H - h0);
  const int c0 = c * L, Lc = min(L, Sn - c0);
  const int R16 = (Lc + kRB - 1) / kRB * kRB;
  const long long row0 = (long long)b * Sn + c0;

  // the block's heads share one group (the wrapper checks): B rows step by G·N
  stage_rows<N, LN>(sB, Bm + row0 * G * N + (h0 / (H / G)) * N, (long long)G * N, R16, Lc);
  cp_async_commit();
  // x pieces of the next round to split: round k's rows [128 k, 128 k + 128)
  // are pieces u = k·XP/2 .. of thread tid (row (tid + u·256) / XP)
  uint4 raw[XP / 2];
  auto load_x = [&](int h, int k) {
#pragma unroll
    for (int i = 0; i < XP / 2; ++i) {
      const int e = tid + (k * XP / 2 + i) * kThreads, r = e / XP, cc = (e % XP) * 8;
      raw[i] = r < Lc ? *reinterpret_cast<const uint4*>(x + ((row0 + r) * H + h) * P + cc) : make_uint4(0, 0, 0, 0);
    }
  };
  load_x(h0, 0);
  float d_next = tid < Lc ? dt[(row0 + tid) * H + h0] : 0.f;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float d = d_next;
    d_next = tid < Lc && hh + 1 < nh ? dt[(row0 + tid) * H + h + 1] : 0.f;
    const float cs = block_inclusive_sum(d * A[h], sRed);  // rows past Lc add dA = 0
    sCs[tid] = cs;
    __syncthreads();
    const float cs_last = sCs[Lc - 1];
    sW[tid] = tid < Lc ? expf(cs_last - cs) * d : 0.f;
    {
      const long long slot = ((long long)b * H + h) * NC + c;
      float* tb = Tb + slot * kTables * kThreads + tid;
      const int rb = tid / kRB, k = tid % kRB;
      tb[T_CS * kThreads] = cs;
      tb[T_DT * kThreads] = d;
      tb[T_BJ * kThreads] = expf(sCs[min((rb + 1) * kRB, kThreads - 1)] - cs) * d;
      tb[T_AL * kThreads] = expf(cs - sCs[rb * kRB]);
      tb[T_E * kThreads] = expf(cs);
      tb[T_BETA * kThreads] = k < rb ? expf(sCs[rb * kRB] - sCs[(k + 1) * kRB]) : 0.f;
      if (tid == 0) Tl[slot] = cs_last;
    }
    __syncthreads();

    float acc[UW][2][4];
#pragma unroll
    for (int u = 0; u < UW; ++u)
#pragma unroll
      for (int t = 0; t < 2; ++t) acc[u][t][0] = acc[u][t][1] = acc[u][t][2] = acc[u][t][3] = 0.f;
    const int mat = lane >> 3;
    for (int half = 0; half < R16; half += kHalf) {
      const int rows = min(kHalf, R16 - half);
      // x·w as bf16 hi + mid + lo, rows past Lc zero
#pragma unroll
      for (int i = 0; i < XP / 2; ++i) {
        const int e = tid + (half / kHalf * XP / 2 + i) * kThreads, r = e / XP, cc = (e % XP) * 8;
        if (r >= half + rows) continue;
        const bf16* xv = reinterpret_cast<const bf16*>(&raw[i]);
        const float w = sW[r];
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(xv[i]) * w;
        store_split3x8(sX + (r - half) * LP + cc, PL, v);
      }
      cp_async_wait<0>();  // B (the first head only)
      __syncthreads();
      if (half + kHalf < R16) {  // the next round's x, in flight behind this round's products
        load_x(h, half / kHalf + 1);
      } else if (hh + 1 < nh) {
        load_x(h + 1, 0);
      }

      for (int kk = 0; kk < rows / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < UW; ++u) {
          const int unit = warp + u * kWarps;
          if (unit >= UNITS) continue;
          const int mt = unit % MT, np = unit / MT;
          // A = (x·w)ᵀ: 16 rows of p × 16 keys, read transposed from [key][p]
          const bf16* ap = sX + (kk * 16 + (lane & 7) + (mat >> 1) * 8) * LP + mt * 16 + (mat & 1) * 8;
          uint32_t a[3][4], bv[4];
#pragma unroll
          for (int k = 0; k < 3; ++k) ldsm_x4_trans(a[k], ap + k * PL);
          ldsm_x4_trans(bv, sB + (half + kk * 16 + (lane & 7) + (mat & 1) * 8) * LN + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            mma_bf16(acc[u][0], a[k], bv[0], bv[1]);
            mma_bf16(acc[u][1], a[k], bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // the planes are rewritten by the next round
    }
    float* lb = Ls + (((long long)b * H + h) * NC + c) * P * N;
#pragma unroll
    for (int u = 0; u < UW; ++u) {
      const int unit = warp + u * kWarps;
      if (unit >= UNITS) continue;
      const int mt = unit % MT, np = unit / MT;
      const int r = mt * 16 + (lane >> 2);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = np * 16 + t * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(lb + r * N + col) = make_float2(acc[u][t][0], acc[u][t][1]);
        *reinterpret_cast<float2*>(lb + (r + 8) * N + col) = make_float2(acc[u][t][2], acc[u][t][3]);
      }
    }
  }
}

// Pass 2: the carry over the chunks, one float4 of one (b, h) state a
// thread: S_prev(c) = S, written as bf16 hi, mid and lo planes for pass 3
// (c >= 1),
// then S = exp(T_c) S + local_c; after the last chunk S is the final state.
// The chunks' local states are read four at a time, ahead of the chain.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_carry(const float* __restrict__ Ls, const float* __restrict__ Tl, bf16* __restrict__ Sp,
                          float* __restrict__ S_out, int NC, long long n4) {
  constexpr int S4 = P * N / 4;  // float4s of a state
  constexpr int AHEAD = 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const long long bh = i / S4;
  const int e4 = (int)(i % S4);
  const float4* src = reinterpret_cast<const float4*>(Ls + bh * NC * P * N) + e4;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < NC; c0 += AHEAD) {
    float4 v[AHEAD];
    float t[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u >= NC) continue;
      v[u] = src[(long long)(c0 + u) * S4];
      t[u] = Tl[bh * NC + c0 + u];
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int c = c0 + u;
      if (c >= NC) continue;
      if (c > 0) {
        bf16 q[4][3];
        split3_bf16(S.x, q[0][0], q[0][1], q[0][2]);
        split3_bf16(S.y, q[1][0], q[1][1], q[1][2]);
        split3_bf16(S.z, q[2][0], q[2][1], q[2][2]);
        split3_bf16(S.w, q[3][0], q[3][1], q[3][2]);
        uint2* dst = reinterpret_cast<uint2*>(Sp + (bh * NC + c) * 3 * P * N) + e4;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          dst[k * S4] = make_uint2(pack_bf16x2(__bfloat162float(q[0][k]), __bfloat162float(q[1][k])),
                                   pack_bf16x2(__bfloat162float(q[2][k]), __bfloat162float(q[3][k])));
      }
      const float dec = expf(t[u]);
      S = make_float4(dec * S.x + v[u].x, dec * S.y + v[u].y, dec * S.z + v[u].z, dec * S.w + v[u].w);
    }
  }
  reinterpret_cast<float4*>(S_out + bh * P * N)[e4] = S;
}

// Pass 3's shared memory.  Up to n = 64 it holds C, B, x and S_prev of
// this head and the next, and the tables.  At n = 128 that would be 330 KB,
// so S_prev is staged one head at a time into the rows C held: C stays in
// registers as mma fragments after the first head (225 KB at p = 64).
template <int P, int N>
struct OutSmem {
  static constexpr int LN = Tc<P, N>::LN;
  static constexpr bool kOneS = N > 64;
  static constexpr int kFirst = kOneS && 3 * P > kThreads ? 3 * P * LN : kThreads * LN;  // bf16 of C's (or S_prev's) rows
};

// C rows of the warp's row blocks as A fragments of C·Bᵀ and C·S_prevᵀ.
template <int N, int LN>
__device__ __forceinline__ void load_c_fragments(uint32_t (&cf)[2][N / 16][4], const bf16* sC, const int (&rbs)[2],
                                                 int lane) {
  const int mat = lane >> 3;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      if (rbs[q] >= 0)
        ldsm_x4(cf[q][kk], sC + (rbs[q] * kRB + (lane & 7) + (mat & 1) * 8) * LN + kk * 16 + (mat >> 1) * 8);
}

// Pass 3: rows of chunk c for the block's heads,
//   y_i = sum_{j<=i} M_ij x_j + exp(cs_i) C_i·S_prev,  M_ij = (C_i·B_j) exp(cs_i - cs_j) dt_j,
// from pass 1's decay tables and pass 2's S_prev.  Each warp owns row
// blocks rb = warp and (for chunks longer than 8 row blocks) R-1-warp.  A
// head's x, S_prev and tables arrive by cp.async while the previous
// head's products run: one barrier per head (two at n = 128, whose S_prev
// is staged after the head's first barrier, into C's rows).
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel_out(const bf16* __restrict__ x, const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                        const bf16* __restrict__ Sp, const float* __restrict__ Tb, float* __restrict__ y, int H,
                        int Sn, int L, int NC, int HB, int G) {
  constexpr int LN = Tc<P, N>::LN, LP = Tc<P, N>::LP;
  constexpr int NK = N / 16;  // k16 steps over n
  constexpr int NP = P / 8;   // n8 tiles over p
  constexpr int SB = 3 * P * LN;  // bf16 of one S_prev buffer: hi, mid and lo planes, [p][n]
  constexpr bool kOneS = OutSmem<P, N>::kOneS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sC = reinterpret_cast<bf16*>(smem);             // kThreads × LN (kOneS: then this head's S_prev)
  bf16* sB = sC + OutSmem<P, N>::kFirst;                // kThreads × LN
  bf16* sX = sB + kThreads * LN;                        // 2 × kThreads × LP: x of this head and the next
  bf16* sS = kOneS ? sC : sX + 2 * kThreads * LP;       // 2 × SB (kOneS: 1 × SB): S_prev
  float* sT = reinterpret_cast<float*>(sX + 2 * kThreads * LP + (kOneS ? 0 : 2 * SB));  // 2 × kTables × kThreads

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / NC, c = blockIdx.x % NC;
  const int h0 = blockIdx.y * HB;
  const int nh = min(HB, H - h0);
  const int c0 = c * L, Lc = min(L, Sn - c0);
  const int R = (Lc + kRB - 1) / kRB, R16 = R * kRB;
  const long long row0 = (long long)b * Sn + c0;
  const long long xs = (long long)H * P;  // x's row stride

  auto stage_head = [&](int hh) {  // x rows, S_prev planes and tables of head h0 + hh into buffer hh & 1
    const int h = h0 + hh, buf = hh & 1;
    const long long slot = ((long long)b * H + h) * NC + c;
    stage_rows<P, LP>(sX + buf * kThreads * LP, x + row0 * xs + (long long)h * P, xs, R16, Lc);
    if (!kOneS && c > 0) stage_rows<N, LN>(sS + buf * SB, Sp + slot * 3 * P * N, N, 3 * P, 3 * P);
    const float* tb = Tb + slot * kTables * kThreads;
    float* st = sT + buf * kTables * kThreads;
    for (int e = tid; e < kTables * kThreads / 4; e += kThreads) cp_async16(st + 4 * e, tb + 4 * e, true);
  };
  const long long bc0 = row0 * G * N + (long long)(h0 / (H / G)) * N;  // the block's group, as in pass 1
  stage_rows<N, LN>(sC, Cm + bc0, (long long)G * N, R16, Lc);
  stage_rows<N, LN>(sB, Bm + bc0, (long long)G * N, R16, Lc);
  stage_head(0);
  cp_async_commit();

  // this warp's row blocks
  int rbs[2];
  rbs[0] = warp < R ? warp : -1;
  rbs[1] = R > kWarps && R - 1 - warp >= kWarps ? R - 1 - warp : -1;
  const int kmax = max(rbs[0], rbs[1]);
  uint32_t cf[2][NK][4];  // C rows of the row blocks as A fragments, loaded once

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    cp_async_wait<0>();  // this head's copies (and, for the first, B and C)
    __syncthreads();     // ... for every thread; and every warp is done with the other buffer
    if constexpr (kOneS) {  // C's rows give way to S_prev, one head's at a time
      if (hh == 0) {
        load_c_fragments<N, LN>(cf, sC, rbs, lane);
        __syncthreads();  // every warp holds its C fragments
      }
      if (c > 0) stage_rows<N, LN>(sS, Sp + (((long long)b * H + h) * NC + c) * 3 * P * N, N, 3 * P, 3 * P);
      cp_async_commit();
      if (hh + 1 < nh) stage_head(hh + 1);
      cp_async_commit();
      cp_async_wait<1>();  // S_prev of this head; the next head's x and tables may still fly
      __syncthreads();
    } else {
      if (hh + 1 < nh) stage_head(hh + 1);
      cp_async_commit();
      if (hh == 0) load_c_fragments<N, LN>(cf, sC, rbs, lane);
    }
    const bf16* sXc = sX + (hh & 1) * kThreads * LP;
    const bf16* sSc = kOneS ? sS : sS + (hh & 1) * SB;
    const float* tab = sT + (hh & 1) * kTables * kThreads;
    const float* sCs = tab + T_CS * kThreads;
    const float* sDt = tab + T_DT * kThreads;
    const float* sBj = tab + T_BJ * kThreads;  // exp(cs_r1 - cs_j) dt_j, r1 the end of j's slice
    const float* sAl = tab + T_AL * kThreads;  // exp(cs_i - cs_r0), r0 the first row of i's row block
    const float* sE = tab + T_E * kThreads;    // exp(cs_i)
    const float* sBeta = tab + T_BETA * kThreads;  // [rb][k]: exp(cs_r0(rb) - cs_r1(k)), k < rb

    float acc[2][NP][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < NP; ++j) acc[q][j][0] = acc[q][j][1] = acc[q][j][2] = acc[q][j][3] = 0.f;
    // exp(cs_i) C_i·S_prevᵀ (chunk 0 starts from a zero state)
    if (c > 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (rbs[q] < 0) continue;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
          for (int j = 0; j < NP; j += 2) {
            const int sr = j * 8 + (lane & 7) + (lane >> 4) * 8, sc = kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int k = 0; k < 3; ++k) {  // S_prev's hi, mid and lo planes
              uint32_t s4[4];
              ldsm_x4(s4, sSc + (k * P + sr) * LN + sc);
              mma_bf16(acc[q][j], cf[q][kk], s4[0], s4[1]);
              mma_bf16(acc[q][j + 1], cf[q][kk], s4[2], s4[3]);
            }
          }
        }
        const int i0 = rbs[q] * kRB + (lane >> 2);
        const float e0 = sE[i0], e1 = sE[i0 + 8];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          acc[q][j][0] *= e0;
          acc[q][j][1] *= e0;
          acc[q][j][2] *= e1;
          acc[q][j][3] *= e1;
        }
      }
    }

    // the 16-key slices at or below the diagonal
    for (int k = 0; k <= kmax; ++k) {
      uint32_t bb[NK][4];  // B rows of the slice: the B operand of C·Bᵀ
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldsm_x4(bb[kk], sB + (k * kRB + (lane & 7) + (lane >> 4) * 8) * LN + kk * 16 + ((lane >> 3) & 1) * 8);
      uint32_t xb[NP / 2][4];  // x rows of the slice: the B operand of M·x
#pragma unroll
      for (int jp = 0; jp < NP / 2; ++jp)
        ldsm_x4_trans(xb[jp], sXc + (k * kRB + (lane & 7) + ((lane >> 3) & 1) * 8) * LP + jp * 16 + (lane >> 4) * 8);
      const int j0 = k * kRB + 2 * (lane & 3);  // this lane's first key column
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int rb = rbs[q];
        if (rb < k) continue;  // also a warp without this row block (-1)
        float g[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) g[t][0] = g[t][1] = g[t][2] = g[t][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          mma_bf16(g[0], cf[q][kk], bb[kk][0], bb[kk][1]);
          mma_bf16(g[1], cf[q][kk], bb[kk][2], bb[kk][3]);
        }
        const int i0 = rb * kRB + (lane >> 2);
        if (k < rb) {  // below the diagonal: row factor · column factor, each at most 1
          const float beta = sBeta[rb * kMaxRB + k];
          const float f0 = sAl[i0] * beta, f1 = sAl[i0 + 8] * beta;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float b0 = sBj[j0 + t * 8], b1 = sBj[j0 + t * 8 + 1];
            g[t][0] *= f0 * b0;
            g[t][1] *= f0 * b1;
            g[t][2] *= f1 * b0;
            g[t][3] *= f1 * b1;
          }
        } else {  // the diagonal slice: exp only where j <= i
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = i0 + 8 * (e >> 1), j = j0 + t * 8 + (e & 1);
              g[t][e] = j <= i ? g[t][e] * expf(sCs[i] - sCs[j]) * sDt[j] : 0.f;
            }
        }
        // M as the A fragment of M·x, bf16 hi + lo
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v0 = g[i >> 1][2 * (i & 1)], v1 = g[i >> 1][2 * (i & 1) + 1];
          bf16 h0, l0, h1, l1;
          split_bf16(v0, h0, l0);
          split_bf16(v1, h1, l1);
          ah[i] = pack_bf16x2(__bfloat162float(h0), __bfloat162float(h1));
          al[i] = pack_bf16x2(__bfloat162float(l0), __bfloat162float(l1));
        }
#pragma unroll
        for (int jp = 0; jp < NP / 2; ++jp) {
          mma_bf16(acc[q][2 * jp], ah, xb[jp][0], xb[jp][1]);
          mma_bf16(acc[q][2 * jp], al, xb[jp][0], xb[jp][1]);
          mma_bf16(acc[q][2 * jp + 1], ah, xb[jp][2], xb[jp][3]);
          mma_bf16(acc[q][2 * jp + 1], al, xb[jp][2], xb[jp][3]);
        }
      }
    }

    // y rows as 16-byte stores: lane pairs swap halves so that the even
    // lane holds four columns of row i0 and the odd lane of row i0 + 8
    const bool odd = lane & 1;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (rbs[q] < 0) continue;
      const int i = rbs[q] * kRB + (lane >> 2) + (odd ? 8 : 0);
      float* yr = y + ((row0 + i) * H + h) * P + 4 * ((lane & 3) >> 1);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float s0 = odd ? acc[q][j][0] : acc[q][j][2];
        const float s1 = odd ? acc[q][j][1] : acc[q][j][3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 v = odd ? make_float4(r0, r1, acc[q][j][2], acc[q][j][3])
                             : make_float4(acc[q][j][0], acc[q][j][1], r0, r1);
        if (i < Lc) *reinterpret_cast<float4*>(yr + j * 8) = v;
      }
    }
  }
}

template <int P, int N>
size_t state_smem_bytes() {
  using T = Tc<P, N>;
  return (size_t)(kThreads * T::LN + 3 * kHalf * T::LP) * sizeof(bf16) + (size_t)(2 * kThreads + 32) * sizeof(float);
}

template <int P, int N>
size_t out_smem_bytes() {
  using T = Tc<P, N>;
  using O = OutSmem<P, N>;
  return (size_t)(O::kFirst + kThreads * T::LN + 2 * kThreads * T::LP + (O::kOneS ? 0 : 6 * P * T::LN)) * sizeof(bf16) +
         (size_t)(2 * kTables * kThreads) * sizeof(float);
}

template <int P, int N>
int launch_tc(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y, void* S_out,
              int Bn, int Sn, int H, int L, int G, const Scratch& w, cudaStream_t stream) {
  if (w.Ls == nullptr || w.Tl == nullptr || w.Tb == nullptr || w.Sp == nullptr) return (int)cudaErrorInvalidValue;
  const int NC = (Sn + L - 1) / L;
  const int HB = min(kHB, H);
  if (G > 1 && (H / G) % HB != 0) return (int)cudaErrorInvalidValue;  // a block's heads span two groups
  const dim3 grid(Bn * NC, (H + HB - 1) / HB);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const size_t smem1 = state_smem_bytes<P, N>();
  int rc = attn_allow_smem(ssd_scan_kernel_state<P, N>, smem1);
  if (rc != 0) return rc;
  ssd_scan_kernel_state<P, N><<<grid, kThreads, smem1, stream>>>(
      xb, static_cast<const float*>(dt), static_cast<const float*>(A), Bb, w.Ls, w.Tl, w.Tb, H, Sn, L, NC, HB, G);
  rc = dacp_last_error();
  if (rc != 0) return rc;
  const long long n4 = (long long)Bn * H * P * N / 4;
  ssd_scan_kernel_carry<P, N><<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      w.Ls, w.Tl, w.Sp, static_cast<float*>(S_out), NC, n4);
  rc = dacp_last_error();
  if (rc != 0) return rc;
  const size_t smem3 = out_smem_bytes<P, N>();
  rc = attn_allow_smem(ssd_scan_kernel_out<P, N>, smem3);
  if (rc != 0) return rc;
  ssd_scan_kernel_out<P, N><<<grid, kThreads, smem3, stream>>>(
      xb, Bb, static_cast<const bf16*>(Cm), w.Sp, w.Tb, static_cast<float*>(y), H, Sn, L, NC, HB, G);
  return dacp_last_error();
}

template <typename T, int P, int N>
int launch_ssd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y, void* S_out,
               int Bn, int Sn, int H, int L, int G, const Scratch& w, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_tc<P, N>(x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, stream);
  }
  const size_t smem = (size_t)SsdSmem<P, N>::kTotal * sizeof(float);
  const int rc = attn_allow_smem(ssd_scan_kernel<float, P, N>, smem);
  if (rc != 0) return rc;
  ssd_scan_kernel<float, P, N><<<Bn * H, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(y), static_cast<float*>(S_out),
      H, Sn, L, G);
  return dacp_last_error();
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y,
               void* S_out, int Bn, int Sn, int H, int L, int G, const Scratch& w, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch_ssd<T, P, 16>(x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, s);
    case 32:
      return launch_ssd<T, P, 32>(x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, s);
    case 64:
      return launch_ssd<T, P, 64>(x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, s);
    case 128:
      return launch_ssd<T, P, 128>(x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_p(int P, int N, const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y,
               void* S_out, int Bn, int Sn, int H, int L, int G, const Scratch& w, cudaStream_t s) {
  switch (P) {
    case 32:
      return dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, s);
    case 64:
      return dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, S, H, P) and Bm, Cm (B, S, G, N) in `dtype` (0 float32, 1 bfloat16), head
// h reading group h / (H / G), G dividing H (bfloat16: H / G a multiple of 4);
// dt (B, S, H), A (H,), y (B, S, H, P) and S_out (B, H, P, N) float32; all
// contiguous.  L: chunk length, 1..256.  bfloat16 also takes scratch, with
// NC = ceil(S / L): float32 Ls (B, H, NC, P, N) for each chunk's own
// state, Tl (B, H, NC) for its total decay and Tb (B, H, NC, 6, 256) for
// its decay tables, and bfloat16 Sp (B, H, NC, 3, P, N) for the state
// before it as hi, mid and lo planes (float32 passes null).
DACP_API int dacp_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y,
                           void* S_out, int dtype, int Bn, int Sn, int H, int P, int N, int G, int L, void* Ls,
                           void* Tl, void* Tb, void* Sp, void* stream) {
  if (Bn <= 0 || Sn <= 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0 || L > kThreads || (long long)Bn * H > 2147483647LL ||
      (long long)Bn * ((Sn + L - 1) / L) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch w = {static_cast<float*>(Ls), static_cast<float*>(Tl), static_cast<float*>(Tb),
                     static_cast<bf16*>(Sp)};
  if (dtype == DACP_ATTN_F32) return dispatch_p<float>(P, N, x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, s);
  if (dtype == DACP_ATTN_BF16) return dispatch_p<bf16>(P, N, x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, G, w, s);
  return (int)cudaErrorInvalidValue;
}
