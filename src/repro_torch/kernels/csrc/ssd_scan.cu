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
//   written.  p is 32 or 64, n 16, 32 or 64, L at most 256.
//
//   Bound: bytes in principle — at the zamba2-1.2b prefill shape (b 4,
//   s 1024, h 64, p 64, n 64, L 256, bf16) the kernel moves about 107 MB
//   (0.032 ms at 3.35 TB/s) for 12.9 GFLOP of products below the diagonal.
//   This first kernel runs those products as explicit float32 FMAs on the
//   CUDA cores (the library builds with -fmad=false), so its ceiling is the
//   float32 rate and, below that, the shared-memory loads of its operands.
//
// Design: the TPU grid walks (b, h, chunk) with the chunk axis sequential
// and the state in VMEM scratch, and holds a chunk's whole (L, L) decay ×
// score matrix: 256 KB in float32 at L = 256, more than a block's shared
// memory.  Here one block owns one (b, h) and walks the chunks itself, with
// S (p × n) and the chunk's cumulative dA in shared memory.  Within a
// chunk it goes over 64-row query tiles and, for each, the 64-row key tiles
// at or below the diagonal: a 64 × 64 tile of M = (C Bᵀ) ⊙ exp(cs_i − cs_j)
// ⊙ dt_j is formed in shared memory and multiplied into the thread's y
// accumulators (4 rows × p/16 columns).  exp(cs_i − cs_j) is taken only
// for i >= j, where it is at most 1: above the diagonal it could overflow.
// All query tiles read S_prev first; the state update then walks the key
// tiles once more.  Shared rows of length n carry one float of padding so
// that column reads are conflict-free.  256 blocks at the zamba2 shape,
// about 85 KB of shared memory each: two blocks per SM.
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
                    float* __restrict__ S_out, int H, int Sn, int L) {
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
        sCq[r * LN + k] = i0 + r < Lc ? attn_to_f<T>(Cm[(row0 + c0 + i0 + r) * N + k]) : 0.f;
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
          sBk[r * LN + k] = j0 + r < Lc ? attn_to_f<T>(Bm[(row0 + c0 + j0 + r) * N + k]) : 0.f;
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
        sBk[r * LN + k] = j0 + r < Lc ? attn_to_f<T>(Bm[(row0 + c0 + j0 + r) * N + k]) : 0.f;
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

template <typename T, int P, int N>
int launch_ssd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y, void* S_out,
               int Bn, int Sn, int H, int L, cudaStream_t stream) {
  const size_t smem = (size_t)SsdSmem<P, N>::kTotal * sizeof(float);
  const int rc = attn_allow_smem(ssd_scan_kernel<T, P, N>, smem);
  if (rc != 0) return rc;
  ssd_scan_kernel<T, P, N><<<Bn * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y), static_cast<float*>(S_out), H,
      Sn, L);
  return dacp_last_error();
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y,
               void* S_out, int Bn, int Sn, int H, int L, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch_ssd<T, P, 16>(x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, s);
    case 32:
      return launch_ssd<T, P, 32>(x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, s);
    case 64:
      return launch_ssd<T, P, 64>(x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_p(int P, int N, const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y,
               void* S_out, int Bn, int Sn, int H, int L, cudaStream_t s) {
  switch (P) {
    case 32:
      return dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, s);
    case 64:
      return dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, S, H, P) and Bm, Cm (B, S, N) in `dtype` (0 float32, 1 bfloat16);
// dt (B, S, H), A (H,), y (B, S, H, P) and S_out (B, H, P, N) float32; all
// contiguous.  L: chunk length, 1..256.
DACP_API int dacp_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, void* y,
                           void* S_out, int dtype, int Bn, int Sn, int H, int P, int N, int L, void* stream) {
  if (Bn <= 0 || Sn <= 0 || H <= 0 || L <= 0 || L > kThreads || (long long)Bn * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DACP_ATTN_F32) return dispatch_p<float>(P, N, x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, s);
  if (dtype == DACP_ATTN_BF16) return dispatch_p<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, y, S_out, Bn, Sn, H, L, s);
  return (int)cudaErrorInvalidValue;
}
