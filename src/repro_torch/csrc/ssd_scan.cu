// Mamba-2 SSD scan for Hopper: for every (batch, head), with an f32 N x P
// state S and a single B/C group shared by the heads,
//     S_t = exp(la_t) S_{t-1} + B_t (outer) xdt_t,     y_t = C_t . S_t,
// returning y (B, S, H, P) f32 and the final state (B, H, N, P) f32.  It is
// computed in the chunked dual form: inside a chunk of kQ steps, with cs the
// inclusive cumsum of la over the chunk,
//     y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xdt_j + exp(cs_i) (C_i . S)
//     S  <- exp(cs_last) S + sum_j B_j (outer) exp(cs_last - cs_j) xdt_j.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan
// (_ssd_kernel), which walks the chunks as the inner axis of a sequential
// grid (B*H, S/Q) with the state in VMEM scratch and needs S % Q == 0.
// Here one block owns one (batch, head) and loops over the chunks itself;
// a ragged last chunk is zero-padded (la 0, B, C and xdt 0), so any S >= 0
// works, and S = 1 (decode) is one chunk of one step.
//
// Every exponent evaluated is <= 0 when la <= 0 (the model's la is the log
// of a decay in (0, 1]): exp(cs_i - cs_j) only for j <= i, exp(cs_i) and
// exp(cs_last - cs_j).  exp(cs_i - cs_j) for j > i, which overflows at the
// full-width decay range (a chunk's cumsum reaches about -26 at kQ 32), is
// never computed: those entries of the decay-masked C.B^T tile are set to
// 0 without it.
//
// Bound on this card, at the zamba2-7b prefill (B 4, S 1000, H 112,
// N = P = 64): operations.  The function needs, at the chunk length q of
// least work (8 here), q(q+1)/2 N multiply-adds a chunk for C.B^T once per
// batch row (B and C are shared by all heads), and per head q(q+1)/2 P for
// its product with xdt, 2 q N P for C.S and the state update and N P for
// the state's decay: about 2.0 GFLOP a batch row, 0.117 ms for the four
// rows at the 67 TFLOP/s float32 CUDA-core peak, against about 250 MB of
// bytes (xdt and y f32, la, B, C, the state read and written once), 0.074
// ms at 3.35 TB/s.  This design does more: each head's block forms its own
// C.B^T, at kQ 32 (about 2.3 GFLOP a batch row).  At the decode
// shape (B 4, S 1) it is bytes: the state read and written, 14.7 MB,
// 0.0044 ms.
//
// Design (a simple first one, float32 on CUDA cores): one block of 256
// threads per (batch, head), so 448 blocks at B 4 on 132 SMs, prefill and
// decode alike.  The state lives in shared memory for the whole sweep and
// touches device memory twice: read at the start, written at the end (so
// out_state may alias state0, which is how a decode step updates a layer's
// slice of the slot state in place).  Each chunk stages xdt (kQ x P), B and
// C (kQ x N, widened from bf16 where given) in shared memory; one warp takes
// the inclusive cumsum of la by shuffles; the threads then form the masked
// decay tile M (kQ x kQ, entries j > i zero), the outputs y = M xdt +
// exp(cs) (C S) (a thread holds kQ / G rows of one column, G = 256 / P, so
// each shared load of xdt or S feeds several multiply-adds), and the state
// update (a thread holds N / G rows of one column in registers).  N and P
// are template parameters (N 4..64, P 8..64); at N = P = 64 the block uses
// 47.5 KB of static shared memory.  wgmma tiles for the three products,
// double-buffered staging, and splitting P across blocks are the ways to
// make it fast.
#include "common.cuh"

namespace {

constexpr int kQ = 32;          // chunk length: steps staged per round
constexpr int kThreads = 256;
constexpr int kPadN = 4;        // B and C row padding: conflict-free float4
constexpr int kPadQ = 8;        // M row padding: conflict-free tile writes

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                const void* __restrict__ bm, const void* __restrict__ cm,
                int bc_bf16, const float* state0, float* __restrict__ y,
                float* out_state, int S, int H) {
  constexpr int G = kThreads / P;                // column groups
  constexpr int RD = kQ / G;                     // output rows a thread
  constexpr int RE = N >= G ? N / G : 1;         // state rows a thread
  static_assert(G <= kQ && RD * G == kQ, "P must be 8..64");
  static_assert(N % 4 == 0 && N <= 64 && P % 4 == 0, "N 4..64, P 8..64");

  __shared__ __align__(16) float x_s[kQ][P];
  __shared__ __align__(16) float b_s[kQ][N + kPadN];
  __shared__ __align__(16) float c_s[kQ][N + kPadN];
  __shared__ __align__(16) float m_s[kQ][kQ + kPadQ];
  __shared__ __align__(16) float st_s[N][P];
  __shared__ float cs_s[kQ];                      // inclusive cumsum of la
  __shared__ float ecs_s[kQ];                     // exp(cs_i)
  __shared__ float w_s[kQ];                       // exp(cs_last - cs_j)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int g = tid / P, p = tid - g * P;
  const size_t st_off = static_cast<size_t>(bh) * N * P;

  for (int e = tid; e < N * P; e += kThreads)
    (&st_s[0][0])[e] = state0 ? state0[st_off + e] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int q = min(kQ, S - t0);
    const size_t row0 = static_cast<size_t>(b) * S + t0;   // (b, t0)
    __syncthreads();                 // the previous chunk is consumed
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int t = e / P, c = e - t * P;
      x_s[t][c] = t < q ? xdt[((row0 + t) * H + h) * P + c] : 0.f;
    }
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int t = e / N, n = e - t * N;
      float bv = 0.f, cv = 0.f;
      if (t < q) {
        const size_t gi = (row0 + t) * N + n;
        if (bc_bf16) {
          bv = to_f32(static_cast<const __nv_bfloat16*>(bm)[gi]);
          cv = to_f32(static_cast<const __nv_bfloat16*>(cm)[gi]);
        } else {
          bv = static_cast<const float*>(bm)[gi];
          cv = static_cast<const float*>(cm)[gi];
        }
      }
      b_s[t][n] = bv;
      c_s[t][n] = cv;
    }
    if (tid < 32) {                  // warp 0: the cumsum, by shuffles
      float cs = tid < q ? la[(row0 + tid) * H + h] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, cs, o);
        if (tid >= o) cs += v;
      }
      const float total = __shfl_sync(0xffffffffu, cs, 31);
      cs_s[tid] = cs;
      ecs_s[tid] = expf(cs);
      w_s[tid] = expf(total - cs);
    }
    __syncthreads();

    // M[i][j] = (C_i . B_j) exp(cs_i - cs_j) for j <= i < q, else 0
#pragma unroll
    for (int m = 0; m < kQ * kQ / kThreads; ++m) {
      const int i = tid >> 3, j = (tid & 7) + 8 * m;
      float v = 0.f;
      if (j <= i && i < q) {
        const float4* ci = reinterpret_cast<const float4*>(c_s[i]);
        const float4* bj = reinterpret_cast<const float4*>(b_s[j]);
#pragma unroll
        for (int u = 0; u < N / 4; ++u) {
          const float4 c4 = ci[u], b4 = bj[u];
          v = fmaf(c4.x, b4.x, v);
          v = fmaf(c4.y, b4.y, v);
          v = fmaf(c4.z, b4.z, v);
          v = fmaf(c4.w, b4.w, v);
        }
        v *= expf(cs_s[i] - cs_s[j]);
      }
      m_s[i][j] = v;
    }
    __syncthreads();

    // y_i = sum_j M[i][j] xdt_j + exp(cs_i) (C_i . S), rows g*RD .. + RD
    const int i0 = g * RD;
    if (i0 < q) {
      float acc[RD], cst[RD];
#pragma unroll
      for (int k = 0; k < RD; ++k) acc[k] = cst[k] = 0.f;
      const int jend = min(q, i0 + RD);           // M[i][j] = 0 past i
      for (int j = 0; j < jend; j += 4) {         // M and x_s are padded
        const float x0 = x_s[j][p], x1 = x_s[j + 1][p];
        const float x2 = x_s[j + 2][p], x3 = x_s[j + 3][p];
#pragma unroll
        for (int k = 0; k < RD; ++k) {
          const float4 m4 = *reinterpret_cast<const float4*>(&m_s[i0 + k][j]);
          acc[k] = fmaf(m4.x, x0, acc[k]);
          acc[k] = fmaf(m4.y, x1, acc[k]);
          acc[k] = fmaf(m4.z, x2, acc[k]);
          acc[k] = fmaf(m4.w, x3, acc[k]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float s0 = st_s[n][p], s1 = st_s[n + 1][p];
        const float s2 = st_s[n + 2][p], s3 = st_s[n + 3][p];
#pragma unroll
        for (int k = 0; k < RD; ++k) {
          const float4 c4 = *reinterpret_cast<const float4*>(&c_s[i0 + k][n]);
          cst[k] = fmaf(c4.x, s0, cst[k]);
          cst[k] = fmaf(c4.y, s1, cst[k]);
          cst[k] = fmaf(c4.z, s2, cst[k]);
          cst[k] = fmaf(c4.w, s3, cst[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < RD; ++k) {
        const int i = i0 + k;
        if (i < q)
          y[((row0 + i) * H + h) * P + p] = fmaf(ecs_s[i], cst[k], acc[k]);
      }
    }
    __syncthreads();                 // every read of the old state is done

    // S[n][p] = exp(cs_last) S[n][p] + sum_j B_j[n] exp(cs_last - cs_j) x_j[p]
    const int n0 = g * RE;
    if (n0 < N) {
      const float etot = expf(cs_s[kQ - 1]);
      float s[RE];
#pragma unroll
      for (int k = 0; k < RE; ++k) s[k] = st_s[n0 + k][p] * etot;
      for (int j = 0; j < q; ++j) {
        const float xw = x_s[j][p] * w_s[j];
        if constexpr (RE % 4 == 0) {
#pragma unroll
          for (int k = 0; k < RE; k += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(&b_s[j][n0 + k]);
            s[k] = fmaf(b4.x, xw, s[k]);
            s[k + 1] = fmaf(b4.y, xw, s[k + 1]);
            s[k + 2] = fmaf(b4.z, xw, s[k + 2]);
            s[k + 3] = fmaf(b4.w, xw, s[k + 3]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < RE; ++k) s[k] = fmaf(b_s[j][n0 + k], xw, s[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < RE; ++k) st_s[n0 + k][p] = s[k];
    }
  }

  __syncthreads();
  for (int e = tid; e < N * P; e += kThreads)
    out_state[st_off + e] = (&st_s[0][0])[e];
}

template <int N, int P>
int launch(const float* xdt, const float* la, const void* bm, const void* cm,
           int bc_bf16, const float* state0, float* y, float* out_state,
           int B, int S, int H, cudaStream_t stream) {
  ssd_scan_kernel<N, P><<<B * H, kThreads, 0, stream>>>(
      xdt, la, bm, cm, bc_bf16, state0, y, out_state, S, H);
  return cudaGetLastError();
}

template <int P>
int dispatch_n(const float* xdt, const float* la, const void* bm,
               const void* cm, int bc_bf16, const float* s0, float* y,
               float* sT, int B, int S, int H, int N, cudaStream_t s) {
  switch (N) {
    case 4: return launch<4, P>(xdt, la, bm, cm, bc_bf16, s0, y, sT, B, S, H, s);
    case 8: return launch<8, P>(xdt, la, bm, cm, bc_bf16, s0, y, sT, B, S, H, s);
    case 16: return launch<16, P>(xdt, la, bm, cm, bc_bf16, s0, y, sT, B, S, H, s);
    case 32: return launch<32, P>(xdt, la, bm, cm, bc_bf16, s0, y, sT, B, S, H, s);
    case 64: return launch<64, P>(xdt, la, bm, cm, bc_bf16, s0, y, sT, B, S, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ssd_scan_launch(const void* xdt, const void* la,
                               const void* bm, const void* cm,
                               const void* state0, void* y, void* out_state,
                               int B, int S, int H, int N, int P,
                               int bc_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S < 0 ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      (bc_dtype != kFloat32 && bc_dtype != kBFloat16))
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(xdt);
  const float* lf = static_cast<const float*>(la);
  const float* s0 = static_cast<const float*>(state0);
  float* yf = static_cast<float*>(y);
  float* sT = static_cast<float*>(out_state);
  const int bf = bc_dtype == kBFloat16;
  switch (P) {
    case 8: return dispatch_n<8>(xf, lf, bm, cm, bf, s0, yf, sT, B, S, H, N, s);
    case 16: return dispatch_n<16>(xf, lf, bm, cm, bf, s0, yf, sT, B, S, H, N, s);
    case 32: return dispatch_n<32>(xf, lf, bm, cm, bf, s0, yf, sT, B, S, H, N, s);
    case 64: return dispatch_n<64>(xf, lf, bm, cm, bf, s0, yf, sT, B, S, H, N, s);
    default: return cudaErrorInvalidValue;
  }
}
