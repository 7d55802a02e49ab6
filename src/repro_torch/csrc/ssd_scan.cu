// Mamba-2 SSD scan for Hopper: for every (batch, head), with an f32 N x P
// state S and a single B/C group shared by the heads,
//     S_t = exp(la_t) S_{t-1} + B_t (outer) xdt_t,     y_t = C_t . S_t,
// returning y (B, S, H, P) f32 and the final state (B, H, N, P) f32, in the
// chunked dual form of the SSD algorithm (Dao & Gu, arXiv:2405.21060,
// sec. 6): inside a chunk, with cs the inclusive cumsum of la over it,
//     y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xdt_j + exp(cs_i) (C_i . S)
//     S  <- exp(cs_last) S + sum_j B_j (outer) exp(cs_last - cs_j) xdt_j.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan
// (_ssd_kernel), which walks the chunks as the inner axis of a sequential
// grid (B*H, S/Q) with the state in VMEM scratch and needs S % Q == 0.  A
// ragged last chunk is zero-padded here (la 0, B, C and xdt 0), so any
// S >= 0 works.  Two routes, picked by the wrapper from shapes and dtypes
// only (kernels/ssd_scan.py:tensor_core_route):
//
// The tensor-core route (N = P = 64, bf16 B and C, S >= 64: every zamba2-7b
// prefill) works in chunks of Q = 64 steps, grouped in segments of 4
// chunks, as two launches over a float32 workspace:
//   1. per (batch, segment, pair of heads), in parallel: each head's
//      segment state contribution, walking the segment's chunks with the
//      accumulators in registers, dS <- exp(cs_last) dS + B^T (exp(cs_last
//      - cs_j) o xdt), and the segment's decay; segment 0 also copies the
//      initial state into the workspace;
//   2. per (batch, segment, pair of heads), in parallel: each head's entry
//      state from the initial state and the earlier segments' (one
//      multiply-add an element and earlier segment: 3 at most at the
//      zamba2-7b prefill), kept in shared memory; then the segment's
//      chunks in order: G = C B^T once for the pair (B and C are shared by
//      the heads), and per head y = (G o exp(cs_i - cs_j), j <= i) xdt +
//      exp(cs_i) (C S) and the state's step to the next chunk.  The last
//      segment writes the final state.
// So 896 blocks of 4 warps at the prefill (B 4, S 1000, H 112) in each
// launch, instead of 448 blocks that each walk 32 chunks of 32 and each
// form their own C B^T.  The segments keep the workspace at 7.3 MB of
// segment states (one a segment and head, not one a chunk and head: 117 MB
// at this shape, which a first version of this route wrote, read, wrote and
// read again in three launches: 0.73 ms, slower than the CUDA-core route);
// the price is the state's step computed twice, once in each launch.
//
// Every exponent evaluated is <= 0 when la <= 0 (the model's la is the log
// of a decay in (0, 1]), and none is a difference of two long sums: the
// chunk's cumsum is kept per sub-chunk of 16 steps as an inclusive local
// prefix l, an exclusive local suffix s and the sub-chunk's total T, each
// from a 16-lane shuffle scan.  A pair in one sub-chunk takes l_i - l_j (two
// sums of at most 16 terms); a pair across sub-chunks takes l_i + s_j + the
// totals between, all <= 0, so no digit cancels (a cumsum from the chunk
// start reaches about -52 at Q 64, where one float32 ulp is 4e-6 of a
// decay).  exp(cs_i - cs_j) for j > i, which overflows at the full-width
// decay range, is never computed: those entries are 0.
//
// Accuracy: the SSD's 1e-5 relative limit holds.  bf16 B and C are exact
// in bf16 mma.sync (m16n8k16) and their products exact in the float32
// accumulator, so G = C B^T needs no split.  C S and B^T (w o xdt) have one
// exact operand (bf16 values are exact in TF32) and one float32 operand
// split as hi + lo, both TF32: two TF32 products (mma.sync m16n8k8).
// M xdt has two float32 operands: three products (3xTF32, lo.hi + hi.lo +
// hi.hi, about 2^-21 relative).  A CPU mirror of this arithmetic
// (tests/test_torch_scans.py) stays within 1e-6 of the plain version.
// float32 B and C take the CUDA-core route (they would need both sides
// split in every product).
//
// Bound on this card, at the zamba2-7b prefill (B 4, S 1000, H 112,
// N = P = 64): bytes, about 250 MB (xdt and y f32, la, B, C, the state
// read and written once), 0.0746 ms at 3.35 TB/s.  The function's 7.83
// GFLOP (counted at the chunk of least work, C B^T once per batch row)
// take 0.0158 ms at the 494.7 TFLOP/s TF32 tensor-core peak (0.117 ms at
// the 67 TFLOP/s float32 CUDA-core peak that bounded the first design).
// The route moves more: xdt is read twice (once a launch), up to 490 MB in
// all with the workspace, 0.15 ms at 3.35 TB/s; and its products, split
// 2-3 ways and the state's step twice, are about 30 GFLOP of tensor-core
// work.  Measured there (NVIDIA H100 80GB HBM3 at 700 W, torch.profiler
// device time, mean of 20 calls): launches 1 and 2 take 0.0977 and 0.356
// ms, 0.454 ms in all, 6x the bound; the CUDA-core route takes 0.701 ms.
// Launch 2 is bound neither by bytes nor by the tensor cores.  In a variant
// with 8 warps a block (0.366 ms), with the products replaced by adds it
// took 0.27 ms, with the products and their operands removed 0.13 ms (0.23
// GB moved: 1.8 TB/s), and the causal M xdt cost 0.20 ms of it.  Versions
// with operands split once into shared memory, rows balanced across warps,
// or inputs held a chunk ahead in registers all ran 0.35-0.41 ms.
//
// The CUDA-core route (float32 B/C, the other widths, S < 64, and so every
// decode step): one block of 256 threads per (batch, head), which loops
// over chunks of kQ 32 with the state in shared memory for the whole sweep,
// touching device memory twice: read at the start, written at the end (so
// out_state may alias state0, which is how a decode step updates a layer's
// slice of the slot state in place).  Each chunk stages xdt, B and C in
// shared memory; one warp takes the inclusive cumsum of la by shuffles; the
// threads form the masked decay tile M (kQ x kQ, entries j > i zero), the
// outputs y = M xdt + exp(cs) (C S) and the state update in float32 on CUDA
// cores.  N and P are template parameters (N 4..64, P 8..64).  At the
// decode shape (B 4, S 1) it is bound by the state's read and write, 14.7
// MB, 0.0044 ms; it takes 0.0144 ms.
//
// On the tensor-core route out_state may alias state0 as well: launch 1
// reads state0 (into the workspace), launch 2 writes out_state.
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


// -- the tensor-core route: chunks of kTQ steps in segments of kSegChunks ----

constexpr int kTQ = 64;                 // chunk length
constexpr int kTSub = 16;               // sub-chunk of the decay pieces
constexpr int kTNSub = kTQ / kTSub;
constexpr int kSegChunks = 4;           // chunks a segment: one block's walk
constexpr int kPairHeads = 2;           // heads a block: one C B^T for both
constexpr int kStateThreads = 128;      // 4 warps: 16 state rows each
constexpr int kOutThreads = 128;        // 4 warps: 16 rows of the chunk each
constexpr int kTD = 64;                 // N = P on this route
constexpr int kLdF = kTD + 8;           // float rows read as [k][n]
constexpr int kLdG = kTQ + 4;           // G rows (float), read as [m][k]
constexpr int kLdH = kTD + 8;           // bf16 rows (144 B: 36 words)

// the decay pieces of one head's chunk: l (inclusive prefix in the
// sub-chunk), s (exclusive suffix in the sub-chunk), T (sub-chunk totals)
struct Decay {
  float l[kTQ];
  float s[kTQ];
  float T[kTNSub];
};

// The decay pieces of the block's heads, one warp a head: a lane holds
// steps lane and lane + 32, scanned in segments of 16 lanes.
__device__ __forceinline__ void decay_pieces(Decay* dk, const float* la,
                                             int b, int t0, int S, int H,
                                             int h0, int nh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane & (kTSub - 1);
  if (warp >= nh) return;
  float l[2], s[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + lane + 32 * half;
    const float x = t < S ? la[(static_cast<size_t>(b) * S + t) * H + h0 +
                               warp] : 0.f;
    float inc = x, suf = x;
#pragma unroll
    for (int o = 1; o < kTSub; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, inc, o, kTSub);
      const float dn = __shfl_down_sync(0xffffffffu, suf, o, kTSub);
      if (seg >= o) inc += up;
      if (seg + o < kTSub) suf += dn;
    }
    const float next = __shfl_down_sync(0xffffffffu, suf, 1, kTSub);
    l[half] = inc;
    s[half] = seg + 1 < kTSub ? next : 0.f;
  }
  Decay& d = dk[warp];
  d.l[lane] = l[0];
  d.l[lane + 32] = l[1];
  d.s[lane] = s[0];
  d.s[lane + 32] = s[1];
  const float T0 = __shfl_sync(0xffffffffu, l[0], 15);
  const float T1 = __shfl_sync(0xffffffffu, l[0], 31);
  const float T2 = __shfl_sync(0xffffffffu, l[1], 15);
  const float T3 = __shfl_sync(0xffffffffu, l[1], 31);
  if (lane == 0) {
    d.T[0] = T0;
    d.T[1] = T1;
    d.T[2] = T2;
    d.T[3] = T3;
  }
}

// the sum of T over sub-chunks [lo, hi), in order from lo
__device__ __forceinline__ float totals(const Decay& d, int lo, int hi) {
  float x = 0.f;
  for (int u = lo; u < hi; ++u) x += d.T[u];
  return x;
}

// w_j = exp(cs_last - cs_j) of each head's chunk, and dec = exp(cs_last)
__device__ __forceinline__ void chunk_weights(const Decay* dk, int nh,
                                              float* w_s, float* dc_s) {
  for (int e = threadIdx.x; e < nh * kTQ; e += blockDim.x) {
    const int hh = e / kTQ, j = e - hh * kTQ;
    w_s[e] = expf(dk[hh].s[j] + totals(dk[hh], j / kTSub + 1, kTNSub));
  }
  if (threadIdx.x < nh)
    dc_s[threadIdx.x] = expf(totals(dk[threadIdx.x], 0, kTNSub));
}

// Copy a chunk's kTQ rows of 64 float32 (row stride src_ld floats) into
// dst[row][kLdF] by cp.async; rows at or past `rows` are zero-filled.
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          size_t src_ld, int rows) {
  for (int e = threadIdx.x; e < kTQ * kTD / 4; e += blockDim.x) {
    const int t = e / (kTD / 4), c = (e - t * (kTD / 4)) * 4;
    const bool live = t < rows;
    cp_async16(dst + t * kLdF + c, live ? src + t * src_ld + c : src,
               live ? 16 : 0);
  }
}

// Copy a chunk's kTQ rows of 64 bf16 (B or C) into dst[row][kLdH].
__device__ __forceinline__ void copy_bf16_rows(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int rows) {
  for (int e = threadIdx.x; e < kTQ * kTD / 8; e += blockDim.x) {
    const int t = e / (kTD / 8), c = (e - t * (kTD / 8)) * 8;
    const bool live = t < rows;
    cp_async16(dst + t * kLdH + c, live ? src + t * kTD + c : src,
               live ? 16 : 0);
  }
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Launch 1: block (b, segment sg, head pair).  For each head, the
// segment's own state contribution dS = sum over its chunks c in order of
// (dS <- exp(cs_last,c) dS + B_c^T (w_c o xdt_c)), from zero, with w_j =
// exp(cs_last - cs_j); and the segment's decay, the product of its chunks'
// exp(cs_last).  Warp w takes rows n 16 w .. + 15 of dS, all 64 columns p;
// B exact, w o xdt split: two TF32 products.  The accumulators stay in
// registers across the chunks.  Segment 0's blocks also copy the initial
// state into the workspace, so that launch 2 never reads state0 (which
// out_state may alias).
__global__ void __launch_bounds__(kStateThreads)
ssd_seg_state_kernel(const float* __restrict__ xdt,
                     const float* __restrict__ la,
                     const __nv_bfloat16* __restrict__ bm,
                     const float* __restrict__ state0, float* __restrict__ ws,
                     float* __restrict__ dec, int S, int H, int nc,
                     int nseg, int npair) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);      // [heads][kTQ][kLdF]
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(
      x_s + kPairHeads * kTQ * kLdF);                    // [kTQ][kLdH]
  Decay* dk = reinterpret_cast<Decay*>(b_s + kTQ * kLdH);  // [heads]
  float* w_s = reinterpret_cast<float*>(dk + kPairHeads);  // [heads][kTQ]
  float* dc_s = w_s + kPairHeads * kTQ;                    // [heads]
  const int pr = blockIdx.x % npair, bs = blockIdx.x / npair;
  const int sg = bs % nseg, b = bs / nseg;
  const int h0 = pr * kPairHeads, nh = min(kPairHeads, H - h0);
  const int c_end = min(nc, (sg + 1) * kSegChunks);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3, m0 = warp * 16;
  const size_t xrow = static_cast<size_t>(H) * kTD;
  const size_t slots = static_cast<size_t>(nseg) + 1;

  if (sg == 0) {                     // slot 0: the initial state
    for (int e = threadIdx.x; e < nh * kTD * kTD / 4; e += kStateThreads) {
      const size_t head = static_cast<size_t>(b) * H + h0 + e / (kTD * kTD / 4);
      const int i4 = e % (kTD * kTD / 4);
      const float4 v = state0 ? reinterpret_cast<const float4*>(
                                    state0 + head * kTD * kTD)[i4]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(ws + head * slots * kTD * kTD)[i4] = v;
    }
  }
  float acc[kPairHeads][(kTD / 8)][4] = {};
  float dseg = 1.f;                  // this thread's head: threadIdx.x < nh
  for (int c = sg * kSegChunks; c < c_end; ++c) {
    const int t0 = c * kTQ, rows = min(kTQ, S - t0);
    const float* x0 = xdt + (static_cast<size_t>(b) * S + t0) * xrow;
    __syncthreads();                 // the previous chunk is consumed
    copy_bf16_rows(b_s, bm + (static_cast<size_t>(b) * S + t0) * kTD, rows);
    for (int hh = 0; hh < nh; ++hh)
      copy_rows(x_s + hh * kTQ * kLdF,
                x0 + static_cast<size_t>(h0 + hh) * kTD, xrow, rows);
    cp_async_commit();
    decay_pieces(dk, la, b, t0, S, H, h0, nh);
    cp_async_wait<0>();
    __syncthreads();
    chunk_weights(dk, nh, w_s, dc_s);
    __syncthreads();
    if (threadIdx.x < nh) dseg *= dc_s[threadIdx.x];
#pragma unroll
    for (int hh = 0; hh < kPairHeads; ++hh) {
      if (hh < nh) {
        const float dcy = dc_s[hh];
#pragma unroll
        for (int n4 = 0; n4 < (kTD / 8); ++n4)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[hh][n4][e] *= dcy;
        const float* xs = x_s + hh * kTQ * kLdF;
        const float* wj = w_s + hh * kTQ;
#pragma unroll 2
        for (int ks = 0; ks < kTQ / 8; ++ks) {
          const int j0 = ks * 8 + q, j1 = j0 + 4;
          uint32_t a[4];
          a[0] = __float_as_uint(bf16_at(b_s + j0 * kLdH + m0 + g));
          a[1] = __float_as_uint(bf16_at(b_s + j0 * kLdH + m0 + g + 8));
          a[2] = __float_as_uint(bf16_at(b_s + j1 * kLdH + m0 + g));
          a[3] = __float_as_uint(bf16_at(b_s + j1 * kLdH + m0 + g + 8));
          const float w0 = wj[j0], w1 = wj[j1];
#pragma unroll
          for (int n4 = 0; n4 < (kTD / 8); ++n4) {
            const int col = n4 * 8 + g;
            uint32_t b_hi[2], b_lo[2];
            split_tf32(w0 * xs[j0 * kLdF + col], b_hi[0], b_lo[0]);
            split_tf32(w1 * xs[j1 * kLdF + col], b_hi[1], b_lo[1]);
            mma_tf32_1688(acc[hh][n4], a, b_lo[0], b_lo[1]);
            mma_tf32_1688(acc[hh][n4], a, b_hi[0], b_hi[1]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kPairHeads; ++hh) {
    if (hh < nh) {
      const size_t head = static_cast<size_t>(b) * H + h0 + hh;
      float* out = ws + (head * slots + sg + 1) * kTD * kTD;
#pragma unroll
      for (int n4 = 0; n4 < (kTD / 8); ++n4) {
        const int col = n4 * 8 + 2 * q;
        *reinterpret_cast<float2*>(out + (m0 + g) * kTD + col) =
            make_float2(acc[hh][n4][0], acc[hh][n4][1]);
        *reinterpret_cast<float2*>(out + (m0 + g + 8) * kTD + col) =
            make_float2(acc[hh][n4][2], acc[hh][n4][3]);
      }
    }
  }
  if (threadIdx.x < nh)
    dec[(static_cast<size_t>(b) * H + h0 + threadIdx.x) * nseg + sg] = dseg;
}

// Launch 2: block (b, segment sg, head pair).  Each head's entry state of
// the segment from the workspace (slot 0 and the earlier segments'
// contributions and decays, in order) into shared memory; then the
// segment's chunks in order: G = C B^T once for the pair, then per head
// y = (G o exp(cs_i - cs_j), j <= i) xdt + exp(cs_i) (C S) and the state's
// step to the next chunk, S <- exp(cs_last) S + B^T (w o xdt).  The last
// segment's blocks write the final state.  Warp w owns the chunk's rows
// 16 w .. + 15 for G and y, and the state's rows n 16 w .. + 15 for its
// update, all 64 columns.
__global__ void __launch_bounds__(kOutThreads, 2)
ssd_seg_out_kernel(const float* __restrict__ xdt,
                   const float* __restrict__ la,
                   const __nv_bfloat16* __restrict__ bm,
                   const __nv_bfloat16* __restrict__ cm,
                   const float* __restrict__ ws, const float* __restrict__ dec,
                   float* __restrict__ y, float* __restrict__ out_state,
                   int S, int H, int nc, int nseg, int npair) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);         // [2][kTQ][kLdF]
  float* s_s = x_s + 2 * kTQ * kLdF;                       // [heads][kTD][kLdF]
  float* g_s = s_s + kPairHeads * kTD * kLdF;              // [kTQ][kLdG]
  __nv_bfloat16* c_s =
      reinterpret_cast<__nv_bfloat16*>(g_s + kTQ * kLdG);   // [kTQ][kLdH]
  __nv_bfloat16* b_s = c_s + kTQ * kLdH;                   // [kTQ][kLdH]
  Decay* dk = reinterpret_cast<Decay*>(b_s + kTQ * kLdH);   // [heads]
  float* w_s = reinterpret_cast<float*>(dk + kPairHeads);   // [heads][kTQ]
  float* dc_s = w_s + kPairHeads * kTQ;                     // [heads]
  const int pr = blockIdx.x % npair, bs = blockIdx.x / npair;
  const int sg = bs % nseg, b = bs / nseg;
  const int h0 = pr * kPairHeads, nh = min(kPairHeads, H - h0);
  const int c0 = sg * kSegChunks, c_end = min(nc, c0 + kSegChunks);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3, i0 = w * 16;
  const size_t xrow = static_cast<size_t>(H) * kTD;
  const size_t slots = static_cast<size_t>(nseg) + 1;
  auto x_tile = [&](int c, int hh) {
    return xdt + (static_cast<size_t>(b) * S + c * kTQ) * xrow +
           static_cast<size_t>(h0 + hh) * kTD;
  };

  copy_rows(x_s, x_tile(c0, 0), xrow, min(kTQ, S - c0 * kTQ));
  cp_async_commit();
  // the entry states: S = slot 0, then S <- dec S + dS over segments < sg
  for (int e = threadIdx.x; e < nh * kTD * kTD / 4; e += kOutThreads) {
    const int hh = e / (kTD * kTD / 4), i4 = e % (kTD * kTD / 4);
    const size_t head = static_cast<size_t>(b) * H + h0 + hh;
    const float4* slot = reinterpret_cast<const float4*>(
        ws + head * slots * kTD * kTD) + i4;
    float4 v = slot[0];
    for (int s2 = 0; s2 < sg; ++s2) {
      const float d = dec[head * nseg + s2];
      const float4 x = slot[static_cast<size_t>(s2 + 1) * kTD * kTD / 4];
      v = make_float4(fmaf(d, v.x, x.x), fmaf(d, v.y, x.y),
                      fmaf(d, v.z, x.z), fmaf(d, v.w, x.w));
    }
    const int row = i4 / (kTD / 4), col = (i4 % (kTD / 4)) * 4;
    *reinterpret_cast<float4*>(s_s + (hh * kTD + row) * kLdF + col) = v;
  }

  int it = 0;                          // (chunk, head) steps: x buffer it & 1
  for (int c = c0; c < c_end; ++c) {
    const int t0 = c * kTQ, rows = min(kTQ, S - t0);
    const size_t bc_off = (static_cast<size_t>(b) * S + t0) * kTD;
    __syncthreads();                   // the previous chunk is consumed
    copy_bf16_rows(c_s, cm + bc_off, rows);
    copy_bf16_rows(b_s, bm + bc_off, rows);
    cp_async_commit();
    decay_pieces(dk, la, b, t0, S, H, h0, nh);
    cp_async_wait<0>();
    __syncthreads();
    chunk_weights(dk, nh, w_s, dc_s);
    // G = C B^T, rows i of this warp, columns j < 16 (w + 1): bf16 mma
    // (m16n8k16), exact products
    {
      float acc[kTQ / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < kTD / 16; ++ks) {
        const int col = ks * 16 + 2 * q;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(c_s + (i0 + g) * kLdH + col);
        a[1] = *reinterpret_cast<const uint32_t*>(c_s + (i0 + g + 8) * kLdH +
                                                  col);
        a[2] = *reinterpret_cast<const uint32_t*>(c_s + (i0 + g) * kLdH + col +
                                                  8);
        a[3] = *reinterpret_cast<const uint32_t*>(c_s + (i0 + g + 8) * kLdH +
                                                  col + 8);
#pragma unroll
        for (int nt = 0; nt < kTQ / 8; ++nt) {
          if (nt < 2 * (w + 1)) {
            const __nv_bfloat16* brow = b_s + (nt * 8 + g) * kLdH + col;
            mma_bf16_16816(acc[nt], a,
                           *reinterpret_cast<const uint32_t*>(brow),
                           *reinterpret_cast<const uint32_t*>(brow + 8));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kTQ / 8; ++nt) {
        if (nt < 2 * (w + 1)) {
          const int col = nt * 8 + 2 * q;
          *reinterpret_cast<float2*>(g_s + (i0 + g) * kLdG + col) =
              make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(g_s + (i0 + g + 8) * kLdG + col) =
              make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncthreads();                   // G, w and the decays are ready

    const int ia = i0 + g, ib = ia + 8;  // this lane's two rows
    for (int hh = 0; hh < nh; ++hh, ++it) {
      const int buf = it & 1;
      const bool more = hh + 1 < nh || c + 1 < c_end;
      if (more) {                      // the next (chunk, head)'s xdt
        const int nc2 = hh + 1 < nh ? c : c + 1;
        const int nh2 = hh + 1 < nh ? hh + 1 : 0;
        copy_rows(x_s + (buf ^ 1) * kTQ * kLdF, x_tile(nc2, nh2), xrow,
                  min(kTQ, S - nc2 * kTQ));
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* xs = x_s + buf * kTQ * kLdF;
      float* ss = s_s + hh * kTD * kLdF;
      const Decay& d = dk[hh];
      const float la_ = d.l[ia], lb_ = d.l[ib];

      // M xdt, M = G o exp(cs_i - cs_j) for j <= i: 3xTF32
      float acc[(kTD / 8)][4] = {};
      for (int ks = 0; ks < 2 * (w + 1); ++ks) {
        const int bj = ks >> 1;
        const float mid = bj < w ? totals(d, bj + 1, w) : 0.f;
        const int j0 = ks * 8 + q, j1 = j0 + 4;
        const int ii[4] = {ia, ib, ia, ib};
        const int jj[4] = {j0, j0, j1, j1};
        const float li[4] = {la_, lb_, la_, lb_};
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float m = 0.f;
          if (jj[e] <= ii[e]) {
            const float ex = bj == w ? li[e] - d.l[jj[e]]
                                     : li[e] + d.s[jj[e]] + mid;
            m = g_s[ii[e] * kLdG + jj[e]] * expf(ex);
          }
          split_tf32(m, a_hi[e], a_lo[e]);
        }
#pragma unroll
        for (int n4 = 0; n4 < (kTD / 8); ++n4) {
          const int col = n4 * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(xs[j0 * kLdF + col], b_hi[0], b_lo[0]);
          split_tf32(xs[j1 * kLdF + col], b_hi[1], b_lo[1]);
          mma_3xtf32(acc[n4], a_hi, a_lo, b_hi, b_lo);
        }
      }
      // C S: C exact, S split: two TF32 products
      float acc2[(kTD / 8)][4] = {};
#pragma unroll 2
      for (int ks = 0; ks < kTD / 8; ++ks) {
        const int n0 = ks * 8 + q, n1 = n0 + 4;
        uint32_t a[4];
        a[0] = __float_as_uint(bf16_at(c_s + ia * kLdH + n0));
        a[1] = __float_as_uint(bf16_at(c_s + ib * kLdH + n0));
        a[2] = __float_as_uint(bf16_at(c_s + ia * kLdH + n1));
        a[3] = __float_as_uint(bf16_at(c_s + ib * kLdH + n1));
#pragma unroll
        for (int n4 = 0; n4 < (kTD / 8); ++n4) {
          const int col = n4 * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(ss[n0 * kLdF + col], b_hi[0], b_lo[0]);
          split_tf32(ss[n1 * kLdF + col], b_hi[1], b_lo[1]);
          mma_tf32_1688(acc2[n4], a, b_lo[0], b_lo[1]);
          mma_tf32_1688(acc2[n4], a, b_hi[0], b_hi[1]);
        }
      }
      const float before = totals(d, 0, w);
      const float ea = expf(la_ + before), eb = expf(lb_ + before);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? ib : ia;
        if (i < rows) {
          const float e = half ? eb : ea;
          float* row = y + ((static_cast<size_t>(b) * S + t0 + i) * H + h0 +
                            hh) * kTD;
#pragma unroll
          for (int n4 = 0; n4 < (kTD / 8); ++n4)
            *reinterpret_cast<float2*>(row + n4 * 8 + 2 * q) =
                make_float2(fmaf(e, acc2[n4][2 * half], acc[n4][2 * half]),
                            fmaf(e, acc2[n4][2 * half + 1],
                                 acc[n4][2 * half + 1]));
        }
      }
      // the state's step to the next chunk (not needed past the last
      // chunk of a segment whose successor starts from the workspace)
      if (c + 1 < c_end || sg == nseg - 1) {
        __syncthreads();               // every warp has read S
        const float dcy = dc_s[hh];
        const float* wj = w_s + hh * kTQ;
        float st[(kTD / 8)][4];
#pragma unroll
        for (int n4 = 0; n4 < (kTD / 8); ++n4) {
          const int col = n4 * 8 + 2 * q;
          const float2 u0 = *reinterpret_cast<const float2*>(
              ss + (i0 + g) * kLdF + col);
          const float2 u1 = *reinterpret_cast<const float2*>(
              ss + (i0 + g + 8) * kLdF + col);
          st[n4][0] = dcy * u0.x;
          st[n4][1] = dcy * u0.y;
          st[n4][2] = dcy * u1.x;
          st[n4][3] = dcy * u1.y;
        }
#pragma unroll 2
        for (int ks = 0; ks < kTQ / 8; ++ks) {
          const int j0 = ks * 8 + q, j1 = j0 + 4;
          uint32_t a[4];
          a[0] = __float_as_uint(bf16_at(b_s + j0 * kLdH + i0 + g));
          a[1] = __float_as_uint(bf16_at(b_s + j0 * kLdH + i0 + g + 8));
          a[2] = __float_as_uint(bf16_at(b_s + j1 * kLdH + i0 + g));
          a[3] = __float_as_uint(bf16_at(b_s + j1 * kLdH + i0 + g + 8));
          const float w0 = wj[j0], w1 = wj[j1];
#pragma unroll
          for (int n4 = 0; n4 < (kTD / 8); ++n4) {
            const int col = n4 * 8 + g;
            uint32_t b_hi[2], b_lo[2];
            split_tf32(w0 * xs[j0 * kLdF + col], b_hi[0], b_lo[0]);
            split_tf32(w1 * xs[j1 * kLdF + col], b_hi[1], b_lo[1]);
            mma_tf32_1688(st[n4], a, b_lo[0], b_lo[1]);
            mma_tf32_1688(st[n4], a, b_hi[0], b_hi[1]);
          }
        }
#pragma unroll
        for (int n4 = 0; n4 < (kTD / 8); ++n4) {
          const int col = n4 * 8 + 2 * q;
          *reinterpret_cast<float2*>(ss + (i0 + g) * kLdF + col) =
              make_float2(st[n4][0], st[n4][1]);
          *reinterpret_cast<float2*>(ss + (i0 + g + 8) * kLdF + col) =
              make_float2(st[n4][2], st[n4][3]);
        }
      }
      __syncthreads();                 // this x buffer is refilled next
    }
  }
  if (sg == nseg - 1) {                // the final state
    for (int e = threadIdx.x; e < nh * kTD * kTD / 4; e += kOutThreads) {
      const int hh = e / (kTD * kTD / 4), i4 = e % (kTD * kTD / 4);
      const int row = i4 / (kTD / 4), col = (i4 % (kTD / 4)) * 4;
      reinterpret_cast<float4*>(
          out_state + (static_cast<size_t>(b) * H + h0 + hh) * kTD * kTD)[i4] =
          *reinterpret_cast<const float4*>(s_s + (hh * kTD + row) * kLdF + col);
    }
  }
}

constexpr size_t kTStateSmem = kPairHeads * kTQ * kLdF * sizeof(float) +
                               kTQ * kLdH * sizeof(__nv_bfloat16) +
                               kPairHeads * (sizeof(Decay) + kTQ * 4 + 4);
constexpr size_t kTOutSmem =
    (2 * kTQ * kLdF + kPairHeads * kTD * kLdF + kTQ * kLdG) * sizeof(float) +
    2 * kTQ * kLdH * sizeof(__nv_bfloat16) +
    kPairHeads * (sizeof(Decay) + kTQ * 4 + 4);

int launch_tc(const float* xdt, const float* la, const __nv_bfloat16* bm,
              const __nv_bfloat16* cm, const float* state0, float* y,
              float* out_state, float* ws, float* dec, int B, int S, int H,
              cudaStream_t stream) {
  // cudaFuncSetAttribute once (a function-local static is initialised
  // once, thread-safely), so a launch inside a CUDA-graph capture makes no
  // attribute call
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_seg_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kTStateSmem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_seg_out_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kTOutSmem));
  }();
  if (attr != cudaSuccess) return attr;
  const int nc = (S + kTQ - 1) / kTQ;
  const int nseg = (nc + kSegChunks - 1) / kSegChunks;
  const int npair = (H + kPairHeads - 1) / kPairHeads;
  const long long blocks = static_cast<long long>(B) * nseg * npair;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_seg_state_kernel<<<static_cast<unsigned>(blocks), kStateThreads,
                         kTStateSmem, stream>>>(xdt, la, bm, state0, ws, dec,
                                                S, H, nc, nseg, npair);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_seg_out_kernel<<<static_cast<unsigned>(blocks), kOutThreads, kTOutSmem,
                       stream>>>(xdt, la, bm, cm, ws, dec, y, out_state, S, H,
                                 nc, nseg, npair);
  return cudaGetLastError();
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

// The tensor-core route: N = P = 64, bf16 B and C, S >= 64; with nseg =
// ceil(S / 256) segments, ws holds B H (nseg + 1) states of 64 x 64
// float32 (the initial state, then each segment's contribution) and dec
// B H nseg float32 (each segment's decay)
extern "C" int ssd_scan_tc_launch(const void* xdt, const void* la,
                                  const void* bm, const void* cm,
                                  const void* state0, void* y,
                                  void* out_state, void* ws, void* dec, int B,
                                  int S, int H, void* stream) {
  if (B <= 0 || H <= 0 || S < kTQ) return cudaErrorInvalidValue;
  return launch_tc(static_cast<const float*>(xdt),
                   static_cast<const float*>(la),
                   static_cast<const __nv_bfloat16*>(bm),
                   static_cast<const __nv_bfloat16*>(cm),
                   static_cast<const float*>(state0), static_cast<float*>(y),
                   static_cast<float*>(out_state), static_cast<float*>(ws),
                   static_cast<float*>(dec), B, S, H,
                   static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the tensor-core route's launches 1 and 2 (bytes)
extern "C" int ssd_scan_tc_smem(int launch) {
  return launch == 1 ? static_cast<int>(kTStateSmem)
                     : launch == 2 ? static_cast<int>(kTOutSmem) : 0;
}

namespace {

// -- backward ---------------------------------------------------------------
//
// The gradients of the scan from y's gradient dy (and the final state's,
// dsT; null: zero).  y_t reads S_t, so with G_t the gradient that reaches
// S_t, walking t from the last step down:
//     G_t += C_t dy_t^T
//     dxdt_t = G_t^T B_t          dB_t = G_t xdt_t (summed over heads)
//     dC_t = S_t dy_t (summed over heads)
//     dla_t = a_t sum(G_t o S_{t-1})
//     G_{t-1} = a_t G_t,          dstate0 = G_{-1}.
// Replaces no TPU kernel (the reference trains through jnp, and no Pallas
// kernel has a VJP); it is B5's backward for training on the card.
//
// Design, as B4's backward (csrc/rwkv6_scan.cu): one block per (batch,
// head) holds the N x P state, a thread a row segment of 16 columns; dB
// and dC are sums along a row (16 terms, then NQ lanes), dxdt a sum down a
// column (shuffles over a warp's rows, then the warps' partials through
// shared memory in warp order), dla a sum over both.  S_{t-1} comes from
// the chunk entry states the block stores on a forward pass (a float32
// workspace of B H ceil(S / 32) N P), recomputed forward to each
// sub-chunk of 8 steps, whose entry states stay in registers; S_t is one
// more step from S_{t-1}.  B and C are one group shared by the heads, so
// their gradients sum over H: each block writes its head's terms into a
// float32 workspace (B S H N, one for each), a second kernel sums them in
// head order.  No float atomics: two runs give the same bits.
//
// Bound on this card: about 12 flops a state element and step (the
// recompute aside), so at the zamba2-7b training shape (B 4, S 2048, H
// 112, N = P = 64) 45 GFLOP, 0.67 ms at the 67 TFLOP/s float32 CUDA-core
// peak, against 0.35 GB of inputs and gradients (0.1 ms): operations.  A
// simple kernel that is right first, on CUDA cores; the chunked
// tensor-core form of the forward is the later design (ROADMAP Queue B).

constexpr int kBwdCols = 16;    // state columns a thread holds
constexpr int kBwdChunk = 32;   // steps staged at once; stored-state interval
constexpr int kBwdSub = 8;      // entry states a thread keeps in registers
// column segments a row: 64 columns, zeros past P (one build serves every
// P <= 64)
constexpr int kBwdSegs = 4;

template <int N>
__global__ void __launch_bounds__((N > 32 / kBwdSegs ? N : 32 / kBwdSegs) *
                                  kBwdSegs)
ssd_scan_bwd_kernel(const float* __restrict__ xdt,
                    const float* __restrict__ la,
                    const void* __restrict__ bm, const void* __restrict__ cm,
                    int bc_bf16, const float* __restrict__ state0,
                    const float* __restrict__ dy,
                    const float* __restrict__ dsT, float* __restrict__ dxdt,
                    float* __restrict__ dla, float* __restrict__ db_part,
                    float* __restrict__ dc_part, float* __restrict__ ds0,
                    float* __restrict__ ws, int S, int H, int P) {
  constexpr int NQ = kBwdSegs;
  constexpr int R = N > 32 / NQ ? N : 32 / NQ;   // rows, dummies past N
  constexpr int PP = NQ * kBwdCols;              // columns, zeros past P
  constexpr int NT = R * NQ;
  constexpr int NW = NT / 32;
  __shared__ float x_s[kBwdChunk][PP];
  __shared__ float dy_s[kBwdChunk][PP];
  __shared__ float b_s[kBwdChunk][N];
  __shared__ float c_s[kBwdChunk][N];
  __shared__ float a_s[kBwdChunk];
  __shared__ float dxp[2][NW][PP];       // each warp's dxdt partial
  __shared__ float dlp[2][NW];           // ... and its dla partial

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = tid / NQ, q = tid - n * NQ;      // row, column segment
  const int j0 = q * kBwdCols;
  const bool row_ok = n < N;
  const int nc = (S + kBwdChunk - 1) / kBwdChunk;
  const size_t st_off = static_cast<size_t>(bh) * N * P;
  float* wsb = ws + static_cast<size_t>(bh) * nc * N * P;

  auto stage = [&](int c, bool grads) {
    const int t0 = c * kBwdChunk;
    const int m = min(kBwdChunk, S - t0);
    __syncthreads();                     // the previous chunk is consumed
    for (int e = tid; e < m * PP; e += NT) {
      const int t = e / PP, jj = e - t * PP;
      const size_t g = ((static_cast<size_t>(b) * S + t0 + t) * H + h) * P + jj;
      x_s[t][jj] = jj < P ? xdt[g] : 0.f;
      dy_s[t][jj] = grads && jj < P ? dy[g] : 0.f;
    }
    for (int e = tid; e < m * N; e += NT) {
      const int t = e / N, nn = e - t * N;
      const size_t g = (static_cast<size_t>(b) * S + t0 + t) * N + nn;
      if (bc_bf16) {
        b_s[t][nn] = to_f32(static_cast<const __nv_bfloat16*>(bm)[g]);
        c_s[t][nn] = to_f32(static_cast<const __nv_bfloat16*>(cm)[g]);
      } else {
        b_s[t][nn] = static_cast<const float*>(bm)[g];
        c_s[t][nn] = static_cast<const float*>(cm)[g];
      }
    }
    for (int t = tid; t < m; t += NT)
      a_s[t] = expf(la[(static_cast<size_t>(b) * S + t0 + t) * H + h]);
    __syncthreads();
    return m;
  };
  auto advance = [&](float* st, int t) {
    const float a = a_s[t];
    const float bn = row_ok ? b_s[t][n] : 0.f;
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e)
      st[e] = fmaf(a, st[e], bn * x_s[t][j0 + e]);
  };
  auto ws_at = [&](int c, int e) -> float* {
    return wsb + (static_cast<size_t>(c) * N + n) * P + j0 + e;
  };

  // 1. forward: each chunk's entry state into the workspace
  float st[kBwdCols];
#pragma unroll
  for (int e = 0; e < kBwdCols; ++e)
    st[e] = state0 && row_ok && j0 + e < P
                ? state0[st_off + static_cast<size_t>(n) * P + j0 + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    if (row_ok) {
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e)
        if (j0 + e < P) *ws_at(c, e) = st[e];
    }
    if (c + 1 == nc) break;
    const int m = stage(c, false);
    for (int t = 0; t < m; ++t) advance(st, t);
  }

  // 2. backward, chunk by chunk from the last
  float G[kBwdCols];
#pragma unroll
  for (int e = 0; e < kBwdCols; ++e)
    G[e] = dsT && row_ok && j0 + e < P
               ? dsT[st_off + static_cast<size_t>(n) * P + j0 + e] : 0.f;
  int buf = 0;
  for (int c = nc - 1; c >= 0; --c) {
    const int m = stage(c, true);
    const int t0 = c * kBwdChunk;
    for (int s0 = ((m - 1) / kBwdSub) * kBwdSub; s0 >= 0; s0 -= kBwdSub) {
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e)
        st[e] = row_ok && j0 + e < P ? *ws_at(c, e) : 0.f;
      for (int t = 0; t < s0; ++t) advance(st, t);
      float sb[kBwdSub][kBwdCols];
#pragma unroll
      for (int a = 0; a < kBwdSub; ++a) {
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e) sb[a][e] = st[e];
        if (s0 + a < m) advance(st, s0 + a);
      }
#pragma unroll
      for (int a = kBwdSub - 1; a >= 0; --a) {
        const int tl = s0 + a;
        if (tl >= m) continue;           // uniform across the block
        const float at = a_s[tl];
        const float bn = row_ok ? b_s[tl][n] : 0.f;
        const float cn = row_ok ? c_s[tl][n] : 0.f;
        float pc = 0.f, pb = 0.f, pl = 0.f, px[kBwdCols];
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e) {
          const float xj = x_s[tl][j0 + e], gj = dy_s[tl][j0 + e];
          const float cur = fmaf(at, sb[a][e], bn * xj);      // S_t
          const float g = fmaf(cn, gj, G[e]);                 // G_t
          pc = fmaf(cur, gj, pc);
          pb = fmaf(g, xj, pb);
          pl = fmaf(g, sb[a][e], pl);
          px[e] = g * bn;
          G[e] = at * g;
        }
#pragma unroll
        for (int o = 1; o < NQ; o <<= 1) {
          pc += __shfl_xor_sync(0xffffffffu, pc, o);
          pb += __shfl_xor_sync(0xffffffffu, pb, o);
          pl += __shfl_xor_sync(0xffffffffu, pl, o);
        }
        const size_t g = (static_cast<size_t>(b) * S + t0 + tl) * H + h;
        if (q == 0 && row_ok) {
          dc_part[g * N + n] = pc;
          db_part[g * N + n] = pb;
        }
#pragma unroll
        for (int o = NQ; o < 32; o <<= 1) {
#pragma unroll
          for (int e = 0; e < kBwdCols; ++e)
            px[e] += __shfl_xor_sync(0xffffffffu, px[e], o);
          pl += __shfl_xor_sync(0xffffffffu, pl, o);
        }
        if (lane < NQ) {
#pragma unroll
          for (int e = 0; e < kBwdCols; ++e) dxp[buf][warp][j0 + e] = px[e];
        }
        if (lane == 0) dlp[buf][warp] = pl;
        __syncthreads();
        for (int jj = tid; jj < P; jj += NT) {
          float acc = 0.f;
          for (int x = 0; x < NW; ++x) acc += dxp[buf][x][jj];
          dxdt[g * P + jj] = acc;
        }
        if (tid == 0) {
          float acc = 0.f;
          for (int x = 0; x < NW; ++x) acc += dlp[buf][x];
          dla[g] = at * acc;
        }
        buf ^= 1;
      }
    }
  }
  if (ds0 && row_ok) {
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e)
      if (j0 + e < P) ds0[st_off + static_cast<size_t>(n) * P + j0 + e] = G[e];
  }
}

// dB and dC: the heads' terms summed in head order, rounded to the dtype
// of B and C
template <typename T>
__global__ void ssd_scan_bwd_bc_kernel(const float* __restrict__ db_part,
                                       const float* __restrict__ dc_part,
                                       T* __restrict__ db, T* __restrict__ dc,
                                       long long rows, int H, int N) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= rows * N) return;
  const long long row = e / N;
  const int nn = static_cast<int>(e - row * N);
  const size_t base = static_cast<size_t>(row) * H * N + nn;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += db_part[base + static_cast<size_t>(h) * N];
    sc += dc_part[base + static_cast<size_t>(h) * N];
  }
  db[e] = from_f32<T>(sb);
  dc[e] = from_f32<T>(sc);
}

template <int N>
cudaError_t launch_bwd(const float* xdt, const float* la, const void* bm,
                       const void* cm, int bc_bf16, const float* state0,
                       const float* dy, const float* dsT, float* dxdt,
                       float* dla, float* db_part, float* dc_part, float* ds0,
                       float* ws, int B, int S, int H, int P,
                       cudaStream_t stream) {
  constexpr int R = N > 32 / kBwdSegs ? N : 32 / kBwdSegs;
  ssd_scan_bwd_kernel<N><<<B * H, R * kBwdSegs, 0, stream>>>(
      xdt, la, bm, cm, bc_bf16, state0, dy, dsT, dxdt, dla, db_part, dc_part,
      ds0, ws, S, H, P);
  return cudaGetLastError();
}

}  // namespace

// B5's backward: xdt, la, Bm/Cm (bc dtype), state0 (null: zeros), dy, dsT
// (null: zero) in; dxdt (B, S, H, P), dla (B, S, H), ds0 (B, H, N, P;
// null: not wanted) float32 and dB, dC (B, S, N, bc dtype) out; db_part
// and dc_part float32 B S H N and ws float32 B H ceil(S / 32) N P (each
// chunk's entry state) as workspace.  N one of 4, 8, 16, 32, 64; 1 <= P <= 64.
extern "C" int ssd_scan_bwd_launch(
    const void* xdt, const void* la, const void* bm, const void* cm,
    const void* state0, const void* dy, const void* dsT, void* dxdt,
    void* dla, void* db, void* dc, void* ds0, void* db_part, void* dc_part,
    void* ws, int B, int S, int H, int N, int P, int bc_dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0 || P > 64 ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      (bc_dtype != kFloat32 && bc_dtype != kBFloat16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(xdt);
  const float* lf = static_cast<const float*>(la);
  const float* s0 = static_cast<const float*>(state0);
  const float* dyf = static_cast<const float*>(dy);
  const float* dsf = static_cast<const float*>(dsT);
  float* dxf = static_cast<float*>(dxdt);
  float* dlf = static_cast<float*>(dla);
  float* dbp = static_cast<float*>(db_part);
  float* dcp = static_cast<float*>(dc_part);
  float* d0 = static_cast<float*>(ds0);
  float* wsf = static_cast<float*>(ws);
  const int bf = bc_dtype == kBFloat16;
  cudaError_t e;
  switch (N) {
    case 4: e = launch_bwd<4>(xf, lf, bm, cm, bf, s0, dyf, dsf, dxf, dlf, dbp, dcp, d0, wsf, B, S, H, P, s); break;
    case 8: e = launch_bwd<8>(xf, lf, bm, cm, bf, s0, dyf, dsf, dxf, dlf, dbp, dcp, d0, wsf, B, S, H, P, s); break;
    case 16: e = launch_bwd<16>(xf, lf, bm, cm, bf, s0, dyf, dsf, dxf, dlf, dbp, dcp, d0, wsf, B, S, H, P, s); break;
    case 32: e = launch_bwd<32>(xf, lf, bm, cm, bf, s0, dyf, dsf, dxf, dlf, dbp, dcp, d0, wsf, B, S, H, P, s); break;
    case 64: e = launch_bwd<64>(xf, lf, bm, cm, bf, s0, dyf, dsf, dxf, dlf, dbp, dcp, d0, wsf, B, S, H, P, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const long long rows = static_cast<long long>(B) * S;
  const long long blocks = (rows * N + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (bf)
    ssd_scan_bwd_bc_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), 256,
                                            0, s>>>(
        dbp, dcp, static_cast<__nv_bfloat16*>(db),
        static_cast<__nv_bfloat16*>(dc), rows, H, N);
  else
    ssd_scan_bwd_bc_kernel<float><<<static_cast<unsigned>(blocks), 256, 0,
                                    s>>>(dbp, dcp, static_cast<float*>(db),
                                         static_cast<float*>(dc), rows, H, N);
  return cudaGetLastError();
}
