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
// The CUDA-core route, as B4's (csrc/rwkv6_scan.cu): one block per (batch,
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
// Bound on this card at the zamba2-7b training shape (B 4, S 2048, H 112,
// N = P = 64): bytes, the inputs read once and the gradients written once,
// 716 MB, 0.2138 ms at 3.35 TB/s (chip_smoke.py's scan_bwd_cost; its 56.4
// GFLOP take 0.84 ms at the 67 TFLOP/s float32 CUDA-core peak, 0.11 at the
// TF32 tensor-core peak).  448 blocks walking 2048 dependent steps in 4
// waves (13.9 ms there): the route for what the tensor-core route below
// does not take (float32 B and C, other widths, S < 64).

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


// -- backward, the tensor-core route: chunk-parallel ------------------------
//
// N = P = 64, bf16 B and C, S >= 64 (the forward's rule,
// kernels/ssd_scan.py:backward_tensor_core_route), in the forward's chunks
// of kTQ steps and decay pieces.  With S_c the state entering chunk c, G_c
// the gradient that reaches its last state from later steps, cs the
// chunk's inclusive cumsum of la, e_i = exp(cs_i), w_j = exp(cs_last -
// cs_j) and dec_c = exp(cs_last):
//   1. per (batch, chunk, group of kBwdGroup heads): each head's state
//      contribution dS_c = B^T (w o xdt) and gradient contribution dG_c =
//      C^T (e o dy) (B, C exact, the other side split: two TF32 products
//      each) and dec_c;
//   2-3. two passes, one thread a state element (common.cuh): S_{c+1} =
//      dec_c S_c + dS_c up the chunks from state0, G_{c-1} = dec_c G_c +
//      dG_c down them from dsT, ending in dstate0;
//   4. per (batch, chunk, group), in parallel: CB = C B^T once for the
//      group (bf16 m16n8k16, exact), then per head, with L_kj = exp(cs_k -
//      cs_j) for j <= k (0 above, never formed), DX = dy xdt^T, D = DX o L
//      and M = CB o L:
//        dxdt = M^T dy + w o (B G_c)
//        dC  += D B + e o (dy S_c^T),     dB += D^T C + w o (xdt G_c^T)
//        dla_t = sum_{k>=t, j<t} CB_kj D_kj + sum_{k>=t} alpha_k
//                + sum_{j<t} beta_j + dec_c <G_c, S_c>,
//      alpha_k = C_k . (e o dy S_c^T)_k, beta_j = xdt_j . (w o B G_c)_j:
//      dla as a_t <G_t, S_{t-1}> written out, every term a direct sum (no
//      difference of two long sums, every exponent <= 0).  dB and dC sum
//      the group's heads in registers, in head order, into one partial a
//      group;
//   5. dB and dC: the groups' partials summed in group order.
// Products with both sides float32 take three TF32 products, those with a
// bf16 side two.  So 1792 blocks at the zamba2-7b training shape (B 4, S
// 2048, H 112) in launches 1 and 4 instead of 448 blocks that each walk
// 2048 steps, and dB/dC partials of B S (H / 8) N float32 (59 MB there)
// instead of B S H N (470 MB).  The workspace holds S_c and G_c for every
// chunk and head, 2 x 4 B x B H ceil(S / 64) N P (470 MB there, as the
// CUDA-core route's states every 32 steps).  No float atomics: two runs
// give the same bits.
//
// Bound on this card at the training shape: bytes, 0.2138 ms (above).
// Measured (NVIDIA H100 80GB HBM3 at 700 W, launch/scan_timing.py: CUDA
// events a call, torch.profiler a launch): 2.79 ms, 13x the bound, the
// CUDA-core route 13.74 ms in the same run; launch 4 is 1.58 ms of it
// (one block of 8 warps an SM: 150 KB of shared memory), launch 1 0.38
// and the two passes 0.78 (the workspace read and written once each way,
// 0.94 GB).

constexpr int kBwdGroup = 8;            // heads a block: one C B^T, partial
constexpr int kBwdStateThreads = 128;   // launch 1: 4 warps, 16 state rows
constexpr int kBwdOutThreads = 256;     // launch 4: 8 warps
constexpr int kLdT = kTQ + 4;           // row stride of launch 4's float tiles

// e_i = exp(cs_i) of each head's chunk (an exponent of at most 16 terms
// plus the earlier sub-chunks' sums, all <= 0)
__device__ __forceinline__ void chunk_eweights(const Decay* dk, int nh,
                                               float* e_s) {
  for (int e = threadIdx.x; e < nh * kTQ; e += blockDim.x) {
    const int hh = e / kTQ, i = e - hh * kTQ;
    e_s[e] = expf(dk[hh].l[i] + totals(dk[hh], 0, i / kTSub));
  }
}

// Copy a chunk's kTQ rows of 64 float32 (row stride src_ld) into dst[row]
// [ld] by cp.async; rows at or past `rows` are zero-filled.
__device__ __forceinline__ void copy_rows_ld(float* dst, int ld,
                                             const float* src, size_t src_ld,
                                             int rows) {
  for (int e = threadIdx.x; e < kTQ * kTD / 4; e += blockDim.x) {
    const int t = e / (kTD / 4), c = (e - t * (kTD / 4)) * 4;
    const bool live = t < rows;
    cp_async16(dst + t * ld + c, live ? src + t * src_ld + c : src,
               live ? 16 : 0);
  }
}

// Launch 1: block (b, chunk c, group); warp w takes state rows n 16 w ..
// + 15, all 64 columns p, of each head's dS_c and dG_c in turn.
__global__ void __launch_bounds__(kBwdStateThreads)
ssd_bwd_chunk_state_kernel(const float* __restrict__ xdt,
                           const float* __restrict__ la,
                           const __nv_bfloat16* __restrict__ bm,
                           const __nv_bfloat16* __restrict__ cm,
                           const float* __restrict__ dy,
                           float* __restrict__ ws_s, float* __restrict__ ws_g,
                           float* __restrict__ dec, int S, int H, int nc,
                           int ngrp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = reinterpret_cast<float*>(smem_raw);        // [kTQ][kLdF]
  float* dy_s = x_s + kTQ * kLdF;                          // [kTQ][kLdF]
  __nv_bfloat16* b_s =
      reinterpret_cast<__nv_bfloat16*>(dy_s + kTQ * kLdF);  // [kTQ][kLdH]
  __nv_bfloat16* c_s = b_s + kTQ * kLdH;                   // [kTQ][kLdH]
  Decay* dk = reinterpret_cast<Decay*>(c_s + kTQ * kLdH);  // [kBwdGroup]
  float* w_s = reinterpret_cast<float*>(dk + kBwdGroup);   // [group][kTQ]
  float* e_s = w_s + kBwdGroup * kTQ;                      // [group][kTQ]
  float* dc_s = e_s + kBwdGroup * kTQ;                     // [group]
  const int grp = blockIdx.x % ngrp, bc = blockIdx.x / ngrp;
  const int c = bc % nc, b = bc / nc;
  const int h0 = grp * kBwdGroup, nh = min(kBwdGroup, H - h0);
  const int t0 = c * kTQ, rows = min(kTQ, S - t0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3, m0 = warp * 16;
  const size_t xrow = static_cast<size_t>(H) * kTD;
  const size_t bc_off = (static_cast<size_t>(b) * S + t0) * kTD;

  copy_bf16_rows(b_s, bm + bc_off, rows);
  copy_bf16_rows(c_s, cm + bc_off, rows);
  cp_async_commit();
  for (int h4 = 0; h4 < nh; h4 += 4)
    decay_pieces(dk + h4, la, b, t0, S, H, h0 + h4, min(4, nh - h4));
  __syncthreads();
  chunk_weights(dk, nh, w_s, dc_s);
  chunk_eweights(dk, nh, e_s);
  for (int hh = 0; hh < nh; ++hh) {
    const size_t off = (static_cast<size_t>(b) * S + t0) * xrow +
                       static_cast<size_t>(h0 + hh) * kTD;
    copy_rows(x_s, xdt + off, xrow, rows);
    copy_rows(dy_s, dy + off, xrow, rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // dS = B^T (w o xdt), dG = C^T (e o dy): B, C exact, the rest split
    float accS[kTD / 8][4] = {}, accG[kTD / 8][4] = {};
    const float* wj = w_s + hh * kTQ;
    const float* ej = e_s + hh * kTQ;
#pragma unroll 2
    for (int ks = 0; ks < kTQ / 8; ++ks) {
      const int j0 = ks * 8 + q, j1 = j0 + 4;
      uint32_t ab[4], ac[4];
      ab[0] = __float_as_uint(bf16_at(b_s + j0 * kLdH + m0 + g));
      ab[1] = __float_as_uint(bf16_at(b_s + j0 * kLdH + m0 + g + 8));
      ab[2] = __float_as_uint(bf16_at(b_s + j1 * kLdH + m0 + g));
      ab[3] = __float_as_uint(bf16_at(b_s + j1 * kLdH + m0 + g + 8));
      ac[0] = __float_as_uint(bf16_at(c_s + j0 * kLdH + m0 + g));
      ac[1] = __float_as_uint(bf16_at(c_s + j0 * kLdH + m0 + g + 8));
      ac[2] = __float_as_uint(bf16_at(c_s + j1 * kLdH + m0 + g));
      ac[3] = __float_as_uint(bf16_at(c_s + j1 * kLdH + m0 + g + 8));
      const float w0 = wj[j0], w1 = wj[j1], e0 = ej[j0], e1 = ej[j1];
#pragma unroll
      for (int n4 = 0; n4 < kTD / 8; ++n4) {
        const int col = n4 * 8 + g;
        uint32_t hi[2], lo[2];
        split_tf32(w0 * x_s[j0 * kLdF + col], hi[0], lo[0]);
        split_tf32(w1 * x_s[j1 * kLdF + col], hi[1], lo[1]);
        mma_tf32_1688(accS[n4], ab, lo[0], lo[1]);
        mma_tf32_1688(accS[n4], ab, hi[0], hi[1]);
        split_tf32(e0 * dy_s[j0 * kLdF + col], hi[0], lo[0]);
        split_tf32(e1 * dy_s[j1 * kLdF + col], hi[1], lo[1]);
        mma_tf32_1688(accG[n4], ac, lo[0], lo[1]);
        mma_tf32_1688(accG[n4], ac, hi[0], hi[1]);
      }
    }
    // the gradient workspace holds a head's chunks last first (common.cuh's
    // chunk_pass_kernel walks them up the addresses)
    const size_t head = static_cast<size_t>(b) * H + h0 + hh;
    const size_t slot = (head * nc + c) * kTD * kTD;
    const size_t gslot = (head * nc + nc - 1 - c) * kTD * kTD;
#pragma unroll
    for (int n4 = 0; n4 < kTD / 8; ++n4) {
      const int col = n4 * 8 + 2 * q;
      *reinterpret_cast<float2*>(ws_s + slot + (m0 + g) * kTD + col) =
          make_float2(accS[n4][0], accS[n4][1]);
      *reinterpret_cast<float2*>(ws_s + slot + (m0 + g + 8) * kTD + col) =
          make_float2(accS[n4][2], accS[n4][3]);
      *reinterpret_cast<float2*>(ws_g + gslot + (m0 + g) * kTD + col) =
          make_float2(accG[n4][0], accG[n4][1]);
      *reinterpret_cast<float2*>(ws_g + gslot + (m0 + g + 8) * kTD + col) =
          make_float2(accG[n4][2], accG[n4][3]);
    }
    if (threadIdx.x == 0)
      dec[(static_cast<size_t>(b) * H + h0 + hh) * nc + c] = dc_s[hh];
    __syncthreads();                   // x and dy are refilled next
  }
}

// A fragment (rows m0 + g, + 8; columns k0 + c, + 4) of a float tile stored
// [m][k] (kT false) or [k][m] (kT true), split
template <bool kT>
__device__ __forceinline__ void tile_a(const float* t, int m0, int k0,
                                       int lane, uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, c = lane & 3;
  const int m[4] = {m0 + g, m0 + g + 8, m0 + g, m0 + g + 8};
  const int k[4] = {k0 + c, k0 + c, k0 + c + 4, k0 + c + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(kT ? t[k[e] * kLdT + m[e]] : t[m[e] * kLdT + k[e]], hi[e],
               lo[e]);
}

// B fragment (rows k0 + c, + 4; column n0 + g) of a float tile stored
// [n][k] (kT false) or [k][n] (kT true), split
template <bool kT>
__device__ __forceinline__ void tile_b(const float* t, int k0, int n0,
                                       int lane, uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, c = lane & 3;
  const int n = n0 + g, k[2] = {k0 + c, k0 + c + 4};
#pragma unroll
  for (int e = 0; e < 2; ++e)
    split_tf32(kT ? t[k[e] * kLdT + n] : t[n * kLdT + k[e]], hi[e], lo[e]);
}

// A fragment of a bf16 tile stored [m][k] (exact in TF32)
__device__ __forceinline__ void bf16_a(const __nv_bfloat16* t, int m0, int k0,
                                       int lane, uint32_t* a) {
  const int g = lane >> 2, c = lane & 3;
  a[0] = __float_as_uint(bf16_at(t + (m0 + g) * kLdH + k0 + c));
  a[1] = __float_as_uint(bf16_at(t + (m0 + g + 8) * kLdH + k0 + c));
  a[2] = __float_as_uint(bf16_at(t + (m0 + g) * kLdH + k0 + c + 4));
  a[3] = __float_as_uint(bf16_at(t + (m0 + g + 8) * kLdH + k0 + c + 4));
}

// B fragment of a bf16 tile stored [k][n] (exact in TF32)
__device__ __forceinline__ void bf16_b(const __nv_bfloat16* t, int k0, int n0,
                                       int lane, uint32_t* b) {
  const int g = lane >> 2, c = lane & 3;
  b[0] = __float_as_uint(bf16_at(t + (k0 + c) * kLdH + n0 + g));
  b[1] = __float_as_uint(bf16_at(t + (k0 + c + 4) * kLdH + n0 + g));
}

// d += a b, a split (hi, lo) and b exact: two products
__device__ __forceinline__ void mma_2a(float* d, const uint32_t* a_hi,
                                       const uint32_t* a_lo,
                                       const uint32_t* b) {
  mma_tf32_1688(d, a_lo, b[0], b[1]);
  mma_tf32_1688(d, a_hi, b[0], b[1]);
}

// d += a b, a exact and b split (hi, lo): two products
__device__ __forceinline__ void mma_2b(float* d, const uint32_t* a,
                                       const uint32_t* b_hi,
                                       const uint32_t* b_lo) {
  mma_tf32_1688(d, a, b_lo[0], b_lo[1]);
  mma_tf32_1688(d, a, b_hi[0], b_hi[1]);
}

// Launch 4: block (b, chunk c, group), 8 warps; warp (rs, half) = (warp &
// 3, warp >> 2) owns rows 16 rs .. + 15 of the chunk and columns 32 half ..
// + 31 (four n-tiles) of dxdt, dB and dC.  Per head: the tiles arrive by
// cp.async (the next head's during this one's dla; a second buffer that
// loads it during the whole head measured no faster);
// phase A forms D and M
// (the lower column tiles of the warp's rows, interleaved between the
// halves); phase B the products; phase C dla from row prefix and column
// suffix sums of CB o D.
__global__ void __launch_bounds__(kBwdOutThreads, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ xdt,
                     const float* __restrict__ la,
                     const __nv_bfloat16* __restrict__ bm,
                     const __nv_bfloat16* __restrict__ cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ ws_s,
                     const float* __restrict__ ws_g,
                     float* __restrict__ dxdt, float* __restrict__ dla,
                     float* __restrict__ db_part, float* __restrict__ dc_part,
                     int S, int H, int nc, int ngrp) {
  constexpr int ld = kLdT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cb_s = reinterpret_cast<float*>(smem_raw);        // [kTQ][ld] C B^T
  float* x_s = cb_s + kTQ * ld;                             // [kTQ][ld]
  float* dy_s = x_s + kTQ * ld;                             // [kTQ][ld]
  float* sc_s = dy_s + kTQ * ld;                            // [kTD][ld] S_c
  float* gc_s = sc_s + kTD * ld;                            // [kTD][ld] G_c
  float* d_s = gc_s + kTD * ld;                             // [kTQ][ld] D
  float* m_s = d_s + kTQ * ld;                              // [kTQ][ld] M
  __nv_bfloat16* b_s =
      reinterpret_cast<__nv_bfloat16*>(m_s + kTQ * ld);     // [kTQ][kLdH]
  __nv_bfloat16* c_s = b_s + kTQ * kLdH;                    // [kTQ][kLdH]
  Decay* dk = reinterpret_cast<Decay*>(c_s + kTQ * kLdH);   // [kBwdGroup]
  float* w_s = reinterpret_cast<float*>(dk + kBwdGroup);    // [group][kTQ]
  float* e_s = w_s + kBwdGroup * kTQ;                       // [group][kTQ]
  float* dc_s = e_s + kBwdGroup * kTQ;                      // [group]
  float* al_s = dc_s + kBwdGroup;                           // [2][kTQ]
  float* be_s = al_s + 2 * kTQ;                             // [2][kTQ]
  float* rect_s = be_s + 2 * kTQ;                           // [kTQ]
  float* suf_s = rect_s + kTQ;                              // [kTQ]
  float* pre_s = suf_s + kTQ;                               // [kTQ]
  float* gm_s = pre_s + kTQ;                                // [8]
  const int grp = blockIdx.x % ngrp, bc = blockIdx.x / ngrp;
  const int c = bc % nc, b = bc / nc;
  const int h0 = grp * kBwdGroup, nh = min(kBwdGroup, H - h0);
  const int t0 = c * kTQ, rows = min(kTQ, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = warp & 3, half = warp >> 2;
  const int g = lane >> 2, q = lane & 3, rb = rs * 16, cb = half * 32;
  const size_t xrow = static_cast<size_t>(H) * kTD;
  const size_t bc_off = (static_cast<size_t>(b) * S + t0) * kTD;
  auto load_head = [&](int hh) {
    const size_t off = (static_cast<size_t>(b) * S + t0) * xrow +
                       static_cast<size_t>(h0 + hh) * kTD;
    const size_t head = static_cast<size_t>(b) * H + h0 + hh;
    const size_t slot = (head * nc + c) * kTD * kTD;
    const size_t gslot = (head * nc + nc - 1 - c) * kTD * kTD;  // last first
    copy_rows_ld(x_s, ld, xdt + off, xrow, rows);
    copy_rows_ld(dy_s, ld, dy + off, xrow, rows);
    copy_rows_ld(sc_s, ld, ws_s + slot, kTD, kTD);
    copy_rows_ld(gc_s, ld, ws_g + gslot, kTD, kTD);
    cp_async_commit();
  };

  copy_bf16_rows(b_s, bm + bc_off, rows);
  copy_bf16_rows(c_s, cm + bc_off, rows);
  cp_async_commit();
  load_head(0);
  for (int h4 = 0; h4 < nh; h4 += 4)
    decay_pieces(dk + h4, la, b, t0, S, H, h0 + h4, min(4, nh - h4));
  cp_async_wait<1>();                      // B and C (the first head's next)
  __syncthreads();
  chunk_weights(dk, nh, w_s, dc_s);
  chunk_eweights(dk, nh, e_s);
  // C B^T, rows of this warp, the column tiles up to its diagonal,
  // interleaved between the halves: bf16 mma, exact products
  for (int nt = half; nt < 2 * (rs + 1); nt += 2) {
    float acc[4] = {};
#pragma unroll
    for (int ks = 0; ks < kTD / 16; ++ks) {
      const int col = ks * 16 + 2 * q;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(c_s + (rb + g) * kLdH + col);
      a[1] = *reinterpret_cast<const uint32_t*>(c_s + (rb + g + 8) * kLdH +
                                                col);
      a[2] = *reinterpret_cast<const uint32_t*>(c_s + (rb + g) * kLdH + col +
                                                8);
      a[3] = *reinterpret_cast<const uint32_t*>(c_s + (rb + g + 8) * kLdH +
                                                col + 8);
      const __nv_bfloat16* brow = b_s + (nt * 8 + g) * kLdH + col;
      mma_bf16_16816(acc, a, *reinterpret_cast<const uint32_t*>(brow),
                     *reinterpret_cast<const uint32_t*>(brow + 8));
    }
    const int col = nt * 8 + 2 * q;
    *reinterpret_cast<float2*>(cb_s + (rb + g) * ld + col) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(cb_s + (rb + g + 8) * ld + col) =
        make_float2(acc[2], acc[3]);
  }

  float accB[4][4] = {}, accC[4][4] = {};  // the group's dB, dC
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    cp_async_wait<0>();
    __syncthreads();                       // this head's tiles, C B^T
    const Decay& d = dk[hh];
    const float* wj = w_s + hh * kTQ;
    const float* ej = e_s + hh * kTQ;

    // phase A: D = (dy xdt^T) o L and M = CB o L, 0 above the diagonal
    for (int nt = half; nt < 2 * (rs + 1); nt += 2) {
      float acc[4] = {};
#pragma unroll
      for (int ks = 0; ks < kTD / 8; ++ks) {
        uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
        tile_a<false>(dy_s, rb, ks * 8, lane, a_hi, a_lo);
        tile_b<false>(x_s, ks * 8, nt * 8, lane, b_hi, b_lo);
        mma_3xtf32(acc, a_hi, a_lo, b_hi, b_lo);
      }
      const int bj = nt >> 1;
      const float mid = bj < rs ? totals(d, bj + 1, rs) : 0.f;
#pragma unroll
      for (int hh2 = 0; hh2 < 2; ++hh2) {
        const int i = rb + g + 8 * hh2;
        float dv[2], mv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + 2 * q + e;
          dv[e] = mv[e] = 0.f;
          if (j <= i) {
            const float ex = bj == rs ? d.l[i] - d.l[j]
                                      : d.l[i] + d.s[j] + mid;
            const float L = expf(ex);
            dv[e] = acc[2 * hh2 + e] * L;
            mv[e] = cb_s[i * ld + j] * L;
          }
        }
        *reinterpret_cast<float2*>(d_s + i * ld + nt * 8 + 2 * q) =
            make_float2(dv[0], dv[1]);
        *reinterpret_cast<float2*>(m_s + i * ld + nt * 8 + 2 * q) =
            make_float2(mv[0], mv[1]);
      }
    }
    __syncthreads();

    // phase B.  dxdt = M^T dy + w o (B G_c); beta's partial sums
    {
      float acc1[4][4] = {}, acc2[4][4] = {};
      for (int ks = 2 * rs; ks < kTQ / 8; ++ks) {
        uint32_t a_hi[4], a_lo[4];
        tile_a<true>(m_s, rb, ks * 8, lane, a_hi, a_lo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b_hi[2], b_lo[2];
          tile_b<true>(dy_s, ks * 8, cb + nt * 8, lane, b_hi, b_lo);
          mma_3xtf32(acc1[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
#pragma unroll 2
      for (int ks = 0; ks < kTD / 8; ++ks) {
        uint32_t a[4];
        bf16_a(b_s, rb, ks * 8, lane, a);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b_hi[2], b_lo[2];
          tile_b<true>(gc_s, ks * 8, cb + nt * 8, lane, b_hi, b_lo);
          mma_2b(acc2[nt], a, b_hi, b_lo);
        }
      }
#pragma unroll
      for (int hh2 = 0; hh2 < 2; ++hh2) {
        const int j = rb + g + 8 * hh2;
        const float wv = wj[j];
        float beta = 0.f;
        float* row = dxdt + ((static_cast<size_t>(b) * S + t0 + j) * H + h) *
                                kTD;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int p = cb + nt * 8 + 2 * q;
          const float x0 = wv * acc2[nt][2 * hh2];
          const float x1 = wv * acc2[nt][2 * hh2 + 1];
          beta = fmaf(x_s[j * ld + p], x0, beta);
          beta = fmaf(x_s[j * ld + p + 1], x1, beta);
          if (j < rows)
            *reinterpret_cast<float2*>(row + p) =
                make_float2(acc1[nt][2 * hh2] + x0,
                            acc1[nt][2 * hh2 + 1] + x1);
        }
        beta += __shfl_xor_sync(0xffffffffu, beta, 1);
        beta += __shfl_xor_sync(0xffffffffu, beta, 2);
        if (q == 0) be_s[half * kTQ + j] = beta;
      }
    }
    // dC += D B + e o (dy S_c^T); alpha's partial sums
    {
      float E[4][4] = {};
      for (int ks = 0; ks < 2 * (rs + 1); ++ks) {
        uint32_t a_hi[4], a_lo[4];
        tile_a<false>(d_s, rb, ks * 8, lane, a_hi, a_lo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bb[2];
          bf16_b(b_s, ks * 8, cb + nt * 8, lane, bb);
          mma_2a(accC[nt], a_hi, a_lo, bb);
        }
      }
#pragma unroll 2
      for (int ks = 0; ks < kTD / 8; ++ks) {
        uint32_t a_hi[4], a_lo[4];
        tile_a<false>(dy_s, rb, ks * 8, lane, a_hi, a_lo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b_hi[2], b_lo[2];
          tile_b<false>(sc_s, ks * 8, cb + nt * 8, lane, b_hi, b_lo);
          mma_3xtf32(E[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
#pragma unroll
      for (int hh2 = 0; hh2 < 2; ++hh2) {
        const int k = rb + g + 8 * hh2;
        const float ev = ej[k];
        float alpha = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = ev * E[nt][2 * hh2 + e];
            accC[nt][2 * hh2 + e] += x;
            alpha = fmaf(bf16_at(c_s + k * kLdH + cb + nt * 8 + 2 * q + e), x,
                         alpha);
          }
        }
        alpha += __shfl_xor_sync(0xffffffffu, alpha, 1);
        alpha += __shfl_xor_sync(0xffffffffu, alpha, 2);
        if (q == 0) al_s[half * kTQ + k] = alpha;
      }
    }
    // dB += D^T C + w o (xdt G_c^T)
    {
      float X[4][4] = {};
      for (int ks = 2 * rs; ks < kTQ / 8; ++ks) {
        uint32_t a_hi[4], a_lo[4];
        tile_a<true>(d_s, rb, ks * 8, lane, a_hi, a_lo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bb[2];
          bf16_b(c_s, ks * 8, cb + nt * 8, lane, bb);
          mma_2a(accB[nt], a_hi, a_lo, bb);
        }
      }
#pragma unroll 2
      for (int ks = 0; ks < kTD / 8; ++ks) {
        uint32_t a_hi[4], a_lo[4];
        tile_a<false>(x_s, rb, ks * 8, lane, a_hi, a_lo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b_hi[2], b_lo[2];
          tile_b<false>(gc_s, ks * 8, cb + nt * 8, lane, b_hi, b_lo);
          mma_3xtf32(X[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
#pragma unroll
      for (int hh2 = 0; hh2 < 2; ++hh2) {
        const float wv = wj[rb + g + 8 * hh2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          accB[nt][2 * hh2] = fmaf(wv, X[nt][2 * hh2], accB[nt][2 * hh2]);
          accB[nt][2 * hh2 + 1] =
              fmaf(wv, X[nt][2 * hh2 + 1], accB[nt][2 * hh2 + 1]);
        }
      }
    }
    {                                      // <G_c, S_c>, a warp's share
      float x = 0.f;
      for (int e = tid; e < kTD * kTD; e += kBwdOutThreads) {
        const int n = e / kTD, p = e - n * kTD;
        x = fmaf(gc_s[n * ld + p], sc_s[n * ld + p], x);
      }
      x = warp_sum(x);
      if (lane == 0) gm_s[warp] = x;
    }
    __syncthreads();                       // x, dy, S_c, G_c are read
    if (hh + 1 < nh) load_head(hh + 1);

    // phase C: dla.  Row prefixes pre[k][t] = sum_{j<t} CB_kj D_kj (j < k)
    // into M's tile, four threads a row, 16 columns each
    {
      const int k = tid >> 2, sg = tid & 3;
      float tot = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * sg + jj;
        if (j < k) tot = fmaf(cb_s[k * ld + j], d_s[k * ld + j], tot);
      }
      float incl = tot;
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o, 4);
        if (sg >= o) incl += up;
      }
      float run = __shfl_up_sync(0xffffffffu, incl, 1, 4);
      if (sg == 0) run = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * sg + jj;
        m_s[k * ld + j] = run;
        if (j < k) run = fmaf(cb_s[k * ld + j], d_s[k * ld + j], run);
      }
    }
    __syncthreads();
    {                                      // column suffixes: rect_t
      const int t = tid >> 2, sg = tid & 3;
      float x = 0.f;
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const int k = 16 * sg + kk;
        if (k >= t) x += m_s[k * ld + t];
      }
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (sg == 0) rect_s[t] = x;
    }
    if (warp == 0) {                       // suffix sums of alpha
      float lo = al_s[lane] + al_s[kTQ + lane];
      float hi = al_s[lane + 32] + al_s[kTQ + lane + 32];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float a = __shfl_down_sync(0xffffffffu, hi, o);
        const float z = __shfl_down_sync(0xffffffffu, lo, o);
        if (lane + o < 32) {
          hi += a;
          lo += z;
        }
      }
      suf_s[lane + 32] = hi;
      suf_s[lane] = lo + __shfl_sync(0xffffffffu, hi, 0);
    } else if (warp == 1) {                // exclusive prefix sums of beta
      float lo = be_s[lane] + be_s[kTQ + lane];
      float hi = be_s[lane + 32] + be_s[kTQ + lane + 32];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float a = __shfl_up_sync(0xffffffffu, hi, o);
        const float z = __shfl_up_sync(0xffffffffu, lo, o);
        if (lane >= o) {
          hi += a;
          lo += z;
        }
      }
      const float lo_total = __shfl_sync(0xffffffffu, lo, 31);
      float ex_lo = __shfl_up_sync(0xffffffffu, lo, 1);
      float ex_hi = __shfl_up_sync(0xffffffffu, hi, 1);
      if (lane == 0) ex_lo = ex_hi = 0.f;
      pre_s[lane] = ex_lo;
      pre_s[lane + 32] = ex_hi + lo_total;
    }
    __syncthreads();
    if (tid < rows) {
      float gam = 0.f;
#pragma unroll
      for (int x = 0; x < kBwdOutThreads / 32; ++x) gam += gm_s[x];
      dla[(static_cast<size_t>(b) * S + t0 + tid) * H + h] =
          rect_s[tid] + suf_s[tid] + pre_s[tid] + dc_s[hh] * gam;
    }
  }
  // the group's dB and dC partials
#pragma unroll
  for (int hh2 = 0; hh2 < 2; ++hh2) {
    const int t = rb + g + 8 * hh2;
    if (t < rows) {
      const size_t row = ((static_cast<size_t>(b) * S + t0 + t) * ngrp + grp) *
                         kTD;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = cb + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(db_part + row + n) =
            make_float2(accB[nt][2 * hh2], accB[nt][2 * hh2 + 1]);
        *reinterpret_cast<float2*>(dc_part + row + n) =
            make_float2(accC[nt][2 * hh2], accC[nt][2 * hh2 + 1]);
      }
    }
  }
}

constexpr size_t kBwdStateSmem =
    2 * kTQ * kLdF * sizeof(float) + 2 * kTQ * kLdH * sizeof(__nv_bfloat16) +
    kBwdGroup * (sizeof(Decay) + 2 * kTQ * 4 + 4);
constexpr size_t kBwdOutSmem =
    (3 * kTQ * kLdT + 2 * kTD * kLdT + 2 * kTQ * kLdT) * sizeof(float) +
    2 * kTQ * kLdH * sizeof(__nv_bfloat16) +
    kBwdGroup * (sizeof(Decay) + 2 * kTQ * 4 + 4) +
    (7 * kTQ + 8) * sizeof(float);

cudaError_t launch_bwd_tc(const float* xdt, const float* la,
                          const __nv_bfloat16* bm, const __nv_bfloat16* cm,
                          const float* state0, const float* dy,
                          const float* dsT, float* dxdt, float* dla,
                          __nv_bfloat16* db, __nv_bfloat16* dc, float* ds0,
                          float* db_part, float* dc_part, float* ws, int B,
                          int S, int H, cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_chunk_state_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kBwdStateSmem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_chunk_bwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kBwdOutSmem));
  }();
  if (attr != cudaSuccess) return attr;
  const int nc = (S + kTQ - 1) / kTQ;
  const int ngrp = (H + kBwdGroup - 1) / kBwdGroup;
  const long long blocks = static_cast<long long>(B) * nc * ngrp;
  const long long pass_blocks =
      (static_cast<long long>(B) * H * kTD * kTD + kPassThreads - 1) /
      kPassThreads;
  const long long rows = static_cast<long long>(B) * S;
  const long long bc_blocks = (rows * kTD + 255) / 256;
  if (blocks > 0x7fffffffLL || pass_blocks > 0x7fffffffLL ||
      bc_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t states = static_cast<size_t>(B) * H * nc * kTD * kTD;
  float* ws_s = ws;
  float* ws_g = ws + states;
  float* dec = ws_g + states;
  ssd_bwd_chunk_state_kernel<<<static_cast<unsigned>(blocks),
                               kBwdStateThreads, kBwdStateSmem, stream>>>(
      xdt, la, bm, cm, dy, ws_s, ws_g, dec, S, H, nc, ngrp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_pass_kernel<false, false><<<static_cast<unsigned>(pass_blocks),
                                    kPassThreads, 0, stream>>>(
      ws_s, dec, state0, nullptr, B * H, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_pass_kernel<true, false><<<static_cast<unsigned>(pass_blocks),
                                   kPassThreads, 0, stream>>>(
      ws_g, dec, dsT, ds0, B * H, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_chunk_bwd_kernel<<<static_cast<unsigned>(blocks), kBwdOutThreads,
                         kBwdOutSmem, stream>>>(
      xdt, la, bm, cm, dy, ws_s, ws_g, dxdt, dla, db_part, dc_part, S, H, nc,
      ngrp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_scan_bwd_bc_kernel<__nv_bfloat16><<<static_cast<unsigned>(bc_blocks),
                                          256, 0, stream>>>(
      db_part, dc_part, db, dc, rows, ngrp, kTD);
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

// B5's backward on the tensor-core route: N = P = 64, bf16 B and C, S >=
// 64.  Arguments as ssd_scan_bwd_launch's, but db_part and dc_part are
// float32 B S ceil(H / 8) 64 (a partial a group of 8 heads) and ws float32
// 2 B H ceil(S / 64) 64 64 + B H ceil(S / 64) (every chunk's entry state,
// the gradient at its end, its decay).
extern "C" int ssd_scan_bwd_tc_launch(
    const void* xdt, const void* la, const void* bm, const void* cm,
    const void* state0, const void* dy, const void* dsT, void* dxdt,
    void* dla, void* db, void* dc, void* ds0, void* db_part, void* dc_part,
    void* ws, int B, int S, int H, void* stream) {
  if (B <= 0 || H <= 0 || S < kTQ) return cudaErrorInvalidValue;
  return launch_bwd_tc(
      static_cast<const float*>(xdt), static_cast<const float*>(la),
      static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm),
      static_cast<const float*>(state0), static_cast<const float*>(dy),
      static_cast<const float*>(dsT), static_cast<float*>(dxdt),
      static_cast<float*>(dla), static_cast<__nv_bfloat16*>(db),
      static_cast<__nv_bfloat16*>(dc), static_cast<float*>(ds0),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(ws), B, S, H, static_cast<cudaStream_t>(stream));
}
