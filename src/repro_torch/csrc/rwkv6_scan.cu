// RWKV-6 wkv recurrence for Hopper: for every (batch, head), with an f32
// K x V state S,
//     y_t = r_t . (S + (u o k_t) v_t^T),    S <- diag(w_t) S + k_t v_t^T,
// returning y (B, S, H, V) f32 and the final state (B, H, K, V) f32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_scan
// (_rwkv_kernel), which walks time as the inner grid axis with the state in
// VMEM scratch, in tiles of t_blk steps, and needs S % t_blk == 0.  Any
// S >= 0 works here.  Two routes, picked by the wrapper from shapes only
// (kernels/rwkv6_scan.py:tensor_core_route):
//
// The tensor-core route (K = V = 64, S >= 64: every rwkv6-3b prefill) is
// the chunked form of gated linear attention with sub-chunk decay
// references (Yang et al., arXiv:2312.06635, sec. 4), in chunks of L = 64
// steps and sub-chunks of 16, as three launches:
//   1. per (batch, head, chunk), in parallel: the chunk's own state
//      contribution dS = sum_j (k_j o prod_{j<t<L} w_t) v_j^T and its decay
//      prod_t w_t, into a float32 workspace (16 KB a chunk and head);
//   2. one thread per state element: the chunks in order, S_{c+1} =
//      diag(dec_c) S_c + dS_c, each chunk's entry state left in the
//      workspace, the final state into out_state;
//   3. per (batch, head, chunk), in parallel: the outputs,
//      y_i = (r_i o prod_{t<i} w_t) . S_c + sum_{j<=i} A_ij v_j, where
//      A_ij = r_i . (k_j o prod_{j<t<i} w_t) for j < i and the bonus
//      r_i . (u o k_i) on the diagonal; two warps a sub-chunk of rows.
// So 640 blocks of 4 warps (launch 1) and of 8 (launch 3) at the prefill
// (B 1, S 1024, H 40) instead of 40 blocks of 2 warps, each walking 1024
// dependent steps.  Each thread issues all its loads of a staged tile
// before it converts and stores any of them.
//
// Decays are products of w, never logs: w holds exact zeros and denormals
// at the full-width decay range (exp(-exp(x)), x ~ N(0, 1)), where log w is
// -inf and a difference of two cumulative logs is NaN, and where one
// chunk's cumulative log reaches -100 and more, so that a decay formed as
// exp(c_i - c_j) loses five digits.  Every factor formed is a product of
// w over a range of steps, so <= 1, and underflows to 0 where the true
// factor is negligible.  The pairs j < i of one sub-chunk take
// prod_{j<t<i} w_t directly, each lane walking j down from i - 1 with a
// running product (CUDA cores, 16 x 16 x K a sub-chunk).  Pairs across
// sub-chunks split the product at i's sub-chunk start b:
//     (r_i o prod_{b<=t<i} w_t) . (k_j o prod_{j<t<b} w_t),
// a tensor-core product of two factors <= 1 (mma.sync m16n8k8 TF32).
//
// Accuracy: the route meets the wkv's 1e-5 relative limit (max |d| over
// max(1, max |plain|)).  One rounding to TF32 (10 bits) of a decayed r or
// k does not (tests/test_torch_scans.py shows it), so every product splits
// its float32 operands as hi + lo, both TF32, and takes lo.hi + hi.lo +
// hi.hi (3xTF32, about 2^-21 relative).  Where one operand is exact in
// TF32 two products suffice: v in A.V and in k^T V when r, k, v are bf16
// (8 significant bits).  A CPU mirror of this arithmetic
// (tests/test_torch_scans.py) stays 2e-7 from the plain version, zeros and
// denormals in w included.
//
// Bound on this card, at the full-width prefill (B 1, S 1024, H 40,
// K = V 64): bytes.  The function moves about 38 MB (bf16 r, k, v; f32 w,
// y; the state read and written): 0.0114 ms at 3.35 TB/s.  Its 0.85 GFLOP
// (5 flops a state element and step plus 2K + 2V for the bonus) take
// 0.0017 ms at the 494.7 TFLOP/s TF32 tensor-core peak (0.0127 ms at the
// 67 TFLOP/s float32 CUDA-core peak that bounded the first design).  The
// route does more: the chunked form's products (about 3x the function's
// flops at L 64), split 2-3 ways, and a 10.5 MB workspace written and read
// twice, which the 50 MB L2 holds.  Measured there (NVIDIA H100 80GB HBM3
// at 700 W, torch.profiler device time, mean of 20 calls): launches 1, 2
// and 3 take 0.0156, 0.0101 and 0.0432 ms, 0.0689 ms in all, 6x the bound;
// the CUDA-core route takes 0.891 ms at the same shape.  In launch 3 the
// staging costs 18 us, the pairs inside sub-chunks, the cross products and
// the y products 6-10 us each (removed one at a time).
//
// The CUDA-core route (every other width, S < 64, and so every decode
// step): one block per (batch, head), V threads; thread v keeps the column
// S[:, v] in K registers (K a template parameter: 8, 16, 32 or 64).  kSteps
// time steps of r, k, w and v are staged in shared memory at once
// (converted to float32 there), one barrier pair per kSteps steps; the
// bonus term r_t . (u o k_t) is computed once per step while staging; w is
// multiplied in directly.  The state is read once and written once, so
// out_state may alias state0 (each thread reads its whole column before it
// writes it), which is how the decode step updates the slot state in
// place.  At the decode shape (B 4, S 1) it is bound by the state's read
// and write, 5.2 MB, 0.0016 ms; it takes 0.0057 ms (NVIDIA H100 80GB HBM3
// at 700 W; latency: one step).
//
// r, k, v, w and y are read and written in their (B, S, H, C) layout, with
// no transposes, on both routes; on the tensor-core route out_state may
// alias state0 too (launch 2 reads each element before it writes it, and
// launch 3 reads the entry states from the workspace only).
#include "common.cuh"

namespace {

constexpr int kSteps = 16;   // time steps staged per barrier pair
constexpr int kMaxV = 256;   // value columns (threads) a block takes

template <int K, typename T>
__global__ void __launch_bounds__(kMaxV)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* state0,
                  float* __restrict__ y, float* out_state, int S, int H,
                  int V) {
  __shared__ __align__(16) float r_s[kSteps][K];
  __shared__ __align__(16) float k_s[kSteps][K];
  __shared__ __align__(16) float w_s[kSteps][K];
  __shared__ float v_s[kSteps][kMaxV];
  __shared__ float bonus_s[kSteps];   // r_t . (u o k_t)
  __shared__ float u_s[K];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;           // this thread's value column
  const size_t state_off = static_cast<size_t>(bh) * K * V;

  for (int i = j; i < K; i += V) u_s[i] = u[h * K + i];

  float st[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    st[i] = state0 ? state0[state_off + static_cast<size_t>(i) * V + j] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int n = min(kSteps, S - t0);
    __syncthreads();                   // the previous stage is consumed
    for (int e = j; e < n * K; e += V) {
      const int t = e / K, i = e - t * K;
      const size_t g = ((static_cast<size_t>(b) * S + t0 + t) * H + h) * K + i;
      r_s[t][i] = to_f32<T>(r[g]);
      k_s[t][i] = to_f32<T>(k[g]);
      w_s[t][i] = w[g];
    }
    for (int t = 0; t < n; ++t)
      v_s[t][j] = to_f32<T>(
          v[((static_cast<size_t>(b) * S + t0 + t) * H + h) * V + j]);
    __syncthreads();
    for (int t = j; t < n; t += V) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) a = fmaf(r_s[t][i], u_s[i] * k_s[t][i], a);
      bonus_s[t] = a;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t][j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[t]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[t]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[t]);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        acc = fmaf(rr.x, st[4 * q + 0], acc);
        acc = fmaf(rr.y, st[4 * q + 1], acc);
        acc = fmaf(rr.z, st[4 * q + 2], acc);
        acc = fmaf(rr.w, st[4 * q + 3], acc);
        st[4 * q + 0] = fmaf(ww.x, st[4 * q + 0], kk.x * vj);
        st[4 * q + 1] = fmaf(ww.y, st[4 * q + 1], kk.y * vj);
        st[4 * q + 2] = fmaf(ww.z, st[4 * q + 2], kk.z * vj);
        st[4 * q + 3] = fmaf(ww.w, st[4 * q + 3], kk.w * vj);
      }
      y[((static_cast<size_t>(b) * S + t0 + t) * H + h) * V + j] =
          fmaf(bonus_s[t], vj, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < K; ++i)
    out_state[state_off + static_cast<size_t>(i) * V + j] = st[i];
}

template <int K, typename T>
void launch(const void* r, const void* k, const void* v, const float* w,
            const float* u, const float* state0, float* y, float* out_state,
            int B, int S, int H, int V, cudaStream_t stream) {
  rwkv6_scan_kernel<K, T><<<B * H, V, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, state0, y, out_state, S, H, V);
}

template <typename T>
int dispatch_k(const void* r, const void* k, const void* v, const float* w,
               const float* u, const float* state0, float* y,
               float* out_state, int B, int S, int H, int K, int V,
               cudaStream_t s) {
  switch (K) {
    case 8: launch<8, T>(r, k, v, w, u, state0, y, out_state, B, S, H, V, s); break;
    case 16: launch<16, T>(r, k, v, w, u, state0, y, out_state, B, S, H, V, s); break;
    case 32: launch<32, T>(r, k, v, w, u, state0, y, out_state, B, S, H, V, s); break;
    case 64: launch<64, T>(r, k, v, w, u, state0, y, out_state, B, S, H, V, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}


// -- the tensor-core route: chunks of kL steps, sub-chunks of kSub ----------

constexpr int kL = 64;            // chunk length
constexpr int kSub = 16;          // sub-chunk length: one mma row tile
constexpr int kNSub = kL / kSub;  // sub-chunks a chunk: one warp each
constexpr int kTcThreads = 32 * kNSub;   // launch 1: one warp a sub-chunk
constexpr int kOutThreads = 64 * kNSub;  // launch 3: two warps a sub-chunk
constexpr int kD = 64;            // K = V on this route
constexpr int kLdM = kD + 4;      // row stride of tiles read as [m][k]
constexpr int kLdK = kD + 8;      // row stride of tiles read as [k][n]

// Stage the chunk's rows [t0, t0 + kL) of a (B, S, H, kD) tensor as float32
// into dst[row * ld + col]; rows at or past S take `fill`.  kThreads
// threads: each issues all its 16-byte loads before it converts and stores
// any of them.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_chunk(float* dst, int ld,
                                            const T* __restrict__ src, int b,
                                            int t0, int S, int h, int H,
                                            float fill) {
  constexpr int N = Vec16<T>::N;            // elements in 16 bytes
  constexpr int kVecs = kD / N;
  constexpr int kPer = kL * kVecs / kThreads;
  static_assert(kPer * kThreads == kL * kVecs, "threads must divide the tile");
  uint4 raw[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int t = e / kVecs, c = (e - t * kVecs) * N;
    if (t0 + t < S)
      raw[i] = __ldg(reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * S + t0 + t) * H + h) * kD + c));
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int t = e / kVecs, c = (e - t * kVecs) * N;
    float vals[N];
    if (t0 + t < S) {
      unpack16<T>(raw[i], vals);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) vals[j] = fill;
    }
    float4* d = reinterpret_cast<float4*>(dst + t * ld + c);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      d[q] = make_float4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2],
                         vals[4 * q + 3]);
  }
}

// The pairs j < i of row i = b0 + il inside one sub-chunk, and the bonus:
// over the channels 4 cc + quarter, walking j down from i - 1 with p =
// prod_{j<t<i} w_t (p is 0 until j = i - 1); kJ = the pair columns the row
// can have (8 for rows 0-7 of a sub-chunk, 16 for rows 8-15).
template <int kJ>
__device__ __forceinline__ void intra_pairs(const float* r_s,
                                            const float* k_s,
                                            const float* w_s,
                                            const float* u_s, int b0, int il,
                                            int quarter, float* intra,
                                            float& bonus) {
  const int i = b0 + il;
  for (int cc = 0; cc < kD / 4; ++cc) {
    const int ch = 4 * cc + quarter;
    const float rc = r_s[i * kLdM + ch];
    float p = 0.f;
#pragma unroll
    for (int jj = kJ - 1; jj >= 0; --jj) {
      p = jj == il - 1 ? 1.f : p;
      intra[jj] = fmaf(rc * k_s[(b0 + jj) * kLdM + ch], p, intra[jj]);
      p *= w_s[(b0 + jj) * kLdM + ch];
    }
    bonus = fmaf(rc * u_s[ch], k_s[i * kLdM + ch], bonus);
  }
}

// B operand fragment of v (k = step, n = value column) from a [k][n] tile,
// split unless v is exact in TF32 (bf16 inputs)
template <bool kExact>
__device__ __forceinline__ void v_fragment(const float* v_s, int k0, int n0,
                                           int lane, uint32_t* hi,
                                           uint32_t* lo) {
  const int g = lane >> 2, c = lane & 3;
  const float b0 = v_s[(k0 + c) * kLdK + n0 + g];
  const float b1 = v_s[(k0 + c + 4) * kLdK + n0 + g];
  if constexpr (kExact) {
    hi[0] = __float_as_uint(b0);
    hi[1] = __float_as_uint(b1);
  } else {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
}

// d += a b where b is v: three products, or two when v is exact
template <bool kExact>
__device__ __forceinline__ void mma_v(float* d, const uint32_t* a_hi,
                                      const uint32_t* a_lo,
                                      const uint32_t* b_hi,
                                      const uint32_t* b_lo) {
  if constexpr (kExact) {
    mma_tf32_1688(d, a_lo, b_hi[0], b_hi[1]);
    mma_tf32_1688(d, a_hi, b_hi[0], b_hi[1]);
  } else {
    mma_3xtf32(d, a_hi, a_lo, b_hi, b_lo);
  }
}

// Launch 1: block (bh, c).  dS[K][V] = khat^T V with khat_j = k_j o
// prod_{j<t<kL} w_t, and dec = prod_t w_t, into the workspace.  The decay
// products per channel: each sub-chunk's exclusive suffix product E_j and
// total G_u (a backward walk), then khat_j = k_j E_j prod_{u > sub(j)} G_u.
template <typename T>
__global__ void __launch_bounds__(kTcThreads)
rwkv6_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ w, float* __restrict__ ws,
                         float* __restrict__ dec, int S, int H, int nc) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                       // [kL][kLdK]: k, then khat
  float* v_s = k_s + kL * kLdK;            // [kL][kLdK]
  float* w_s = v_s + kL * kLdK;            // [kL][kD]
  float* g_s = w_s + kL * kD;              // [kNSub][kD]
  const int bh = blockIdx.x / nc, c = blockIdx.x - bh * nc;
  const int b = bh / H, h = bh - b * H, t0 = c * kL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_chunk<T, kTcThreads>(k_s, kLdK, k, b, t0, S, h, H, 0.f);
  stage_chunk<T, kTcThreads>(v_s, kLdK, v, b, t0, S, h, H, 0.f);
  stage_chunk<float, kTcThreads>(w_s, kD, w, b, t0, S, h, H, 1.f);
  __syncthreads();
  const int ch = tid & (kD - 1);
  for (int u = tid / kD; u < kNSub; u += kTcThreads / kD) {
    float e = 1.f;
#pragma unroll
    for (int t = kSub - 1; t >= 0; --t) {
      k_s[(u * kSub + t) * kLdK + ch] *= e;
      e *= w_s[(u * kSub + t) * kD + ch];
    }
    g_s[u * kD + ch] = e;
  }
  __syncthreads();
  for (int u = tid / kD; u < kNSub; u += kTcThreads / kD) {
    float f = 1.f;                         // prod_{u' > u} G_u'
    for (int v2 = kNSub - 1; v2 > u; --v2) f *= g_s[v2 * kD + ch];
#pragma unroll
    for (int t = 0; t < kSub; ++t) k_s[(u * kSub + t) * kLdK + ch] *= f;
    if (u == 0)
      dec[static_cast<size_t>(blockIdx.x) * kD + ch] = g_s[ch] * f;
  }
  __syncthreads();

  // warp: rows (channels) 16 warp .. + 15 of dS, all kD value columns
  const int g = lane >> 2, q = lane & 3, m0 = warp * 16;
  float acc[kD / 8][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < kL / 8; ++ks) {
    uint32_t a_hi[4], a_lo[4];
    const int j = ks * 8 + q;
    split_tf32(k_s[j * kLdK + m0 + g], a_hi[0], a_lo[0]);
    split_tf32(k_s[j * kLdK + m0 + g + 8], a_hi[1], a_lo[1]);
    split_tf32(k_s[(j + 4) * kLdK + m0 + g], a_hi[2], a_lo[2]);
    split_tf32(k_s[(j + 4) * kLdK + m0 + g + 8], a_hi[3], a_lo[3]);
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      uint32_t b_hi[2], b_lo[2];
      v_fragment<kExact>(v_s, ks * 8, nt * 8, lane, b_hi, b_lo);
      mma_v<kExact>(acc[nt], a_hi, a_lo, b_hi, b_lo);
    }
  }
  float* out = ws + static_cast<size_t>(blockIdx.x) * kD * kD;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    const int col = nt * 8 + 2 * q;
    *reinterpret_cast<float2*>(out + (m0 + g) * kD + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (m0 + g + 8) * kD + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Launch 3: block (bh, c); warps s and s + 4 own the rows of sub-chunk s:
// for the pairs inside it, rows 0-7 and 8-15 of it; for the products, the
// column tiles of even and odd index (across sub-chunks) and value columns
// 0-31 and 32-63 (y).
template <typename T>
__global__ void __launch_bounds__(kOutThreads, 2)
rwkv6_chunk_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u,
                       const float* __restrict__ ws, float* __restrict__ y,
                       int S, int H, int nc) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                       // [kL][kLdM]: r, then q
  float* k_s = r_s + kL * kLdM;            // [kL][kLdM]: k, then kE
  float* w_s = k_s + kL * kLdM;            // [kL][kLdM]: w, then A
  float* v_s = w_s + kL * kLdM;            // [kL][kLdK]
  float* s_s = v_s + kL * kLdK;            // [kD][kLdK]: the entry state
  float* g_s = s_s + kD * kLdK;            // [kNSub][kD]
  float* u_s = g_s + kNSub * kD;           // [kD]
  const int bh = blockIdx.x / nc, c = blockIdx.x - bh * nc;
  const int b = bh / H, h = bh - b * H, t0 = c * kL;
  const int tid = threadIdx.x, lane = tid & 31, s = (tid >> 5) & 3;
  const int half = tid >> 7;               // this warp's half of the work

  const float* st = ws + static_cast<size_t>(blockIdx.x) * kD * kD;
  for (int e = tid; e < kD * kD / 4; e += kOutThreads) {
    const int row = e / (kD / 4), col = (e - row * (kD / 4)) * 4;
    cp_async16(s_s + row * kLdK + col, st + row * kD + col, 16);
  }
  cp_async_commit();
  stage_chunk<T, kOutThreads>(r_s, kLdM, r, b, t0, S, h, H, 0.f);
  stage_chunk<T, kOutThreads>(k_s, kLdM, k, b, t0, S, h, H, 0.f);
  stage_chunk<float, kOutThreads>(w_s, kLdM, w, b, t0, S, h, H, 1.f);
  stage_chunk<T, kOutThreads>(v_s, kLdK, v, b, t0, S, h, H, 0.f);
  for (int e = tid; e < kD; e += kOutThreads) u_s[e] = u[h * kD + e];
  cp_async_wait<0>();
  __syncthreads();

  // pairs j < i inside sub-chunk s, and the bonus: lane (il, quarter)
  // takes row i = 16 s + il over the channels 4 cc + quarter
  const int quarter = lane & 3, il = (lane >> 2) + 8 * half;
  const int b0 = s * kSub, i = b0 + il;
  float intra[kSub] = {}, bonus = 0.f;
  if (half == 0)
    intra_pairs<kSub / 2>(r_s, k_s, w_s, u_s, b0, il, quarter, intra, bonus);
  else
    intra_pairs<kSub>(r_s, k_s, w_s, u_s, b0, il, quarter, intra, bonus);
#pragma unroll
  for (int jj = 0; jj < kSub; ++jj) {
    intra[jj] += __shfl_xor_sync(0xffffffffu, intra[jj], 1);
    intra[jj] += __shfl_xor_sync(0xffffffffu, intra[jj], 2);
  }
  bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
  bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
  __syncthreads();                 // r, k and w are read raw for the last time

  // per sub-chunk u and channel: q = r o prod_{b<=t<i} w (forward walk),
  // kE = k o prod_{j<t<end} w (backward walk), G_u = the sub-chunk's product
  const int ch = tid & (kD - 1);
  for (int uu = tid / kD; uu < kNSub; uu += kOutThreads / kD) {
    float p = 1.f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      r_s[(uu * kSub + t) * kLdM + ch] *= p;
      p *= w_s[(uu * kSub + t) * kLdM + ch];
    }
    float e = 1.f;
#pragma unroll
    for (int t = kSub - 1; t >= 0; --t) {
      k_s[(uu * kSub + t) * kLdM + ch] *= e;
      e *= w_s[(uu * kSub + t) * kLdM + ch];
    }
    g_s[uu * kD + ch] = e;
  }
  __syncthreads();                 // w is dead: its tile becomes A

  float* a_s = w_s;
#pragma unroll
  for (int jj = 0; jj < kSub; ++jj)
    if ((jj >> 2) == quarter)
      a_s[i * kLdM + b0 + jj] = jj < il ? intra[jj] : jj == il ? bonus : 0.f;

  // pairs across sub-chunks: A[i][j] = q_i . (kE_j o prod_{t<u'<s} G_u')
  // for j in sub-chunk t < s, 3xTF32; this warp takes column tile `half`
  // of each sub-chunk t
  const int g = lane >> 2, q4 = lane & 3;
  if (s > 0) {
    float cross[kNSub - 1][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < kD / 8; ++ks) {
      const int c0 = ks * 8 + q4, c1 = c0 + 4;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(r_s[(b0 + g) * kLdM + c0], a_hi[0], a_lo[0]);
      split_tf32(r_s[(b0 + g + 8) * kLdM + c0], a_hi[1], a_lo[1]);
      split_tf32(r_s[(b0 + g) * kLdM + c1], a_hi[2], a_lo[2]);
      split_tf32(r_s[(b0 + g + 8) * kLdM + c1], a_hi[3], a_lo[3]);
      float f0 = 1.f, f1 = 1.f;                // prod_{t<u'<s} G_u'
#pragma unroll
      for (int t = kNSub - 2; t >= 0; --t) {
        if (t < s) {
          const int j = t * kSub + half * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(k_s[j * kLdM + c0] * f0, b_hi[0], b_lo[0]);
          split_tf32(k_s[j * kLdM + c1] * f1, b_hi[1], b_lo[1]);
          mma_3xtf32(cross[t], a_hi, a_lo, b_hi, b_lo);
          f0 *= g_s[t * kD + c0];
          f1 *= g_s[t * kD + c1];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kNSub - 1; ++t) {
      if (t < s) {
        const int col = t * kSub + half * 8 + 2 * q4;
        *reinterpret_cast<float2*>(a_s + (b0 + g) * kLdM + col) =
            make_float2(cross[t][0], cross[t][1]);
        *reinterpret_cast<float2*>(a_s + (b0 + g + 8) * kLdM + col) =
            make_float2(cross[t][2], cross[t][3]);
      }
    }
  }
  __syncthreads();                 // A's rows are complete (two warps each)

  // y = (q o prod_{u<s} G_u) . S_c + A V over this warp's 16 rows and 32
  // value columns
  const int nt0 = half * (kD / 16);
  float acc[kD / 16][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < kD / 8; ++ks) {
    const int c0 = ks * 8 + q4, c1 = c0 + 4;
    float p0 = 1.f, p1 = 1.f;
    for (int t = 0; t < s; ++t) {
      p0 *= g_s[t * kD + c0];
      p1 *= g_s[t * kD + c1];
    }
    uint32_t a_hi[4], a_lo[4];
    split_tf32(r_s[(b0 + g) * kLdM + c0] * p0, a_hi[0], a_lo[0]);
    split_tf32(r_s[(b0 + g + 8) * kLdM + c0] * p0, a_hi[1], a_lo[1]);
    split_tf32(r_s[(b0 + g) * kLdM + c1] * p1, a_hi[2], a_lo[2]);
    split_tf32(r_s[(b0 + g + 8) * kLdM + c1] * p1, a_hi[3], a_lo[3]);
#pragma unroll
    for (int n4 = 0; n4 < kD / 16; ++n4) {
      const int col = (nt0 + n4) * 8 + g;
      uint32_t b_hi[2], b_lo[2];
      split_tf32(s_s[c0 * kLdK + col], b_hi[0], b_lo[0]);
      split_tf32(s_s[c1 * kLdK + col], b_hi[1], b_lo[1]);
      mma_3xtf32(acc[n4], a_hi, a_lo, b_hi, b_lo);
    }
  }
  for (int ks = 0; ks < 2 * (s + 1); ++ks) {
    const int j0 = ks * 8 + q4, j1 = j0 + 4;
    uint32_t a_hi[4], a_lo[4];
    split_tf32(a_s[(b0 + g) * kLdM + j0], a_hi[0], a_lo[0]);
    split_tf32(a_s[(b0 + g + 8) * kLdM + j0], a_hi[1], a_lo[1]);
    split_tf32(a_s[(b0 + g) * kLdM + j1], a_hi[2], a_lo[2]);
    split_tf32(a_s[(b0 + g + 8) * kLdM + j1], a_hi[3], a_lo[3]);
#pragma unroll
    for (int n4 = 0; n4 < kD / 16; ++n4) {
      uint32_t b_hi[2], b_lo[2];
      v_fragment<kExact>(v_s, ks * 8, (nt0 + n4) * 8, lane, b_hi, b_lo);
      mma_v<kExact>(acc[n4], a_hi, a_lo, b_hi, b_lo);
    }
  }
#pragma unroll
  for (int half8 = 0; half8 < 2; ++half8) {
    const int t = t0 + b0 + g + 8 * half8;
    if (t < S) {
      float* row = y + ((static_cast<size_t>(b) * S + t) * H + h) * kD;
#pragma unroll
      for (int n4 = 0; n4 < kD / 16; ++n4)
        *reinterpret_cast<float2*>(row + (nt0 + n4) * 8 + 2 * q4) =
            make_float2(acc[n4][2 * half8], acc[n4][2 * half8 + 1]);
    }
  }
}

// Launch 2: the chunks in order, one thread a state element (kD x kD of a
// (batch, head)): ws[c] holds dS_c on entry and the chunk's entry state S_c
// on exit, S_{c+1} = dec_c S_c + dS_c (dec_c one value a state row), from
// S_0 = state0 (zeros when null); the final state goes to out_state, which
// may alias state0 (each element is read before it is written).  No
// reduction: 164k threads at the rwkv6-3b prefill.  Bound by bytes: the
// workspace read and written once (10.5 MB there, which the 50 MB L2
// holds), the loads of kPassGroup chunks in flight before their updates.
constexpr int kPassThreads = 256;
constexpr int kPassGroup = 4;

__global__ void __launch_bounds__(kPassThreads)
rwkv6_chunk_pass_kernel(float* ws, const float* __restrict__ dec,
                        const float* state0, float* out_state, int heads,
                        int nc) {
  constexpr int E = kD * kD;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kPassThreads +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(heads) * E) return;
  const size_t hd = idx / E;
  const int e = static_cast<int>(idx - hd * E);
  float* p = ws + hd * nc * E + e;
  const float* d = dec + hd * nc * kD + e / kD;
  float s = state0 ? state0[idx] : 0.f;
  int c = 0;
  for (; c + kPassGroup <= nc; c += kPassGroup) {
    float x[kPassGroup], f[kPassGroup];
#pragma unroll
    for (int j = 0; j < kPassGroup; ++j) {
      x[j] = p[static_cast<size_t>(c + j) * E];
      f[j] = d[static_cast<size_t>(c + j) * kD];
    }
#pragma unroll
    for (int j = 0; j < kPassGroup; ++j) {
      p[static_cast<size_t>(c + j) * E] = s;
      s = fmaf(f[j], s, x[j]);
    }
  }
  for (; c < nc; ++c) {
    const float x = p[static_cast<size_t>(c) * E];
    const float f = d[static_cast<size_t>(c) * kD];
    p[static_cast<size_t>(c) * E] = s;
    s = fmaf(f, s, x);
  }
  out_state[idx] = s;
}

constexpr size_t kStateSmem =
    (2 * kL * kLdK + kL * kD + kNSub * kD) * sizeof(float);
constexpr size_t kOutSmem = (3 * kL * kLdM + kL * kLdK + kD * kLdK +
                             kNSub * kD + kD) * sizeof(float);

template <typename T>
int launch_tc(const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* state0, float* y,
              float* out_state, float* ws, float* dec, int B, int S, int H,
              cudaStream_t stream) {
  // cudaFuncSetAttribute once per instantiation (a function-local static is
  // initialised once, thread-safely), so a launch inside a CUDA-graph
  // capture makes no attribute call
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_chunk_state_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kStateSmem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(rwkv6_chunk_out_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kOutSmem));
  }();
  if (attr != cudaSuccess) return attr;
  const int nc = (S + kL - 1) / kL;
  const long long blocks = static_cast<long long>(B) * H * nc;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  rwkv6_chunk_state_kernel<T><<<static_cast<unsigned>(blocks), kTcThreads,
                                kStateSmem, stream>>>(kt, vt, w, ws, dec, S,
                                                      H, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long pass_blocks =
      (static_cast<long long>(B) * H * kD * kD + kPassThreads - 1) /
      kPassThreads;
  if (pass_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rwkv6_chunk_pass_kernel<<<static_cast<unsigned>(pass_blocks), kPassThreads,
                            0, stream>>>(ws, dec, state0, out_state, B * H,
                                         nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rwkv6_chunk_out_kernel<T><<<static_cast<unsigned>(blocks), kOutThreads,
                              kOutSmem, stream>>>(rt, kt, vt, w, u, ws, y, S,
                                                  H, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* state0, void* y, void* out_state,
                                 int B, int S, int H, int K, int V,
                                 int rkv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S < 0 || V <= 0 || V > kMaxV ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* yf = static_cast<float*>(y);
  float* sT = static_cast<float*>(out_state);
  if (rkv_dtype == kFloat32)
    return dispatch_k<float>(r, k, v, wf, uf, s0, yf, sT, B, S, H, K, V, s);
  if (rkv_dtype == kBFloat16)
    return dispatch_k<__nv_bfloat16>(r, k, v, wf, uf, s0, yf, sT, B, S, H, K,
                                     V, s);
  return cudaErrorInvalidValue;
}

// The tensor-core route: K = V = 64, S >= 64; ws holds B H ceil(S / 64)
// chunk states of 64 x 64 float32 and dec B H ceil(S / 64) x 64 float32
extern "C" int rwkv6_scan_tc_launch(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, const void* state0,
                                    void* y, void* out_state, void* ws,
                                    void* dec, int B, int S, int H,
                                    int rkv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S < kL) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* yf = static_cast<float*>(y);
  float* sT = static_cast<float*>(out_state);
  float* wsf = static_cast<float*>(ws);
  float* df = static_cast<float*>(dec);
  if (rkv_dtype == kFloat32)
    return launch_tc<float>(r, k, v, wf, uf, s0, yf, sT, wsf, df, B, S, H, s);
  if (rkv_dtype == kBFloat16)
    return launch_tc<__nv_bfloat16>(r, k, v, wf, uf, s0, yf, sT, wsf, df, B,
                                    S, H, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the tensor-core route's launches 1 and 3 (bytes)
extern "C" int rwkv6_scan_tc_smem(int launch) {
  return launch == 1 ? static_cast<int>(kStateSmem)
                     : launch == 3 ? static_cast<int>(kOutSmem) : 0;
}

namespace {

// -- backward ---------------------------------------------------------------
//
// The gradients of the recurrence from y's gradient dy (and, where the final
// state feeds on, its gradient dsT; null: zero).  With G_t the gradient
// that reaches S_t (G_T = dsT), walking t from the last step down:
//     dr_t = (S_{t-1} + (u o k_t) v_t^T) dy_t
//     dk_t = u o r_t (v_t . dy_t) + G_t v_t
//     dv_t = (r_t . (u o k_t)) dy_t + G_t^T k_t
//     dw_t = rowsum(G_t o S_{t-1})
//     du  += r_t o k_t (v_t . dy_t)
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   dstate0 = G_{-1}.
// Replaces no TPU kernel (the reference trains through jnp, whose XLA
// backward is not a Pallas kernel, and no Pallas kernel has a VJP); it is
// B4's backward for training on the card.
//
// Design.  Every element of S (and of G) evolves on its own: row i decays
// by w_t[i], column j takes v_t[j].  So one block per (batch, head) holds
// the whole state, a thread a row segment of 16 columns (row i, columns
// 16q .. 16q + 15, the NQ segments of a row in neighbouring lanes): dr, dk,
// dw and du are sums along a row (the thread's 16 terms, then NQ lanes by
// shuffles), dv a sum down a column (8 / NQ rows a warp by shuffles, then
// the warps' partials through shared memory, summed in warp order).
// S_{t-1} is never recovered by dividing by w_t (w reaches exact zeros at
// the full-width decay range): the block first runs the recurrence forward
// and keeps the state at the start of every chunk of kBwdChunk steps in a
// float32 workspace (B H ceil(S / kBwdChunk) K V); walking back, it reloads
// a chunk's entry state, recomputes forward to the start of each sub-chunk
// of kBwdSub steps and holds that sub-chunk's kBwdSub entry states in
// registers.  That costs 2.5 forward steps a step, on CUDA cores in
// float32.  du sums over batch rows: each block writes its own partial, a
// second kernel sums them in batch order; no float atomics anywhere, so
// two runs give the same bits.
//
// Bound on this card: a K x V state element takes about 10 flops a step
// (4 products forward and back, the recompute aside), so at the rwkv6-3b
// training shape (B 4, S 2048, H 40, K = V = 64) 13.4 GFLOP, 0.2 ms at the
// 67 TFLOP/s float32 CUDA-core peak, against 55 MB of inputs and gradients
// (0.016 ms): operations.  A simple kernel that is right first: 160 blocks
// walking 2048 dependent steps each leave most of the card idle; the
// chunked tensor-core form of the forward is the later design (ROADMAP
// Queue B).

constexpr int kBwdCols = 16;    // value columns a thread holds
constexpr int kBwdChunk = 32;   // steps staged at once; stored-state interval
constexpr int kBwdSub = 8;      // entry states a thread keeps in registers
// column segments a row: 64 columns, zeros past V (one build serves every
// V <= 64)
constexpr int kBwdSegs = 4;

template <int K, typename T>
__global__ void __launch_bounds__((K > 32 / kBwdSegs ? K : 32 / kBwdSegs) *
                                  kBwdSegs)
rwkv6_scan_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ state0,
                      const float* __restrict__ dy,
                      const float* __restrict__ dsT, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      float* __restrict__ ds0, float* __restrict__ ws, int S,
                      int H, int V) {
  constexpr int NQ = kBwdSegs;
  constexpr int R = K > 32 / NQ ? K : 32 / NQ;   // rows, dummies past K
  constexpr int VP = NQ * kBwdCols;              // columns, zeros past V
  constexpr int NT = R * NQ;
  constexpr int NW = NT / 32;
  __shared__ float r_s[kBwdChunk][K];
  __shared__ float k_s[kBwdChunk][K];
  __shared__ float w_s[kBwdChunk][K];
  __shared__ float v_s[kBwdChunk][VP];
  __shared__ float dy_s[kBwdChunk][VP];
  __shared__ float bonus_s[kBwdChunk];   // r_t . (u o k_t)
  __shared__ float vdy_s[kBwdChunk];     // v_t . dy_t
  __shared__ float u_s[K];
  __shared__ float dvp[2][NW][VP];       // each warp's dv partial, two steps

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i = tid / NQ, q = tid - i * NQ;      // row, column segment
  const int j0 = q * kBwdCols;
  const bool row_ok = i < K;
  const int nc = (S + kBwdChunk - 1) / kBwdChunk;
  const size_t st_off = static_cast<size_t>(bh) * K * V;
  float* wsb = ws + static_cast<size_t>(bh) * nc * K * V;

  for (int e = tid; e < K; e += NT) u_s[e] = u[h * K + e];

  // stage chunk c's inputs as float32 (v and dy zero past V), then each
  // step's two scalars
  auto stage = [&](int c, bool grads) {
    const int t0 = c * kBwdChunk;
    const int n = min(kBwdChunk, S - t0);
    __syncthreads();                     // the previous chunk is consumed
    for (int e = tid; e < n * K; e += NT) {
      const int t = e / K, ii = e - t * K;
      const size_t g = ((static_cast<size_t>(b) * S + t0 + t) * H + h) * K + ii;
      r_s[t][ii] = to_f32<T>(r[g]);
      k_s[t][ii] = to_f32<T>(k[g]);
      w_s[t][ii] = w[g];
    }
    for (int e = tid; e < n * VP; e += NT) {
      const int t = e / VP, jj = e - t * VP;
      const size_t g = ((static_cast<size_t>(b) * S + t0 + t) * H + h) * V + jj;
      v_s[t][jj] = jj < V ? to_f32<T>(v[g]) : 0.f;
      dy_s[t][jj] = grads && jj < V ? dy[g] : 0.f;
    }
    __syncthreads();
    if (grads) {
      for (int t = tid; t < n; t += NT) {
        float a = 0.f, c2 = 0.f;
        for (int ii = 0; ii < K; ++ii) a = fmaf(r_s[t][ii], u_s[ii] * k_s[t][ii], a);
        for (int jj = 0; jj < VP; ++jj) c2 = fmaf(v_s[t][jj], dy_s[t][jj], c2);
        bonus_s[t] = a;
        vdy_s[t] = c2;
      }
      __syncthreads();
    }
    return n;
  };
  // one forward step of this thread's row segment
  auto advance = [&](float* st, int t) {
    const float wi = row_ok ? w_s[t][i] : 1.f;
    const float ki = row_ok ? k_s[t][i] : 0.f;
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e)
      st[e] = fmaf(wi, st[e], ki * v_s[t][j0 + e]);
  };
  auto ws_at = [&](int c, int e) -> float* {
    return wsb + (static_cast<size_t>(c) * K + i) * V + j0 + e;
  };

  // 1. forward: each chunk's entry state into the workspace
  float st[kBwdCols];
#pragma unroll
  for (int e = 0; e < kBwdCols; ++e)
    st[e] = state0 && row_ok && j0 + e < V
                ? state0[st_off + static_cast<size_t>(i) * V + j0 + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    if (row_ok) {
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e)
        if (j0 + e < V) *ws_at(c, e) = st[e];
    }
    if (c + 1 == nc) break;              // the last chunk's steps: unused
    const int n = stage(c, false);
    for (int t = 0; t < n; ++t) advance(st, t);
  }

  // 2. backward, chunk by chunk from the last
  float G[kBwdCols];
#pragma unroll
  for (int e = 0; e < kBwdCols; ++e)
    G[e] = dsT && row_ok && j0 + e < V
               ? dsT[st_off + static_cast<size_t>(i) * V + j0 + e] : 0.f;
  const float ui = row_ok ? u_s[i] : 0.f;
  float du_acc = 0.f;
  int buf = 0;
  for (int c = nc - 1; c >= 0; --c) {
    const int n = stage(c, true);
    const int t0 = c * kBwdChunk;
    for (int s0 = ((n - 1) / kBwdSub) * kBwdSub; s0 >= 0; s0 -= kBwdSub) {
      // the entry states of steps s0 .. s0 + kBwdSub - 1 of the chunk
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e)
        st[e] = row_ok && j0 + e < V ? *ws_at(c, e) : 0.f;
      for (int t = 0; t < s0; ++t) advance(st, t);
      float sb[kBwdSub][kBwdCols];
#pragma unroll
      for (int a = 0; a < kBwdSub; ++a) {
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e) sb[a][e] = st[e];
        if (s0 + a < n) advance(st, s0 + a);
      }
#pragma unroll
      for (int a = kBwdSub - 1; a >= 0; --a) {
        const int tl = s0 + a;
        if (tl >= n) continue;           // uniform across the block
        const float ri = row_ok ? r_s[tl][i] : 0.f;
        const float ki = row_ok ? k_s[tl][i] : 0.f;
        const float wi = row_ok ? w_s[tl][i] : 1.f;
        float pr = 0.f, pk = 0.f, pw = 0.f, pv[kBwdCols];
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e) {
          const float vj = v_s[tl][j0 + e], gj = dy_s[tl][j0 + e];
          const float g = G[e];
          pr = fmaf(sb[a][e], gj, pr);
          pk = fmaf(g, vj, pk);
          pw = fmaf(g, sb[a][e], pw);
          pv[e] = g * ki;
          G[e] = fmaf(wi, g, ri * gj);
        }
#pragma unroll
        for (int o = 1; o < NQ; o <<= 1) {
          pr += __shfl_xor_sync(0xffffffffu, pr, o);
          pk += __shfl_xor_sync(0xffffffffu, pk, o);
          pw += __shfl_xor_sync(0xffffffffu, pw, o);
        }
        const size_t g = ((static_cast<size_t>(b) * S + t0 + tl) * H + h);
        if (q == 0 && row_ok) {
          const float vdy = vdy_s[tl];
          dr[g * K + i] = fmaf(ui * ki, vdy, pr);
          dk[g * K + i] = fmaf(ui * ri, vdy, pk);
          dw[g * K + i] = pw;
          du_acc = fmaf(ri * ki, vdy, du_acc);
        }
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e) {
#pragma unroll
          for (int o = NQ; o < 32; o <<= 1)
            pv[e] += __shfl_xor_sync(0xffffffffu, pv[e], o);
        }
        if (lane < NQ) {
#pragma unroll
          for (int e = 0; e < kBwdCols; ++e) dvp[buf][warp][j0 + e] = pv[e];
        }
        __syncthreads();
        for (int jj = tid; jj < V; jj += NT) {
          float acc = bonus_s[tl] * dy_s[tl][jj];
          for (int x = 0; x < NW; ++x) acc += dvp[buf][x][jj];
          dv[g * V + jj] = acc;
        }
        buf ^= 1;                        // the next step writes the other
      }
    }
  }
  if (row_ok) {
    if (ds0) {
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e)
        if (j0 + e < V) ds0[st_off + static_cast<size_t>(i) * V + j0 + e] = G[e];
    }
    if (q == 0) du_part[static_cast<size_t>(bh) * K + i] = du_acc;
  }
}

// du[h][i] = the batch rows' partials, summed in batch order
__global__ void rwkv6_scan_bwd_du_kernel(const float* __restrict__ du_part,
                                         float* __restrict__ du, int B,
                                         int HK) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= HK) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<size_t>(b) * HK + e];
  du[e] = acc;
}

struct BwdArgs {
  const void *r, *k, *v;
  const float *w, *u, *state0, *dy, *dsT;
  float *dr, *dk, *dv, *dw, *du_part, *du, *ds0, *ws;
  int B, S, H, V;
};

template <int K, typename T>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr int R = K > 32 / kBwdSegs ? K : 32 / kBwdSegs;
  rwkv6_scan_bwd_kernel<K, T><<<a.B * a.H, R * kBwdSegs, 0, stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.w, a.u, a.state0, a.dy, a.dsT, a.dr,
      a.dk, a.dv, a.dw, a.du_part, a.ds0, a.ws, a.S, a.H, a.V);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int HK = a.H * K;
  rwkv6_scan_bwd_du_kernel<<<(HK + 255) / 256, 256, 0, stream>>>(
      a.du_part, a.du, a.B, HK);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dispatch_k(const BwdArgs& a, int K, cudaStream_t s) {
  switch (K) {
    case 8: return launch_bwd<8, T>(a, s);
    case 16: return launch_bwd<16, T>(a, s);
    case 32: return launch_bwd<32, T>(a, s);
    case 64: return launch_bwd<64, T>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B4's backward: r, k, v (r/k/v dtype), w, u, state0 (null: zeros), dy,
// dsT (null: zero) float32 in; dr, dk, dw (B, S, H, K), dv (B, S, H, V),
// du (H, K), ds0 (B, H, K, V; null: not wanted) float32 out; du_part
// float32 B x H x K and ws float32 B x H x ceil(S / 32) x K x V (each
// chunk's entry state) as workspace.  K one of 8, 16, 32, 64; 1 <= V <= 64; S >= 1.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* state0, const void* dy, const void* dsT,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* du,
    void* ds0, void* ws, int B, int S, int H, int K, int V, int rkv_dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || V <= 0 || V > 64 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const BwdArgs a{r, k, v,
                  static_cast<const float*>(w), static_cast<const float*>(u),
                  static_cast<const float*>(state0),
                  static_cast<const float*>(dy),
                  static_cast<const float*>(dsT), static_cast<float*>(dr),
                  static_cast<float*>(dk), static_cast<float*>(dv),
                  static_cast<float*>(dw), static_cast<float*>(du_part),
                  static_cast<float*>(du), static_cast<float*>(ds0),
                  static_cast<float*>(ws), B, S, H, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rkv_dtype == kFloat32) return bwd_dispatch_k<float>(a, K, s);
  if (rkv_dtype == kBFloat16) return bwd_dispatch_k<__nv_bfloat16>(a, K, s);
  return cudaErrorInvalidValue;
}
