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
//   2. one thread a state element: the chunks in order, S_{c+1} =
//      diag(dec_c) S_c + dS_c, each chunk's entry state left in the
//      workspace, the final state into out_state (common.cuh's
//      chunk_pass_kernel, which the backwards' passes run too);
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

// The chunk's rows [t0, t0 + kL) of a (B, S, H, kD) tensor, staged as
// float32 into dst[row * ld + col] by kThreads threads in two halves: load
// (each thread's 16-byte loads into registers) and store (converted; rows
// at or past S take `fill`), so that a kernel can issue the loads of all
// its tiles before it waits on any.
template <typename T, int kThreads>
struct ChunkTile {
  static constexpr int N = Vec16<T>::N;          // elements in 16 bytes
  static constexpr int kVecs = kD / N;
  static constexpr int kPer = kL * kVecs / kThreads;
  static_assert(kPer * kThreads == kL * kVecs, "threads must divide the tile");
  uint4 raw[kPer];

  __device__ __forceinline__ void load(const T* __restrict__ src, int b,
                                       int t0, int S, int h, int H) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int t = e / kVecs, c = (e - t * kVecs) * N;
      if (t0 + t < S)
        raw[i] = __ldg(reinterpret_cast<const uint4*>(
            src + ((static_cast<size_t>(b) * S + t0 + t) * H + h) * kD + c));
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld, int t0, int S,
                                        float fill) const {
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
};

// One tile, its loads issued before any is converted and stored.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_chunk(float* dst, int ld,
                                            const T* __restrict__ src, int b,
                                            int t0, int S, int h, int H,
                                            float fill) {
  ChunkTile<T, kThreads> tile;
  tile.load(src, b, t0, S, h, H);
  tile.store(dst, ld, t0, S, fill);
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

// Launch 1: block (bh, c).  dS[K][V] = ahat^T B over the chunk's steps j,
// a and B the tensors `a` and `bsrc` (k and v for the forward); and, unless
// kPrefix, dec = prod_t w_t, into the workspace.  kPrefix false (the
// forward's): ahat_j = a_j o prod_{j<t<kL} w_t, from each sub-chunk's
// exclusive suffix product E_j and total G_u (a backward walk), then
// ahat_j = a_j E_j prod_{u > sub(j)} G_u.  kPrefix true (the backward's
// gradient contributions, a = r, B = dy): ahat_j = a_j o prod_{0<=t<j}
// w_t, from exclusive prefix products (a forward walk) and prod_{u <
// sub(j)} G_u.  B is exact in TF32 when bf16 (two products), else split.
template <typename TA, typename TB, bool kPrefix>
__global__ void __launch_bounds__(kTcThreads)
rwkv6_chunk_state_kernel(const TA* __restrict__ a, const TB* __restrict__ bsrc,
                         const float* __restrict__ w, float* __restrict__ ws,
                         float* __restrict__ dec, int S, int H, int nc) {
  constexpr bool kExact = std::is_same<TB, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                       // [kL][kLdK]: a, then ahat
  float* v_s = k_s + kL * kLdK;            // [kL][kLdK]
  float* w_s = v_s + kL * kLdK;            // [kL][kD]
  float* g_s = w_s + kL * kD;              // [kNSub][kD]
  const int bh = blockIdx.x / nc, c = blockIdx.x - bh * nc;
  const int b = bh / H, h = bh - b * H, t0 = c * kL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_chunk<TA, kTcThreads>(k_s, kLdK, a, b, t0, S, h, H, 0.f);
  stage_chunk<TB, kTcThreads>(v_s, kLdK, bsrc, b, t0, S, h, H, 0.f);
  stage_chunk<float, kTcThreads>(w_s, kD, w, b, t0, S, h, H, 1.f);
  __syncthreads();
  const int ch = tid & (kD - 1);
  for (int u = tid / kD; u < kNSub; u += kTcThreads / kD) {
    float e = 1.f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int t = kPrefix ? i : kSub - 1 - i;
      k_s[(u * kSub + t) * kLdK + ch] *= e;
      e *= w_s[(u * kSub + t) * kD + ch];
    }
    g_s[u * kD + ch] = e;
  }
  __syncthreads();
  for (int u = tid / kD; u < kNSub; u += kTcThreads / kD) {
    float f = 1.f;              // the product of the other sub-chunks' G
    if constexpr (kPrefix) {
      for (int v2 = 0; v2 < u; ++v2) f *= g_s[v2 * kD + ch];
    } else {
      for (int v2 = kNSub - 1; v2 > u; --v2) f *= g_s[v2 * kD + ch];
    }
#pragma unroll
    for (int t = 0; t < kSub; ++t) k_s[(u * kSub + t) * kLdK + ch] *= f;
    if (!kPrefix && u == 0)
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
  // kPrefix: the gradient workspace holds a head's chunks last first
  // (common.cuh's chunk_pass_kernel walks them up the addresses)
  const int slot = kPrefix ? bh * nc + nc - 1 - c : blockIdx.x;
  float* out = ws + static_cast<size_t>(slot) * kD * kD;
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
        rwkv6_chunk_state_kernel<T, T, false>,
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
  rwkv6_chunk_state_kernel<T, T, false><<<static_cast<unsigned>(blocks),
                                          kTcThreads, kStateSmem, stream>>>(
      kt, vt, w, ws, dec, S, H, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long pass_blocks =
      (static_cast<long long>(B) * H * kD * kD + kPassThreads - 1) /
      kPassThreads;
  if (pass_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  chunk_pass_kernel<false, true><<<static_cast<unsigned>(pass_blocks),
                                   kPassThreads, 0, stream>>>(
      ws, dec, state0, out_state, B * H, nc);
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
// The CUDA-core route.  Every element of S (and of G) evolves on its own:
// row i decays by w_t[i], column j takes v_t[j].  So one block per (batch,
// head) holds
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
// Bound on this card at the rwkv6-3b training shape (B 4, S 2048, H 40,
// K = V = 64): bytes, the inputs read once and the gradients written once,
// 503 MB, 0.1502 ms at 3.35 TB/s (chip_smoke.py's scan_bwd_cost; its 16.1
// GFLOP take 0.24 ms at the 67 TFLOP/s float32 CUDA-core peak, 0.033 at
// the TF32 tensor-core peak).  160 blocks walking 2048 dependent steps
// each leave most of the card idle (7.1 ms there): the route for what the
// tensor-core route below does not take (K or V other than 64, S < 64).

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


// -- backward, the tensor-core route: chunk-parallel ------------------------
//
// K = V = 64, S >= 64 (kernels/rwkv6_scan.py:backward_tensor_core_route):
// the forward's chunks of kL steps and sub-chunks of kSub, turned around.
// With S_c the state entering chunk c and G_c the gradient that reaches
// its last state from later steps, every chunk's gradients are local:
//   1. per (batch, head, chunk): the forward's launch 1, the chunk's state
//      contribution dS_c and decay dec_c;
//   2. the same launch with (r, dy) for (k, v) and the decay references
//      reversed: the chunk's gradient contribution dG_c = sum_i (r_i o
//      prod_{c0<=s<i} w_s) dy_i^T (dy float32: 3xTF32);
//   3-4. two passes, one thread a state element (common.cuh): S_{c+1} =
//      diag(dec_c) S_c + dS_c up the chunks from state0, and G_{c-1} =
//      diag(dec_c) G_c + dG_c down them from dsT, ending in dstate0; each
//      leaves its per-chunk values in the workspace;
//   5. per (batch, head, chunk), in parallel: dr, dk and dv, the
//      intra-chunk products with sub-chunk decay references on the tensor
//      cores (3xTF32; two products where bf16 v is one side), with Pf_t =
//      prod_{b<=s<t} w_s, Ef_t = prod_{t<s<=e} w_s (b, e: the first and
//      last step of t's sub-chunk), Gs_u a sub-chunk's product and DV_tj =
//      dy_t . v_j:
//        dr_t = Pf_t o (prod_{u<s} Gs_u o (S_c dy_t) + sum_{j in u<s} DV_tj
//               (k_j Ef_j prod_{u<u'<s} Gs_u')) + pairs + u o k_t DV_tt
//        dk_j = Ef_j o (prod_{u'>u} Gs_u' o (G_c v_j) + sum_{t in s>u}
//               DV_tj (r_t Pf_t prod_{u<u'<s} Gs_u')) + pairs + u o r_j DV_jj
//        dv   = A^T dy + (k o prod_{t<s<=last} w) G_c,
//      A the forward's launch-3 matrix (bonus on the diagonal), the pairs
//      j < t inside one sub-chunk on CUDA cores with a running product.
//      Then, in the same block, dw_t = rowsum(G_t o S_{t-1}) with S_{t-1}
//      and G_t written out in the same chunk form (Lam_xy = prod_{y<s<x}
//      w_s), a thread a (sub-chunk u, channel) on CUDA cores:
//        dw_t = Ef_t Pf_t Om_u + Ef_t Fw_t + Pf_t Bw_t + T4_t,
//        Om_u = NG_u PG_u <G_c, S_c> + NG_u K_u + PG_u M_u + C_u
//      (PG_u, NG_u: the products of the sub-chunks before and after u),
//      K_u, M_u the sums sum_{j before u} Lam_{b_u j} k_j (G_c v_j) and
//      sum_{i after u} Lam_{i e_u} r_i (S_c dy_i) carried across the
//      sub-chunks, C_u the pairs j < t < i with j before u and i after it,
//      Fw_t = sum_{j<t in u} Lam_tj k_j [dk's bracket]_j and Bw_t =
//      sum_{i>t in u} Lam_it r_i [dr's bracket]_i (16-step recurrences),
//      T4_t the pairs j < t < i inside u; and the chunk's du partial,
//      sum_t r_t o k_t DV_tt;
//   6. du: the partials summed in (batch, chunk) order.
// So 5120 blocks at the rwkv6-3b training shape (B 4, S 2048, H 40) in
// launches 1, 2 and 5 instead of 160 blocks that each walk 2048 steps.
// dw is the row sum itself, written out: no log w and no quotient by w
// (w holds exact zeros and denormals at the full-width decay range, where
// the usual d(log w) from reverse cumsums of r o dr - k o dk is 0 / 0).
// Every decay formed is a product of w over a range of steps.  A first
// version walked each chunk's 64 steps for dw in a launch of its own (S up
// from S_c, G down from G_c, the states recomputed 8 steps at a time); it
// took longer than dr, dk and dv together.  No float atomics: two runs
// give the same bits.  The workspace holds S_c and G_c
// for every chunk, 2 x 4 B x B H ceil(S / 64) K V (168 MB at the training
// shape, as the CUDA-core route's states every 32 steps).
//
// Bound on this card at the training shape: bytes, 503 MB (r, k, v bf16;
// w, dy float32 read once; the gradients written once), 0.1502 ms at 3.35
// TB/s (chip_smoke.py's scan_bwd_cost); 16.1 GFLOP take 0.033 ms at the
// TF32 tensor-core peak.  Measured (NVIDIA H100 80GB HBM3 at 700 W,
// launch/scan_timing.py: CUDA events a call, torch.profiler a launch; bf16
// r/k/v): 1.61 ms, 11x the bound, the CUDA-core route 7.14 ms in the same
// run; launch 5 is 1.14 ms of it, launches 1-2 0.23, the passes 0.20.
// Launch 5 holds 195 KB of shared memory, so one block of 16 warps an SM.

constexpr int kBwdThreads = 512;      // launch 5: 16 warps
constexpr int kLdB = kLdM;            // row stride of launch 5's tiles

// A fragment (rows m0 + g, + 8; columns k0 + c, + 4) of a tile stored
// [m][k] (kT false) or [k][m] (kT true), split
template <bool kT>
__device__ __forceinline__ void frag_a(const float* t, int m0, int k0,
                                       int lane, uint32_t* hi, uint32_t* lo) {
  const int g = lane >> 2, c = lane & 3;
  const int m[4] = {m0 + g, m0 + g + 8, m0 + g, m0 + g + 8};
  const int k[4] = {k0 + c, k0 + c, k0 + c + 4, k0 + c + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(kT ? t[k[e] * kLdB + m[e]] : t[m[e] * kLdB + k[e]], hi[e],
               lo[e]);
}

// B fragment (rows k0 + c, + 4; column n0 + g) of a tile stored [n][k],
// split
__device__ __forceinline__ void frag_b_nk(const float* t, int k0, int n0,
                                          int lane, uint32_t* hi,
                                          uint32_t* lo) {
  const int g = lane >> 2, c = lane & 3;
  split_tf32(t[(n0 + g) * kLdB + k0 + c], hi[0], lo[0]);
  split_tf32(t[(n0 + g) * kLdB + k0 + c + 4], hi[1], lo[1]);
}

// ... of a tile stored [k][n], split
__device__ __forceinline__ void frag_b_kn(const float* t, int k0, int n0,
                                          int lane, uint32_t* hi,
                                          uint32_t* lo) {
  const int g = lane >> 2, c = lane & 3;
  split_tf32(t[(k0 + c) * kLdB + n0 + g], hi[0], lo[0]);
  split_tf32(t[(k0 + c + 4) * kLdB + n0 + g], hi[1], lo[1]);
}

// dw's pairs j < t < i with j in a sub-chunk before U and i in one after
// it, the same for every step t of U (times Ef_t Pf_t):
//   sum_{i in si > U} r_i Pf_i F(U, si) sum_{j in sj < U} DV_ij k_j Ef_j
//   F(sj, U),   F(a, b) = prod_{a<u<b} Gs_u (gs: Gs of channel ch)
template <int U>
__device__ __forceinline__ float pairs_across(const float* r_s,
                                              const float* k_s,
                                              const float* pf_s,
                                              const float* ef_s,
                                              const float* dv_s,
                                              const float* gs, int ch) {
  constexpr int ld = kLdB;
  float kef[U * kSub];
#pragma unroll
  for (int sj = 0; sj < U; ++sj) {
    float f = 1.f;
#pragma unroll
    for (int x = sj + 1; x < U; ++x) f *= gs[x];
#pragma unroll
    for (int jj = 0; jj < kSub; ++jj) {
      const int j = sj * kSub + jj;
      kef[j] = k_s[j * ld + ch] * ef_s[j * ld + ch] * f;
    }
  }
  float C = 0.f;
#pragma unroll
  for (int si = U + 1; si < kNSub; ++si) {
    float f = 1.f;
#pragma unroll
    for (int x = U + 1; x < si; ++x) f *= gs[x];
    for (int ii = 0; ii < kSub; ++ii) {
      const int i = si * kSub + ii;
      float W = 0.f;
#pragma unroll
      for (int j = 0; j < U * kSub; ++j) W = fmaf(dv_s[i * ld + j], kef[j], W);
      C = fmaf(r_s[i * ld + ch] * pf_s[i * ld + ch] * f, W, C);
    }
  }
  return C;
}

// Launch 5: block (bh, c), 16 warps; warp (s, cq) = (warp & 3, warp >> 2)
// owns rows 16 s .. + 15 (sub-chunk s) and columns 16 cq .. + 15 of dr, dk
// and dv.  Phases: DV, the factors and <G_c, S_c>; A (the pairs inside
// sub-chunks and the bonus by warps cq 0-1, the cross products by cq 2-3);
// dr, dk, dv, keeping dr's and dk's brackets and their sub-chunk sums; dw
// (a thread a sub-chunk and channel) beside du's partial.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
rwkv6_chunk_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u,
                       const float* __restrict__ dy,
                       const float* __restrict__ ws_s,
                       const float* __restrict__ ws_g, float* __restrict__ dr,
                       float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dw, float* __restrict__ du_part,
                       int S, int H, int nc) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  constexpr int ld = kLdB;
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                       // [kL][ld] r
  float* k_s = r_s + kL * ld;              // [kL][ld] k
  float* w_s = k_s + kL * ld;              // [kL][ld] w
  float* pf_s = w_s + kL * ld;             // [kL][ld] Pf
  float* ef_s = pf_s + kL * ld;            // [kL][ld] Ef
  float* v_s = ef_s + kL * ld;             // [kL][ld] v
  float* dy_s = v_s + kL * ld;             // [kL][ld] dy
  float* dv_s = dy_s + kL * ld;            // [kL][ld] DV[t][j], j <= t
  float* a_s = dv_s + kL * ld;             // [kL][ld] A[i][j], j <= i
  float* sc_s = a_s + kL * ld;             // [kD][ld] S_c[ch][col]
  float* ge_s = sc_s + kD * ld;            // [kD][ld] G_c[ch][col]
  float* g_s = ge_s + kD * ld;             // [kNSub][kD] Gs
  float* u_s = g_s + kNSub * kD;           // [kD]
  float* gam_s = u_s + kD;                 // [kD] <G_c, S_c> a row
  float* m_s = gam_s + kD;                 // [kNSub][kD] sum Pf r (S_c dy)
  float* p_s = m_s + kNSub * kD;           // [kNSub][kD] sum Ef k (G_c v)
  const int bh = blockIdx.x / nc, c = blockIdx.x - bh * nc;
  const int b = bh / H, h = bh - b * H, t0 = c * kL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = warp & 3, cq = warp >> 2;
  const int g = lane >> 2, q4 = lane & 3;
  const int rb = s * kSub, cb = cq * 16;   // this warp's rows and columns

  const float* st = ws_s + static_cast<size_t>(blockIdx.x) * kD * kD;
  const float* gt = ws_g + static_cast<size_t>(bh * nc + nc - 1 - c) * kD *
                               kD;                 // chunks last first
  for (int e = tid; e < kD * kD / 4; e += kBwdThreads) {
    const int row = e / (kD / 4), col = (e - row * (kD / 4)) * 4;
    cp_async16(sc_s + row * ld + col, st + row * kD + col, 16);
    cp_async16(ge_s + row * ld + col, gt + row * kD + col, 16);
  }
  cp_async_commit();
  {                                        // every tile's loads, then stores
    ChunkTile<T, kBwdThreads> tr, tk, tv;
    ChunkTile<float, kBwdThreads> tw, tg;
    tr.load(r, b, t0, S, h, H);
    tk.load(k, b, t0, S, h, H);
    tw.load(w, b, t0, S, h, H);
    tv.load(v, b, t0, S, h, H);
    tg.load(dy, b, t0, S, h, H);
    tr.store(r_s, ld, t0, S, 0.f);
    tk.store(k_s, ld, t0, S, 0.f);
    tw.store(w_s, ld, t0, S, 1.f);
    tv.store(v_s, ld, t0, S, 0.f);
    tg.store(dy_s, ld, t0, S, 0.f);
  }
  for (int e = tid; e < kD; e += kBwdThreads) u_s[e] = u[h * kD + e];
  cp_async_wait<0>();
  __syncthreads();

  // the factors, a thread a (sub-chunk, channel): Pf by a forward walk, Ef
  // and Gs by a backward one
  if (tid < kNSub * kD) {
    const int uu = tid / kD, ch = tid & (kD - 1);
    float p = 1.f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      pf_s[(uu * kSub + t) * ld + ch] = p;
      p *= w_s[(uu * kSub + t) * ld + ch];
    }
    float e = 1.f;
#pragma unroll
    for (int t = kSub - 1; t >= 0; --t) {
      ef_s[(uu * kSub + t) * ld + ch] = e;
      e *= w_s[(uu * kSub + t) * ld + ch];
    }
    g_s[uu * kD + ch] = e;
  } else {
    // gamma = <G_c, S_c> a row: four threads a row, 16 columns each
    const int ch = (tid - kNSub * kD) >> 2, sg = tid & 3;
    float x = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      x = fmaf(ge_s[ch * ld + 16 * sg + e], sc_s[ch * ld + 16 * sg + e], x);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (sg == 0) gam_s[ch] = x;
  }
  // DV = dy v^T, rows of sub-chunk s, column tiles cq and cq + 4 up to the
  // diagonal (v exact when bf16: two products)
  for (int nt = cq; nt < 2 * (s + 1); nt += 4) {
    float acc[4] = {};
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
      frag_a<false>(dy_s, rb, ks * 8, lane, a_hi, a_lo);
      if constexpr (kExact) {
        const float* vrow = v_s + (nt * 8 + g) * ld + ks * 8 + q4;
        const uint32_t b0 = __float_as_uint(vrow[0]);
        const uint32_t b1 = __float_as_uint(vrow[4]);
        mma_tf32_1688(acc, a_lo, b0, b1);
        mma_tf32_1688(acc, a_hi, b0, b1);
      } else {
        frag_b_nk(v_s, ks * 8, nt * 8, lane, b_hi, b_lo);
        mma_3xtf32(acc, a_hi, a_lo, b_hi, b_lo);
      }
    }
    const int col = nt * 8 + 2 * q4;
    *reinterpret_cast<float2*>(dv_s + (rb + g) * ld + col) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(dv_s + (rb + g + 8) * ld + col) =
        make_float2(acc[2], acc[3]);
  }
  __syncthreads();

  // A, as the forward's launch 3 forms it
  if (cq < 2) {
    // the pairs j < i inside sub-chunk s and the bonus: lane (il, quarter)
    // takes row i = 16 s + il over the channels 4 cc + quarter
    const int il = g + 8 * cq, i = rb + il;
    float intra[kSub] = {}, bonus = 0.f;
    if (cq == 0)
      intra_pairs<kSub / 2>(r_s, k_s, w_s, u_s, rb, il, q4, intra, bonus);
    else
      intra_pairs<kSub>(r_s, k_s, w_s, u_s, rb, il, q4, intra, bonus);
#pragma unroll
    for (int jj = 0; jj < kSub; ++jj) {
      intra[jj] += __shfl_xor_sync(0xffffffffu, intra[jj], 1);
      intra[jj] += __shfl_xor_sync(0xffffffffu, intra[jj], 2);
    }
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
#pragma unroll
    for (int jj = 0; jj < kSub; ++jj)
      if ((jj >> 2) == q4)
        a_s[i * ld + rb + jj] = jj < il ? intra[jj] : jj == il ? bonus : 0.f;
  } else if (s > 0) {
    // the pairs across sub-chunks: A[i][j] = (r_i Pf_i) . (k_j Ef_j
    // prod_{t<u'<s} Gs_u') for j in sub-chunk t < s, 3xTF32; this warp
    // takes column tile cq - 2 of each sub-chunk t
    const int half = cq - 2;
    float cross[kNSub - 1][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < kD / 8; ++ks) {
      const int c0 = ks * 8 + q4, c1 = c0 + 4;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(r_s[(rb + g) * ld + c0] * pf_s[(rb + g) * ld + c0], a_hi[0],
                 a_lo[0]);
      split_tf32(r_s[(rb + g + 8) * ld + c0] * pf_s[(rb + g + 8) * ld + c0],
                 a_hi[1], a_lo[1]);
      split_tf32(r_s[(rb + g) * ld + c1] * pf_s[(rb + g) * ld + c1], a_hi[2],
                 a_lo[2]);
      split_tf32(r_s[(rb + g + 8) * ld + c1] * pf_s[(rb + g + 8) * ld + c1],
                 a_hi[3], a_lo[3]);
      float f0 = 1.f, f1 = 1.f;                // prod_{t<u'<s} Gs_u'
#pragma unroll
      for (int t = kNSub - 2; t >= 0; --t) {
        if (t < s) {
          const int j = t * kSub + half * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(k_s[j * ld + c0] * ef_s[j * ld + c0] * f0, b_hi[0],
                     b_lo[0]);
          split_tf32(k_s[j * ld + c1] * ef_s[j * ld + c1] * f1, b_hi[1],
                     b_lo[1]);
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
        *reinterpret_cast<float2*>(a_s + (rb + g) * ld + col) =
            make_float2(cross[t][0], cross[t][1]);
        *reinterpret_cast<float2*>(a_s + (rb + g + 8) * ld + col) =
            make_float2(cross[t][2], cross[t][3]);
      }
    }
  }
  __syncthreads();

  // the outputs of this warp's 16 rows and 16 columns: a lane's elements
  // are rows rb + g + 8 hh, columns cb + 8 nt + 2 q4 + e
  auto store = [&](float* out, float (*val)[2][2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + rb + g + 8 * hh;
      if (t < S) {
        float* row = out + ((static_cast<size_t>(b) * S + t) * H + h) * kD;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *reinterpret_cast<float2*>(row + cb + nt * 8 + 2 * q4) =
              make_float2(val[hh][nt][0], val[hh][nt][1]);
      }
    }
  };
  float val[2][2][2];
  // the brackets of dr and dk (before Pf / Ef), kept for dw
  float dr_b[2][2][2], dk_b[2][2][2];
  // a column sum over this warp's 16 rows, written by the lanes g = 0
  auto col_sum = [&](float (*x)[2][2], float* out) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float y = x[0][nt][e] + x[1][nt][e];
        y += __shfl_xor_sync(0xffffffffu, y, 4);
        y += __shfl_xor_sync(0xffffffffu, y, 8);
        y += __shfl_xor_sync(0xffffffffu, y, 16);
        if (g == 0) out[s * kD + cb + nt * 8 + 2 * q4 + e] = y;
      }
    }
  };

  // dr
  {
    float accS[2][4] = {}, accX[2][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < kD / 8; ++ks) {      // dy S_c^T
      uint32_t a_hi[4], a_lo[4];
      frag_a<false>(dy_s, rb, ks * 8, lane, a_hi, a_lo);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b_hi[2], b_lo[2];
        frag_b_nk(sc_s, ks * 8, cb + nt * 8, lane, b_hi, b_lo);
        mma_3xtf32(accS[nt], a_hi, a_lo, b_hi, b_lo);
      }
    }
    float f[2] = {1.f, 1.f};                   // prod_{uo<u'<s} Gs_u'
    for (int uo = s - 1; uo >= 0; --uo) {      // DV (k Ef F) over u < s
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j0 = uo * kSub + kk * 8 + q4, j1 = j0 + 4;
        uint32_t a_hi[4], a_lo[4];
        frag_a<false>(dv_s, rb, uo * kSub + kk * 8, lane, a_hi, a_lo);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int ch = cb + nt * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(k_s[j0 * ld + ch] * ef_s[j0 * ld + ch] * f[nt], b_hi[0],
                     b_lo[0]);
          split_tf32(k_s[j1 * ld + ch] * ef_s[j1 * ld + ch] * f[nt], b_hi[1],
                     b_lo[1]);
          mma_3xtf32(accX[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) f[nt] *= g_s[uo * kD + cb + nt * 8 + g];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = cb + nt * 8 + 2 * q4 + e;
        float pg = 1.f;                        // prod_{u<s} Gs_u
        for (int uo = 0; uo < s; ++uo) pg *= g_s[uo * kD + ch];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int il = g + 8 * hh, t = rb + il;
          float intra = 0.f, p = 1.f;          // p = prod_{j<s'<t} w
          for (int jj = il - 1; jj >= 0; --jj) {
            const int j = rb + jj;
            intra = fmaf(dv_s[t * ld + j] * k_s[j * ld + ch], p, intra);
            p *= w_s[j * ld + ch];
          }
          dr_b[hh][nt][e] =
              fmaf(pg, accS[nt][2 * hh + e], accX[nt][2 * hh + e]);
          val[hh][nt][e] =
              fmaf(pf_s[t * ld + ch], dr_b[hh][nt][e], intra) +
              u_s[ch] * k_s[t * ld + ch] * dv_s[t * ld + t];
          // m: Pf r (S_c dy), summed over the sub-chunk below
          accS[nt][2 * hh + e] *= pf_s[t * ld + ch] * r_s[t * ld + ch];
        }
      }
    }
    store(dr, val);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) val[hh][nt][e] = accS[nt][2 * hh + e];
    col_sum(val, m_s);
  }

  // dk
  {
    float accG[2][4] = {}, accY[2][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < kD / 8; ++ks) {      // v G_c^T
      uint32_t a_hi[4], a_lo[4];
      if constexpr (kExact) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = rb + g + 8 * (e & 1), kc = ks * 8 + q4 + 4 * (e >> 1);
          a_hi[e] = __float_as_uint(v_s[m * ld + kc]);
        }
      } else {
        frag_a<false>(v_s, rb, ks * 8, lane, a_hi, a_lo);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b_hi[2], b_lo[2];
        frag_b_nk(ge_s, ks * 8, cb + nt * 8, lane, b_hi, b_lo);
        if constexpr (kExact) {
          mma_tf32_1688(accG[nt], a_hi, b_lo[0], b_lo[1]);
          mma_tf32_1688(accG[nt], a_hi, b_hi[0], b_hi[1]);
        } else {
          mma_3xtf32(accG[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }
    float f[2] = {1.f, 1.f};                   // prod_{s<u'<so} Gs_u'
    for (int so = s + 1; so < kNSub; ++so) {   // DV^T (r Pf F) over so > s
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j0 = so * kSub + kk * 8 + q4, j1 = j0 + 4;
        uint32_t a_hi[4], a_lo[4];
        frag_a<true>(dv_s, rb, so * kSub + kk * 8, lane, a_hi, a_lo);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int ch = cb + nt * 8 + g;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(r_s[j0 * ld + ch] * pf_s[j0 * ld + ch] * f[nt], b_hi[0],
                     b_lo[0]);
          split_tf32(r_s[j1 * ld + ch] * pf_s[j1 * ld + ch] * f[nt], b_hi[1],
                     b_lo[1]);
          mma_3xtf32(accY[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) f[nt] *= g_s[so * kD + cb + nt * 8 + g];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = cb + nt * 8 + 2 * q4 + e;
        float ng = 1.f;                        // prod_{u'>s} Gs_u'
        for (int uo = kNSub - 1; uo > s; --uo) ng *= g_s[uo * kD + ch];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int il = g + 8 * hh, j = rb + il;
          float intra = 0.f, p = 1.f;          // p = prod_{j<s'<t} w
          for (int tt = il + 1; tt < kSub; ++tt) {
            const int t = rb + tt;
            intra = fmaf(dv_s[t * ld + j] * r_s[t * ld + ch], p, intra);
            p *= w_s[t * ld + ch];
          }
          dk_b[hh][nt][e] =
              fmaf(ng, accG[nt][2 * hh + e], accY[nt][2 * hh + e]);
          val[hh][nt][e] =
              fmaf(ef_s[j * ld + ch], dk_b[hh][nt][e], intra) +
              u_s[ch] * r_s[j * ld + ch] * dv_s[j * ld + j];
          // p: Ef k (G_c v), summed over the sub-chunk below
          accG[nt][2 * hh + e] *= ef_s[j * ld + ch] * k_s[j * ld + ch];
        }
      }
    }
    store(dk, val);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) val[hh][nt][e] = accG[nt][2 * hh + e];
    col_sum(val, p_s);
  }

  // dv = A^T dy + (k Ef prod_{u'>s} Gs) G_c
  {
    float acc[2][4] = {};
    for (int ks = 2 * s; ks < kL / 8; ++ks) {
      uint32_t a_hi[4], a_lo[4];
      frag_a<true>(a_s, rb, ks * 8, lane, a_hi, a_lo);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b_hi[2], b_lo[2];
        frag_b_kn(dy_s, ks * 8, cb + nt * 8, lane, b_hi, b_lo);
        mma_3xtf32(acc[nt], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll 2
    for (int ks = 0; ks < kD / 8; ++ks) {
      const int c0 = ks * 8 + q4, c1 = c0 + 4;
      float n0 = 1.f, n1 = 1.f;
      for (int uo = kNSub - 1; uo > s; --uo) {
        n0 *= g_s[uo * kD + c0];
        n1 *= g_s[uo * kD + c1];
      }
      uint32_t a_hi[4], a_lo[4];
      split_tf32(k_s[(rb + g) * ld + c0] * ef_s[(rb + g) * ld + c0] * n0,
                 a_hi[0], a_lo[0]);
      split_tf32(k_s[(rb + g + 8) * ld + c0] * ef_s[(rb + g + 8) * ld + c0] *
                     n0, a_hi[1], a_lo[1]);
      split_tf32(k_s[(rb + g) * ld + c1] * ef_s[(rb + g) * ld + c1] * n1,
                 a_hi[2], a_lo[2]);
      split_tf32(k_s[(rb + g + 8) * ld + c1] * ef_s[(rb + g + 8) * ld + c1] *
                     n1, a_hi[3], a_lo[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b_hi[2], b_lo[2];
        frag_b_kn(ge_s, ks * 8, cb + nt * 8, lane, b_hi, b_lo);
        mma_3xtf32(acc[nt], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) val[hh][nt][e] = acc[nt][2 * hh + e];
    store(dv, val);
  }
  __syncthreads();                 // S_c, G_c, v, dy and A are dead

  // dw.  The brackets into S_c's and G_c's tiles, [t][channel]
  float* drb_s = sc_s;
  float* dkb_s = ge_s;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = rb + g + 8 * hh;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = cb + nt * 8 + 2 * q4;
      *reinterpret_cast<float2*>(drb_s + t * ld + col) =
          make_float2(dr_b[hh][nt][0], dr_b[hh][nt][1]);
      *reinterpret_cast<float2*>(dkb_s + t * ld + col) =
          make_float2(dk_b[hh][nt][0], dk_b[hh][nt][1]);
    }
  }
  __syncthreads();
  if (tid < kNSub * kD) {
    // thread (sub-chunk uu, channel ch): dw_t = Ef_t Pf_t Om + Ef_t Fw_t +
    // Pf_t Bw_t + T4_t for the sub-chunk's 16 steps t
    const int uu = tid / kD, ch = tid & (kD - 1), b0 = uu * kSub;
    float gs[kNSub];
#pragma unroll
    for (int x = 0; x < kNSub; ++x) gs[x] = g_s[x * kD + ch];
    float pg = 1.f, ng = 1.f, K = 0.f, M = 0.f;
#pragma unroll
    for (int x = 0; x < kNSub; ++x) {
      if (x < uu) {
        pg *= gs[x];
        K = fmaf(gs[x], K, p_s[x * kD + ch]);
      }
    }
#pragma unroll
    for (int x = kNSub - 1; x >= 0; --x) {
      if (x > uu) {
        ng *= gs[x];
        M = fmaf(gs[x], M, m_s[x * kD + ch]);
      }
    }
    float C = 0.f;
    if (uu == 1)
      C = pairs_across<1>(r_s, k_s, pf_s, ef_s, dv_s, gs, ch);
    else if (uu == 2)
      C = pairs_across<2>(r_s, k_s, pf_s, ef_s, dv_s, gs, ch);
    const float om = fmaf(ng * pg, gam_s[ch], fmaf(ng, K, fmaf(pg, M, C)));
    float rr[kSub], ww[kSub], part[kSub], Z[kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      rr[a] = r_s[(b0 + a) * ld + ch];
      ww[a] = w_s[(b0 + a) * ld + ch];
      Z[a] = 0.f;
    }
    float fw = 0.f;
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int t = b0 + a;
      // pairs j < t < i inside the sub-chunk: Z[i] = sum_{j<t} (prod_{j<s<t}
      // w) k_j DV_ij, then sum_{i>t} (prod_{t<s<i} w) r_i Z[i]
      float t4 = 0.f, pp = 1.f;
#pragma unroll
      for (int i = a + 1; i < kSub; ++i) {
        t4 = fmaf(pp * rr[i], Z[i], t4);
        pp *= ww[i];
      }
      const float ef = ef_s[t * ld + ch], pf = pf_s[t * ld + ch];
      part[a] = fmaf(ef * pf, om, fmaf(ef, fw, t4));
      const float kt = k_s[t * ld + ch];
      fw = fmaf(ww[a], fw, kt * dkb_s[t * ld + ch]);
#pragma unroll
      for (int i = a + 1; i < kSub; ++i)
        Z[i] = fmaf(ww[a], Z[i], kt * dv_s[(b0 + i) * ld + t]);
    }
    float bw = 0.f;
#pragma unroll
    for (int a = kSub - 1; a >= 0; --a) {
      const int t = b0 + a;
      if (t0 + t < S)
        dw[((static_cast<size_t>(b) * S + t0 + t) * H + h) * kD + ch] =
            fmaf(pf_s[t * ld + ch], bw, part[a]);
      bw = fmaf(ww[a], bw, rr[a] * drb_s[t * ld + ch]);
    }
  } else if (tid < kNSub * kD + kD) {
    // the chunk's du partial: sum_t r_t o k_t (v_t . dy_t), in step order
    const int ch = tid - kNSub * kD;
    float a = 0.f;
    for (int t = 0; t < kL; ++t)
      a = fmaf(r_s[t * ld + ch] * k_s[t * ld + ch], dv_s[t * ld + t], a);
    du_part[(static_cast<size_t>(b * nc + c) * H + h) * kD + ch] = a;
  }
}

constexpr size_t kBwdSmem =
    (9 * kL * kLdB + 2 * kD * kLdB + 3 * kNSub * kD + 2 * kD) *
    sizeof(float);

template <typename T>
cudaError_t launch_bwd_tc(const BwdArgs& a, float* ws_s, float* ws_g,
                          float* dec, cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_chunk_state_kernel<T, T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kStateSmem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rwkv6_chunk_state_kernel<T, float, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStateSmem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rwkv6_chunk_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBwdSmem));
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int nc = (a.S + kL - 1) / kL;
  const long long blocks = static_cast<long long>(a.B) * a.H * nc;
  const long long pass_blocks =
      (static_cast<long long>(a.B) * a.H * kD * kD + kPassThreads - 1) /
      kPassThreads;
  if (blocks > 0x7fffffffLL || pass_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  rwkv6_chunk_state_kernel<T, T, false><<<nb, kTcThreads, kStateSmem,
                                          stream>>>(k, v, a.w, ws_s, dec,
                                                    a.S, a.H, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rwkv6_chunk_state_kernel<T, float, true><<<nb, kTcThreads, kStateSmem,
                                             stream>>>(r, a.dy, a.w, ws_g,
                                                       nullptr, a.S, a.H, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_pass_kernel<false, true><<<static_cast<unsigned>(pass_blocks),
                                   kPassThreads, 0, stream>>>(
      ws_s, dec, a.state0, nullptr, a.B * a.H, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_pass_kernel<true, true><<<static_cast<unsigned>(pass_blocks),
                                  kPassThreads, 0, stream>>>(
      ws_g, dec, a.dsT, a.ds0, a.B * a.H, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rwkv6_chunk_bwd_kernel<T><<<nb, kBwdThreads, kBwdSmem, stream>>>(
      r, k, v, a.w, a.u, a.dy, ws_s, ws_g, a.dr, a.dk, a.dv, a.dw,
      a.du_part, a.S, a.H, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int HK = a.H * kD;
  rwkv6_scan_bwd_du_kernel<<<(HK + 255) / 256, 256, 0, stream>>>(
      a.du_part, a.du, a.B * nc, HK);
  return cudaGetLastError();
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

// B4's backward on the tensor-core route: K = V = 64, S >= 64.  Arguments
// as rwkv6_scan_bwd_launch's, but du_part is float32 B x ceil(S / 64) x H x
// 64 (a partial a chunk) and ws float32 2 B H ceil(S / 64) 64 64 + B H
// ceil(S / 64) 64 (every chunk's entry state, the gradient at its end, its
// decay).
extern "C" int rwkv6_scan_bwd_tc_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* state0, const void* dy, const void* dsT,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* du,
    void* ds0, void* ws, int B, int S, int H, int rkv_dtype, void* stream) {
  if (B <= 0 || H <= 0 || S < kL) return cudaErrorInvalidValue;
  const BwdArgs a{r, k, v,
                  static_cast<const float*>(w), static_cast<const float*>(u),
                  static_cast<const float*>(state0),
                  static_cast<const float*>(dy),
                  static_cast<const float*>(dsT), static_cast<float*>(dr),
                  static_cast<float*>(dk), static_cast<float*>(dv),
                  static_cast<float*>(dw), static_cast<float*>(du_part),
                  static_cast<float*>(du), static_cast<float*>(ds0),
                  static_cast<float*>(ws), B, S, H, kD};
  const size_t states = static_cast<size_t>(B) * H * ((S + kL - 1) / kL) *
                        kD * kD;
  float* ws_s = static_cast<float*>(ws);
  float* ws_g = ws_s + states;
  float* dec = ws_g + states;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rkv_dtype == kFloat32)
    return launch_bwd_tc<float>(a, ws_s, ws_g, dec, s);
  if (rkv_dtype == kBFloat16)
    return launch_bwd_tc<__nv_bfloat16>(a, ws_s, ws_g, dec, s);
  return cudaErrorInvalidValue;
}
