// The backward of flash attention for Hopper: the gradients of grouped-query
// attention over whole sequences, causal and/or sliding-window, with respect
// to q, k and v.  Sq queries at positions q_off .. q_off + Sq - 1 attend to
// Sk keys at 0 .. Sk - 1: the training forward has Sq == Sk and q_off 0;
// under sequence parallelism a rank's query block has q_off = its first
// position and the keys before its last query (flash_attention.cu's note).
//
// Replaces no TPU kernel: the reference trains through jnp (its Pallas
// flash kernel, src/repro/kernels/flash_attention.py:flash_attention, has
// no VJP), so XLA differentiates the masked softmax.  This is B3's
// backward, for training on the card.
//
// With P = softmax(scale q k^T) under the mask and O = P v, and dO given:
//
//   lse_i   = log sum_j exp(s_ij)            (from the forward on the
//                                             tensor-core route; recomputed
//                                             on the CUDA-core route)
//   delta_i = sum_c dO_ic O_ic               (rowsum(dO * O))
//   dP_ij   = dO_i . v_j,  dS_ij = P_ij (dP_ij - delta_i)
//   dq_i    = scale sum_j dS_ij k_j
//   dk_j    = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
//
// summed over the G query heads of each KV head for dk and dv.  No kernel
// uses atomics: every output element is written by one thread, and the
// result is the same every run.
//
// Bound on this card: operations (the backward's five products of the
// forward's size).  Two routes, chosen by the wrapper from dtype and D
// before any launch (neither is a fallback of the other; the entry point
// refuses a route that does not match them):
//
// 1. Tensor cores (bf16 at D 64, 128 and 256, training's case: qwen3-1.7b
//    at 128, gemma3-4b at 256), FlashAttention-3's backward on the
//    forward's machinery (tma.cuh, wgmma.cuh): a producer warpgroup keeping
//    a ring of 3 stages full by TMA (128-byte swizzled tiles, full/empty
//    mbarriers) and two consumer warpgroups under setmaxnreg (24 / 240
//    registers), each owning 64 of the block's 128 rows (wgmma's M).
//    Streamed tiles hold kCols rows: 64 at D 64 and 128, 32 at D 256.
//    Three launches:
//
//      fa_bwd_delta_kernel    delta = rowsum(dO * O), one warp a row
//      fa_bwd_dq_tc_kernel    a block a (128 query rows, query head,
//                             sequence): q and dO once, kCols-key tiles of
//                             k and v streamed; S = Q K^T and dP = dO V^T
//                             (wgmma.m64n{kCols}k16 from shared memory), P
//                             and dS on the accumulator fragment, dq += dS
//                             K (dS from registers: the m64 accumulator
//                             layout is the A-fragment layout; K read
//                             MN-major).  dq of tile i - 1 and S, dP of
//                             tile i are in flight together (at D 64 and
//                             128).
//      fa_bwd_dkdv_tc_kernel  a block a (128 keys, KV head, sequence): k
//                             and v once; for each of the KV head's G
//                             query heads the kCols-query tiles that see
//                             the keys, with their slices of lse and
//                             delta, streamed; S^T = K Q^T and
//                             dP^T = V dO^T from shared memory, P^T and
//                             dS^T on the fragment, dv += P^T dO and
//                             dk += dS^T Q with A from registers.
//
//    * The log-sum-exp comes from the forward (flash_attention.cu writes
//      it in log2 units when asked, at D 256 too), so P = exp2(s scale
//      log2 e - lse) needs no pass of its own; rows are padded to the
//      forward's 128-row block, so a stage's slice is one aligned bulk
//      copy.
//    * S and dP are recomputed in both kernels: 7 products of the forward's
//      size against the ideal 5, the price of dq without atomics.
//    * P and dS enter their products as bf16, one rounding each (a CPU
//      mirror of this arithmetic, tests/test_torch_flash_tc.py, holds it
//      within half the 2e-2 bf16 limit at D 64, 128 and 256), where the
//      forward needs the hi + lo pair for its tighter 4e-3.
//    * Registers: dk and dv are 64 + 64 float32 a thread at D 128 and S^T
//      and dP^T 32 + 32, within the consumers' 240, but a second tile's
//      S^T and dP^T would not fit beside them; so the dk/dv kernel runs
//      its tiles one after the other and relies on its two consumer
//      warpgroups to overlap one's softmax with the other's products, and
//      within a tile on P^T's exp2 running while dP^T is in flight.
//      (Issuing dv's product before forming dS^T, to overlap the two, ran
//      no faster on an H100 and spilled more.)
//    * D 256: the split.  dk and dv alone would be 128 + 128 float32
//      registers a thread, over setmaxnreg's 240 before S^T and dP^T.  So
//      the dk/dv grid is twice as deep (its z): z = 0 blocks accumulate dk
//      (S^T, dP^T, dk: 128 + 16 + 16 + 8 registers of fragments), z = 1
//      blocks dv (S^T, dv: 128 + 16 + 8; they read no v and form no dP^T),
//      each over the same tiles: 8 products of the forward's size against
//      7 at D 128.  One launch holds both halves, so at gemma3's B 1 shape
//      (4 KV heads x 16 key blocks) 128 blocks fill the card where either
//      half alone would fill half of it; the dk blocks, the heavier, start
//      first.  dq is 128 float32 registers a thread with S, dP and dS of a
//      32-key tile beside it (16 + 16 + 8); its tiles run one after the
//      other (with dq of one tile in flight beside the next one's S and dP,
//      ptxas spilled 120 bytes), the two consumer warpgroups overlapping
//      each other, as the forward does at D 256.  Shared memory sets the
//      tile: q and dO of 128 rows (or k and v) take 128 KB of the 227, so
//      the streamed tiles are 32 rows, 3 stages of 32 KB, where 64-row ones
//      would fit one stage and leave every load exposed.  S and dP are
//      then wgmma.m64n32k16, which reads three quarters of m64n64k16's
//      shared-memory bytes for half its work.
//    * The causal and windowed dead-tile skip of the forward bounds both
//      loops, and a warpgroup releases unread the tiles none of its rows
//      sees; blocks start heaviest first (the last query blocks for dq,
//      the first key blocks for dk/dv).
//    * ptxas (sm_90a, CUDA 12.8): 168 registers a thread at launch, no
//      spills in the dq and dk/dv kernels at D 64, 128 and 256; 166,456
//      bytes of dynamic shared memory at D 128, 84,536 at D 64, 231,224
//      at D 256.
//
// 2. CUDA cores (float32, and bf16 at D 16 and 32; bf16 at D 256 only when
//    the wrapper is asked for it by name, to time it beside route 1), two
//    kernels in float32 with the forward's CUDA-core thread layout (128
//    threads, 16 row groups x 8 column groups, tiles staged in shared
//    memory as float32, a row's reductions over 8 lanes by shuffle):
//
//      fa_bwd_dq_kernel    a block a (query tile, query head, sequence):
//                          delta from O and dO, lse by an online pass over
//                          the keys the tile sees, then a second pass over
//                          them for dq; writes lse and delta (float32) for
//                          the second kernel
//      fa_bwd_dkdv_kernel  a block a (key tile, KV head, sequence): loops
//                          over the KV head's G query heads and the query
//                          tiles that see its keys, recomputing P and dS
//                          from lse and delta
//
// Inputs are contiguous (B, S, H, D) in float32 or bf16, D one of 16, 32,
// 64, 128, 256; the gradients come out in the inputs' dtype, accumulated
// in float32.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;                       // lanes sharing a row
constexpr int kRowGroups = kThreads / kColGroups;   // 16
constexpr float kNegInf = -1e30f;
constexpr float kPosInf = 1e30f;    // a row that sees no key: p = 0

// TM rows a thread holds (queries in dq, keys in dk/dv), TN columns it
// scores a tile (keys in dq, queries in dk/dv), TC output columns
template <int D>
struct Tile {
  static constexpr int TM = D >= 128 ? 2 : 4;
  static constexpr int TN = D > 128 ? 4 : 8;
  static constexpr int BM = kRowGroups * TM;
  static constexpr int BN = kColGroups * TN;
  static constexpr int TC = D / kColGroups;
  static constexpr int CS = BN + 1;     // stride of the column tiles
  static constexpr int PS = BM + 1;     // stride of the P / dS tiles
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * static_cast<size_t>(D) * BM +
                       2 * static_cast<size_t>(D) * CS +
                       static_cast<size_t>(BN) * PS);
  static constexpr size_t kDkvSmem =
      sizeof(float) * (2 * static_cast<size_t>(D) * BM +
                       2 * static_cast<size_t>(D) * CS +
                       2 * static_cast<size_t>(BN) * PS + 2 * BN);
};

struct Geo {
  int Sq, Sk, q_off, Hq, Hkv, causal, window;
  float scale;
};

// query row i (at position q_off + i) sees key j
__device__ __forceinline__ bool visible(int i, int j, const Geo& g) {
  const int p = g.q_off + i;
  return j < g.Sk && i < g.Sq && (!g.causal || j <= p) &&
         (g.window <= 0 || p - j < g.window);
}

// rows [row0, row0 + rows) of a (S, H, D) slab (row stride `stride`
// elements), transposed into dst[D][ld] as float32 times `mul`; rows at or
// past `limit` are zeros
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, int ld, const T* base,
                                       long long stride, int row0, int rows,
                                       int limit, float mul) {
  constexpr int N = Vec16<T>::N, kVecs = D / N;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i % rows, c = (i / rows) * N, row = row0 + r;
    float f[N];
    if (row < limit) {
      unpack16<T>(*reinterpret_cast<const uint4*>(base + row * stride + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[(c + e) * ld + r] = f[e] * mul;
  }
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kColGroups / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kColGroups / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, T* __restrict__ dq,
                 float* __restrict__ lse_out, float* __restrict__ delta_out,
                 Geo g) {
  using C = Tile<D>;
  constexpr int TM = C::TM, TN = C::TN, BM = C::BM, BN = C::BN, TC = C::TC,
                CS = C::CS, PS = C::PS;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // [D][BM], times scale
  float* do_s = q_s + D * BM;     // [D][BM]
  float* k_s = do_s + D * BM;     // [D][CS]
  float* v_s = k_s + D * CS;      // [D][CS]
  float* ds_s = v_s + D * CS;     // [BN][PS]

  const int b = blockIdx.z, h = blockIdx.y, hk = h / (g.Hq / g.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // heaviest first
  const int q_last = min(q0 + BM, g.Sq) - 1;
  const int tid = threadIdx.x, rg = tid / kColGroups, cg = tid % kColGroups;
  const long long qs = static_cast<long long>(g.Hq) * D;   // seq strides
  const long long ks = static_cast<long long>(g.Hkv) * D;
  const long long qoff = static_cast<long long>(b) * g.Sq * qs + h * D;
  const long long koff = static_cast<long long>(b) * g.Sk * ks + hk * D;

  load_t<T, D>(q_s, BM, q + qoff, qs, q0, BM, g.Sq, g.scale);
  load_t<T, D>(do_s, BM, dout + qoff, qs, q0, BM, g.Sq, 1.f);

  float dl[TM];                   // delta of each row
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg * TM + i;
    float t = 0.f;
    if (row < g.Sq) {
      const T* a = dout + qoff + row * qs;
      const T* c = o + qoff + row * qs;
      for (int e = cg; e < D; e += kColGroups)
        t += to_f32<T>(a[e]) * to_f32<T>(c[e]);
    }
    dl[i] = group_sum(t);
  }

  const int kv_end = g.causal ? min(g.Sk, g.q_off + q_last + 1) : g.Sk;
  const int kv_begin =
      g.window > 0 ? max(0, g.q_off + q0 - g.window + 1) : 0;

  // pass 1: each row's log-sum-exp over the keys it sees
  float m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) m[i] = kNegInf, l[i] = 0.f;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();
    load_t<T, D>(k_s, CS, k + koff, ks, k0, BN, kv_end, 1.f);
    __syncthreads();
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) s[i][t] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = q_s[d * BM + rg * TM + i];
#pragma unroll
      for (int t = 0; t < TN; ++t) kv[t] = k_s[d * CS + cg + kColGroups * t];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) s[i][t] += qv[i] * kv[t];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + rg * TM + i;
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < TN; ++t)
        if (visible(row, k0 + cg + kColGroups * t, g)) mx = fmaxf(mx, s[i][t]);
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TN; ++t)
        if (visible(row, k0 + cg + kColGroups * t, g))
          sum += expf(s[i][t] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + group_sum(sum);
      m[i] = m_new;
    }
  }
  float lse[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg * TM + i;
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : kPosInf;
    if (row < g.Sq && cg == 0) {
      const size_t at = (static_cast<size_t>(b) * g.Hq + h) * g.Sq + row;
      lse_out[at] = lse[i];
      delta_out[at] = dl[i];
    }
  }

  // pass 2: dS a tile at a time, dq += dS k
  float acc[TM][TC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();
    load_t<T, D>(k_s, CS, k + koff, ks, k0, BN, kv_end, 1.f);
    load_t<T, D>(v_s, CS, v + koff, ks, k0, BN, kv_end, 1.f);
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) s[i][t] = dp[i][t] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[TM], gv[TM], kv[TN], vv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        qv[i] = q_s[d * BM + rg * TM + i];
        gv[i] = do_s[d * BM + rg * TM + i];
      }
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        kv[t] = k_s[d * CS + cg + kColGroups * t];
        vv[t] = v_s[d * CS + cg + kColGroups * t];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          s[i][t] += qv[i] * kv[t];
          dp[i][t] += gv[i] * vv[t];
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + rg * TM + i;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int j = cg + kColGroups * t;
        const float p = visible(row, k0 + j, g) ? expf(s[i][t] - lse[i]) : 0.f;
        ds_s[j * PS + rg * TM + i] = p * (dp[i][t] - dl[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float dsj[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsj[i] = ds_s[j * PS + rg * TM + i];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float kk = k_s[(cg + kColGroups * c) * CS + j];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][c] += dsj[i] * kk;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg * TM + i;
    if (row >= g.Sq) continue;
    T* dst = dq + qoff + row * qs + cg;
#pragma unroll
    for (int c = 0; c < TC; ++c)
      dst[kColGroups * c] = from_f32<T>(acc[i][c] * g.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Geo g) {
  using C = Tile<D>;
  constexpr int TM = C::TM, TN = C::TN, BM = C::BM, BN = C::BN, TC = C::TC,
                CS = C::CS, PS = C::PS;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;              // [D][BM]
  float* v_s = k_s + D * BM;      // [D][BM]
  float* q_s = v_s + D * BM;      // [D][CS], times scale
  float* do_s = q_s + D * CS;     // [D][CS]
  float* p_s = do_s + D * CS;     // [BN][PS]
  float* ds_s = p_s + BN * PS;    // [BN][PS]
  float* lse_s = ds_s + BN * PS;  // [BN]
  float* dl_s = lse_s + BN;       // [BN]

  const int b = blockIdx.z, hk = blockIdx.y, G = g.Hq / g.Hkv;
  const int k0 = blockIdx.x * BM;   // the first keys see the most queries
  const int k_last = min(k0 + BM, g.Sk) - 1;
  const int tid = threadIdx.x, rg = tid / kColGroups, cg = tid % kColGroups;
  const long long qs = static_cast<long long>(g.Hq) * D;
  const long long ks = static_cast<long long>(g.Hkv) * D;
  const long long koff = static_cast<long long>(b) * g.Sk * ks + hk * D;

  load_t<T, D>(k_s, BM, k + koff, ks, k0, BM, g.Sk, 1.f);
  load_t<T, D>(v_s, BM, v + koff, ks, k0, BM, g.Sk, 1.f);
  // the query rows that see any key of the tile (row i at q_off + i)
  const int q_begin = g.causal ? max(0, k0 - g.q_off) : 0;
  const int q_end =
      g.window > 0 ? min(g.Sq, max(0, k_last + g.window - g.q_off)) : g.Sq;

  float ak[TM][TC], av[TM][TC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) ak[i][c] = av[i][c] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const long long qoff = static_cast<long long>(b) * g.Sq * qs + h * D;
    const size_t loff = (static_cast<size_t>(b) * g.Hq + h) * g.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BN) {
      __syncthreads();
      load_t<T, D>(q_s, CS, q + qoff, qs, q0, BN, q_end, g.scale);
      load_t<T, D>(do_s, CS, dout + qoff, qs, q0, BN, q_end, 1.f);
      for (int i = tid; i < BN; i += kThreads) {
        const int row = q0 + i;
        lse_s[i] = row < q_end ? lse[loff + row] : kPosInf;
        dl_s[i] = row < q_end ? delta[loff + row] : 0.f;
      }
      __syncthreads();
      // s[i][t]: key rg * TM + i against query cg + 8t
      float s[TM][TN], dp[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) s[i][t] = dp[i][t] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[TM], vv[TM], qv[TN], gv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          kv[i] = k_s[d * BM + rg * TM + i];
          vv[i] = v_s[d * BM + rg * TM + i];
        }
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          qv[t] = q_s[d * CS + cg + kColGroups * t];
          gv[t] = do_s[d * CS + cg + kColGroups * t];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int t = 0; t < TN; ++t) {
            s[i][t] += kv[i] * qv[t];
            dp[i][t] += vv[i] * gv[t];
          }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int key = k0 + rg * TM + i;
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const int j = cg + kColGroups * t;
          const float p = q0 + j < q_end && visible(q0 + j, key, g)
                              ? expf(s[i][t] - lse_s[j])
                              : 0.f;
          p_s[j * PS + rg * TM + i] = p;
          ds_s[j * PS + rg * TM + i] = p * (dp[i][t] - dl_s[j]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < BN; ++j) {
        float pj[TM], dsj[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          pj[i] = p_s[j * PS + rg * TM + i];
          dsj[i] = ds_s[j * PS + rg * TM + i];
        }
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const float gg = do_s[(cg + kColGroups * c) * CS + j];
          const float qq = q_s[(cg + kColGroups * c) * CS + j];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            av[i][c] += pj[i] * gg;
            ak[i][c] += dsj[i] * qq;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int key = k0 + rg * TM + i;
    if (key >= g.Sk) continue;
    T* kd = dk + koff + key * ks + cg;
    T* vd = dv + koff + key * ks + cg;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      kd[kColGroups * c] = from_f32<T>(ak[i][c]);
      vd[kColGroups * c] = from_f32<T>(av[i][c]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(bytes))
             : cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                   void* delta, int B, const Geo& g, cudaStream_t stream) {
  using C = Tile<D>;
  // set once per instantiation (a function-local static is initialised
  // once, thread-safely)
  static const cudaError_t attr =
      allow_smem(fa_bwd_dq_kernel<T, D>, C::kDqSmem) != cudaSuccess
          ? cudaErrorInvalidValue
          : allow_smem(fa_bwd_dkdv_kernel<T, D>, C::kDkvSmem);
  if (attr != cudaSuccess) return attr;
  const unsigned q_tiles = (g.Sq + C::BM - 1) / C::BM;
  const unsigned k_tiles = (g.Sk + C::BM - 1) / C::BM;
  fa_bwd_dq_kernel<T, D><<<dim3(q_tiles, g.Hq, B), kThreads, C::kDqSmem,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<T, D><<<dim3(k_tiles, g.Hkv, B), kThreads, C::kDkvSmem,
                             stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}

// -- route 1: tensor cores (wgmma, TMA, mbarriers), bf16 at D 64, 128, 256 --

namespace tc {

using namespace hopper;

constexpr int kThreads = 384;    // producer warpgroup + 2 consumers
constexpr int kRows = 128;       // a block's rows: 64 a consumer (wgmma's M)
constexpr int kStages = 3;       // ring depth

// Shared memory of both kernels, from a 1024-aligned base: the block's two
// operands (dq: q and dO of its 128 query rows; dk/dv: k and v of its 128
// keys), then kStages stages of two kCols-row tiles (dq: k and v; dk/dv: q
// and dO), then each stage's slices of lse and delta (dk/dv only), then the
// barriers.  Every operand is D / 64 swizzle atoms side by side, each
// [rows][128 bytes], as TMA writes them.  A streamed tile holds 64 rows at
// D 64 and 128, 32 at D 256: there the block's operands alone take 128 KB,
// and 3 stages of 32-row tiles (96 KB) fit beside them where 64-row ones
// would fit in one stage only (231,224 bytes of the 232,448).
template <int D>
struct Smem {
  static constexpr int kCols = D == 256 ? 32 : 64;
  static constexpr int kBlockBytes = kRows * D * 2;
  static constexpr int kTileBytes = kCols * D * 2;
  static constexpr int kVecBytes = kCols * 4;
  static constexpr int kTilesOffset = 2 * kBlockBytes;
  static constexpr int kVecsOffset = kTilesOffset + kStages * 2 * kTileBytes;
  static constexpr int kBarOffset = kVecsOffset + kStages * 2 * kVecBytes;
  // + full[kStages], empty[kStages], the block's barrier; + alignment slack
  static constexpr int kBytes = kBarOffset + 8 * (2 * kStages + 1) + 1024;
};

// one k step of X Y^T: 64 rows of X against a kCols-row tile of Y
template <int kCols>
__device__ __forceinline__ void wgmma_xyt(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  if constexpr (kCols == 32)
    wgmma_ss_m64n32k16(d, a, b, scale_d);
  else
    wgmma_ss_m64n64k16(d, a, b, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_acc(float* d, const uint32_t* a,
                                          uint64_t b) {
  if constexpr (D == 256)
    wgmma_rs_m64n256k16(d, a, b);
  else if constexpr (D == 128)
    wgmma_rs_m64n128k16(d, a, b);
  else
    wgmma_rs_m64n64k16(d, a, b);
}

// X Y^T for one warpgroup: X its 64 rows of a 128-row block operand, Y a
// kCols-row tile, both K-major over D: D / 16 wgmma, one commit.
// The first k step overwrites acc; kZero zeroes it first, which ends the
// last tile's values' lives here instead of at the fence (registers for
// the dk/dv kernel), but only where no wgmma is in flight (ptxas
// serializes a batch if a plain instruction writes an accumulator inside
// it)
template <int D, bool kZero>
__device__ __forceinline__ void issue_xyt(float* acc, uint32_t x_rows,
                                          uint32_t y_tile) {
  constexpr int kCols = Smem<D>::kCols;
  if constexpr (kZero) {
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
  }
  fence_regs<kCols / 2>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_xyt<kCols>(
        acc, gmma_desc(x_rows + (kk / 4) * kRows * kAtomBytes + off, 16, 1024),
        gmma_desc(y_tile + (kk / 4) * kCols * kAtomBytes + off, 16, 1024),
        kk > 0);
  }
  wgmma_commit();
  fence_regs<kCols / 2>(acc);
}

// acc (64 x D) += A (64 x kCols, bf16 fragments from registers) * Y, Y a
// kCols-row tile read MN-major: kCols / 16 k steps of 16 rows, 2048 bytes
// apart
template <int D>
__device__ __forceinline__ void issue_acc(float* acc, const uint32_t (*a)[4],
                                          uint32_t y_tile) {
  constexpr int kCols = Smem<D>::kCols;
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk)
    wgmma_acc<D>(acc, a[kk],
                 gmma_desc(y_tile + kk * 16 * kAtomBytes, kCols * kAtomBytes,
                           1024));
}

// a float32 fragment of a 64 x kCols accumulator as bf16 A fragments, one
// rounding: k step kk is registers 8 kk .. 8 kk + 7
template <int kCols>
__device__ __forceinline__ void pack_frag(const float* x, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// a warpgroup's 64 x D float32 fragment, scaled, as bf16 into a (B, S, H,
// D) contiguous tensor at head h (S the tensor's own length): acc[4 j + e] is row rows[e >> 1], column
// 8 j + 2 t + (e & 1); rows at or past S are not written
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float* acc,
                                           const int* rows, int b, int S, int H,
                                           int h, int t, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    __nv_bfloat16* p =
        dst + ((static_cast<size_t>(b) * S + rows[r]) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// delta = rowsum(dO * O) in float32, one warp a row, for every row of the
// padded (B, Hq, stride) layout; rows at or past S (= Sq) are 0
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, int S, int Hq, int stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t id = static_cast<size_t>(blockIdx.x) * 8 + warp;
  const int row = static_cast<int>(id % stride);
  const int bh = static_cast<int>(id / stride), b = bh / Hq, h = bh % Hq;
  float sum = 0.f;
  if (row < S) {
    const size_t at = ((static_cast<size_t>(b) * S + row) * Hq + h) * D;
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(o + at);
    const __nv_bfloat162* c =
        reinterpret_cast<const __nv_bfloat162*>(dout + at);
#pragma unroll
    for (int e = lane; e < D / 2; e += 32) {
      const float2 x = __bfloat1622float2(a[e]), y = __bfloat1622float2(c[e]);
      sum += x.x * y.x + x.y * y.y;
    }
  }
  sum = warp_sum(sum);
  if (lane == 0) delta[id] = sum;
}

// dq: a block owns 128 query rows of one (sequence, query head) and walks
// the kCols-key tiles they see: S = Q K^T and dP = dO V^T from shared memory,
// P and dS on the fragment, dq += dS K with dS from registers
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                    int q_off, int Hq, int Hkv, int causal, int window,
                    int stride, float scale_log2, float scale) {
  using L = Smem<D>;
  constexpr int kAtoms = D / 64, kCols = L::kCols;
  // dq of tile i - 1 beside S, dP of tile i: not at D 256, where dq's 128
  // registers in flight beside them made ptxas spill (the forward's
  // choice too); there the two consumer warpgroups overlap each other
  constexpr bool kOverlap = D != 256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::kBlockBytes;
  auto k_tile = [&](int s) {
    return base + L::kTilesOffset + 2 * s * L::kTileBytes;
  };
  auto v_tile = [&](int s) { return k_tile(s) + L::kTileBytes; };
  const uint32_t bars = base + L::kBarOffset;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t blk_bar = bars + 8 * 2 * kStages;

  // the last query block of every (sequence, head) first: the heaviest
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int q_last = min(q0 + kRows, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_off + q_last + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kCols - 1) / kCols : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);             // one arrive a consumer warp
    }
    mbar_init(blk_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(blk_bar, 2 * L::kBlockBytes);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load(q_s + a * kRows * kAtomBytes, &q_map, 64 * a, h, q0, b,
                 blk_bar);
        tma_load(do_s + a * kRows * kAtomBytes, &do_map, 64 * a, h, q0, b,
                 blk_bar);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = kv_begin + i * kCols;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kTileBytes);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load(k_tile(s) + a * kCols * kAtomBytes, &k_map, 64 * a, hk, k0,
                   b, full(s));
          tma_load(v_tile(s) + a * kCols * kAtomBytes, &v_map, 64 * a, hk, k0,
                   b, full(s));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, tw = tid - 128 * wg;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int rlo = q0 + 64 * c, rhi = rlo + 63;
  const int row[2] = {rlo + 16 * warp + g, rlo + 16 * warp + g + 8};
  // the rows' positions: the masks compare these with the keys'
  const int plo = q_off + rlo, phi = q_off + rhi;
  const int pos[2] = {q_off + row[0], q_off + row[1]};
  const uint32_t q_rows = q_s + 64 * c * kAtomBytes;
  const uint32_t do_rows = do_s + 64 * c * kAtomBytes;
  const size_t bh = static_cast<size_t>(b) * Hq + h;
  // the padded layout holds every row of the block
  const float lse_r[2] = {lse[bh * stride + row[0]],
                          lse[bh * stride + row[1]]};
  const float dl_r[2] = {delta[bh * stride + row[0]],
                         delta[bh * stride + row[1]]};

  auto seen = [&](int i) {
    const int k0 = kv_begin + i * kCols;
    return k0 < Sk && !(causal && k0 > phi) &&
           !(window > 0 && plo - (k0 + kCols - 1) >= window);
  };
  int i_lo = 0;
  while (i_lo < n_tiles && !seen(i_lo)) ++i_lo;
  int i_hi = i_lo;
  while (i_hi < n_tiles && seen(i_hi)) ++i_hi;
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(empty(i % kStages));
  };
  auto skip = [&](int i) {
    mbar_wait(full(i % kStages), (i / kStages) & 1);
    release(i);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[kCols / 2], dp[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) s[i] = dp[i] = 0.f;
  uint32_t ds[kCols / 16][4];

  auto issue_sdp = [&](int i) {
    mbar_wait(full(i % kStages), (i / kStages) & 1);
    issue_xyt<D, false>(s, q_rows, k_tile(i % kStages));
    issue_xyt<D, false>(dp, do_rows, v_tile(i % kStages));
  };

  // P = exp2(s scale log2 e - lse) while dP is in flight, then dS =
  // P (dP - delta) as bf16 fragments: s[4 j + e] is row row[e >> 1], key
  // k0 + 8 j + 2 t + (e & 1)
  auto ds_of = [&](int i) {
    wgmma_wait<1>();                       // dq of tile i - 1, S of tile i
    fence_regs<kCols / 2>(s);
    if (kOverlap && i > i_lo) release(i - 1);
    const int k0 = kv_begin + i * kCols;
    const bool full_tile = k0 + kCols <= Sk &&
                           (!causal || k0 + kCols - 1 <= plo) &&
                           (window <= 0 || phi - k0 < window);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1), r = pos[e >> 1];
        const bool ok = full_tile || (key < Sk && (!causal || key <= r) &&
                                      (window <= 0 || r - key < window));
        const float p =
            fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse_r[e >> 1]));
        s[4 * j + e] = ok ? p : 0.f;
      }
    wgmma_wait<0>();                       // dP of tile i
    fence_regs<kCols / 2>(dp);
#pragma unroll
    for (int x = 0; x < kCols / 2; ++x)
      dp[x] = s[x] * (dp[x] - dl_r[(x >> 1) & 1]);
    pack_frag<kCols>(dp, ds);
  };
  auto issue_dq = [&](int i) {             // dq += dS K
    fence_regs<D / 2>(acc);
    fence_regs<kCols / 4>(&ds[0][0]);
    wgmma_fence();
    issue_acc<D>(acc, ds, k_tile(i % kStages));
    wgmma_commit();
    fence_regs<D / 2>(acc);
  };

  for (int i = 0; i < i_lo; ++i) skip(i);
  mbar_wait(blk_bar, 0);
  if constexpr (!kOverlap) {
    for (int i = i_lo; i < i_hi; ++i) {
      issue_sdp(i);
      ds_of(i);
      issue_dq(i);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      release(i);
    }
  } else if (i_lo < i_hi) {
    // dq of tile i - 1 and S, dP of tile i run together on the tensor
    // cores, issued and waited for in one iteration (a wait across the
    // loop's back edge makes ptxas serialize the batch); the last tile's
    // dq is peeled so that no wgmma sits in a branch
    issue_sdp(i_lo);
    ds_of(i_lo);
    for (int i = i_lo + 1; i < i_hi; ++i) {
      issue_dq(i - 1);
      issue_sdp(i);
      ds_of(i);
    }
    issue_dq(i_hi - 1);
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);
    release(i_hi - 1);
  }
  for (int i = i_hi; i < n_tiles; ++i) skip(i);
  store_rows<D>(dq, acc, row, b, Sq, Hq, h, t, scale);
}

// dk, dv: a block owns 128 keys of one (sequence, KV head) and, for each of
// the KV head's query heads, walks the kCols-query tiles that see them:
// S^T = K Q^T (and dP^T = V dO^T) from shared memory, P^T (and dS^T) on
// the fragment (lse and delta of the tile's queries from the stage's
// slices), dv += P^T dO and dk += dS^T Q with P^T and dS^T from registers.
// kDk and kDv say which of the two the block accumulates: both at D 64 and
// 128; at D 256, where dk and dv would be 128 + 128 float32 registers a
// thread, one each (the grid's z: dk first, the heavier), so the dv
// blocks compute no dP^T and read no v.
template <int D, bool kDk, bool kDv>
__device__ __forceinline__ void dkdv_body(
    const CUtensorMap* q_map, const CUtensorMap* do_map,
    const CUtensorMap* k_map, const CUtensorMap* v_map,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
    int Sk, int q_off, int Hq, int Hkv, int causal, int window, int stride,
    float scale_log2, float scale) {
  using L = Smem<D>;
  constexpr int kAtoms = D / 64, kCols = L::kCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::kBlockBytes;
  auto q_tile = [&](int s) {
    return base + L::kTilesOffset + 2 * s * L::kTileBytes;
  };
  auto do_tile = [&](int s) { return q_tile(s) + L::kTileBytes; };
  auto lse_vec = [&](int s) {
    return base + L::kVecsOffset + 2 * s * L::kVecBytes;
  };
  auto dl_vec = [&](int s) { return lse_vec(s) + L::kVecBytes; };
  const uint32_t bars = base + L::kBarOffset;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t blk_bar = bars + 8 * 2 * kStages;
  const float* vecs = reinterpret_cast<const float*>(
      smem_raw + (base - smem_addr(smem_raw)) + L::kVecsOffset);

  // the first keys see the most queries: they start first
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.y * kRows;
  const int k_last = min(k0 + kRows, Sk) - 1;
  // the query rows any key of the block sees (row i at q_off + i); the
  // first is rounded down to a multiple of 64, so that a stage's slices of
  // lse and delta are aligned and end inside the padded rows
  const int q_begin = causal ? (max(0, k0 - q_off) & ~63) : 0;
  const int q_end =
      window > 0 ? min(Sq, max(0, k_last + window - q_off)) : Sq;
  const int n_q = q_end > q_begin ? (q_end - q_begin + kCols - 1) / kCols : 0;
  const int n_tiles = G * n_q;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init(blk_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(blk_bar, (kDk ? 2 : 1) * L::kBlockBytes);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load(k_s + a * kRows * kAtomBytes, k_map, 64 * a, hk, k0, b,
                 blk_bar);
        if constexpr (kDk)
          tma_load(v_s + a * kRows * kAtomBytes, v_map, 64 * a, hk, k0, b,
                   blk_bar);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, h = hk * G + i / n_q;
        const int q0 = q_begin + (i % n_q) * kCols;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kTileBytes + 2 * L::kVecBytes);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load(q_tile(s) + a * kCols * kAtomBytes, q_map, 64 * a, h, q0,
                   b, full(s));
          tma_load(do_tile(s) + a * kCols * kAtomBytes, do_map, 64 * a, h,
                   q0, b, full(s));
        }
        const size_t at = (static_cast<size_t>(b) * Hq + h) * stride + q0;
        bulk_load(lse_vec(s), lse + at, L::kVecBytes, full(s));
        bulk_load(dl_vec(s), delta + at, L::kVecBytes, full(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, tw = tid - 128 * wg;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int klo = k0 + 64 * c, khi = klo + 63;
  const int key[2] = {klo + 16 * warp + g, klo + 16 * warp + g + 8};
  const uint32_t k_rows = k_s + 64 * c * kAtomBytes;
  const uint32_t v_rows = v_s + 64 * c * kAtomBytes;

  float ak[kDk ? D / 2 : 1], av[kDv ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < (kDk ? D / 2 : 1); ++i) ak[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDv ? D / 2 : 1); ++i) av[i] = 0.f;
  float s[kCols / 2], dp[kDk ? kCols / 2 : 1];
  uint32_t pt[kCols / 16][4], dst[kCols / 16][4];

  mbar_wait(blk_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, q0 = q_begin + (i % n_q) * kCols;
    mbar_wait(full(st), (i / kStages) & 1);
    // a tile none of this warpgroup's keys sees is released unread (its
    // queries at positions p0 .. p0 + kCols - 1)
    const int p0 = q_off + q0;
    if (klo >= Sk || (causal && p0 + kCols - 1 < klo) ||
        (window > 0 && p0 - khi >= window)) {
      if (lane == 0) mbar_arrive(empty(st));
      continue;
    }
    issue_xyt<D, true>(s, k_rows, q_tile(st));
    if constexpr (kDk) issue_xyt<D, true>(dp, v_rows, do_tile(st));
    const float* lse_s = vecs + 2 * st * kCols;
    const float* dl_s = lse_s + kCols;
    const bool full_tile = q0 + kCols <= Sq && khi < Sk &&
                           (!causal || p0 >= khi) &&
                           (window <= 0 || p0 + kCols - 1 - klo < window);
    // P^T while dP^T is in flight: s[4 j + e] is key key[e >> 1], query
    // q0 + 8 j + 2 t + (e & 1)
    wgmma_wait<kDk ? 1 : 0>();
    fence_regs<kCols / 2>(s);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = q0 + 8 * j + 2 * t + (e & 1), kr = key[e >> 1];
        const int pr = q_off + qr;
        const bool ok =
            full_tile || (qr < Sq && kr < Sk && (!causal || kr <= pr) &&
                          (window <= 0 || pr - kr < window));
        const float p = fast_exp2(
            fmaf(s[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
        s[4 * j + e] = ok ? p : 0.f;
      }
    }
    if constexpr (kDv) pack_frag<kCols>(s, pt);
    if constexpr (kDk) {
      wgmma_wait<0>();
      fence_regs<kCols / 2>(dp);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      pack_frag<kCols>(dp, dst);
      fence_regs<D / 2>(ak);
      fence_regs<kCols / 4>(&dst[0][0]);
    }
    if constexpr (kDv) {
      fence_regs<D / 2>(av);
      fence_regs<kCols / 4>(&pt[0][0]);
    }
    wgmma_fence();
    if constexpr (kDv) issue_acc<D>(av, pt, do_tile(st));
    if constexpr (kDk) issue_acc<D>(ak, dst, q_tile(st));
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kDv) fence_regs<D / 2>(av);
    if constexpr (kDk) fence_regs<D / 2>(ak);
    if (lane == 0) mbar_arrive(empty(st));
  }
  if constexpr (kDk) store_rows<D>(dk, ak, key, b, Sk, Hkv, hk, t, scale);
  if constexpr (kDv) store_rows<D>(dv, av, key, b, Sk, Hkv, hk, t, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                      int q_off, int Hq, int Hkv, int causal, int window,
                      int stride, float scale_log2, float scale) {
  if constexpr (D == 256) {
    if (blockIdx.z == 0)
      dkdv_body<D, true, false>(&q_map, &do_map, &k_map, &v_map, lse, delta,
                                dk, dv, Sq, Sk, q_off, Hq, Hkv, causal,
                                window, stride, scale_log2, scale);
    else
      dkdv_body<D, false, true>(&q_map, &do_map, &k_map, &v_map, lse, delta,
                                dk, dv, Sq, Sk, q_off, Hq, Hkv, causal,
                                window, stride, scale_log2, scale);
  } else {
    dkdv_body<D, true, true>(&q_map, &do_map, &k_map, &v_map, lse, delta, dk,
                             dv, Sq, Sk, q_off, Hq, Hkv, causal, window,
                             stride, scale_log2, scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv,
                   const void* lse, void* delta, int B, int Sq, int Sk,
                   int q_off, int Hq, int Hkv, int causal, int window,
                   float scale, cudaStream_t stream) {
  using L = Smem<D>;
  constexpr int kCols = L::kCols;
  static const cudaError_t attr =
      cudaFuncSetAttribute(fa_bwd_dq_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kBytes) != cudaSuccess
          ? cudaErrorInvalidValue
          : cudaFuncSetAttribute(fa_bwd_dkdv_tc_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 L::kBytes);
  if (attr != cudaSuccess) return attr;
  const long long qs = static_cast<long long>(Hq) * D;   // seq strides
  const long long ks = static_cast<long long>(Hkv) * D;
  const int q_blocks = (Sq + kRows - 1) / kRows, stride = q_blocks * kRows;
  const int k_blocks = (Sk + kRows - 1) / kRows;
  // the dq kernel's q and dO in 128-row boxes, k and v in kCols-row tiles;
  // the dk/dv kernel's the other way round
  CUtensorMap q128, do128, kt, vt, qt, dot, k128, v128;
  if (!make_map(&q128, q, B, Sq, Hq, D, Sq * qs, qs, D, kRows) ||
      !make_map(&do128, dout, B, Sq, Hq, D, Sq * qs, qs, D, kRows) ||
      !make_map(&kt, k, B, Sk, Hkv, D, Sk * ks, ks, D, kCols) ||
      !make_map(&vt, v, B, Sk, Hkv, D, Sk * ks, ks, D, kCols) ||
      !make_map(&qt, q, B, Sq, Hq, D, Sq * qs, qs, D, kCols) ||
      !make_map(&dot, dout, B, Sq, Hq, D, Sq * qs, qs, D, kCols) ||
      !make_map(&k128, k, B, Sk, Hkv, D, Sk * ks, ks, D, kRows) ||
      !make_map(&v128, v, B, Sk, Hkv, D, Sk * ks, ks, D, kRows))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  float* dl = static_cast<float*>(delta);
  const float* ls = static_cast<const float*>(lse);
  const size_t rows = static_cast<size_t>(B) * Hq * stride;
  fa_bwd_delta_kernel<D><<<static_cast<unsigned>(rows / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), dl, Sq, Hq, stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq_tc_kernel<D><<<dim3(B * Hq, q_blocks), kThreads, L::kBytes,
                           stream>>>(
      q128, do128, kt, vt, ls, dl, static_cast<__nv_bfloat16*>(dq), Sq, Sk,
      q_off, Hq, Hkv, causal, window, stride, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // at D 256 z = 0 blocks write dk, z = 1 blocks dv
  fa_bwd_dkdv_tc_kernel<D><<<dim3(B * Hkv, k_blocks, D == 256 ? 2 : 1),
                             kThreads, L::kBytes, stream>>>(
      qt, dot, k128, v128, ls, dl, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, q_off, Hq, Hkv, causal, window,
      stride, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, void* lse, void* delta, int B, int D,
                     const Geo& g, cudaStream_t s) {
  // bf16 at D 64 and 128 is the tensor cores' (route 1) only, never built
  // here; bf16 at D 256 is theirs too, and here only when asked for
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
    case 64:
      if constexpr (!kBf16)
        return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
      break;
    case 128:
      if constexpr (!kBf16)
        return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
      break;
    case 256: return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq (B, Sq, Hq, D) and k, v, dk, dv (B, Sk, Hkv, D), contiguous,
// all in `dtype`; query row i at position q_off + i (q_off >= 0); window <=
// 0: no window.  route 0 (CUDA cores): lse and delta are float32 (B, Hq, Sq)
// workspace, written by the first kernel and read by the second.  route 1
// (tensor cores: bf16 at D 64, 128 or 256): lse is the forward's, float32
// (B, Hq, ceil(Sq / 128) * 128) in log2 units, and delta workspace of that
// shape.  The entry refuses route 1 where dtype and D do not take it, and
// route 0 at bf16 D 64 and 128; route 0 at bf16 D 256 is the CUDA-core
// kernels asked for by name (the wrapper's tensor_cores=False, to time the
// two routes side by side).  Returns the last launch's cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int Sq, int Sk, int q_off, int Hq, int Hkv, int D, int causal,
    int window, float scale, int dtype, int route, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || q_off < 0 || Hkv <= 0 ||
      Hq > 65535 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const bool tensor_cores =
      dtype == kBFloat16 && (D == 64 || D == 128 || D == 256);
  if (route == 1 ? !tensor_cores : (route != 0 || (tensor_cores && D != 256)))
    return cudaErrorInvalidValue;
  const Geo g{Sq, Sk, q_off, Hq, Hkv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (D == 256)
      return tc::launch<256>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq,
                             Sk, q_off, Hq, Hkv, causal, window, scale, s);
    if (D == 128)
      return tc::launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq,
                             Sk, q_off, Hq, Hkv, causal, window, scale, s);
    return tc::launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk,
                          q_off, Hq, Hkv, causal, window, scale, s);
  }
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, D, g,
                           s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   B, D, g, s);
  return cudaErrorInvalidValue;
}
