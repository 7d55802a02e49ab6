// The backward of flash attention for Hopper: the gradients of grouped-query
// attention over whole sequences (Sq == Sk == S, the training forward),
// causal and/or sliding-window, with respect to q, k and v.
//
// Replaces no TPU kernel: the reference trains through jnp (its Pallas
// flash kernel, src/repro/kernels/flash_attention.py:flash_attention, has
// no VJP), so XLA differentiates the masked softmax.  This is B3's
// backward, for training on the card.
//
// With P = softmax(scale q k^T) under the mask and O = P v, and dO given:
//
//   lse_i   = log sum_j exp(s_ij)            (the forward does not keep it:
//                                             recomputed here, pass 1)
//   delta_i = sum_c dO_ic O_ic               (rowsum(dO * O))
//   dP_ij   = dO_i . v_j,  dS_ij = P_ij (dP_ij - delta_i)
//   dq_i    = scale sum_j dS_ij k_j
//   dk_j    = scale sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
//
// summed over the G query heads of each KV head for dk and dv.  Two
// kernels, so that neither needs atomics (every output element is written
// by one thread, and the result is the same every run):
//
//   fa_bwd_dq_kernel    a block a (query tile, query head, sequence): delta
//                       from O and dO, lse by an online pass over the keys
//                       the tile sees, then a second pass over them for dq;
//                       writes lse and delta (float32) for the second kernel
//   fa_bwd_dkdv_kernel  a block a (key tile, KV head, sequence): loops over
//                       the KV head's G query heads and the query tiles that
//                       see its keys, recomputing P and dS from lse and delta
//
// Bound on this card: operations (the backward's five products of the
// forward's size).  This first version runs them on CUDA cores in float32,
// as the forward's CUDA-core route does (the same thread layout: 128
// threads, 16 row groups x 8 column groups, tiles staged in shared memory
// as float32, a row's reductions over 8 lanes by shuffle); the dead-tile
// skip of the forward bounds both loops.  A wgmma/TMA backward is later
// speed work (ROADMAP Queue B).  Inputs are contiguous (B, S, H, D) in
// float32 or bf16, D one of 16, 32, 64, 128, 256; the gradients come out
// in the inputs' dtype, computed in float32.
#include "common.cuh"

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
  int S, Hq, Hkv, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int i, int j, const Geo& g) {
  return j < g.S && i < g.S && (!g.causal || j <= i) &&
         (g.window <= 0 || i - j < g.window);
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
  const int q_last = min(q0 + BM, g.S) - 1;
  const int tid = threadIdx.x, rg = tid / kColGroups, cg = tid % kColGroups;
  const long long qs = static_cast<long long>(g.Hq) * D;   // seq strides
  const long long ks = static_cast<long long>(g.Hkv) * D;
  const long long qoff = static_cast<long long>(b) * g.S * qs + h * D;
  const long long koff = static_cast<long long>(b) * g.S * ks + hk * D;

  load_t<T, D>(q_s, BM, q + qoff, qs, q0, BM, g.S, g.scale);
  load_t<T, D>(do_s, BM, dout + qoff, qs, q0, BM, g.S, 1.f);

  float dl[TM];                   // delta of each row
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg * TM + i;
    float t = 0.f;
    if (row < g.S) {
      const T* a = dout + qoff + row * qs;
      const T* c = o + qoff + row * qs;
      for (int e = cg; e < D; e += kColGroups)
        t += to_f32<T>(a[e]) * to_f32<T>(c[e]);
    }
    dl[i] = group_sum(t);
  }

  const int kv_end = g.causal ? min(g.S, q_last + 1) : g.S;
  const int kv_begin = g.window > 0 ? max(0, q0 - g.window + 1) : 0;

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
    if (row < g.S && cg == 0) {
      const size_t at = (static_cast<size_t>(b) * g.Hq + h) * g.S + row;
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
    if (row >= g.S) continue;
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
  const int k_last = min(k0 + BM, g.S) - 1;
  const int tid = threadIdx.x, rg = tid / kColGroups, cg = tid % kColGroups;
  const long long qs = static_cast<long long>(g.Hq) * D;
  const long long ks = static_cast<long long>(g.Hkv) * D;
  const long long koff = static_cast<long long>(b) * g.S * ks + hk * D;

  load_t<T, D>(k_s, BM, k + koff, ks, k0, BM, g.S, 1.f);
  load_t<T, D>(v_s, BM, v + koff, ks, k0, BM, g.S, 1.f);
  // the queries that see any key of the tile
  const int q_begin = g.causal ? k0 : 0;
  const int q_end = g.window > 0 ? min(g.S, k_last + g.window) : g.S;

  float ak[TM][TC], av[TM][TC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) ak[i][c] = av[i][c] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const long long qoff = static_cast<long long>(b) * g.S * qs + h * D;
    const size_t loff = (static_cast<size_t>(b) * g.Hq + h) * g.S;
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
    if (key >= g.S) continue;
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
  const unsigned tiles = (g.S + C::BM - 1) / C::BM;
  fa_bwd_dq_kernel<T, D><<<dim3(tiles, g.Hq, B), kThreads, C::kDqSmem,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<T, D><<<dim3(tiles, g.Hkv, B), kThreads, C::kDkvSmem,
                             stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, void* lse, void* delta, int B, int D,
                     const Geo& g, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
    case 256: return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (B, S, Hq, D) and k, v, dk, dv (B, S, Hkv, D), contiguous,
// all in `dtype`; lse and delta: float32 (B, Hq, S) workspace, written by
// the first kernel and read by the second.  window <= 0: no window.
// Returns the last launch's cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int S, int Hq, int Hkv, int D, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Hkv <= 0 || Hq > 65535 ||
      Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const Geo g{S, Hq, Hkv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, D, g,
                           s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta,
                                   B, D, g, s);
  return cudaErrorInvalidValue;
}
