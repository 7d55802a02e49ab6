// Blocked online-softmax (flash) attention for Hopper: grouped-query
// attention over whole sequences, causal and/or sliding-window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel), whose grid (B*Hq, Sq/q_blk, Sk/kv_blk)
// walks KV tiles in order on one core, carries the float32 (acc, m, l)
// state in VMEM scratch from one grid step to the next, and skips dead
// tiles with pl.when.
//
// Semantics kept from the TPU kernel: query row i sees key j when
// (not causal or j <= i) and (no window or i - j < window); query head h
// reads KV head h / (Hq / Hkv); scores are q * D^-0.5 . k in float32; the
// softmax is online in float32; the result is acc / max(l, 1e-30) cast to
// q's dtype.  Unlike the TPU kernel, a key a row cannot see never takes
// weight: masked probabilities are zeroed explicitly (a row can be fully
// masked on a tile another row of the block needs), so a row that sees no
// key at all is written as zeros.
//
// Bound on this card: operations at the prefill shapes.  Every visible
// (query, key) pair costs 4 * D flops a query head against one read of
// q, k, v and one write of out, so at S = 1024 the work is ~450 flops a
// byte, above the ~295 at which H100 stops being memory-bound.
//
// Design, a first simple one (float32 on CUDA cores; no wgmma, no TMA):
// * Grid (ceil(Sq / BM), Hq, B); each block owns BM query rows of one
//   (sequence, query head).  Blocks run in no order, so the TPU's
//   sequential KV axis is a loop inside the block, and its tile skip is
//   the loop's bounds: a causal block stops after its last row's key, a
//   windowed block starts at the first key its first row can see.  The
//   x index is reversed so that the heaviest causal tiles launch first.
// * q, k and v are read in the (B, S, H, D) layout through their strides
//   with 16-byte vector loads; the wrapper does no transpose.  Rows past
//   Sq and keys past the loop's end are staged as zeros and masked, so any
//   S >= 1 works (the TPU wrapper asserts S % 256 == 0).
// * 128 threads = 16 row groups x 8 column groups.  A thread holds TM
//   query rows; for the scores it takes TN keys (j = cg + 8 * t) of a tile,
//   for the output D / 8 columns (c = cg + 8 * t), so a row's max and sum
//   are reduced over 8 neighbouring lanes by shuffle.  Q and K are staged
//   in shared memory transposed ([D][rows]) and V row-major, all float32,
//   so the inner loops read shared memory without bank conflicts; the
//   tile's probabilities pass through shared memory ([keys][BM + 1]) from
//   the score layout to the P @ V layout.
// * The accumulator is TM x D / 8 float32 registers a thread: 64 at
//   D = 128 with TM = 4.  At D = 256 the same rows would need 128 and
//   spill, so D = 256 holds TM = 2 rows a thread (BM = 32) and 32-key tiles,
//   which also keeps its shared memory near 100 KB, two blocks an SM.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;                     // lanes sharing a row
constexpr int kRowGroups = kThreads / kColGroups; // 16
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int TM = D > 128 ? 2 : 4;      // query rows a thread holds
  static constexpr int TN = D > 128 ? 4 : 8;      // keys a thread scores a tile
  static constexpr int BM = kRowGroups * TM;      // query rows a block holds
  static constexpr int BN = kColGroups * TN;      // keys a tile holds
  static constexpr int TC = D / kColGroups;       // output columns a thread holds
  static constexpr int PS = BM + 1;               // probability row stride
  static constexpr size_t kSmemBytes =
      sizeof(float) * (static_cast<size_t>(D) * BM + static_cast<size_t>(D) * BN +
                       static_cast<size_t>(BN) * D + static_cast<size_t>(BN) * PS);
};

struct Strides {
  long long b, s, h;  // in elements; the head dimension is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int Hkv, Strides qs, Strides ks,
                       Strides vs, int causal, int window, float scale) {
  using C = Tile<D>;
  constexpr int TM = C::TM, TN = C::TN, BM = C::BM, BN = C::BN, TC = C::TC,
                PS = C::PS;
  constexpr int N = Vec16<T>::N;   // elements in one 16-byte vector
  constexpr int kVecs = D / N;     // vectors in one row of D
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [D][BM], pre-scaled
  float* k_s = q_s + D * BM;       // [D][BN]
  float* v_s = k_s + D * BN;       // [BN][D]
  float* p_s = v_s + BN * D;       // [BN][PS]

  const int b = blockIdx.z, h = blockIdx.y, hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int q_last = min(q0 + BM, Sq) - 1;
  const int tid = threadIdx.x, rg = tid / kColGroups, cg = tid % kColGroups;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // q tile, transposed; row-fast so neighbouring threads store neighbouring
  // floats.  Rows past Sq are zeros (computed, never written out).
  for (int i = tid; i < BM * kVecs; i += kThreads) {
    const int r = i % BM, c = (i / BM) * N, row = q0 + r;
    float f[N];
    if (row < Sq) {
      unpack16<T>(*reinterpret_cast<const uint4*>(qb + row * qs.s + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) q_s[(c + e) * BM + r] = f[e] * scale;
  }

  // the keys any row of this tile can see: the TPU's dead-tile skip
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[TM], l[TM], acc[TM][TC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BN) {
    __syncthreads();  // q_s written / the previous tile fully read
    // K transposed, key-fast (conflict-free stores); keys past kv_end zero
    for (int i = tid; i < BN * kVecs; i += kThreads) {
      const int j = i % BN, c = (i / BN) * N, pos = k0 + j;
      float f[N];
      if (pos < kv_end) {
        unpack16<T>(*reinterpret_cast<const uint4*>(kb + pos * ks.s + c), f);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) k_s[(c + e) * BN + j] = f[e];
    }
    // V row-major, column-fast, stored as float4 vectors
    for (int i = tid; i < BN * kVecs; i += kThreads) {
      const int j = i / kVecs, c = (i % kVecs) * N, pos = k0 + j;
      float f[N];
      if (pos < kv_end) {
        unpack16<T>(*reinterpret_cast<const uint4*>(vb + pos * vs.s + c), f);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(v_s + j * D + c);
#pragma unroll
      for (int e = 0; e < N / 4; ++e)
        dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
    }
    __syncthreads();

    // scores: TM rows x TN keys a thread, one float32 sum each
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
      for (int t = 0; t < TN; ++t) kv[t] = k_s[d * BN + cg + kColGroups * t];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) s[i][t] += qv[i] * kv[t];
    }

    // online softmax per row; the row's 8 lanes reduce by shuffle
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + rg * TM + i;
      unsigned seen = 0;       // bit t: key cg + 8t is visible to this row
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int key = k0 + cg + kColGroups * t;
        const bool ok = key < kv_end && (!causal || key <= row) &&
                        (window <= 0 || row - key < window);
        if (ok) {
          seen |= 1u << t;
          mx = fmaxf(mx, s[i][t]);
        }
      }
#pragma unroll
      for (int o = kColGroups / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        // masked keys are zeroed explicitly, whatever m_new is
        const float p = (seen >> t) & 1u ? expf(s[i][t] - m_new) : 0.f;
        p_s[(cg + kColGroups * t) * PS + rg * TM + i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = kColGroups / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      m[i] = m_new;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // P @ V: each p and each V element read once for all of a thread's rows
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float pj[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) pj[i] = p_s[j * PS + rg * TM + i];
      const float* vr = v_s + j * D + cg;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float vv = vr[kColGroups * c];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][c] += pj[i] * vv;
      }
    }
  }

  // out is contiguous (B, Sq, Hq, D)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg * TM + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + cg;
#pragma unroll
    for (int c = 0; c < TC; ++c) o[kColGroups * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, Strides qs,
                   Strides ks, Strides vs, int causal, int window, float scale,
                   cudaStream_t stream) {
  using C = Tile<D>;
  // above 48 KB only with the attribute; set once per instantiation (a
  // function-local static is initialised once, thread-safely), so a launch
  // inside a CUDA-graph capture makes no attribute call
  static const cudaError_t attr =
      C::kSmemBytes > 48 * 1024
          ? cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(C::kSmemBytes))
          : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + C::BM - 1) / C::BM, Hq, B);
  flash_attention_kernel<T, D><<<grid, kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, qs, ks,
      vs, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int Hq, int Hkv, int D, Strides qs,
                     Strides ks, Strides vs, int causal, int window,
                     float scale, cudaStream_t stream) {
#define REPRO_FA_CASE(DIM)                                                     \
  case DIM:                                                                    \
    return launch<T, DIM>(q, k, v, out, B, Sq, Sk, Hq, Hkv, qs, ks, vs,       \
                          causal, window, scale, stream);
  switch (D) {
    REPRO_FA_CASE(16) REPRO_FA_CASE(32) REPRO_FA_CASE(64) REPRO_FA_CASE(128)
    REPRO_FA_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D) through their (batch, seq,
// head) strides in elements; out contiguous (B, Sq, Hq, D).  window <= 0:
// no window.  Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq > 65535 ||
      Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs,
                           causal, window, scale, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, qs, ks,
                                   vs, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
