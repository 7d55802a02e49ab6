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
// key at all is written as zeros.  Any S >= 1 works, Sq != Sk works, and
// q, k, v are read through their (batch, seq, head) strides.
//
// Bound on this card: operations at the prefill shapes.  Every visible
// (query, key) pair costs 4 * D flops a query head against one read of
// q, k, v and one write of out, so at S = 1024 the work is ~450 flops a
// byte, above the ~295 at which H100 stops being memory-bound.  The bound
// is the tensor cores' rate, which only wgmma reaches.
//
// Two routes, chosen by the wrapper from dtype and D before any launch
// (neither is a fallback of the other; the entry point refuses a route
// that does not match them):
//
// 1. Tensor cores (flash_attention_tc_kernel): bf16 q/k/v at D 64, 128
//    and 256, the serving path's case (qwen2-7b and qwen3-1.7b, D 128;
//    gemma3-4b, D 256).
//    * A block holds 128 query rows of one (sequence, query head): two
//      consumer warpgroups of 64 rows each (wgmma's M) and a producer
//      warpgroup.  setmaxnreg gives the producer 24 registers a thread and
//      the consumers 240.
//    * One producer thread keeps K/V tiles in flight with TMA
//      (cp.async.bulk.tensor, 4-d tensor maps over (D, H, S, B) built on
//      the host through cudaGetDriverEntryPoint, so the library links no
//      libcuda, and passed as __grid_constant__ parameters) into a ring,
//      full/empty mbarriers between producer and consumers: tiles of 128
//      keys in 3 stages at D 64 and 128 (224 KB with q at D 128); at D 256
//      tiles of 64 keys in 2 stages, since q alone is 64 KB there and a
//      128-key stage would be 128 KB (q + 2 x 64 KB = 192 KB).  The q tile
//      arrives once the same way.  TMA writes the 128-byte swizzle (64 bf16
//      a row of an atom; D 128 is two atoms side by side, D 256 four),
//      which is the layout the wgmma descriptors name; rows past S arrive
//      as zeros (tma.cuh).
//    * S = Q K^T is D / 16 wgmma from shared memory (both operands
//      K-major; m64n128k16, at D 256 m64n64k16), float32 accumulator in
//      registers.  The online softmax runs on the accumulator fragment (ex2
//      with the scale and log2 e folded into one FMA), a row's max reduced
//      over the 4 lanes that share it; the row sums stay per lane until
//      the end.
//    * O += P V is wgmma.m64nDk16 with P from registers (N = D, up to
//      wgmma's widest 256): the m64 accumulator layout is the A-fragment
//      layout, so P needs no trip through shared memory; V is the B
//      operand, MN-major (the descriptor's transpose bit).  P enters as a
//      bf16 pair hi + lo (lo the rounding rest of hi), two wgmma each: one
//      bf16 rounding of p gave 1.23x the 4e-3 bf16 limit at S 1024 in a CPU
//      emulation of this arithmetic, the pair 0.65x.  It costs PV twice,
//      1.5x the tensor work.
//    * What bounds it on the card is keeping the tensor cores fed, not the
//      products: a tile's softmax on the CUDA cores takes about as long as
//      its wgmma (run one tile at a time, D 64 took as long as D 128 on an
//      H100).  So a warpgroup pipelines its tiles as FlashAttention-3
//      does: QK of tile i and PV of tile i - 1 are issued together, and
//      the softmax of tile i runs on the CUDA cores while PV i - 1 runs on
//      the tensor cores (S, P and O in registers: 64 + 64 + 64 of the 240
//      at D 128).  D 256 runs its tiles one after the other: with 64-key
//      tiles S is 32 registers and P's pair 32, so the overlap would hold
//      the same 192 beside O's 128, but ptxas then spilled, and on an H100
//      the overlapped version ran slower at gemma3's prefill (B 4, S 2048,
//      8/4) than this one, which spills nothing.
//    * Blocks start in the order of their work, the last query block of
//      every (sequence, head) first: at S 1024, 8 x 28 = 224 blocks are
//      1.7 waves on 132 SMs, and heaviest-first only within each head
//      leaves 8-tile blocks for the second wave.  With this order the
//      busiest SM holds about 8 tile-times against an average of 7.6, so
//      a persistent schedule could gain little here.
//    * The dead-tile skip stays: a causal block stops after its last row's
//      key, a windowed one starts at its first row's first key, and a
//      warpgroup releases unread the tiles none of its rows sees.
//    * Training's forward also writes each row's log-sum-exp in log2 units
//      (m scale log2 e + log2 l, float32, every row of the block) for the
//      backward's tensor-core route; serving passes no pointer.
//    * Raw PTX in inline asm (wgmma.cuh, tma.cuh), not CuTe: the build
//      stays one nvcc per source with no include path beyond the toolkit's.
//    * ptxas (sm_90a): 168 registers a thread at launch (setmaxnreg moves
//      them), no spills, no stack; 230,456 bytes of dynamic shared memory
//      at D 128, 115,768 at D 64, 197,672 at D 256.
// 2. CUDA cores (flash_attention_kernel): float32 q/k/v (the 2e-4 float32
//    limit rules out TF32 and bf16 operands), and bf16 at D 16 and 32
//    (the SMOKE configs).
//    * Grid (ceil(Sq / BM), Hq, B); each block owns BM query rows of one
//      (sequence, query head).  Blocks run in no order, so the TPU's
//      sequential KV axis is a loop inside the block, and its tile skip is
//      the loop's bounds.  The x index is reversed so that the heaviest
//      causal tiles launch first.
//    * q, k and v are read in the (B, S, H, D) layout through their
//      strides with 16-byte vector loads.  Rows past Sq and keys past the
//      loop's end are staged as zeros and masked.
//    * 128 threads = 16 row groups x 8 column groups.  A thread holds TM
//      query rows; for the scores it takes TN keys (j = cg + 8 * t) of a
//      tile, for the output D / 8 columns (c = cg + 8 * t), so a row's max
//      and sum are reduced over 8 neighbouring lanes by shuffle.  Q and K
//      are staged in shared memory transposed ([D][rows]) and V
//      row-major, all float32; the tile's probabilities pass through
//      shared memory ([keys][BM + 1]) from the score layout to the P @ V
//      layout.
//    * The accumulator is TM x D / 8 float32 registers a thread: 64 at
//      D = 128 with TM = 4.  D = 256 holds TM = 2 rows a thread (BM = 32)
//      and 32-key tiles, which keeps its shared memory near 100 KB.
//
// chip_smoke.py prints every instantiation's registers and spills from
// build/*.log.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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
  // bf16 at D 64, 128 and 256 is the tensor cores' (route 1), never built
  // here
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
#define REPRO_FA_CASE(DIM)                                                     \
  case DIM:                                                                    \
    if constexpr (!kBf16 || DIM < 64)                                          \
      return launch<T, DIM>(q, k, v, out, B, Sq, Sk, Hq, Hkv, qs, ks, vs,     \
                            causal, window, scale, stream);                   \
    break;
  switch (D) {
    REPRO_FA_CASE(16) REPRO_FA_CASE(32) REPRO_FA_CASE(64) REPRO_FA_CASE(128)
    REPRO_FA_CASE(256)
  }
#undef REPRO_FA_CASE
  return cudaErrorInvalidValue;
}

// -- route 1: tensor cores (wgmma, TMA, mbarriers) ---------------------------

namespace tc {

using namespace hopper;

constexpr int kBM = 128;            // query rows a block: 2 consumer warpgroups
constexpr int kThreads = 384;       // producer warpgroup + 2 consumers
constexpr float kNegInf = -1e30f;
constexpr float kNoKey = 1e30f;     // log-sum-exp of a row that sees no key

template <int D>
struct Smem {
  // keys a tile and ring depth: 128-key tiles in 3 stages at D 64 and 128;
  // at D 256 a 128-key stage alone would be 128 KB, so 64-key tiles in 2
  // stages (q 64 KB + 2 x 64 KB)
  static constexpr int kBN = D == 256 ? 64 : 128;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kQBytes = kBM * D * 2;      // D / 64 atoms of 128 rows
  static constexpr int kTileBytes = kBN * D * 2;   // one of K, V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + full[kStages], empty[kStages], q barriers; + slack to align to 1024
  static constexpr int kBytes = kBarOffset + 8 * (2 * kStages + 1) + 1024;
};

// S = Q K^T for one k step: 128-key tiles at D 64 and 128, 64-key at 256
template <int D>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (D == 256)
    wgmma_ss_m64n64k16(s, a, b, scale_d);
  else
    wgmma_ss_m64n128k16(s, a, b, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (D == 256)
    wgmma_rs_m64n256k16(o, a, b);
  else if constexpr (D == 128)
    wgmma_rs_m64n128k16(o, a, b);
  else
    wgmma_rs_m64n64k16(o, a, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int lse_stride, int Sq,
                          int Sk, int Hq, int Hkv, int causal, int window,
                          float scale_log2) {
  using L = Smem<D>;
  constexpr int kBN = L::kBN, kStages = L::kStages;
  constexpr int kAtoms = D / 64;          // swizzle atoms across D
  // QK of tile i beside PV of tile i - 1: not at D 256 (see the note)
  constexpr bool kOverlap = D != 256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // the swizzle's alignment
  const uint32_t q_s = base;
  const uint32_t bars = base + L::kBarOffset;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t q_bar = bars + 8 * 2 * kStages;
  auto k_tile = [&](int s) { return base + L::kQBytes + s * L::kStageBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + L::kTileBytes; };

  // blocks start in x order: every (sequence, head) of the last query
  // block first, the heaviest causal work of the whole grid
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int q_last = min(q0 + kBM, Sq) - 1;
  // the keys any row of this block can see: the TPU's dead-tile skip
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBN - 1) / kBN
                                        : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);             // one arrive a consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int a = 0; a < kAtoms; ++a)
        tma_load(q_s + a * kBM * kAtomBytes, &q_map, 64 * a, h, q0, b, q_bar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = kv_begin + i * kBN;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        mbar_expect_tx(full(s), L::kStageBytes);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load(k_tile(s) + a * kBN * kAtomBytes, &k_map, 64 * a, hk, k0, b,
                   full(s));
          tma_load(v_tile(s) + a * kBN * kAtomBytes, &v_map, 64 * a, hk, k0, b,
                   full(s));
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows q0 + 64 c .. + 63 -------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, tw = tid - 128 * wg;
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t = lane % 4;
  const int rlo = q0 + 64 * c, rhi = rlo + 63;
  const int row[2] = {rlo + 16 * warp + g, rlo + 16 * warp + g + 8};
  const uint32_t q_rows = q_s + 64 * c * kAtomBytes;   // this warpgroup's rows
  // the tiles this warpgroup's rows see form one run [i_lo, i_hi) of the
  // block's (a window cuts early tiles, causality late ones); the others
  // are released unread
  auto seen = [&](int i) {
    const int k0 = kv_begin + i * kBN;
    return k0 < Sk && !(causal && k0 > rhi) &&
           !(window > 0 && rlo - (k0 + kBN - 1) >= window);
  };
  int i_lo = 0;
  while (i_lo < n_tiles && !seen(i_lo)) ++i_lo;
  int i_hi = i_lo;
  while (i_hi < n_tiles && seen(i_hi)) ++i_hi;
  auto release = [&](int i) {              // this warp is done with tile i
    if (lane == 0) mbar_arrive(empty(i % kStages));
  };
  auto skip = [&](int i) {
    mbar_wait(full(i % kStages), (i / kStages) & 1);
    release(i);
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sacc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sacc[i] = 0.f;
  uint32_t ph[kBN / 16][4], pl[kBN / 16][4];   // P of the tile in flight
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // S = Q K^T of tile i into sacc: D / 16 k steps; a step inside a
  // swizzle atom moves the descriptors 32 bytes
  auto issue_qk = [&](int i) {
    const uint32_t k_s = k_tile(i % kStages);
    fence_regs<kBN / 2>(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_qk<D>(
          sacc, gmma_desc(q_rows + (kk / 4) * kBM * kAtomBytes + off, 16, 1024),
          gmma_desc(k_s + (kk / 4) * kBN * kAtomBytes + off, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
    fence_regs<kBN / 2>(sacc);
  };
  // O += P V of tile i: V is [keys][D] in atoms of 64 columns (MN-major);
  // a k step of 16 keys is two 8-row groups, 2048 bytes; P as hi + lo
  auto issue_pv = [&](int i) {
    const uint32_t v_s = v_tile(i % kStages);
    fence_regs<D / 2>(o);
    fence_regs<kBN / 4>(&ph[0][0]);
    fence_regs<kBN / 4>(&pl[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t vd = gmma_desc(v_s + kk * 16 * kAtomBytes,
                                    kBN * kAtomBytes, 1024);
      wgmma_pv<D>(o, ph[kk], vd);
      wgmma_pv<D>(o, pl[kk], vd);
    }
    wgmma_commit();
    fence_regs<D / 2>(o);
  };
  // online softmax of tile i on the fragment: sacc[4 j + e] is row
  // row[e >> 1], key k0 + 8 j + 2 t + (e & 1).  Leaves p = exp2((s - m)
  // scale log2 e) in sacc, updates m and l, returns the rescale of O.
  auto softmax = [&](int i, float* corr) {
    const int k0 = kv_begin + i * kBN;
    const bool full_tile = k0 + kBN <= Sk && (!causal || k0 + kBN - 1 <= rlo) &&
                           (window <= 0 || rhi - k0 < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full_tile) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), r = row[e >> 1];
          const bool ok = key < Sk && (!causal || key <= r) &&
                          (window <= 0 || r - key < window);
          // exp2(-inf) = 0: a masked key is zeroed explicitly
          if (!ok) sacc[4 * j + e] = -__int_as_float(0x7f800000);
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * j + e]);
      }
    float neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      neg[r] = -mx[r] * scale_log2;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            fast_exp2(fmaf(sacc[4 * j + e], scale_log2, neg[e >> 1]));
        sacc[4 * j + e] = p;
        l[e >> 1] += p;
      }
  };
  // P (in sacc) as bf16 hi + lo A fragments: k step kk covers keys
  // 16 kk .. + 15, which are sacc[8 kk .. 8 kk + 7] in register order
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = sacc[8 * kk + 2 * r], p1 = sacc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][r] = pack_bf16x2(p0 - __low2float(hi), p1 - __high2float(hi));
      }
  };
  auto rescale = [&](const float* corr) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
  };

  for (int i = 0; i < i_lo; ++i) skip(i);
  mbar_wait(q_bar, 0);
  if constexpr (!kOverlap) {
    float corr[2];
    for (int i = i_lo; i < i_hi; ++i) {
      mbar_wait(full(i % kStages), (i / kStages) & 1);
      issue_qk(i);
      wgmma_wait<0>();
      fence_regs<kBN / 2>(sacc);
      softmax(i, corr);
      rescale(corr);
      pack_p();
      issue_pv(i);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      release(i);
    }
  } else if (i_lo < i_hi) {
    // The pipeline (FlashAttention-3's, within a warpgroup): QK of tile i
    // and PV of tile i - 1 are issued together, and the softmax of tile i
    // runs on the CUDA cores while PV i - 1 runs on the tensor cores.
    float corr[2];
    mbar_wait(full(i_lo % kStages), (i_lo / kStages) & 1);
    issue_qk(i_lo);
    wgmma_wait<0>();
    fence_regs<kBN / 2>(sacc);
    softmax(i_lo, corr);
    pack_p();
    for (int i = i_lo + 1; i < i_hi; ++i) {
      mbar_wait(full(i % kStages), (i / kStages) & 1);
      issue_qk(i);
      issue_pv(i - 1);
      wgmma_wait<1>();                     // QK i done, PV i - 1 in flight
      fence_regs<kBN / 2>(sacc);
      softmax(i, corr);
      wgmma_wait<0>();                     // PV i - 1 done: P and O free
      fence_regs<D / 2>(o);
      release(i - 1);
      rescale(corr);
      pack_p();
    }
    issue_pv(i_hi - 1);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    release(i_hi - 1);
  }
  for (int i = i_hi; i < n_tiles; ++i) skip(i);

  // out (B, Sq, Hq, D) contiguous: o[4 j + e] is row row[e >> 1], column
  // 8 j + 2 t + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // the rows' log-sum-exp in log2 units, m scale log2 e + log2 l, for the
  // backward: every row of the block, those past Sq too (lse_stride covers
  // them), so the backward reads no unwritten row
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[(static_cast<size_t>(b) * Hq + h) * lse_stride + row[r]] =
          l[r] > 0.f ? m[r] * scale_log2 + __log2f(l[r]) : kNoKey;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        out + ((static_cast<size_t>(b) * Sq + row[r]) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                   Strides qs, Strides ks, Strides vs, int causal, int window,
                   float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::kBytes);
  if (attr != cudaSuccess) return attr;
  constexpr int kBN = Smem<D>::kBN;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, B, Sq, Hq, D, qs.b, qs.s, qs.h, kBM) ||
      !make_map(&k_map, k, B, Sk, Hkv, D, ks.b, ks.s, ks.h, kBN) ||
      !make_map(&v_map, v, B, Sk, Hkv, D, vs.b, vs.s, vs.h, kBN))
    return cudaErrorInvalidValue;
  const int blocks = (Sq + kBM - 1) / kBM;
  const dim3 grid(B * Hq, blocks);
  flash_attention_tc_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse,
      blocks * kBM, Sq, Sk, Hq, Hkv, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D) through their (batch, seq,
// head) strides in elements; out contiguous (B, Sq, Hq, D).  window <= 0:
// no window.  route 1: the tensor cores, which must be bf16 at D 64, 128 or
// 256; route 0: the CUDA cores, everything else.  lse: null, or (route 1
// only) a float32 (B, Hq, ceil(Sq / 128) * 128) buffer that receives each
// row's log-sum-exp in log2 units for the backward.  Returns the launch's
// cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int Sq, int Sk, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, int dtype, int route, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq > 65535 ||
      Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const bool tensor_cores =
      dtype == kBFloat16 && (D == 64 || D == 128 || D == 256);
  if (route != static_cast<int>(tensor_cores)) return cudaErrorInvalidValue;
  if (lse != nullptr && !tensor_cores) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (tensor_cores) {
    if (D == 256)
      return tc::launch<256>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, qs, ks, vs,
                             causal, window, scale, s);
    if (D == 128)
      return tc::launch<128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, qs, ks, vs,
                             causal, window, scale, s);
    return tc::launch<64>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, qs, ks, vs,
                          causal, window, scale, s);
  }
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, qs, ks, vs,
                           causal, window, scale, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, qs, ks,
                                   vs, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
