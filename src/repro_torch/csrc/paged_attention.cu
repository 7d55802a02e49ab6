// Paged multi-query attention for Hopper: W queries per sequence attend,
// through a page table, to a KV prefix stored in fixed-size pages.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention_mq (_paged_mq_kernel), whose grid (B, Hkv, pages) walks
// pages in order on one core and carries the online-softmax state in VMEM
// scratch from one grid step to the next.  With int8 pages (the TPU
// kernel's k_scale/v_scale variant) every cached row of every KV head
// carries one float32 scale.
//
// Semantics kept from the TPU kernel: GQA rows are stacked head-major
// (row r = w * G + g serves window position w and query head h * G + g);
// row r may read KV positions < lengths[b] + w; the softmax is in float32;
// masked probabilities are zeroed explicitly (a row can be fully masked in
// a range another row of the block needs); the normaliser is clamped at
// 1e-30, so a row that sees no key (a dead slot, length 0) is written as
// zeros; a trash page past a row's limit is never read.
//
// Bound on this card: bytes.  Decode reads every cached K/V byte once for a
// handful of query rows (about 2 * G flops a KV element), and the chunked
// prefill window reads the same pages for W * G rows; both are far under
// the ~295 flops a byte at which H100 becomes compute-bound.  At the
// serving shapes the bytes are few (qwen2-7b decode, 4 slots of ~300 keys:
// 2.5 MB, 0.7 us at 3.35 TB/s), so what a call costs is latency: the
// launch, one round trip to device memory, and how many SMs share it.
//
// Design (flash-decoding on mma.sync):
// * Split over the keys.  The grid is (B * Hkv, ceil(W * G / 16),
//   n_split): a block owns 16 query rows of one (sequence, KV head) and a
//   fixed range of kSplitKeys = 64 key positions.  n_split =
//   ceil(P * page_size / 64) comes from shapes only (the wrapper never
//   reads the lengths, so a CUDA graph can hold the call).  64 and not 128:
//   at qwen2-7b's decode (4 slots x 4 KV heads, a 512-key table) 64 gives
//   128 blocks, one wave on 132 SMs, where one ordered walk per (slot,
//   head) had 16; a block's range is then a single tile, so there is no
//   loop to pipeline.  A block whose range starts past its tile's deepest
//   limit writes an empty partial (l = 0) and returns.
// * A block stages its tile in the storage type (bf16 or float32 pages, or
//   int8 codes with each row's float32 scale) with cp.async 16-byte copies,
//   one page lookup a thread: q, K and the int8 scales in the first group,
//   V in the second, so the scores are computed while V's copies are still
//   in flight.
// * bf16 q: QK^T and PV on mma.sync.m16n8k16 (bf16 in, float32
//   accumulate).  The block's 16 rows are the mma M (7 of 16 live at
//   decode, G 7: wgmma's M of 64 would leave 57 idle); each warp owns 16 of
//   the 64 keys, takes its own softmax over them, and the four warps'
//   (m, l, acc) merge in shared memory.  int8 codes enter the B fragment
//   as bf16, which holds them exactly; the K scale multiplies the float32
//   scores of its key and the V scale folds into that key's probability,
//   so no dequantized value is rounded.  The probabilities enter PV as a
//   bf16 pair (hi + lo, lo the rounding rest of hi): one bf16 rounding of
//   p costs up to 2^-9 of an output, where the int8 limit of 4e-3 leaves
//   no room; the pair costs a second mma on a latency-bound kernel.
// * float32 q: CUDA-core FMAs in the same grid (TF32 would break the 2e-4
//   float32 limit): a warp owns 4 rows, a lane 2 of the 64 keys for the
//   scores and D / 32 output columns for PV.
// * Each block writes a float32 partial (m, l, acc[16][D]) to scratch the
//   wrapper allocates; a combine kernel of this file merges a row's
//   partials (M = max m_s over the splits with l_s > 0, out = sum
//   e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-30)).  With n_split 1
//   the block writes out itself and no combine is launched, so a call is
//   one launch, or two when it is split.  The combine is a programmatic
//   dependent launch: it is scheduled while the split kernel's last blocks
//   run and waits for them on the device (griddepcontrol), which takes its
//   launch latency off the call.
//
// ptxas (sm_90a, D 97-128): the bf16-q split kernel 90 registers with
// bf16 pages and 94 with int8 pages, no spills; float32 q 67 (float
// pages) and 72 with 8 bytes of spill (int8 pages); the combine 32.
// Dynamic shared memory at D 128: 39,168 bytes (bf16 q and pages), 56,576
// (bf16 q, int8 pages), 75,776 / 27,136 (float32 q).  chip_smoke.py
// prints the registers and spills of every instantiation.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                 // query rows a block (the mma M)
constexpr int kSplitKeys = 64;            // key positions a block
constexpr int kMaxCols = 8;               // D <= 256: kCols = ceil(D / 32)
constexpr float kNegInf = -1e30f;

// Shared-memory layout of one block.  Row strides are padded so rows stay
// 16-byte aligned (cp.async) and lanes reading neighbouring rows fall in
// different banks.
template <typename T, typename KV>
struct Layout {
  static constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  // the mma's k extent over D
  __host__ __device__ static int dk(int D) { return (D + 15) / 16 * 16; }
  __host__ __device__ static int q_stride(int D) {       // elements of T
    return kTC ? dk(D) + 8 : D;
  }
  __host__ __device__ static int kv_stride(int D) {      // elements of KV
    return kQuant ? dk(D) + 16 : (kTC ? dk(D) + 8 : D + 4);
  }
  __host__ __device__ static size_t q_bytes(int D) {
    return sizeof(T) * kRows * q_stride(D);
  }
  __host__ __device__ static size_t kv_bytes(int D) {    // one of K, V
    return sizeof(KV) * kSplitKeys * kv_stride(D);
  }
  __host__ __device__ static size_t scale_bytes() {      // K and V scales
    return kQuant ? 2 * sizeof(float) * kSplitKeys : 0;
  }
  // the four warps' partials of the tensor-core route.  With bf16 pages
  // they go over the K/V tiles, which are as large, once every warp is
  // done with them: 39 instead of 72 KB a block at D 128 (on an H100 at
  // qwen2-7b's prefill chunk: 0.0307 against 0.0323 ms).  int8 tiles are
  // half as large, and there the sync it needs cost more than it saved
  // (0.0294 against 0.0268 ms), so they keep their own.
  static constexpr bool kOverTiles = kTC && !kQuant;
  __host__ __device__ static size_t combine_bytes(int D) {
    return kTC ? sizeof(float) * kWarps * kRows * (D + 2) : 0;
  }
  __host__ __device__ static size_t combine_offset(int D) {
    return q_bytes(D) + (kOverTiles ? 0 : 2 * kv_bytes(D) + scale_bytes());
  }
  __host__ __device__ static size_t bytes(int D) {
    const size_t tiles = q_bytes(D) + 2 * kv_bytes(D) + scale_bytes();
    const size_t comb = combine_offset(D) + combine_bytes(D);
    return tiles > comb ? tiles : comb;
  }
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one page element as the mma's bf16 (int8 codes are exact in bf16)
__device__ __forceinline__ float kv_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float kv_value(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float kv_value(float v) { return v; }

// two neighbouring K elements (d, d + 1) as one bf16x2 B register
__device__ __forceinline__ uint32_t k_pair(const __nv_bfloat16* p) {
  return ld32(p);
}
__device__ __forceinline__ uint32_t k_pair(const int8_t* p) {
  return pack_bf16x2(static_cast<float>(p[0]), static_cast<float>(p[1]));
}

// x0, x1 as a bf16x2 pair hi + lo, lo the rounding rest of hi
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(x0 - __low2float(h), x1 - __high2float(h));
}

// T: q's and out's type; KV: the pages' type (T, or int8_t with a float32
// scale a row and head in k_scale/v_scale, which are null otherwise);
// kCols = ceil(D / 32).
template <typename T, typename KV, int kCols>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const T* __restrict__ q,
                             const KV* __restrict__ k_pages,
                             const KV* __restrict__ v_pages,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             T* __restrict__ out, float* __restrict__ part_acc,
                             float* __restrict__ part_ml, int W, int Hq,
                             int Hkv, int D, int ps, int P, int n_split,
                             float scale) {
  using L = Layout<T, KV>;
  constexpr bool kTC = L::kTC, kQuant = L::kQuant;
  extern __shared__ __align__(16) unsigned char smem[];
  const int QS = L::q_stride(D), KS = L::kv_stride(D);
  T* q_s = reinterpret_cast<T*>(smem);                          // [16][QS]
  KV* k_s = reinterpret_cast<KV*>(smem + L::q_bytes(D));        // [64][KS]
  KV* v_s = k_s + kSplitKeys * KS;                              // [64][KS]
  float* ks_s = reinterpret_cast<float*>(v_s + kSplitKeys * KS);  // [64]
  float* vs_s = ks_s + kSplitKeys;                              // [64]
  float* comb = reinterpret_cast<float*>(smem + L::combine_offset(D));

  // the combine may be scheduled now: it waits for this whole grid anyway
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv, z = blockIdx.z;
  const int G = Hq / Hkv, n_rows = W * G;
  const int r0 = blockIdx.y * kRows;
  const int r_last = min(r0 + kRows, n_rows) - 1;
  const int k_lo = z * kSplitKeys;
  const int tid = threadIdx.x;
  const int j = tid % kSplitKeys;          // this thread's key in the tile
  const int part = tid / kSplitKeys;       // and which half of its vectors
  // the length and this key's page in one round trip to device memory
  const int length = lengths[b];
  const int pos = k_lo + j;
  const int page = pos < P * ps ? tables[static_cast<size_t>(b) * P + pos / ps]
                                : 0;
  // keys the deepest row of this tile may read, within the table
  const int limit_max = min(max(length + r_last / G, 0), P * ps);
  const size_t R0 = (static_cast<size_t>(b) * Hkv + h) * n_rows;  // row base

  // a row's merged result: out itself when unsplit, else this split's
  // partial
  auto emit = [&](int r, int d, float m, float l, float acc) {
    if (n_split == 1) {
      const int w = r / G, g = r % G;
      out[((static_cast<size_t>(b) * W + w) * Hq + h * G + g) * D + d] =
          from_f32<T>(acc / fmaxf(l, 1e-30f));
    } else {
      const size_t p = (R0 + r) * n_split + z;
      part_acc[p * D + d] = acc;
      if (d == 0) {
        part_ml[2 * p] = m;
        part_ml[2 * p + 1] = l;
      }
    }
  };

  if (k_lo >= limit_max) {   // no row of the tile sees a key of this range
    if (n_split == 1) {
      for (int i = tid; i < kRows * D; i += kThreads)
        if (r0 + i / D < n_rows) emit(r0 + i / D, i % D, kNegInf, 0.f, 0.f);
    } else if (tid < kRows && r0 + tid < n_rows) {
      const size_t p = (R0 + r0 + tid) * n_split + z;
      part_ml[2 * p] = kNegInf;
      part_ml[2 * p + 1] = 0.f;
    }
    return;
  }
  const int n_keys = min(kSplitKeys, limit_max - k_lo);  // the rest: zeros

  // -- staging: q and K (group 1), then V (group 2) --------------------------
  {
    constexpr int NQ = 16 / sizeof(T);
    const int qv = D / NQ;                 // 16-byte vectors in a q row
    for (int i = tid; i < kRows * qv; i += kThreads) {
      const int rr = i / qv, c = (i % qv) * NQ, r = r0 + rr;
      const T* src = q;
      int n = 0;
      if (r < n_rows) {
        src = q + ((static_cast<size_t>(b) * W + r / G) * Hq + h * G + r % G) *
                      D + c;
        n = 16;
      }
      cp_async16(q_s + rr * QS + c, src, n);
    }
    if (kTC && D % 16) {   // the mma's last k step reads 8 pad columns
      for (int i = tid; i < kRows + kSplitKeys; i += kThreads) {
        void* pad = i < kRows ? static_cast<void*>(q_s + i * QS + D)
                              : static_cast<void*>(k_s + (i - kRows) * KS + D);
        *reinterpret_cast<uint4*>(pad) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  constexpr int NK = 16 / sizeof(KV);
  const int kv_vecs = D / NK;              // 16-byte vectors in a K/V row
  const bool live = j < n_keys;            // (page row, head) of key j
  const size_t row = live ? (static_cast<size_t>(page) * ps + pos % ps) * Hkv + h
                          : 0;
  for (int c = part; c < kv_vecs; c += kThreads / kSplitKeys)
    cp_async16(k_s + j * KS + c * NK, live ? k_pages + row * D + c * NK
                                           : k_pages, live ? 16 : 0);
  if (kQuant && part == 0) {   // both scales: the V scale folds into p
    cp_async4(ks_s + j, live ? k_scale + row : k_scale, live ? 4 : 0);
    cp_async4(vs_s + j, live ? v_scale + row : v_scale, live ? 4 : 0);
  }
  cp_async_commit();
  for (int c = part; c < kv_vecs; c += kThreads / kSplitKeys)
    cp_async16(v_s + j * KS + c * NK, live ? v_pages + row * D + c * NK
                                           : v_pages, live ? 16 : 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                         // q and K landed

  const int warp = tid >> 5, lane = tid & 31;
  if constexpr (kTC) {
    // ---- bf16 q: the warp's 16 keys on mma.sync -----------------------------
    const int g = lane >> 2, t = lane & 3;
    const int kb = warp * 16;              // the warp's first key in the tile
    const int ra = r0 + g, rb = ra + 8;
    const int lim[2] = {ra < n_rows ? length + ra / G : 0,
                        rb < n_rows ? length + rb / G : 0};
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 2 * kCols; ++kk) {
      if (16 * kk >= D) break;
      const T* qr = q_s + g * QS + 16 * kk + 2 * t;
      const uint32_t a[4] = {ld32(qr), ld32(qr + 8 * QS), ld32(qr + 8),
                             ld32(qr + 8 * QS + 8)};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const KV* kr = k_s + (kb + 8 * nt + g) * KS + 16 * kk + 2 * t;
        mma_bf16_16816(s[nt], a, k_pair(kr), k_pair(kr + 8));
      }
    }
    // s[nt][e]: row e < 2 ? ra : rb, key kb + 8 nt + 2 t + (e & 1)
    float mx[2] = {kNegInf, kNegInf};
    unsigned ok = 0;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + 8 * nt + 2 * t + (e & 1);
        float v = s[nt][e] * scale;
        if constexpr (kQuant) v *= ks_s[key];
        s[nt][e] = v;
        if (k_lo + key < lim[e >> 1]) {
          ok |= 1u << (4 * nt + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked keys are zeroed explicitly, whatever the row's max is
        p[nt][e] = (ok >> (4 * nt + e)) & 1u ? expf(s[nt][e] - mx[e >> 1])
                                             : 0.f;
        l[e >> 1] += p[nt][e];
        if constexpr (kQuant) p[nt][e] *= vs_s[kb + 8 * nt + 2 * t + (e & 1)];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    // A fragment of P (16 rows x the warp's 16 keys) as hi + lo
    uint32_t ah[4], al[4];
    split_bf16x2(p[0][0], p[0][1], ah[0], al[0]);
    split_bf16x2(p[0][2], p[0][3], ah[1], al[1]);
    split_bf16x2(p[1][0], p[1][1], ah[2], al[2]);
    split_bf16x2(p[1][2], p[1][3], ah[3], al[3]);

    cp_async_wait<0>();
    __syncthreads();                       // V landed
    float acc[4 * kCols][4] = {};
#pragma unroll
    for (int nd = 0; nd < 4 * kCols; ++nd) {
      if (8 * nd >= D) break;
      const KV* vc = v_s + (kb + 2 * t) * KS + 8 * nd + g;
      const uint32_t b0 = pack_bf16x2(kv_value(vc[0]), kv_value(vc[KS]));
      const uint32_t b1 = pack_bf16x2(kv_value(vc[8 * KS]),
                                      kv_value(vc[9 * KS]));
      mma_bf16_16816(acc[nd], ah, b0, b1);
      mma_bf16_16816(acc[nd], al, b0, b1);
    }

    // the four warps' partials merge in shared memory
    if constexpr (L::kOverTiles) __syncthreads();   // K/V tiles all read
    float* c_acc = comb;                                // [4][16][D]
    float* c_m = comb + kWarps * kRows * D;             // [4][16]
    float* c_l = c_m + kWarps * kRows;                  // [4][16]
#pragma unroll
    for (int nd = 0; nd < 4 * kCols; ++nd) {
      if (8 * nd >= D) break;
      float* ca = c_acc + (warp * kRows + g) * D + 8 * nd + 2 * t;
      ca[0] = acc[nd][0];
      ca[1] = acc[nd][1];
      ca[8 * D] = acc[nd][2];
      ca[8 * D + 1] = acc[nd][3];
    }
    if (t == 0) {
      c_m[warp * kRows + g] = mx[0];
      c_m[warp * kRows + g + 8] = mx[1];
      c_l[warp * kRows + g] = l[0];
      c_l[warp * kRows + g + 8] = l[1];
    }
    __syncthreads();
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int rr = i / D, d = i % D;
      if (r0 + rr >= n_rows) continue;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, c_m[w * kRows + rr]);
      float Lsum = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(c_m[w * kRows + rr] - M);
        Lsum += e * c_l[w * kRows + rr];
        A += e * c_acc[(w * kRows + rr) * D + d];
      }
      emit(r0 + rr, d, M, Lsum, A);
    }
  } else {
    // ---- float32 q: CUDA-core FMAs, a warp's 4 rows over all 64 keys --------
    constexpr int kRW = kRows / kWarps;
    const int w_row0 = warp * kRW;
    int lim[kRW];
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const int r = r0 + w_row0 + i;
      lim[i] = r < n_rows ? length + r / G : 0;
    }
    float s[kRW][2] = {};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int key = lane + 32 * jj;
      const KV* kr = k_s + key * KS;
      const float ksc = kQuant ? ks_s[key] : 1.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kd = kv_value(kr[d]);
        if constexpr (kQuant) kd *= ksc;   // the plain version's dequant
#pragma unroll
        for (int i = 0; i < kRW; ++i)
          s[i][jj] += to_f32<T>(q_s[(w_row0 + i) * QS + d]) * kd;
      }
    }
    float m[kRW], l[kRW], p[kRW][2];
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        s[i][jj] *= scale;
        if (k_lo + lane + 32 * jj < lim[i]) mx = fmaxf(mx, s[i][jj]);
      }
      m[i] = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        p[i][jj] = k_lo + lane + 32 * jj < lim[i] ? expf(s[i][jj] - m[i]) : 0.f;
        sum += p[i][jj];
      }
      l[i] = warp_sum(sum);
    }
    cp_async_wait<0>();
    __syncthreads();                       // V landed
    float acc[kRW][kCols] = {};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll 4
      for (int jl = 0; jl < 32; ++jl) {
        const int jk = 32 * jj + jl;
        const float vsc = kQuant ? vs_s[jk] : 1.f;
        float pj[kRW];
#pragma unroll
        for (int i = 0; i < kRW; ++i)
          pj[i] = __shfl_sync(0xffffffffu, p[i][jj], jl);
        const KV* vr = v_s + jk * KS;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = 32 * c + lane;
          float vd = d < D ? kv_value(vr[d]) : 0.f;
          if constexpr (kQuant) vd *= vsc;
#pragma unroll
          for (int i = 0; i < kRW; ++i) acc[i][c] += pj[i] * vd;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const int r = r0 + w_row0 + i;
      if (r >= n_rows) continue;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = 32 * c + lane;
        if (d < D) emit(r, d, m[i], l[i], acc[i][c]);
      }
    }
  }
}

// out row R = (b * Hkv + h) * W * G + r from its n_split partials
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               T* __restrict__ out, int W, int Hq, int Hkv,
                               int D, int n_split) {
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = Hq / Hkv, n_rows = W * G;
  const size_t R = blockIdx.x;
  const int r = static_cast<int>(R % n_rows);
  const int bh = static_cast<int>(R / n_rows), h = bh % Hkv, b = bh / Hkv;
  const float* ml = part_ml + R * n_split * 2;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) M = fmaxf(M, ml[2 * s]);
  T* o = out + ((static_cast<size_t>(b) * W + r / G) * Hq + h * G + r % G) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float Lsum = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float l = ml[2 * s + 1];
      if (l > 0.f) {          // an empty split's acc is never written
        const float e = expf(ml[2 * s] - M);
        Lsum += e * l;
        A += e * part_acc[(R * n_split + s) * D + d];
      }
    }
    o[d] = from_f32<T>(A / fmaxf(Lsum, 1e-30f));
  }
}

template <typename T, typename KV, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* lengths, void* out,
                   float* part_acc, float* part_ml, int B, int W, int Hq,
                   int Hkv, int D, int ps, int P, int n_split, float scale,
                   cudaStream_t stream) {
  using L = Layout<T, KV>;
  auto kernel = paged_attention_split_kernel<T, KV, kCols>;
  // the largest D of the instantiation; set once (a function-local static
  // is initialised once, thread-safely), so a launch inside a CUDA-graph
  // capture makes no attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes(32 * kCols)));
  if (attr != cudaSuccess) return attr;
  const int n_rows = W * (Hq / Hkv);
  const dim3 grid(B * Hkv, (n_rows + kRows - 1) / kRows, n_split);
  kernel<<<grid, kThreads, L::bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, tables, lengths,
      static_cast<T*>(out), part_acc, part_ml, W, Hq, Hkv, D, ps, P, n_split,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  // the combine launches while the split kernel's last blocks run
  // (programmatic dependent launch) and waits for it on the device
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * n_rows);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_attention_combine_kernel<T>,
                            static_cast<const float*>(part_acc),
                            static_cast<const float*>(part_ml),
                            static_cast<T*>(out), W, Hq, Hkv, D, n_split);
}

// kCols = ceil(D / 32) as a compile-time constant, so the column loops
// unroll without dead iterations.
template <typename T, typename KV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* tables, const int* lengths, void* out,
                     float* part_acc, float* part_ml, int B, int W, int Hq,
                     int Hkv, int D, int ps, int P, int n_split, float scale,
                     cudaStream_t stream) {
#define REPRO_PA_CASE(C)                                                      \
  case C:                                                                     \
    return launch<T, KV, C>(q, k, v, k_scale, v_scale, tables, lengths, out, \
                            part_acc, part_ml, B, W, Hq, Hkv, D, ps, P,       \
                            n_split, scale, stream);
  switch ((D + 31) / 32) {
    REPRO_PA_CASE(1) REPRO_PA_CASE(2) REPRO_PA_CASE(3) REPRO_PA_CASE(4)
    REPRO_PA_CASE(5) REPRO_PA_CASE(6) REPRO_PA_CASE(7) REPRO_PA_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PA_CASE
}

}  // namespace

// k_scale/v_scale: null for float pages (kv_dtype == dtype); for int8 pages
// (kv_dtype == kInt8, D a multiple of 16) the (N, page_size, Hkv) float32
// scales.  n_split must be ceil(P * page_size / 64); above 1, part_acc
// (B * W * Hq * n_split * D floats) and part_ml (B * W * Hq * n_split * 2)
// are the partials' scratch, and the call is two launches.
extern "C" int paged_attention_mq_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* part_acc, void* part_ml, int B,
    int W, int Hq, int Hkv, int D, int ps, int P, int n_split, float scale,
    int dtype, int kv_dtype, void* stream) {
  if (B <= 0 || W <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D % 8 != 0 ||
      D > 32 * kMaxCols || ps <= 0 || P <= 0 ||
      static_cast<long long>(B) * Hkv > 0x7fffffffLL ||
      (W * (Hq / Hkv) + kRows - 1) / kRows > 65535 ||
      n_split != (P * ps + kSplitKeys - 1) / kSplitKeys || n_split > 65535 ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kInt8;
  if (quant != (k_scale != nullptr) || quant != (v_scale != nullptr) ||
      (quant && D % Vec16<int8_t>::N != 0) || (!quant && kv_dtype != dtype))
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return quant ? dispatch<float, int8_t>(q, k_pages, v_pages, ks, vs, tb, ln,
                                           out, pa, pm, B, W, Hq, Hkv, D, ps,
                                           P, n_split, scale, s)
                 : dispatch<float, float>(q, k_pages, v_pages, ks, vs, tb, ln,
                                          out, pa, pm, B, W, Hq, Hkv, D, ps, P,
                                          n_split, scale, s);
  if (dtype == kBFloat16)
    return quant ? dispatch<__nv_bfloat16, int8_t>(
                       q, k_pages, v_pages, ks, vs, tb, ln, out, pa, pm, B, W,
                       Hq, Hkv, D, ps, P, n_split, scale, s)
                 : dispatch<__nv_bfloat16, __nv_bfloat16>(
                       q, k_pages, v_pages, ks, vs, tb, ln, out, pa, pm, B, W,
                       Hq, Hkv, D, ps, P, n_split, scale, s);
  return cudaErrorInvalidValue;
}
