// Paged multi-query attention for Hopper: W queries per sequence attend,
// through a page table, to a KV prefix stored in fixed-size pages.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention_mq (_paged_mq_kernel), whose grid (B, Hkv, pages) walks
// pages in order on one core and carries the online-softmax state in VMEM
// scratch from one grid step to the next.
//
// With int8 pages (the TPU kernel's k_scale/v_scale variant) every cached
// row of every KV head carries one float32 scale; the TPU kernel multiplies
// its VMEM page tile by them right after the DMA, and this one does the same
// where it stages a tile in shared memory: a lane loads 16 codes as one
// 16-byte vector, converts them and multiplies by the row's scale before
// writing the float32 tile.  The inner loops are the float pages' own, and
// full-precision K/V never exists in device memory.
//
// Semantics kept from the TPU kernel: GQA rows are stacked head-major
// (row r = w * G + g serves window position w and query head h * G + g);
// row r may read KV positions < lengths[b] + w; the softmax is online in
// float32; masked probabilities are zeroed explicitly (a row can be fully
// masked on a tile another row of the block needs); the normaliser is
// clamped at 1e-30, so a row that sees no key (a dead slot, length 0) is
// written as zeros.
//
// Bound on this card: bytes.  Decode reads every cached K/V byte once for a
// handful of query rows (about 2 * G flops a KV element), and the chunked
// prefill window reads the same pages for W * G rows; both are far under
// the ~295 flops a byte at which H100 becomes compute-bound.  int8 pages
// halve the bytes of bf16 ones (plus 4 B of scale a row and head).
//
// Design, a first simple one (no wgmma, no TMA):
// * Grid (B, Hkv, ceil(W*G / 16)): each block owns a tile of 16 query rows
//   of one (sequence, KV head).  A whole-window tile does not fit: the TPU's
//   (W*G, D) float32 accumulator is 448 x 128 x 4 = 229 KB at qwen2-7b's
//   prefill chunk, above Hopper's 227 KB of shared memory a block.
// * A loop inside the block replaces the TPU's sequential page axis.  It
//   walks key positions in tiles of 32, looking each position's page up in
//   the block's own row of the page table, and stops at the deepest row of
//   ITS tile (the TPU kernel stops at the window's last row), so the work is
//   O(length + W), not O(table capacity).
// * K and V tiles (32 x D) are staged in shared memory as float32 with
//   16-byte vector loads (the page type KV is float, bf16 or int8,
//   dequantized on the way in); K rows are padded by one float so that lane j
//   reading key j's row is free of bank conflicts.
// * 4 warps x 4 rows.  For scores, lane j computes key j against all four
//   of the warp's rows at once (four independent sums, each K element read
//   once); max and sum are interleaved warp reductions; P @ V broadcasts p
//   by shuffle while each lane owns D/32 accumulator columns in registers
//   and reads each V element once for the four rows.  The decode grid is
//   small (B * Hkv blocks), so these independent sums, not occupancy, are
//   what hides shared-memory latency.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // key positions per tile (= lanes)
constexpr int kMaxCols = 8;                   // D <= 256: at most 8 columns a lane
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kRows) * D +
                          static_cast<size_t>(kKeys) * (D + 1) +
                          static_cast<size_t>(kKeys) * D);
}

// T: q's and out's type; KV: the pages' type (T, or int8_t with a float32
// scale a row and head in k_scale/v_scale, which are null otherwise).
template <typename T, typename KV, int kCols>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_mq_kernel(const T* __restrict__ q,
                          const KV* __restrict__ k_pages,
                          const KV* __restrict__ v_pages,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ lengths, T* __restrict__ out,
                          int W, int Hq, int Hkv, int D, int ps, int P,
                          float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kRows][D], pre-scaled
  float* k_s = q_s + kRows * D;               // [kKeys][D + 1]
  float* v_s = k_s + kKeys * (D + 1);         // [kKeys][D]

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hkv;
  const int n_rows = W * G;
  const int r0 = blockIdx.z * kRows;
  const int r_last = min(r0 + kRows, n_rows) - 1;
  const int length = lengths[b];
  const int* table = tables + static_cast<size_t>(b) * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int N = Vec16<T>::N;
  const int vecs = D / N;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int NK = Vec16<KV>::N;
  const int kv_vecs = D / NK;

  // keys the deepest row of this tile may read, within the table's capacity
  const int limit_max = min(max(length + r_last / G, 0), P * ps);

  for (int i = threadIdx.x; i < kRows * vecs; i += blockDim.x) {
    const int rr = i / vecs, c = (i % vecs) * N, r = r0 + rr;
    float f[N];
    if (r < n_rows) {
      const int w = r / G, g = r % G;
      const size_t off = ((static_cast<size_t>(b) * W + w) * Hq + h * G + g) * D + c;
      unpack16<T>(*reinterpret_cast<const uint4*>(q + off), f);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) q_s[rr * D + c + j] = f[j] * scale;
  }

  // this warp's rows (pad rows have limit 0: every key masked)
  const int w_row0 = warp * kRowsPerWarp;
  const bool active = r0 + w_row0 < n_rows;   // warp-uniform
  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + w_row0 + i;
    limit[i] = r < n_rows ? length + r / G : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const float* qw = q_s + w_row0 * D;

  for (int k0 = 0; k0 < limit_max; k0 += kKeys) {
    __syncthreads();  // q_s written / previous tile fully read
#pragma unroll 4
    for (int i = threadIdx.x; i < kKeys * kv_vecs; i += blockDim.x) {
      const int j = i / kv_vecs, c = (i % kv_vecs) * NK, pos = k0 + j;
      float fk[NK], fv[NK];
      if (pos < limit_max) {
        const size_t page = static_cast<size_t>(table[pos / ps]);
        const size_t row = (page * ps + pos % ps) * Hkv + h;
        const size_t off = row * D + c;
        unpack16<KV>(*reinterpret_cast<const uint4*>(k_pages + off), fk);
        unpack16<KV>(*reinterpret_cast<const uint4*>(v_pages + off), fv);
        if constexpr (kQuant) {   // the TPU kernel's in-VMEM dequant
          const float sk = k_scale[row], sv = v_scale[row];
#pragma unroll
          for (int e = 0; e < NK; ++e) {
            fk[e] *= sk;
            fv[e] *= sv;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < NK; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < NK; ++e) {
        k_s[j * (D + 1) + c + e] = fk[e];
        v_s[j * D + c + e] = fv[e];
      }
    }
    __syncthreads();
    if (!active) continue;

    // scores: lane j holds key k0 + j against the warp's rows, the rows'
    // dot products interleaved so each K element is read once
    const int pos = k0 + lane;
    const float* kr = k_s + lane * (D + 1);
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] += qw[i * D + d] * kd;
    }

    // online softmax, the rows' warp reductions interleaved
    float mx[kRowsPerWarp], p[kRowsPerWarp], sum[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) mx[i] = pos < limit[i] ? s[i] : kNegInf;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      // masked keys are zeroed explicitly: a row may be fully masked here
      p[i] = pos < limit[i] ? expf(s[i] - m_new) : 0.f;
      sum[i] = p[i];
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) l[i] += sum[i];

    // P @ V: p broadcast by shuffle, each V element read once for all rows
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pj[i] = __shfl_sync(0xffffffffu, p[i], j);
      const float* vr = v_s + j * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = c * 32 + lane;
        const float vd = d < D ? vr[d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) acc[i][c] += pj[i] * vd;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + w_row0 + i;
    if (r >= n_rows) continue;
    const int w = r / G, g = r % G;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * W + w) * Hq + h * G + g) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c * 32 + lane;
      if (d < D) o[d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, typename KV, int kCols>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* lengths, void* out, int B,
                   int W, int Hq, int Hkv, int D, int ps, int P, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = paged_attention_mq_kernel<T, KV, kCols>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, Hkv, (W * (Hq / Hkv) + kRows - 1) / kRows);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale, tables, lengths,
      static_cast<T*>(out), W, Hq, Hkv, D, ps, P, scale);
  return cudaGetLastError();
}

// The accumulator columns a lane owns (ceil(D / 32)) as a compile-time
// constant, so the column loops unroll without dead iterations.
template <typename T, typename KV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* tables, const int* lengths, void* out, int B,
                     int W, int Hq, int Hkv, int D, int ps, int P, float scale,
                     cudaStream_t stream) {
#define REPRO_PA_CASE(C)                                                      \
  case C:                                                                     \
    return launch<T, KV, C>(q, k, v, k_scale, v_scale, tables, lengths, out, \
                            B, W, Hq, Hkv, D, ps, P, scale, stream);
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
// scales.
extern "C" int paged_attention_mq_launch(const void* q, const void* k_pages,
                                         const void* v_pages,
                                         const void* k_scale,
                                         const void* v_scale,
                                         const void* tables,
                                         const void* lengths, void* out, int B,
                                         int W, int Hq, int Hkv, int D, int ps,
                                         int P, float scale, int dtype,
                                         int kv_dtype, void* stream) {
  if (B <= 0 || W <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D % 8 != 0 ||
      D > 32 * kMaxCols || ps <= 0 || P <= 0)
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kInt8;
  if (quant != (k_scale != nullptr) || quant != (v_scale != nullptr) ||
      (quant && D % Vec16<int8_t>::N != 0) || (!quant && kv_dtype != dtype))
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return quant ? dispatch<float, int8_t>(q, k_pages, v_pages, ks, vs, tb, ln,
                                           out, B, W, Hq, Hkv, D, ps, P,
                                           scale, s)
                 : dispatch<float, float>(q, k_pages, v_pages, ks, vs, tb, ln,
                                          out, B, W, Hq, Hkv, D, ps, P, scale,
                                          s);
  if (dtype == kBFloat16)
    return quant ? dispatch<__nv_bfloat16, int8_t>(q, k_pages, v_pages, ks, vs,
                                                   tb, ln, out, B, W, Hq, Hkv,
                                                   D, ps, P, scale, s)
                 : dispatch<__nv_bfloat16, __nv_bfloat16>(
                       q, k_pages, v_pages, ks, vs, tb, ln, out, B, W, Hq, Hkv,
                       D, ps, P, scale, s);
  return cudaErrorInvalidValue;
}
