// Shared helpers of the port's CUDA kernels: dtype codes, conversions to and
// from float32, 16-byte vector unpacking, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// dtype codes passed from Python (kernels/*.py)
enum DtypeCode { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);   // exact: int8 codes of quantized pages
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);   // round to nearest even, as astype does
}

// elements of T in one 16-byte vector
template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

// Unpack one 16-byte vector of T into N floats.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec16<T>::N; ++j) out[j] = to_f32<T>(e[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// -- asynchronous copies and tensor-core products (sm_80 and later) ---------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip; src_bytes 0
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats -> one register of two bf16 (lo in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- TF32 tensor-core products, split for float32 accuracy --------------------

// float32 -> TF32 bit pattern (10 mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: about 22 significant bits together (x - hi is
// exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 accumulate.
// Fragments (g = lane / 4, c = lane % 4): a0 (g, c), a1 (g + 8, c),
// a2 (g, c + 4), a3 (g + 8, c + 4); b0 (k c, n g), b1 (k c + 4, n g);
// d0, d1 (g, 2c + 0/1), d2, d3 (g + 8, 2c + 0/1)
__device__ __forceinline__ void mma_tf32_1688(float* d, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with both operands split (3xTF32): lo.hi + hi.lo + hi.hi, the
// small products first; lo.lo (about 2^-22 of a b) is dropped
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo) {
  mma_tf32_1688(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32_1688(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32_1688(d, a_hi, b_hi[0], b_hi[1]);
}

// -- the chunk passes of the scans' tensor-core routes ---------------------

namespace {

constexpr int kPassThreads = 256;
constexpr int kPassGroup = 4;    // chunks whose loads are in flight at once

// The chunks of a (batch, head) in order, one thread a state element of a
// 64 x 64 state: slot i of the workspace holds a chunk's own contribution x
// on entry, and on exit the value s had when the walk reached it, s <- dec
// s + x from s = init (null: zeros).  The walk goes up the slots; slot i
// holds chunk i (kReverse false: s is the state entering the chunk) or
// chunk nc - 1 - i (kReverse true: the chunks walked down, s the gradient
// that reaches the chunk's last state from later steps, ending as the
// initial state's), so that both walks read memory upward (walking down
// the addresses was the slower at the training shapes on an H100).  The
// last s goes to out (null: not wanted; it may alias init: each element is read
// before it is written).  dec holds one value a chunk and state row
// (kRowDecay: B4) or a chunk (B5), by chunk.  No reduction: bound by
// bytes, the workspace read and written once, the loads of kPassGroup
// chunks in flight before their updates.
template <bool kReverse, bool kRowDecay>
__global__ void __launch_bounds__(kPassThreads)
chunk_pass_kernel(float* ws, const float* __restrict__ dec, const float* init,
                  float* out, int heads, int nc) {
  constexpr int kDim = 64, E = kDim * kDim;
  constexpr int kDecStride = kRowDecay ? kDim : 1;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kPassThreads +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(heads) * E) return;
  const size_t hd = idx / E;
  const int e = static_cast<int>(idx - hd * E);
  float* p = ws + hd * nc * E + e;
  const float* d = kRowDecay ? dec + hd * nc * kDim + e / kDim : dec + hd * nc;
  auto dec_at = [&](int slot) {
    return d[static_cast<size_t>(kReverse ? nc - 1 - slot : slot) *
             kDecStride];
  };
  float s = init ? init[idx] : 0.f;
  int i = 0;
  for (; i + kPassGroup <= nc; i += kPassGroup) {
    float x[kPassGroup], f[kPassGroup];
#pragma unroll
    for (int j = 0; j < kPassGroup; ++j) {
      x[j] = p[static_cast<size_t>(i + j) * E];
      f[j] = dec_at(i + j);
    }
#pragma unroll
    for (int j = 0; j < kPassGroup; ++j) {
      p[static_cast<size_t>(i + j) * E] = s;
      s = fmaf(f[j], s, x[j]);
    }
  }
  for (; i < nc; ++i) {
    const float x = p[static_cast<size_t>(i) * E];
    const float f = dec_at(i);
    p[static_cast<size_t>(i) * E] = s;
    s = fmaf(f, s, x);
  }
  if (out) out[idx] = s;
}

}  // namespace
