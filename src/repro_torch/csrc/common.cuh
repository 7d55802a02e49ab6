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

// Pack N floats into one 16-byte vector of T.
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec16<T>::N; ++j) e[j] = from_f32<T>(in[j]);
  return raw;
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
