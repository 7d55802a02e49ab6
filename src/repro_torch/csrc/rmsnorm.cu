// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel), which tiles rows into VMEM and pads the last row block.
//
// Bound on this card: bytes.  Each row is read once and written once (plus
// the d-wide scale, which stays in L1/L2), against about 4 flops an element,
// far under the ~295 flops a byte at which H100 stops being memory-bound.
// Design: one 256-thread block per row, 16-byte vector loads and stores where
// the row allows it (d a multiple of the vector width and 16-byte aligned
// pointers), a float32 sum of squares reduced across the warp and then the
// block, and the row re-read from L1 for the scaled write.  The grid has one
// block per row, so the ragged edge needs no padding and no mask.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

template <typename T, typename S, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  constexpr int N = Vec16<T>::N;
  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / N; i += kThreads) {
      float f[N];
      unpack16<T>(xv[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_f32<T>(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss) / d + eps);
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / N; i += kThreads) {
      float f[N];
      unpack16<T>(xv[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = f[j] * inv * to_f32<S>(scale[i * N + j]);
      yv[i] = pack16<T>(f);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      yr[i] = from_f32<T>(to_f32<T>(xr[i]) * inv * to_f32<S>(scale[i]));
  }
}

template <typename T, typename S>
void launch(const void* x, const void* scale, void* out, long long rows, int d,
            float eps, cudaStream_t stream) {
  const bool vec = d % Vec16<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(rows));
  if (vec)
    rmsnorm_kernel<T, S, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(out), d, eps);
  else
    rmsnorm_kernel<T, S, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(out), d, eps);
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              long long rows, int d, float eps, int x_dtype,
                              int scale_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return cudaErrorInvalidValue;
  if (x_dtype == kFloat32 && scale_dtype == kFloat32)
    launch<float, float>(x, scale, out, rows, d, eps, s);
  else if (x_dtype == kFloat32 && scale_dtype == kBFloat16)
    launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  else if (x_dtype == kBFloat16 && scale_dtype == kFloat32)
    launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  else if (x_dtype == kBFloat16 && scale_dtype == kBFloat16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
