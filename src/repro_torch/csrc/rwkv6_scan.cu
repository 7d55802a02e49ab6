// RWKV-6 wkv recurrence for Hopper: for every (batch, head), with an f32
// K x V state S,
//     y_t = r_t . (S + (u o k_t) v_t^T),    S <- diag(w_t) S + k_t v_t^T,
// returning y (B, S, H, V) f32 and the final state (B, H, K, V) f32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_scan
// (_rwkv_kernel), which walks time as the inner grid axis with the state in
// VMEM scratch, in tiles of t_blk steps, and needs S % t_blk == 0.  Here the
// time loop runs inside one block and any S >= 0 works.
//
// Bound on this card, at the full-width prefill (B 1, S 1024, H 40,
// K = V 64): operations, barely.  A step and head needs 5 flops a state
// element (y += r_i S_iv; S_iv = w_i S_iv + k_i v_v) plus 2K + 2V for the
// bonus term, 0.85 GFLOP in all, 0.0127 ms at the 67 TFLOP/s float32
// CUDA-core peak; the bytes (bf16 r, k, v; f32 w, y and the state read and
// written) are about 38 MB, 0.0114 ms at 3.35 TB/s.  At the decode shape
// (B 4, S 1) it is the state's read and write, 5.2 MB, 0.0016 ms.
//
// Design (a simple first one): one block per (batch, head), V threads;
// thread v keeps the column S[:, v] in K registers (K a template
// parameter: 8, 16, 32 or 64).  kSteps time steps of r, k, w and v are
// staged in shared memory at once (converted to float32 there, so bf16
// r, k, v need no cast launch), one barrier pair per kSteps steps; the
// bonus term r_t . (u o k_t) is the same for every column, so kSteps
// threads compute it once per step while staging.  w is used as it is,
// multiplied in directly: no log and no exp, so decays down to e^-20 and
// below need no care.  The state is read once at the start and written
// once at the end; out_state may alias state0 (each thread reads its whole
// column before it writes it), which is how the decode step updates the
// slot state in place.  r, k, v, w and y are read and written in their
// (B, S, H, C) layout, with no transposes.
//
// This is latency-bound: 40 blocks of 2 warps at the prefill on 132 SMs,
// each walking 1024 dependent steps.  The chunked matmul form (wgmma over
// chunks of steps) and more blocks (splitting V or K across blocks and
// warps) are the ways to make it fast.
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
