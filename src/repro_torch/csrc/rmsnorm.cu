// RMSNorm for Hopper, fused with the elementwise op the served models run
// right before it: y = v * rsqrt(mean(v^2) + eps) * scale over each row, where
//
//   rmsnorm        v = x
//   add_rmsnorm    v = s = x + delta, rounded once to x's dtype; s is written
//                  too (the new residual stream) unless its pointer is null
//                  (a model's final norm, after which no op reads s)
//   gated_rmsnorm  v = T(T(y) * T(silu(z))), y float32, z and the result in
//                  T (Mamba-2's gated output norm, with the roundings of the
//                  unfused bf16 expression)
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel), which tiles rows into VMEM and pads the last row block.
//
// Bound on this card: bytes (about 4-8 flops an element against the ~295 a
// byte at which H100 stops being memory-bound), and at the decode shapes (4
// rows) the launch and one DRAM round trip.  So the design reads every input
// byte once and writes every output byte once, and saves the launches and the
// round trips of the separate add and gate:
//   - one block a row, every thread holding its 16-byte vectors of the row in
//     registers, packed as loaded (the pre-norm values rounded to x's dtype,
//     the scale): all loads are issued before the reduction, the scaled
//     write needs no second read, and a thread's few registers leave room
//     for many rows on an SM;
//   - one reduction step across warps (each warp's partial into shared
//     memory, one barrier, every thread sums the partials itself);
//   - many rows: blocks of a few warps, several rows in flight on each SM.
// A row whose d is not a multiple of the vector, whose pointers are not
// 16-byte aligned or which is too wide for the registers takes a scalar
// kernel that reads the row twice.  The route is picked from shapes and
// pointers only.  Tried and dropped on an H100 (PERF.md §6): holding the
// values unpacked as float32 (more registers, fewer rows in flight: 2-33%
// slower), reading scale after the reduction from L1, splitting a few-row
// launch's rows over clusters of blocks (both slower but for the gated
// norm at 4 rows), and programmatic dependent launches (no decode step
// faster).
#include "common.cuh"

namespace {

enum Variant { kPlain = 0, kAdd = 1, kGated = 2 };

constexpr int kMaxThreads = 512;     // the vector kernel's widest block
constexpr int kScalarThreads = 256;

struct Args {
  const void* a;       // x (plain, add) or y (gated, float32)
  const void* b;       // delta (add), z (gated), null (plain)
  const void* scale;
  void* s;             // add: x + delta, or null (not stored); null otherwise
  void* out;
  int d;
  float eps;
};

// The elements of U in one 32-bit word, to and from float32 (bf16: exact
// widening, round to nearest even back).
template <typename U> struct Word;
template <> struct Word<float> {
  static constexpr int kPer = 1;
  static __device__ __forceinline__ void get(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t put(const float* f) {
    return __float_as_uint(f[0]);
  }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int kPer = 2;
  static __device__ __forceinline__ void get(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t put(const float* f) {
    return pack_bf16x2(f[0], f[1]);
  }
};

// N elements of U, packed in 32-bit words as they lie in memory.
template <typename U, int N>
struct Packed {
  static constexpr int kWords = N / Word<U>::kPer;
  uint32_t w[kWords];
};

// Load N elements of U at p: whole 16-byte vectors, or one 8-byte one (an
// N of 4 two-byte elements).
template <typename U, int N>
__device__ __forceinline__ Packed<U, N> load_packed(const U* p) {
  Packed<U, N> r;
  constexpr int W = Packed<U, N>::kWords;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[c];
      r.w[4 * c] = q.x, r.w[4 * c + 1] = q.y;
      r.w[4 * c + 2] = q.z, r.w[4 * c + 3] = q.w;
    }
  } else {
    static_assert(W == 2, "load_packed: 8 or a multiple of 16 bytes");
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    r.w[0] = q.x, r.w[1] = q.y;
  }
  return r;
}

template <typename U, int N>
__device__ __forceinline__ void unpack(const Packed<U, N>& r, float* f) {
#pragma unroll
  for (int i = 0; i < Packed<U, N>::kWords; ++i)
    Word<U>::get(r.w[i], f + i * Word<U>::kPer);
}

// N floats rounded to T, packed
template <typename T, int N>
__device__ __forceinline__ Packed<T, N> pack(const float* f) {
  Packed<T, N> r;
#pragma unroll
  for (int i = 0; i < Packed<T, N>::kWords; ++i)
    r.w[i] = Word<T>::put(f + i * Word<T>::kPer);
  return r;
}

// store 16 bytes of T
template <typename T, int N>
__device__ __forceinline__ void store_packed(T* p, const Packed<T, N>& r) {
  static_assert(Packed<T, N>::kWords == 4, "store_packed: one 16-byte vector");
  *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// silu in float32 as PyTorch computes it (x / (1 + exp(-x))), then the
// product of the two T-rounded factors, rounded to T
template <typename T>
__device__ __forceinline__ float gate(float y, float z) {
  const float g = round_to<T>(z / (1.f + expf(-z)));
  return round_to<T>(round_to<T>(y) * g);
}

// The sum over the block in one step across warps: every thread returns it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kMaxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float t = 0.f;
  const int n = blockDim.x >> 5;
  for (int w = 0; w < n; ++w) t += part[w];
  return t;
}

// One block a row; thread t holds the row's vectors t, t + blockDim.x, ...
// (at most VPT of them) in registers between the sum and the write.
template <int V, typename T, typename S, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_vec_kernel(Args a) {
  constexpr int N = Vec16<T>::N;
  const int nvec = a.d / N;
  const size_t base = static_cast<size_t>(blockIdx.x) * a.d;
  const S* scale = static_cast<const S*>(a.scale);
  Packed<S, N> sc[VPT];
  Packed<T, N> v[VPT];      // the pre-norm values, rounded to T
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) sc[k] = load_packed<S, N>(scale + i * N);
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i >= nvec) continue;
    const size_t e = base + static_cast<size_t>(i) * N;
    if constexpr (V == kGated) {
      float y[N], z[N];
      unpack(load_packed<float, N>(static_cast<const float*>(a.a) + e), y);
      unpack(load_packed<T, N>(static_cast<const T*>(a.b) + e), z);
#pragma unroll
      for (int j = 0; j < N; ++j) z[j] = gate<T>(y[j], z[j]);
      v[k] = pack<T, N>(z);
    } else {
      v[k] = load_packed<T, N>(static_cast<const T*>(a.a) + e);
      if constexpr (V == kAdd) {
        float x[N], dl[N];
        unpack(v[k], x);
        unpack(load_packed<T, N>(static_cast<const T*>(a.b) + e), dl);
#pragma unroll
        for (int j = 0; j < N; ++j) x[j] += dl[j];
        v[k] = pack<T, N>(x);               // s: x + delta rounded once
      }
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i >= nvec) continue;
    if constexpr (V == kAdd)
      if (a.s)
        store_packed(static_cast<T*>(a.s) + base + static_cast<size_t>(i) * N,
                     v[k]);
    float f[N];
    unpack(v[k], f);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += f[j] * f[j];
  }
  const float inv = rsqrtf(block_sum(ss) / a.d + a.eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i >= nvec) continue;
    float f[N], g[N];
    unpack(v[k], f);
    unpack(sc[k], g);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = f[j] * inv * g[j];
    store_packed(static_cast<T*>(a.out) + base + static_cast<size_t>(i) * N,
                 pack<T, N>(f));
  }
}

// Element e of row base's pre-norm value; the add variant writes s there
// when it stores s.
template <int V, typename T>
__device__ __forceinline__ float pre_norm(const Args& a, size_t e) {
  if constexpr (V == kGated)
    return gate<T>(static_cast<const float*>(a.a)[e],
                   to_f32<T>(static_cast<const T*>(a.b)[e]));
  const float x = to_f32<T>(static_cast<const T*>(a.a)[e]);
  if constexpr (V == kAdd) {
    const T s = from_f32<T>(x + to_f32<T>(static_cast<const T*>(a.b)[e]));
    if (a.s) static_cast<T*>(a.s)[e] = s;
    return to_f32<T>(s);
  }
  return x;
}

// Any d and alignment: one block a row, the row read twice (the second
// read of a stored s is the thread's own write, else of x and delta or y and
// z, from L1/L2).
template <int V, typename T, typename S>
__global__ void __launch_bounds__(kScalarThreads)
rmsnorm_scalar_kernel(Args a) {
  const size_t base = static_cast<size_t>(blockIdx.x) * a.d;
  const S* scale = static_cast<const S*>(a.scale);
  float ss = 0.f;
  for (int j = threadIdx.x; j < a.d; j += blockDim.x) {
    const float f = pre_norm<V, T>(a, base + j);
    ss += f * f;
  }
  const float inv = rsqrtf(block_sum(ss) / a.d + a.eps);
  T* out = static_cast<T*>(a.out) + base;
  for (int j = threadIdx.x; j < a.d; j += blockDim.x) {
    float f;
    if (V == kAdd && a.s)
      f = to_f32<T>(static_cast<const T*>(a.s)[base + j]);
    else
      f = pre_norm<V, T>(a, base + j);
    out[j] = from_f32<T>(f * inv * to_f32<S>(scale[j]));
  }
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename K>
cudaError_t start(K kernel, const Args& a, long long rows, int threads,
                  cudaStream_t stream) {
  kernel<<<static_cast<unsigned>(rows), threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int V, typename T, typename S>
cudaError_t launch(const Args& a, long long rows, cudaStream_t stream) {
  constexpr int N = Vec16<T>::N;
  const int nvec = a.d / N;
  const bool vec =
      a.d % N == 0 && nvec <= 4 * kMaxThreads && aligned(a.a, 16) &&
      (V == kPlain || aligned(a.b, 16)) && (V != kAdd || aligned(a.s, 16)) &&
      aligned(a.out, 16) && aligned(a.scale, N * sizeof(S) >= 16 ? 16 : 8);
  if (!vec)
    return start(rmsnorm_scalar_kernel<V, T, S>, a, rows, kScalarThreads,
                 stream);
  // 2 vectors a thread up to d = 1024 vectors (8192 bf16), else 4; the
  // block rounded up to whole warps
  const int vpt = nvec <= 2 * kMaxThreads ? 2 : 4;
  const int threads = ((nvec + vpt - 1) / vpt + 31) / 32 * 32;
  if (vpt == 2)
    return start(rmsnorm_vec_kernel<V, T, S, 2>, a, rows, threads, stream);
  return start(rmsnorm_vec_kernel<V, T, S, 4>, a, rows, threads, stream);
}

template <int V>
cudaError_t dispatch(const Args& a, long long rows, int dtype, int scale_dtype,
                     cudaStream_t stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || a.d <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32 && scale_dtype == kFloat32)
    return launch<V, float, float>(a, rows, stream);
  if (dtype == kFloat32 && scale_dtype == kBFloat16)
    return launch<V, float, __nv_bfloat16>(a, rows, stream);
  if (dtype == kBFloat16 && scale_dtype == kFloat32)
    return launch<V, __nv_bfloat16, float>(a, rows, stream);
  if (dtype == kBFloat16 && scale_dtype == kBFloat16)
    return launch<V, __nv_bfloat16, __nv_bfloat16>(a, rows, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, and returns its
// cudaError_t (0: launched).  rows x d row-major, contiguous; dtype codes as
// in common.cuh.

extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              long long rows, int d, float eps, int x_dtype,
                              int scale_dtype, void* stream) {
  const Args a{x, nullptr, scale, nullptr, out, d, eps};
  return dispatch<kPlain>(a, rows, x_dtype, scale_dtype,
                          static_cast<cudaStream_t>(stream));
}

// s null: the sum is not stored, only the norm
extern "C" int add_rmsnorm_launch(const void* x, const void* delta,
                                  const void* scale, void* s, void* out,
                                  long long rows, int d, float eps,
                                  int x_dtype, int scale_dtype,
                                  void* stream) {
  const Args a{x, delta, scale, s, out, d, eps};
  return dispatch<kAdd>(a, rows, x_dtype, scale_dtype,
                        static_cast<cudaStream_t>(stream));
}

// y float32; z and out in z_dtype
extern "C" int gated_rmsnorm_launch(const void* y, const void* z,
                                    const void* scale, void* out,
                                    long long rows, int d, float eps,
                                    int z_dtype, int scale_dtype,
                                    void* stream) {
  const Args a{y, z, scale, nullptr, out, d, eps};
  return dispatch<kGated>(a, rows, z_dtype, scale_dtype,
                          static_cast<cudaStream_t>(stream));
}

namespace {

// -- backward ------------------------------------------------------------------
//
// The gradient of y = v * r * scale, r = rsqrt(mean(v^2) + eps), over each
// row v (the norm's input: x, or the fused add's sum s), from the output's
// gradient dy and, for the fused add, the sum's own gradient ds:
//
//   dv = r * (dy * scale - v * r^2 * mean(dy * scale * v)) + ds
//   dscale = sum over rows of dy * v * r
//
// all in float32 from T rows (bf16 or float32), dv rounded to T once.  For
// the fused add dv is the gradient of both addends.  Replaces no TPU kernel
// (the reference trains through jnp, whose XLA backward is not a Pallas
// kernel); it is B2's backward for training on the card.
//
// Bound on this card: bytes, as the forward (a few flops an element).  One
// warp a row: the row's two sums by shuffle, then dv, with no barrier.  The
// scale's gradient is a sum over every row, which blocks cannot share
// without atomics, so each block adds its rows' terms into a float32 row
// of its own in shared memory (a warp each, no two threads on one word,
// summed in a fixed order) and writes one partial row; a second kernel
// sums the partials column by column.  The grid and the rows of a warp
// depend on (rows, d) only, so the result is the same every run.  The row
// is read twice (the second read from L1/L2): a kernel that is right
// first; fusing the passes is later work (ROADMAP Queue B).

constexpr int kBwdMaxWarps = 8;
constexpr int kBwdSmem = 48 * 1024;     // a block's partial rows, no opt-in
constexpr long long kBwdMaxBlocks = 528;  // 4 blocks an SM of 132

int bwd_warps(int d) {
  const int w = kBwdSmem / (4 * d);
  return w < kBwdMaxWarps ? w : kBwdMaxWarps;
}

long long bwd_blocks(long long rows, int d) {
  const int w = bwd_warps(d);
  if (w < 1) return 0;
  const long long b = (rows + w - 1) / w;
  return b < kBwdMaxBlocks ? b : kBwdMaxBlocks;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kBwdMaxWarps * 32)
rmsnorm_bwd_kernel(const T* __restrict__ v, const T* __restrict__ dy,
                   const T* __restrict__ ds, const S* __restrict__ scale,
                   T* __restrict__ dv, float* __restrict__ part,
                   long long rows, int d, float eps) {
  extern __shared__ float acc[];        // [warps][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* mine = acc + static_cast<size_t>(warp) * d;
  for (int j = lane; j < d; j += 32) mine[j] = 0.f;
  for (long long row = static_cast<long long>(blockIdx.x) * nw + warp;
       row < rows; row += static_cast<long long>(gridDim.x) * nw) {
    const size_t base = static_cast<size_t>(row) * d;
    float ss = 0.f, dot = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float x = to_f32<T>(v[base + j]);
      ss += x * x;
      dot += to_f32<T>(dy[base + j]) * to_f32<S>(scale[j]) * x;
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float r = rsqrtf(ss / d + eps);
    const float c = r * r * dot / d;
    for (int j = lane; j < d; j += 32) {
      const float x = to_f32<T>(v[base + j]);
      const float g = to_f32<T>(dy[base + j]);
      float out = r * (g * to_f32<S>(scale[j]) - x * c);
      if (ds) out += to_f32<T>(ds[base + j]);
      dv[base + j] = from_f32<T>(out);
      mine[j] += g * x * r;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < nw; ++w) t += acc[static_cast<size_t>(w) * d + j];
    part[static_cast<size_t>(blockIdx.x) * d + j] = t;
  }
}

// dscale[j] = the blocks' partials of column j, summed in block order
template <typename S>
__global__ void rmsnorm_bwd_reduce_kernel(const float* __restrict__ part,
                                          S* __restrict__ dscale, int blocks,
                                          int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b) t += part[static_cast<size_t>(b) * d + j];
  dscale[j] = from_f32<S>(t);
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* v, const void* dy, const void* ds,
                       const void* scale, void* dv, void* part, void* dscale,
                       long long rows, int d, float eps, cudaStream_t stream) {
  const int w = bwd_warps(d);
  const long long blocks = bwd_blocks(rows, d);
  rmsnorm_bwd_kernel<T, S><<<static_cast<unsigned>(blocks), w * 32,
                             static_cast<size_t>(w) * d * sizeof(float),
                             stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(dy),
      static_cast<const T*>(ds), static_cast<const S*>(scale),
      static_cast<T*>(dv), static_cast<float*>(part), rows, d, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_reduce_kernel<S><<<(d + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<S*>(dscale),
      static_cast<int>(blocks), d);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the backward's first kernel for (rows, d): its float32
// partials of dscale take blocks x d floats of workspace.  0: d too wide.
extern "C" int rmsnorm_bwd_blocks(long long rows, int d) {
  return d > 0 && rows > 0 ? static_cast<int>(bwd_blocks(rows, d)) : 0;
}

// The norm's backward over rows x d: v the norm's input (x, or the fused
// add's sum), dy the output's gradient, ds the sum's gradient (null: the
// plain norm, or a sum no op read), all in x_dtype and contiguous; dv (in
// x_dtype) and dscale (in scale_dtype) written; part: float32 workspace of
// rmsnorm_bwd_blocks(rows, d) x d.
extern "C" int rmsnorm_bwd_launch(const void* v, const void* dy,
                                  const void* ds, const void* scale, void* dv,
                                  void* part, void* dscale, long long rows,
                                  int d, float eps, int x_dtype,
                                  int scale_dtype, void* stream) {
  if (rows <= 0 || d <= 0 || bwd_blocks(rows, d) == 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && scale_dtype == kFloat32)
    return launch_bwd<float, float>(v, dy, ds, scale, dv, part, dscale, rows,
                                    d, eps, s);
  if (x_dtype == kFloat32 && scale_dtype == kBFloat16)
    return launch_bwd<float, __nv_bfloat16>(v, dy, ds, scale, dv, part,
                                            dscale, rows, d, eps, s);
  if (x_dtype == kBFloat16 && scale_dtype == kFloat32)
    return launch_bwd<__nv_bfloat16, float>(v, dy, ds, scale, dv, part,
                                            dscale, rows, d, eps, s);
  if (x_dtype == kBFloat16 && scale_dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(v, dy, ds, scale, dv,
                                                    part, dscale, rows, d,
                                                    eps, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
