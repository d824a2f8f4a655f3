// GroupNorm moments, GroupNorm apply (+SiLU) and nearest 2x upsample for
// Hopper (sm_90a), bound to PyTorch through plain C launchers loaded with
// ctypes (instarevive_tpu_torch/ops/norm_kernels.py). All tensors are NHWC.
//
// Replaces the Pallas TPU kernels of instarevive_tpu/ops/norm_kernels.py:
// * `_stats_kernel` (reached through `_gn_silu_pallas`): per-strip partial
//   sums and sums of squares per channel. Here: `stats_kernel` plus
//   `fold_kernel`, which also does the fold to the per-(sample, channel)
//   affine a = gamma * rstd, b = beta - mean * a that the TPU wrapper left to
//   eight small XLA ops.
// * `_apply_kernel` (same entry): y = x * a + b with an optional SiLU, in
//   x's type. Here: `apply_kernel`.
// * `_upsample_kernel` (reached through `_upsample2x_pallas`): nearest 2x
//   upsample. Here: `upsample_kernel`.
//
// What bounds them on this card: all three do a handful of operations per
// byte, far below the H100's ridge, so device-memory bytes bound them. The
// design moves each byte once: x is read in its own type (bf16 or f32) with
// 16-byte accesses along C, never copied to f32 in memory; the moments are
// accumulated in f32 in registers, then per block in shared memory, and the
// per-block partials go to a small scratch array; the apply pass is one read
// and one write; the upsample one read and four writes.
//
// The TPU grid ran its row strips in order on one core. Here a sample is
// split over enough blocks to fill the 132 SMs even at batch 1 (a 1024x1024
// x128 sample has 134 M elements but only 32 groups), and the partials are
// combined by a second, tiny kernel (one block per sample and group) rather
// than by atomics, so the result does not change from run to run.
//
// The variance is E[x^2] - mean^2 in f32, clamped at 0 as `_gn_affine` of
// instarevive_tpu/ops/gn_conv.py clamps it; `_gn_silu_pallas` does not clamp
// and can return NaN on a near-constant input. The clamped fold serves both
// the standalone norm and the fused GN+SiLU+conv kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// A 16-byte vector of T as floats.
template <typename T> struct Vec;
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* p, float (&f)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  static __device__ __forceinline__ float sigmoid(float y) { return __fdividef(1.f, 1.f + __expf(-y)); }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ float sigmoid(float y) { return 1.f / (1.f + expf(-y)); }
};

// ---------------------------------------------------------------------------
// Moments, pass 1: block `blk` of sample `n` sums pixels [blk * ppb, (blk + 1)
// * ppb) of x (n, hw, c) per channel and writes partial (n, bps, 2, c).

constexpr int kStatThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kStatThreads)
stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int hw, int c, int bps, int ppb) {
  constexpr int V = Vec<T>::N;
  __shared__ __align__(16) float sm[2][kStatThreads * V];  // [sum | sumsq][row][channel]
  const int cols = c / V;              // threads along C, one 16-byte vector each
  const int rows = kStatThreads / cols;  // pixels in flight per step
  const int n = blockIdx.x / bps, blk = blockIdx.x % bps;
  const int col = threadIdx.x % cols, row = threadIdx.x / cols;

  float s[V], ss[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = ss[i] = 0.f;
  if (row < rows) {
    const int p0 = blk * ppb, p1 = min(hw, p0 + ppb);
    const T* base = x + (size_t)n * hw * c + col * V;
#pragma unroll 4
    for (int p = p0 + row; p < p1; p += rows) {
      float f[V];
      Vec<T>::load(base + (size_t)p * c, f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += f[i];
        ss[i] = fmaf(f[i], f[i], ss[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      *reinterpret_cast<float4*>(&sm[0][row * c + col * V + i]) = make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
      *reinterpret_cast<float4*>(&sm[1][row * c + col * V + i]) = make_float4(ss[i], ss[i + 1], ss[i + 2], ss[i + 3]);
    }
  }
  __syncthreads();
  float* dst = partial + ((size_t)n * bps + blk) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += kStatThreads) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rows; ++r) {
      a += sm[0][r * c + ch];
      b += sm[1][r * c + ch];
    }
    dst[ch] = a;
    dst[c + ch] = b;
  }
}

// Moments, pass 2: one block per (sample, group) sums that group's partials
// over blocks and channels, then writes a = gamma * rstd, b = beta - mean * a
// for the group's channels of a and b (n, c). Fixed order: bit-equal reruns.

constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const float* __restrict__ partial, const float* __restrict__ gamma,
            const float* __restrict__ beta, float* __restrict__ a, float* __restrict__ b, int c,
            int groups, int bps, float count, float eps) {
  __shared__ float sm[2][kFoldThreads / 32];
  __shared__ float s_mean, s_rstd;
  const int n = blockIdx.x / groups, g = blockIdx.x % groups;
  const int cg = c / groups;
  const float* p = partial + (size_t)n * bps * 2 * c + g * cg;
  float s = 0.f, ss = 0.f;
  for (int e = threadIdx.x; e < bps * cg; e += kFoldThreads) {
    const float* q = p + (size_t)(e / cg) * 2 * c + e % cg;
    s += q[0];
    ss += q[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (threadIdx.x % 32 == 0) {
    sm[0][threadIdx.x / 32] = s;
    sm[1][threadIdx.x / 32] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float gs = 0.f, gss = 0.f;
    for (int w = 0; w < kFoldThreads / 32; ++w) {
      gs += sm[0][w];
      gss += sm[1][w];
    }
    const float mean = gs / count;
    const float var = fmaxf(gss / count - mean * mean, 0.f);  // f32 cancellation can dip below 0
    s_mean = mean;
    s_rstd = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cg; j += kFoldThreads) {
    const int ch = g * cg + j;
    const float av = gamma[ch] * s_rstd;
    a[(size_t)n * c + ch] = av;
    b[(size_t)n * c + ch] = beta[ch] - s_mean * av;
  }
}

// ---------------------------------------------------------------------------
// Apply: y = x * a + b, optional SiLU, one 16-byte vector per thread.

constexpr int kApplyThreads = 256;

template <typename T, bool SILU>
__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
             T* __restrict__ y, size_t total_vecs, size_t vecs_per_sample, int c) {
  constexpr int V = Vec<T>::N;
  const size_t i = (size_t)blockIdx.x * kApplyThreads + threadIdx.x;
  if (i >= total_vecs) return;
  const size_t n = i / vecs_per_sample;
  const int ch = (int)(i % (size_t)(c / V)) * V;
  float f[V];
  Vec<T>::load(x + i * V, f);
  const float* ap = a + n * c + ch;
  const float* bp = b + n * c + ch;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float v = __fadd_rn(__fmul_rn(f[j], ap[j]), bp[j]);  // two roundings, as the plain version
    if (SILU) v *= Vec<T>::sigmoid(v);
    f[j] = v;
  }
  Vec<T>::store(y + i * V, f);
}

// ---------------------------------------------------------------------------
// Nearest 2x upsample on raw 16-byte vectors: one read, four writes.

constexpr int kUpThreads = 256;

__global__ void __launch_bounds__(kUpThreads)
upsample_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, size_t total_vecs, int h, int w,
                int cols) {
  const size_t i = (size_t)blockIdx.x * kUpThreads + threadIdx.x;
  if (i >= total_vecs) return;
  const int col = (int)(i % cols);
  size_t t = i / cols;
  const int px = (int)(t % w);
  t /= w;
  const int py = (int)(t % h);
  const size_t n = t / h;
  const uint4 v = x[i];
  const size_t row = (size_t)2 * w * cols;  // one output row, in vectors
  uint4* o = y + ((n * 2 * h + 2 * py) * 2 * w + 2 * px) * cols + col;
  o[0] = v;
  o[cols] = v;
  o[row] = v;
  o[row + cols] = v;
}

template <typename T>
cudaError_t launch_stats(const void* x, void* partial, int n, int hw, int c, int bps, cudaStream_t s) {
  const int ppb = (hw + bps - 1) / bps;
  stats_kernel<T><<<n * bps, kStatThreads, 0, s>>>(static_cast<const T*>(x), static_cast<float*>(partial),
                                                  hw, c, bps, ppb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply(const void* x, const void* a, const void* b, void* y, int n, int hw, int c,
                         int silu, cudaStream_t s) {
  const size_t per_sample = (size_t)hw * (c / Vec<T>::N), total = per_sample * n;
  const unsigned grid = (unsigned)((total + kApplyThreads - 1) / kApplyThreads);
  auto xt = static_cast<const T*>(x);
  auto at = static_cast<const float*>(a);
  auto bt = static_cast<const float*>(b);
  auto yt = static_cast<T*>(y);
  if (silu) apply_kernel<T, true><<<grid, kApplyThreads, 0, s>>>(xt, at, bt, yt, total, per_sample, c);
  else apply_kernel<T, false><<<grid, kApplyThreads, 0, s>>>(xt, at, bt, yt, total, per_sample, c);
  return cudaGetLastError();
}

}  // namespace

// x: (n, hw, c) contiguous, bf16 when is_bf16 else f32, c a multiple of 32 and
// at most 1024; gamma, beta: (c) f32; partial: (n, bps, 2, c) f32 scratch;
// a, b: (n, c) f32 outputs. Launches the two moments kernels. Returns a
// cudaError_t; 0 means both launches were accepted.
extern "C" int gn_stats_fold(const void* x, const void* gamma, const void* beta, void* partial, void* a,
                             void* b, int n, int hw, int c, int groups, int bps, float eps,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 32 != 0 || c > 1024 || groups < 1 || c % groups != 0 || bps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = is_bf16 ? launch_stats<bf16>(x, partial, n, hw, c, bps, s)
                            : launch_stats<float>(x, partial, n, hw, c, bps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float count = (float)((double)hw * (c / groups));
  fold_kernel<<<n * groups, kFoldThreads, 0, s>>>(static_cast<const float*>(partial), static_cast<const float*>(gamma),
                                         static_cast<const float*>(beta), static_cast<float*>(a),
                                         static_cast<float*>(b), c, groups, bps, count, eps);
  return static_cast<int>(cudaGetLastError());
}

// y = x * a + b (then SiLU when silu != 0), x and y (n, hw, c) of one type, a
// and b (n, c) f32.
extern "C" int gn_apply(const void* x, const void* a, const void* b, void* y, int n, int hw, int c,
                        int silu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(is_bf16 ? launch_apply<bf16>(x, a, b, y, n, hw, c, silu, s)
                                  : launch_apply<float>(x, a, b, y, n, hw, c, silu, s));
}

// x: (n, h, w, c) -> y: (n, 2h, 2w, c); row_bytes = c * element size, a
// multiple of 16.
extern "C" int upsample2x(const void* x, void* y, int n, int h, int w, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = row_bytes / 16;
  const size_t total = (size_t)n * h * w * cols;
  const unsigned grid = (unsigned)((total + kUpThreads - 1) / kUpThreads);
  upsample_kernel<<<grid, kUpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), total, h, w, cols);
  return static_cast<int>(cudaGetLastError());
}
