// Per-sample depthwise 2-D correlation over a reflect-padded NHWC f32 image
// for Hopper (sm_90a), bound to PyTorch through a plain C launcher loaded with
// ctypes (instarevive_tpu_torch/ops/filters.py):
//
//   out[b, y, x, c] = sum_{i, j} k[b, i, j] * img[b, refl(y + i - kh/2), refl(x + j - kw/2), c]
//
// with torch's "reflect" (no edge repeat: -i -> i, H-1+i -> H-1-i), the same
// (kh, kw) taps for every channel of a sample, f32 throughout.
//
// Replaces the Pallas TPU kernel `_filter2d_plane_kernel` of
// instarevive_tpu/ops/filters.py (reached through `_filter2d_pallas`). That
// version pads a copy of the image, transposes it to one plane per channel,
// repeats the taps per channel, pads the rows to 8-aligned slabs and refuses
// shapes that do not tile by 8 rows and 128-aligned columns. None of that is
// carried over. Here the image is read as it lies in memory: a row of an NHWC
// image is W * C floats, and because every channel takes the same taps the
// filter is a 2-D correlation on that flat row whose horizontal taps are C
// floats apart. A block owns 32 rows by 64 flat floats of one sample (tiles
// need not start on a pixel), stages the (32 + kh - 1) x (64 + (kw - 1) * C)
// patch in shared memory with the reflection folded into the load addresses,
// and the sample's taps beside it. No padded copy, no transpose, any H and W.
//
// What bounds it on this card: 2 * kh * kw operations per output float (882
// at 21 taps, 3362 at 41) against 8 bytes moved, so f32 FMAs, not memory. In
// the inner loop a thread holds a column of 8 outputs and a rotating window
// of 8 patch values in registers: each tap row costs one shared-memory load
// of a patch value and one broadcast load of the tap for 8 FMAs, which is the
// ratio (32 lanes of 4 bytes a clock against 128 FMAs a clock) at which an
// SM's shared memory keeps its FMA units fed. Neighbouring lanes read
// neighbouring floats: no bank conflicts whatever C is.
//
// For a large C the patch of all channels does not fit in shared memory; the
// launcher takes a channel range [c0, c0 + cc) and the wrapper launches once
// per range. The RGB images of the degradation programs take one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 64;         // flat floats of a row that a block owns
constexpr int kTY = 4;          // thread rows of a block
constexpr int kR = 8;           // outputs (consecutive rows) a thread accumulates
constexpr int kTH = kTY * kR;   // rows a block owns
constexpr int kMaxTaps = 41;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// torch "reflect" for an index at most n - 1 outside [0, n); clamped beyond
// that, where only the unused rows and columns of a ragged tile fall.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kTX * kTY)
filter2d_kernel(const float* __restrict__ img, const float* __restrict__ taps, float* __restrict__ out,
                int H, int W, int C, int kh, int kw, int tap_stride, int c0, int cc) {
  extern __shared__ float smem[];
  float* ks = smem;               // kh * kw taps of this sample
  float* patch = smem + kh * kw;  // PH rows of PW flat floats
  const int ph = kh / 2, pw = kw / 2;
  const int PH = kTH + kh - 1, PW = kTX + (kw - 1) * cc;
  const int b = blockIdx.z, y0 = blockIdx.y * kTH, f0 = blockIdx.x * kTX;
  const int tid = threadIdx.y * kTX + threadIdx.x;

  const float* kb = taps + (size_t)b * tap_stride;
  for (int t = tid; t < kh * kw; t += kTX * kTY) ks[t] = kb[t];
  const float* ib = img + (size_t)b * H * W * C;
  for (int t = tid; t < PH * PW; t += kTX * kTY) {
    const int pr = t / PW, pc = t - pr * PW;
    const int y = reflect(y0 + pr - ph, H);
    const int g = f0 + pc;   // flat index within the channel range, moved right by pw pixels
    const int xp = g / cc;
    const int x = reflect(xp - pw, W);
    patch[t] = ib[((size_t)y * W + x) * C + c0 + (g - xp * cc)];
  }
  __syncthreads();

  const int tx = threadIdx.x, r0 = threadIdx.y * kR;
  float acc[kR];
#pragma unroll
  for (int o = 0; o < kR; ++o) acc[o] = 0.f;
  for (int j = 0; j < kw; ++j) {
    // v[(o + i) % kR] holds patch row r0 + o + i of this thread's column while tap row i is applied
    const float* col = patch + r0 * PW + tx + j * cc;
    const float* next = col + kR * PW;
    float v[kR];
#pragma unroll
    for (int o = 0; o < kR; ++o) v[o] = col[o * PW];
    for (int i0 = 0; i0 < kh; i0 += kR) {
#pragma unroll
      for (int s = 0; s < kR; ++s) {
        const int i = i0 + s;
        if (i < kh) {
          const float t = ks[i * kw + j];
#pragma unroll
          for (int o = 0; o < kR; ++o) acc[o] = fmaf(t, v[(o + s) % kR], acc[o]);
          if (i + 1 < kh) v[s] = next[i * PW];  // row r0 + i is done with; row r0 + i + kR takes its place
        }
      }
    }
  }

  const int f = f0 + tx;
  if (f < W * cc) {
    const int x = f / cc, cl = f - x * cc;
    float* ob = out + ((size_t)b * H * W + x) * C + c0 + cl;
#pragma unroll
    for (int o = 0; o < kR; ++o) {
      const int y = y0 + r0 + o;
      if (y < H) ob[(size_t)y * W * C] = acc[o];
    }
  }
}

}  // namespace

// Shared memory, in bytes, of a block that filters `cc` channels with (kh, kw) taps.
extern "C" int filter2d_smem_bytes(int kh, int kw, int cc) {
  return 4 * (kh * kw + (kTH + kh - 1) * (kTX + (kw - 1) * cc));
}

// img, out: (b, h, w, c) f32 contiguous; taps: (b, kh, kw) f32 when per_sample,
// else (kh, kw). Filters channels [c0, c0 + cc) of every sample.
extern "C" int filter2d_f32(const void* img, const void* taps, void* out, int b, int h, int w, int c,
                            int kh, int kw, int per_sample, int c0, int cc, void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || kh < 1 || kw < 1 || kh % 2 == 0 || kw % 2 == 0 ||
      kh > kMaxTaps || kw > kMaxTaps || kh / 2 >= h || kw / 2 >= w || c0 < 0 || cc < 1 || c0 + cc > c ||
      b > 65535 || (long long)b * h * w * c >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = filter2d_smem_bytes(kh, kw, cc);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(filter2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w * cc + kTX - 1) / kTX, (h + kTH - 1) / kTH, b);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  filter2d_kernel<<<grid, dim3(kTX, kTY), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(taps), static_cast<float*>(out),
      h, w, c, kh, kw, per_sample ? kh * kw : 0, c0, cc);
  return static_cast<int>(cudaGetLastError());
}
