// The split prepass of the f32 attention kernels (flash_attn_fwd.cu, namespaces
// fwd_tf32 and d512_tf32; flash_attn_bwd.cu, namespace bwd_tf32), bound to PyTorch through a
// plain C launcher loaded with ctypes (instarevive_tpu_torch/ops/attention.py,
// `tf32_planes`; its plain version is `tf32_planes_plain`, bit for bit).
//
// Those kernels run every f32 product on the tensor cores as three tf32
// products, hi.hi + hi.lo + lo.hi, on operands held as hi = tf32(x) and
// lo = tf32(x - hi), each rounded to nearest with ties away from zero
// (cvt.rna), so each plane's low 13 mantissa bits are zero and hi + lo is
// within 2^-22 |x| of x. This kernel reads an f32 operand (bh, n, d) once and
// writes, as asked, its planes in the operand's own layout (bh, n, d) and
// transposed, (bh, d, n_pad): a tf32 operand of wgmma is read from shared
// memory K-major only, so a B operand whose K runs along n (V in P.V, K in
// dQ = dS.K, Q and dO in dK = dS^T.Q and dV = P^T.dO) is read from the
// transposed planes. Their rows are padded to n_pad = n rounded up to a
// multiple of 8 (a TMA row stride is a multiple of 16 bytes) and zero-filled
// past n, and within each group of 8 positions along n, position j holds
// entry 8 (j / 8) + (0 2 4 6 1 3 5 7)[j % 8]: the order in which a thread's
// accumulator columns (2t, 2t + 1) of an 8-column group become the tf32 A
// fragment's k = (t, t + 4), so P and dS go from the accumulator to the next
// product with no shuffle.
//
// It replaces no TPU kernel (the TPU kernels take f32 operands as they are);
// it is bound by the bytes it moves: one f32 read and up to four written per
// element. A block stages 32 rows of one head in shared memory (rows of d + 1
// f32: no bank conflicts down a column; 64 KB at d = 512), so both layouts are
// written with neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace tf32_split {

constexpr int kRows = 32, kThreads = 256, kMaxD = 512;
constexpr int kMaxSmem = kRows * (kMaxD + 1) * 4;

__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ x, float* __restrict__ hi, float* __restrict__ lo, float* __restrict__ t_hi,
       float* __restrict__ t_lo, int n, int d, int n_pad) {
  extern __shared__ float tile[];  // kRows x (d + 1)
  const int ld = d + 1;
  const int bh = blockIdx.y, r0 = blockIdx.x * kRows;
  const size_t base = (size_t)bh * n * d;
  for (int e = threadIdx.x; e < kRows * d; e += kThreads) {
    const int r = e / d, c = e % d, row = r0 + r;
    const float v = row < n ? x[base + (size_t)row * d + c] : 0.f;
    tile[r * ld + c] = v;
    if (hi != nullptr && row < n) {
      const float h = hopper::tf32_rna(v);
      hi[base + (size_t)row * d + c] = h;
      lo[base + (size_t)row * d + c] = hopper::tf32_rna(v - h);
    }
  }
  if (t_hi == nullptr) return;
  __syncthreads();
  for (int e = threadIdx.x; e < d * kRows; e += kThreads) {
    const int c = e / kRows, j = e % kRows, pos = r0 + j;
    if (pos >= n_pad) continue;
    const int m = j % 8, r = (j & ~7) + (m < 4 ? 2 * m : 2 * m - 7);  // 0 2 4 6 1 3 5 7
    const float v = tile[r * ld + c], h = hopper::tf32_rna(v);
    const size_t at = ((size_t)bh * d + c) * n_pad + pos;
    t_hi[at] = h;
    t_lo[at] = hopper::tf32_rna(v - h);
  }
}

}  // namespace tf32_split

}  // namespace

// x: (bh, n, d) f32, contiguous, d <= 512. hi, lo: (bh, n, d) f32, or both
// null; t_hi, t_lo: (bh, d, n_pad) f32 with n_pad = n rounded up to a
// multiple of 8, or both null. Returns a cudaError_t; 0 means the launch was
// accepted.
extern "C" int tf32_planes(const void* x, void* hi, void* lo, void* t_hi, void* t_lo, int bh, int n, int d,
                           void* stream) {
  using namespace tf32_split;
  if (d < 1 || d > kMaxD || n < 1 || bh < 1 || bh > 65535 || (hi == nullptr) != (lo == nullptr) ||
      (t_hi == nullptr) != (t_lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_pad = (n + 7) / 8 * 8;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_pad + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, kRows * (d + 1) * 4, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(hi), static_cast<float*>(lo), static_cast<float*>(t_hi),
      static_cast<float*>(t_lo), n, d, n_pad);
  return static_cast<int>(cudaGetLastError());
}
