// Fused GroupNorm + SiLU + 3x3 SAME convolution for Hopper (sm_90a), bound to
// PyTorch through a plain C launcher loaded with ctypes
// (instarevive_tpu_torch/ops/gn_conv.py).
//
// Replaces the Pallas TPU kernel `_kernel` of instarevive_tpu/ops/gn_conv.py
// (reached through `_fused_call` and `gn_silu_conv3x3`):
//   out = conv3x3_SAME(silu(x * a + b), w) + bias
// with x (N, H, W, C) NHWC, w (9 * C, Co) (HWIO flattened), a and b the
// per-(sample, channel) GroupNorm fold (N, C) in f32 made beforehand by the
// moments kernels of norm_kernels.cu. The normalised tensor never reaches
// device memory. SAME padding pads the convolution's input, which is the SiLU
// output: halo positions outside the image are ZERO, not silu(b).
//
// Design: an implicit GEMM with M = output pixels, N = Co, K = 9 * C. A block
// owns an 8 x 16 tile of output pixels of one sample and a tile of BN output
// channels, and walks C in chunks. For each chunk it
//   * loads the 10 x 18 input patch (tile plus one-pixel halo) from device
//     memory, applies silu(x * a + b) in registers, rounds to the compute type
//     and stores it to shared memory (zeros outside the image);
//   * brings the chunk's 9 x KC x BN weights to shared memory with cp.async;
//   * runs the nine taps as products of the shifted patch with the tap's
//     weight slab, accumulating in f32 registers.
// The raw patch of the next chunk is fetched into registers before the
// products of this one, so its latency hides behind them. Bias is added in
// f32 and the result stored in x's type. Ragged H, W and Co are masked; C is
// a multiple of 32, so K has no ragged edge. The TPU kernel's row strips, its
// (W+4)-padded flat scratch, its in-VMEM im2col and its C % 128 rule answered
// VMEM and lane constraints that this card does not have.
//
// Two forms:
// * bf16: tensor cores through mma.sync m16n8k16 (bf16 x bf16 -> f32) with
//   ldmatrix operands. 8 warps as 4 (pixel rows) x 2 (channel halves); a warp
//   holds 2 tile rows x BN/2 channels of accumulators. Patch rows are padded
//   to 80 bytes and weight rows to BN*2+16 bytes so that the eight rows of an
//   ldmatrix fall on eight different bank groups. BN is 128 when Co is a
//   multiple of 128, else 64. About 97 KB of shared memory: two blocks per SM.
// * f32: plain FMAs (no TF32), a 4-pixel x 8-channel register tile per thread.
//
// What bounds it on this card: at the VAE's shapes (C, Co in 128..512) the
// work is 9 * C * Co / (C + Co) > 500 operations per byte moved, above the
// H100's bf16 ridge (~295), so the tensor cores bound it; mma.sync reaches a
// fraction of the wgmma peak, and the weights are not double-buffered. wgmma,
// TMA and a persistent schedule are left for later work. The kernel is
// forward-only, like the TPU kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 8, TW = 16;           // output pixels of one block
constexpr int PH = TH + 2, PW = TW + 2;  // the input patch with its halo
constexpr int NPOS = PH * PW;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 destination bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The block's place in the grid: output-channel tiles vary fastest, so the
// blocks that share an input patch run together and find it in L2.
struct Tile {
  int n, y0, x0, co0;
  __device__ Tile(int tiles_x, int tiles_y, int co_tiles, int bn) {
    int t = blockIdx.x;
    co0 = (t % co_tiles) * bn;
    t /= co_tiles;
    x0 = (t % tiles_x) * TW;
    t /= tiles_x;
    y0 = (t % tiles_y) * TH;
    n = t / tiles_y;
  }
};

// Which 16-byte vectors of the patch a thread loads: `VPP` vectors per patch
// position, `kSlots` per thread. pix[s] is the vector's pixel index in the
// sample (y * W + x), -1 for a position outside the image (stored as zeros)
// and -2 for a slot past the end of the patch (nothing stored).
template <int VPP>
struct PatchSlots {
  static constexpr int kVecs = NPOS * VPP;
  static constexpr int kSlots = (kVecs + kThreads - 1) / kThreads;
  int pix[kSlots];
  __device__ PatchSlots(const Tile& t, int h, int wd) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int v = threadIdx.x + s * kThreads;
      const int pos = v / VPP, gy = t.y0 + pos / PW - 1, gx = t.x0 + pos % PW - 1;
      if (v >= kVecs) pix[s] = -2;
      else if (gy < 0 || gy >= h || gx < 0 || gx >= wd) pix[s] = -1;
      else pix[s] = gy * wd + gx;
    }
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores.

namespace gnconv_tc {

constexpr int KC = 32;       // input channels per chunk: two k-steps of 16
constexpr int LDA = KC + 8;  // patch row stride, 80 bytes
constexpr int VPP = KC / 8;  // 16-byte vectors per patch position

template <int BN>
struct Smem {
  static constexpr int LDW = BN + 8;  // weight row stride
  static constexpr size_t a = 0;
  static constexpr size_t w = a + sizeof(bf16) * NPOS * LDA;
  static constexpr size_t ab = w + sizeof(bf16) * 9 * KC * LDW;  // then 2 * C floats
  static size_t bytes(int c) { return ab + sizeof(float) * 2 * c; }
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
kernel(const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
       const bf16* __restrict__ w, const float* __restrict__ bias, bf16* __restrict__ out, int h,
       int wd, int c, int co, int tiles_x, int tiles_y, int co_tiles) {
  using S = Smem<BN>;
  constexpr int LDW = S::LDW;
  constexpr int kNT = BN / 16;  // n-tiles of 8 channels per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem + S::a);
  bf16* sW = reinterpret_cast<bf16*>(smem + S::w);
  float* sFa = reinterpret_cast<float*>(smem + S::ab);
  float* sFb = sFa + c;

  const Tile tile(tiles_x, tiles_y, co_tiles, BN);
  const bf16* xn = x + (size_t)tile.n * h * wd * c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;  // tile rows 2wm, 2wm+1; channel half wn

  for (int i = threadIdx.x; i < c; i += kThreads) {
    sFa[i] = a[(size_t)tile.n * c + i];
    sFb[i] = b[(size_t)tile.n * c + i];
  }

  const PatchSlots<VPP> slots(tile, h, wd);
  constexpr int kSlots = PatchSlots<VPP>::kSlots;
  uint4 raw[kSlots];

  auto fetch = [&](int c0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (slots.pix[s] >= 0)
        raw[s] = __ldg(reinterpret_cast<const uint4*>(
            xn + (size_t)slots.pix[s] * c + c0 + ((threadIdx.x + s * kThreads) % VPP) * 8));
  };
  // silu(x * a + b) of the fetched vectors, rounded to bf16, into the patch
  auto stage = [&](int c0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (slots.pix[s] == -2) continue;
      const int v = threadIdx.x + s * kThreads;
      const int pos = v / VPP, cv = (v % VPP) * 8;
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (slots.pix[s] >= 0) {
        const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw[s]);
        __nv_bfloat162* res = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(in[j]);
          const int ch = c0 + cv + 2 * j;
          // two roundings, as the plain version's x * a + b
          const float y0 = __fadd_rn(__fmul_rn(f.x, sFa[ch]), sFb[ch]);
          const float y1 = __fadd_rn(__fmul_rn(f.y, sFa[ch + 1]), sFb[ch + 1]);
          res[j] = __floats2bfloat162_rn(__fdividef(y0, 1.f + __expf(-y0)), __fdividef(y1, 1.f + __expf(-y1)));
        }
      }
      *reinterpret_cast<uint4*>(sA + pos * LDA + cv) = o;
    }
  };
  auto load_w = [&](int c0) {
    constexpr int kRowVecs = BN / 8;
    for (int i = threadIdx.x; i < 9 * KC * kRowVecs; i += kThreads) {
      const int row = i / kRowVecs, col = (i % kRowVecs) * 8;  // row = tap * KC + k
      const bool valid = tile.co0 + col < co;
      const bf16* src = w + ((size_t)(row / KC) * c + c0 + row % KC) * co + tile.co0 + col;
      cp_async_16(sW + row * LDW + col, valid ? src : w, valid);
    }
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  fetch(0);
  for (int c0 = 0; c0 < c; c0 += KC) {
    __syncthreads();  // a and b are in shared memory; the previous chunk's readers are done
    load_w(c0);
    cp_async_commit();
    stage(c0);
    if (c0 + KC < c) fetch(c0 + KC);  // in flight during the products below
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(af[i], sA + ((2 * wm + i + dy) * PW + lane % 16 + dx) * LDA + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, sW + (tap * KC + ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDW +
                                wn * (BN / 2) + np * 16 + (lane / 16) * 8);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma(acc[i][2 * np], af[i], bf[0], bf[1]);
            mma(acc[i][2 * np + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
  }

  // accumulator rows are pixel columns g and g + 8 of a tile row; columns 2t, 2t+1 of an n-tile
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = tile.y0 + 2 * wm + i;
    if (gy >= h) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gx = tile.x0 + g + 8 * hh;
      if (gx >= wd) continue;
      bf16* op = out + (((size_t)tile.n * h + gy) * wd + gx) * co;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = tile.co0 + wn * (BN / 2) + nt * 8 + 2 * t4;
        if (col >= co) continue;
        *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(
            acc[i][nt][2 * hh] + __ldg(bias + col), acc[i][nt][2 * hh + 1] + __ldg(bias + col + 1));
      }
    }
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w, const void* bias,
                   void* out, int n, int h, int wd, int c, int co, cudaStream_t stream) {
  const size_t bytes = Smem<BN>::bytes(c);
  if (bytes > 232448) return cudaErrorInvalidValue;
  auto fn = kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH, co_tiles = (co + BN - 1) / BN;
  const long long blocks = (long long)n * tiles_y * tiles_x * co_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(w), static_cast<const float*>(bias), static_cast<bf16*>(out), h, wd, c,
      co, tiles_x, tiles_y, co_tiles);
  return cudaGetLastError();
}

}  // namespace gnconv_tc

// ---------------------------------------------------------------------------
// f32: FMAs on shared tiles.

namespace gnconv_f32 {

constexpr int KC = 16;       // input channels per chunk
constexpr int BN = 64;       // output channels per block
constexpr int LDA = KC + 1;  // odd patch row stride: no bank conflicts between pixels
constexpr int VPP = KC / 4;  // 16-byte vectors per patch position

struct Smem {
  static constexpr size_t a = 0;
  static constexpr size_t w = a + sizeof(float) * NPOS * LDA;
  static constexpr size_t ab = w + sizeof(float) * 9 * KC * BN;  // then 2 * C floats
  static size_t bytes(int c) { return ab + sizeof(float) * 2 * c; }
};
static_assert(Smem::w % 16 == 0, "the weight tile is read as float4");

__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
       const float* __restrict__ w, const float* __restrict__ bias, float* __restrict__ out, int h,
       int wd, int c, int co, int tiles_x, int tiles_y, int co_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem + Smem::a);
  float* sW = reinterpret_cast<float*>(smem + Smem::w);
  float* sFa = reinterpret_cast<float*>(smem + Smem::ab);
  float* sFb = sFa + c;

  const Tile tile(tiles_x, tiles_y, co_tiles, BN);
  const float* xn = x + (size_t)tile.n * h * wd * c;
  // a thread's register tile: 4 pixels of one tile row x 8 output channels
  const int tc8 = (threadIdx.x % 8) * 8;
  const int r = threadIdx.x / 32, cb = ((threadIdx.x / 8) % 4) * 4;

  for (int i = threadIdx.x; i < c; i += kThreads) {
    sFa[i] = a[(size_t)tile.n * c + i];
    sFb[i] = b[(size_t)tile.n * c + i];
  }

  const PatchSlots<VPP> slots(tile, h, wd);
  constexpr int kSlots = PatchSlots<VPP>::kSlots;
  float4 raw[kSlots];

  auto fetch = [&](int c0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (slots.pix[s] >= 0)
        raw[s] = __ldg(reinterpret_cast<const float4*>(
            xn + (size_t)slots.pix[s] * c + c0 + ((threadIdx.x + s * kThreads) % VPP) * 4));
  };
  auto stage = [&](int c0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (slots.pix[s] == -2) continue;
      const int v = threadIdx.x + s * kThreads;
      const int pos = v / VPP, cv = (v % VPP) * 4;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (slots.pix[s] >= 0) {
        const float in[4] = {raw[s].x, raw[s].y, raw[s].z, raw[s].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = __fadd_rn(__fmul_rn(in[j], sFa[c0 + cv + j]), sFb[c0 + cv + j]);
          f[j] = y * (1.f / (1.f + expf(-y)));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sA[pos * LDA + cv + j] = f[j];
    }
  };
  auto load_w = [&](int c0) {
    constexpr int kRowVecs = BN / 4;
    for (int i = threadIdx.x; i < 9 * KC * kRowVecs; i += kThreads) {
      const int row = i / kRowVecs, col = (i % kRowVecs) * 4;  // row = tap * KC + k
      const bool valid = tile.co0 + col < co;
      const float* src = w + ((size_t)(row / KC) * c + c0 + row % KC) * co + tile.co0 + col;
      cp_async_16(sW + row * BN + col, valid ? src : w, valid);
    }
  };

  float acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

  fetch(0);
  for (int c0 = 0; c0 < c; c0 += KC) {
    __syncthreads();  // a and b are in shared memory; the previous chunk's readers are done
    load_w(c0);
    cp_async_commit();
    stage(c0);
    if (c0 + KC < c) fetch(c0 + KC);
    cp_async_wait_all();
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* pa = sA + ((r + tap / 3) * PW + cb + tap % 3) * LDA;
      const float* pw = sW + tap * KC * BN + tc8;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(pw + k * BN);
        const float4 w1 = *reinterpret_cast<const float4*>(pw + k * BN + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float av = pa[j * LDA + k];
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[j][q] = fmaf(av, wv[q], acc[j][q]);
        }
      }
    }
  }

  const int gy = tile.y0 + r, col = tile.co0 + tc8;
  if (gy >= h || col >= co) return;
  const float4 b0 = *reinterpret_cast<const float4*>(bias + col);
  const float4 b1 = *reinterpret_cast<const float4*>(bias + col + 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gx = tile.x0 + cb + j;
    if (gx >= wd) continue;
    float* op = out + (((size_t)tile.n * h + gy) * wd + gx) * co + col;
    *reinterpret_cast<float4*>(op) =
        make_float4(acc[j][0] + b0.x, acc[j][1] + b0.y, acc[j][2] + b0.z, acc[j][3] + b0.w);
    *reinterpret_cast<float4*>(op + 4) =
        make_float4(acc[j][4] + b1.x, acc[j][5] + b1.y, acc[j][6] + b1.z, acc[j][7] + b1.w);
  }
}

cudaError_t launch(const void* x, const void* a, const void* b, const void* w, const void* bias,
                   void* out, int n, int h, int wd, int c, int co, cudaStream_t stream) {
  const size_t bytes = Smem::bytes(c);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH, co_tiles = (co + BN - 1) / BN;
  const long long blocks = (long long)n * tiles_y * tiles_x * co_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(out), h, wd, c,
      co, tiles_x, tiles_y, co_tiles);
  return cudaGetLastError();
}

}  // namespace gnconv_f32

}  // namespace

// x: (n, h, wd, c) and out: (n, h, wd, co), contiguous NHWC of one type (bf16
// when is_bf16, else f32); w: (9 * c, co) of that type; a, b: (n, c) f32;
// bias: (co) f32. c and co are multiples of 32. Returns a cudaError_t; 0
// means the launch was accepted.
extern "C" int gn_silu_conv3x3(const void* x, const void* a, const void* b, const void* w,
                               const void* bias, void* out, int n, int h, int wd, int c, int co,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 32 != 0 || co % 32 != 0 || n < 1 || h < 1 || wd < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) return static_cast<int>(gnconv_f32::launch(x, a, b, w, bias, out, n, h, wd, c, co, s));
  return static_cast<int>(co % 128 == 0 ? gnconv_tc::launch<128>(x, a, b, w, bias, out, n, h, wd, c, co, s)
                                        : gnconv_tc::launch<64>(x, a, b, w, bias, out, n, h, wd, c, co, s));
}
