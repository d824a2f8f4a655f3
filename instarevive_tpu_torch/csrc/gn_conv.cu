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
// An implicit GEMM with M = output pixels, N = Co, K = 9 * C. Two forms:
//
// * bf16 (namespace gnconv_wg): wgmma on TMA-fed weight tiles. A block owns a
//   16 x 16 tile of output pixels of one sample and BN output channels, and
//   walks C in chunks of 64. Its two warpgroups hold 8 pixel rows each, as two
//   m64 x BN f32 accumulators (128 registers a thread at BN = 128).
//   - Weights: a 3-D tensor map over the (9C, Co) matrix, seen as (Co, C, 9),
//     brings one tap x 64 channels x BN into a stage, in 128-byte rows under
//     the 128-byte swizzle (BN / 64 boxes 8 KB apart); channels past C and
//     output channels past Co arrive as zeros. Five stages in a ring, each
//     with a full mbarrier (the bytes landed) and an empty one (every warp is
//     done with it); thread 0 refills a stage once it is empty, so the next
//     taps' weights land while this one multiplies. They are the B operand of
//     wgmma in its MN-major form, as V is in flash_attn_fwd.cu's P.V.
//   - Activations: a 4-D tensor map over x, seen as (C, W, H, N), brings the
//     raw 18 x 18 patch of a chunk (the tile and its halo; TMA zero-fills what
//     lies outside the image). silu(x * a + b), with the plain version's two
//     roundings, is applied once a chunk (never once a tap) and rounded to
//     bf16 into one of two activated patches of 144-byte rows (ldmatrix's
//     eight rows on eight bank groups), zeros outside the image. The next
//     chunk's patch is activated a sixth at a time during taps 3-8 of this
//     chunk, while the taps' wgmmas run.
//   - Products: for each tap, ldmatrix reads each warp's A fragments (one
//     pixel row of 16, shifted by the tap: an address offset) and wgmma
//     m64nBNk16 multiplies them, from registers, by the stage's weights. The
//     fragments of two taps are held, so one tap's wgmmas run while the next
//     tap's fragments load.
//   BN is 128 where Co is a multiple of 128, else 64 (a fixed rule on the
//   shape; at 72 x 72 x 512 the 64-wide tile's two waves of blocks took 0.126
//   ms against one wave of 128-wide blocks' 0.081). 222 KB of shared memory
//   at BN = 128 and C = 512: one block an SM. No atomics: the output repeats
//   bit for bit.
// * f32 (namespace gnconv_f32): plain FMAs (no TF32) on an 8 x 16 pixel tile,
//   a 4-pixel x 8-channel register tile per thread, weights by cp.async.
//
// Bias is added in f32 and the result rounded once to x's type. Ragged H, W
// and Co are masked at the store; C is a multiple of 32, never padded in
// device memory. The TPU kernel's row strips, its (W+4)-padded flat scratch,
// its in-VMEM im2col and its C % 128 rule answered VMEM and lane constraints
// that this card does not have.
//
// What bounds it on this card: at the VAE's shapes (C, Co in 128..512) the
// work is 9 * C * Co / (C + Co) > 500 operations per byte moved, above the
// H100's bf16 ridge (~295), so the tensor cores bound it in principle; the
// kernel reaches 40-48% of their peak. The 256-pixel tile halves the weight
// bytes read from L2 per operation against the 128-pixel tile of the
// mma.sync form this replaces. What holds it back, measured on edited copies
// (tools/time_gn_conv.py, PERF.md): the activation, which costs 17-32% of the
// time whichever warps run it (a third warpgroup doing it under setmaxnreg
// gained nothing), and at C = 128 each block's start (the first patch's copy
// and activation) and end. A persistent schedule, A read by wgmma from a
// swizzled shared patch, and a producer warpgroup were each tried and were
// slower or no faster. The kernel is forward-only, like the TPU kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The f32 form's tile (the bf16 form's are in its namespace).
constexpr int TH = 8, TW = 16;           // output pixels of one block
constexpr int PH = TH + 2, PW = TW + 2;  // the input patch with its halo
constexpr int NPOS = PH * PW;
constexpr int kThreads = 256;

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
// bf16: wgmma on TMA-fed weight tiles.

namespace gnconv_wg {

using namespace hopper;

constexpr int TH = 16, TW = 16;           // output pixels of one block
constexpr int PH = TH + 2, PW = TW + 2;   // the patch with its halo
constexpr int NPOS = PH * PW;
constexpr int kThreads = 256;             // two warpgroups, 8 pixel rows each
constexpr int KC = 64;                    // input channels a chunk: one 128-byte row of a weight tile
constexpr int LDA = KC + 8;               // activated patch row stride, 144 bytes
constexpr int kVecs = NPOS * KC / 8;      // 16-byte vectors of a patch
constexpr int kStages = 5;                // the weight ring
constexpr int kFirstSliceTap = 3;         // taps 3-8 activate the next chunk, a sixth each
constexpr int kSlice = kVecs / (9 - kFirstSliceTap);
static_assert(kVecs % (9 - kFirstSliceTap) == 0, "equal slices");
constexpr uint32_t kRawBytes = NPOS * KC * 2, kPatchBytes = NPOS * LDA * 2;

// Shared memory from a 1024-byte aligned base: the weight ring (stages of
// 16 or 8 KB, on 1024 bytes as the swizzle wants), the raw patch, two
// activated patches, 2 kStages + 1 barriers, then a and b of the sample.
template <int BN>
struct Smem {
  static constexpr uint32_t kStage = 64 * BN * 2;
  static constexpr uint32_t raw = kStages * kStage;
  static constexpr uint32_t patch = raw + kRawBytes;
  static constexpr uint32_t bars = patch + 2 * kPatchBytes;
  static constexpr uint32_t ab = bars + (8 * (2 * kStages + 1) + 15) / 16 * 16;  // on 16 bytes: read as float4
  static size_t bytes(int cpad) { return 1024 + ab + sizeof(float) * 2 * cpad; }
};

struct Maps {  // x as (C, W, H, N), boxes of 64 x 18 x 18 x 1; w as (Co, C, 9), boxes of 64 x 64 x 1
  CUtensorMap x, w;
};

// Keeps the A fragments alive up to here: wgmma reads them after it issues.
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ Maps maps, const float* __restrict__ a, const float* __restrict__ b,
       const float* __restrict__ bias, bf16* __restrict__ out, int h, int wd, int c, int co, int tiles_x,
       int tiles_y, int co_tiles) {
  using S = Smem<BN>;
  constexpr int kAcc = BN / 2;  // accumulators a thread holds per m64 tile
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (1024 - smem_u32(smem) % 1024) % 1024;
  const uint32_t sW = smem_u32(base), sRaw = sW + S::raw;
  const uint32_t full = sW + S::bars, empty = full + 8 * kStages, rawbar = empty + 8 * kStages;
  const bf16* raw = reinterpret_cast<const bf16*>(base + S::raw);
  bf16* patch = reinterpret_cast<bf16*>(base + S::patch);
  const int cpad = (c + KC - 1) / KC * KC;
  float* sFa = reinterpret_cast<float*>(base + S::ab);
  float* sFb = sFa + cpad;

  // output-channel tiles vary fastest, so the blocks that share a patch run together and find it in L2
  int blk = blockIdx.x;
  const int co0 = (blk % co_tiles) * BN;
  blk /= co_tiles;
  const int x0 = (blk % tiles_x) * TW;
  blk /= tiles_x;
  const int y0 = (blk % tiles_y) * TH;
  const int n = blk / tiles_y;
  const int chunks = cpad / KC, steps = 9 * chunks;  // a step is one tap of one chunk
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const bool producer = threadIdx.x == 0;  // issues every copy; no warp is set aside (a warpgroup that was: no faster)

  auto load_w = [&](int step) {
    const int s = step % kStages;
    mbar_expect_tx(full + 8 * s, S::kStage);
#pragma unroll
    for (int half = 0; half < BN / 64; ++half)
      tma_load(sW + s * S::kStage + half * 8192, &maps.w, full + 8 * s, co0 + 64 * half, (step / 9) * KC, step % 9);
  };
  auto load_raw = [&](int chunk) {
    mbar_expect_tx(rawbar, kRawBytes);
    tma_load(sRaw, &maps.x, rawbar, chunk * KC, x0 - 1, y0 - 1, n);
  };
  // silu(x * a + b) of vectors [v0, v1) of the raw patch (chunk `chunk`), rounded to bf16, into its patch;
  // channels past C have a = b = 0 and a zero raw value, so they come out 0
  auto activate = [&](int chunk, int v0, int v1) {
    bf16* dst = patch + (chunk % 2) * (NPOS * LDA);
    for (int v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const int pos = v / (KC / 8), cv = (v % (KC / 8)) * 8;
      const int gy = y0 - 1 + pos / PW, gx = x0 - 1 + pos % PW;
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        const uint4 in4 = *reinterpret_cast<const uint4*>(raw + pos * KC + cv);
        const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&in4);
        __nv_bfloat162* res = reinterpret_cast<__nv_bfloat162*>(&o);
        const float4* fa = reinterpret_cast<const float4*>(sFa + chunk * KC + cv);
        const float4* fb = reinterpret_cast<const float4*>(sFb + chunk * KC + cv);
        const float4 a4[2] = {fa[0], fa[1]}, b4[2] = {fb[0], fb[1]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(in[j]);
          const float2 aa = j % 2 ? make_float2(a4[j / 2].z, a4[j / 2].w) : make_float2(a4[j / 2].x, a4[j / 2].y);
          const float2 bb = j % 2 ? make_float2(b4[j / 2].z, b4[j / 2].w) : make_float2(b4[j / 2].x, b4[j / 2].y);
          // two roundings, as the plain version's x * a + b
          const float u0 = __fadd_rn(__fmul_rn(f.x, aa.x), bb.x);
          const float u1 = __fadd_rn(__fmul_rn(f.y, aa.y), bb.y);
          res[j] = __floats2bfloat162_rn(__fdividef(u0, 1.f + __expf(-u0)), __fdividef(u1, 1.f + __expf(-u1)));
        }
      }
      *reinterpret_cast<uint4*>(dst + pos * LDA + cv) = o;
    }
  };

  if (producer) {  // the first copies are in flight while the block reads its fold
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    mbar_init(rawbar, 1);
    mbar_init_fence();
    load_raw(0);
    for (int step = 0; step < kStages && step < steps; ++step) load_w(step);
  }
  for (int i = threadIdx.x; i < cpad; i += kThreads) {
    sFa[i] = i < c ? a[(size_t)n * c + i] : 0.f;
    sFb[i] = i < c ? b[(size_t)n * c + i] : 0.f;
  }
  __syncthreads();  // the barriers are set up, a and b in place
  mbar_wait(rawbar, 0);
  activate(0, 0, kVecs);
  __syncthreads();  // the first patch is whole and the raw tile free
  if (producer && chunks > 1) load_raw(1);

  float acc[2][kAcc];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.f;
  // this warp's A rows in m64 tile i: pixel row 8 wg + 4 i + warp of the tile; lane l of an ldmatrix
  // gives pixel l % 16 of it, channels 8 (l / 16) on
  const bf16* a_lane = patch + ((wg * 8 + warp) * PW + lane % 16) * LDA + (lane / 16) * 8;

  // A fragments of two taps: this tap's, read by its wgmmas while the next tap's load
  uint32_t af[2][2][KC / 16][4];
  auto load_a = [&](uint32_t (&f)[2][KC / 16][4], const bf16* chunk_patch, int tap) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        ldsm_x4(f[i][ks], chunk_patch + ((4 * i + tap / 3) * PW + tap % 3) * LDA + ks * 16);
  };
  auto keep = [&](uint32_t (&f)[2][KC / 16][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) keep_regs(f[i][ks]);
  };

  for (int chunk = 0; chunk < chunks; ++chunk) {
    const bf16* a_chunk = a_lane + (chunk % 2) * (NPOS * LDA);
    const bool next = chunk + 1 < chunks;
    load_a(af[0], a_chunk, 0);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int step = chunk * 9 + tap, s = step % kStages;
      // refill the stage of two steps back once every warp is done with it (the step before may still be read)
      if (producer && step >= 2 && step - 2 + kStages < steps) {
        mbar_wait(empty + 8 * ((step - 2) % kStages), ((step - 2) / kStages) & 1);
        load_w(step - 2 + kStages);
      }
      __syncwarp();
      mbar_wait(full + 8 * s, (step / kStages) & 1);
      __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
      // a k-step of 16 channels is 16 rows of 128 bytes; the two 64-wide column groups are 8 KB apart
      const uint64_t b_desc = smem_desc(sW + s * S::kStage, 1024, kSwizzle128, 8192);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
        for (int i = 0; i < 2; ++i) Wgmma<BN>::rs(acc[i], af[tap % 2][i][ks], b_desc + ks * 128);
      wgmma_commit();
      if (next && tap >= kFirstSliceTap) {
        if (tap == kFirstSliceTap) mbar_wait(rawbar, (chunk + 1) & 1);
        activate(chunk + 1, (tap - kFirstSliceTap) * kSlice, (tap - kFirstSliceTap + 1) * kSlice);
        __syncwarp();
      }
      if (tap > 0) {  // the previous tap's wgmmas are done: its stage and its fragments are free
        wgmma_wait<1>();
        keep(af[(tap + 1) % 2]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((step - 1) % kStages));
      }
      if (tap < 8) load_a(af[(tap + 1) % 2], a_chunk, tap + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    keep(af[0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ((chunk * 9 + 8) % kStages));
    __syncthreads();  // the next chunk's patch is whole; this one's patch and the raw tile are free
    if (producer && chunk + 2 < chunks) load_raw(chunk + 2);
  }

  // accumulator rows are pixels g and g + 8 of the warp's pixel row; columns 2t, 2t + 1 of each n-tile of 8
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = y0 + wg * 8 + 4 * i + warp;
    if (gy >= h) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gx = x0 + g + 8 * hh;
      if (gx >= wd) continue;
      bf16* op = out + (((size_t)n * h + gy) * wd + gx) * co;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = co0 + nt * 8 + 2 * t4;
        if (col >= co) continue;
        *reinterpret_cast<__nv_bfloat162*>(op + col) =
            __floats2bfloat162_rn(acc[i][4 * nt + 2 * hh] + __ldg(bias + col),
                                  acc[i][4 * nt + 2 * hh + 1] + __ldg(bias + col + 1));
      }
    }
  }
}

// The channel tile: 128 where Co is a multiple of it, else 64.
int tile_n(int co) { return co % 128 == 0 ? 128 : 64; }

template <int BN>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w, const void* bias, void* out, int n,
                   int h, int wd, int c, int co, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const size_t bytes = Smem<BN>::bytes((c + KC - 1) / KC * KC);
  if (bytes > 232448) return cudaErrorInvalidValue;
  Maps maps;
  const cuuint64_t xdims[4] = {(cuuint64_t)c, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xstrides[3] = {(cuuint64_t)c * 2, (cuuint64_t)wd * c * 2, (cuuint64_t)h * wd * c * 2};
  const cuuint32_t xbox[4] = {KC, PW, PH, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)co, (cuuint64_t)c, 9};
  const cuuint64_t wstrides[2] = {(cuuint64_t)co * 2, (cuuint64_t)c * co * 2};
  const cuuint32_t wbox[3] = {64, KC, 1};
  if (!tiled_map(&maps.x, x, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tiled_map(&maps.w, w, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto fn = kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH, co_tiles = (co + BN - 1) / BN;
  const long long blocks = (long long)n * tiles_y * tiles_x * co_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, kThreads, bytes, stream>>>(maps, static_cast<const float*>(a), static_cast<const float*>(b),
                                                   static_cast<const float*>(bias), static_cast<bf16*>(out), h, wd,
                                                   c, co, tiles_x, tiles_y, co_tiles);
  return cudaGetLastError();
}

template <int BN>
cudaError_t occupancy(int c, int* smem_bytes, int* blocks_per_sm) {
  const size_t bytes = Smem<BN>::bytes((c + KC - 1) / KC * KC);
  *smem_bytes = (int)bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel<BN>, kThreads, bytes);
}

}  // namespace gnconv_wg

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
// bias: (co) f32. c and co are multiples of 32; in bf16, x and w start on 16
// bytes. Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int gn_silu_conv3x3(const void* x, const void* a, const void* b, const void* w,
                               const void* bias, void* out, int n, int h, int wd, int c, int co,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 32 != 0 || co % 32 != 0 || n < 1 || h < 1 || wd < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) return static_cast<int>(gnconv_f32::launch(x, a, b, w, bias, out, n, h, wd, c, co, s));
  return static_cast<int>(gnconv_wg::tile_n(co) == 128
                              ? gnconv_wg::launch<128>(x, a, b, w, bias, out, n, h, wd, c, co, s)
                              : gnconv_wg::launch<64>(x, a, b, w, bias, out, n, h, wd, c, co, s));
}

// The bf16 form at channel tile bn (64 or 128) and c input channels: the
// shared memory a block takes and how many of its blocks fit on one SM,
// registers and shared memory together (for reports). Returns a cudaError_t.
extern "C" int gn_silu_conv3x3_occupancy(int bn, int c, int* smem_bytes, int* blocks_per_sm) {
  if (bn == 128) return static_cast<int>(gnconv_wg::occupancy<128>(c, smem_bytes, blocks_per_sm));
  if (bn == 64) return static_cast<int>(gnconv_wg::occupancy<64>(c, smem_bytes, blocks_per_sm));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The channel tile (64 or 128) the bf16 launcher takes for co output channels.
extern "C" int gn_silu_conv3x3_tile_n(int co) { return gnconv_wg::tile_n(co); }
