// Fused GroupNorm + SiLU + 3x3 SAME convolution for Hopper (sm_90a), bound to
// PyTorch through a plain C launcher loaded with ctypes
// (instarevive_tpu_torch/ops/gn_conv.py).
//
// Replaces the Pallas TPU kernel `_kernel` of instarevive_tpu/ops/gn_conv.py
// (reached through `_fused_call` and `gn_silu_conv3x3`):
//   out = conv3x3_SAME(silu(x * a + b), w) + bias
// with x (N, H, W, C) NHWC, w (3, 3, C, Co) HWIO, a and b the
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
// * f32 (namespace gnconv_tf32; every f32 trainer's VAE encode, the f32
//   restoration path): the same implicit GEMM on the tensor cores' TF32 path,
//   with f32 accuracy kept by splitting, as the f32 attention forms do
//   (flash_attn_fwd.cu): every operand is held as hi = tf32(v) and lo =
//   tf32(v - hi), and every product is lo.hi + hi.lo + hi.hi in that order,
//   each tf32 product exact, lo.lo (about 2^-22 of a product) dropped. Torch's
//   own TF32 stays off.
//   - Weights: a tf32 operand of wgmma is read from shared memory K-major
//     only, so the kernel reads w's hi and lo planes in OHWI order, (Co, 3, 3,
//     C) with channels contiguous, made once per module by the split prepass
//     (tf32_planes.cu). A 3-D tensor map over each, seen as (C, 9, Co), brings
//     one tap x 16 channels x BN output channels, rows of 64 bytes under the
//     64-byte swizzle, into a stage (both planes: 16 KB at BN = 128); nine
//     stages in a ring under full and empty mbarriers, refilled by thread 0 as
//     in the bf16 form (nine, a stage a tap: a tap's stage and phase are then
//     known when the tap loop unrolls, which was 6% faster than six).
//   - Activations: the 4-D tensor map brings the raw f32 patch of a chunk of
//     16 channels with its halo; silu(x * a + b), with the plain version's two
//     roundings, is applied once a chunk, zero outside the image, and split
//     into hi and lo then (once a value, never once a tap), into one of two
//     activated patches; the next chunk's is made a sixth at a time during
//     taps 3-8 of this one. A position's 16 channels are 8 units of 16 bytes,
//     unit 4 s + t holding channels 8 s + t and 8 s + t + 4 as (hi, hi, lo,
//     lo), XOR-swizzled by the position's parity: a thread's A fragment of a
//     k-step is two 16-byte loads, conflict-free, taken into registers (rs).
//     A K-major shared A could not follow a tap's shifted rows (8-row core
//     matrices would fall 8 then 10 positions apart).
//   - Products: a block is 8 x 16 output pixels and BN output channels; each
//     warpgroup holds one m64 tile of 4 pixel rows (a warp's 16 A rows are
//     one pixel row). Each k-step of 8 channels is three m64nBNk8 wgmmas. The
//     tensor cores' f32 sums truncate, and one output sums 3 x 9C / 8 of them
//     (1,728 at C = 512), so each chunk's products run into fresh
//     accumulators that one round-to-nearest f32 add folds into the running
//     sums (64 + 64 registers a thread at BN = 128; that is why a warpgroup
//     holds one m64 tile, not the bf16 form's two).
//   BN as in the bf16 form. No atomics: the output repeats bit for bit.
//
// Bias is added in f32 and the result rounded once to x's type. Ragged H, W
// and Co are masked at the store; C is a multiple of 32 (the f32 form's
// 16-channel chunks divide it), never padded in device memory. The TPU
// kernel's row strips, its (W+4)-padded flat scratch, its in-VMEM im2col and
// its C % 128 rule answered VMEM and lane constraints that this card does not
// have.
//
// What bounds it on this card: at the VAE's shapes (C, Co in 128..512) the
// work is 9 * C * Co / (C + Co) > 500 operations per byte moved, above the
// H100's bf16 ridge (~295), so the tensor cores bound it in principle; the
// bf16 kernel reaches 40-48% of their peak. The 256-pixel tile halves the weight
// bytes read from L2 per operation against the 128-pixel tile of the
// mma.sync form this replaces. What holds it back, measured on edited copies
// (tools/time_gn_conv.py, PERF.md): the activation, which costs 17-32% of the
// time whichever warps run it (a third warpgroup doing it under setmaxnreg
// gained nothing), and at C = 128 each block's start (the first patch's copy
// and activation) and end. A persistent schedule, A read by wgmma from a
// swizzled shared patch, and a producer warpgroup were each tried and were
// slower or no faster. The f32 form does three tf32 products for each f32
// one at half the bf16 rate, so operations bound it at 6x the bf16 bound; on
// an H100 (700 W, tools/time_gn_conv.py --dtype f32) it took 0.832 ms at 4 x
// 64 x 64 x 512 -> 512, 56% of that bound (cuDNN's f32 convolution 1.83, the
// FMA form it replaced 2.91). Without the fold it was 1.2% faster with 8x
// the error (1.2e-4 against the 2e-4 bound); two m64 tiles a warpgroup, which
// registers allow only without it, 14% faster than a six-stage form. The
// kernels are forward-only, like the TPU kernel; the wrapper differentiates
// the plain composition.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

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
// f32: split-tf32 wgmma on TMA-fed weight planes.

namespace gnconv_tf32 {

using namespace hopper;

constexpr int TH = 8, TW = 16;            // output pixels of one block: a warp's 16 A rows are a pixel row
constexpr int PH = TH + 2, PW = TW + 2;   // the patch with its halo
constexpr int NPOS = PH * PW;
constexpr int kThreads = 256;             // two warpgroups, one m64 tile of 4 pixel rows each
constexpr int KC = 16;                    // input channels a chunk: one 64-byte row of a weight box
constexpr int kUnits = KC / 2;            // 16-byte units of an activated patch position (KC values, hi and lo)
constexpr int kVecs = NPOS * kUnits;
constexpr int kStages = 9;                // the weight ring: a stage a tap, so a tap's stage is known when it compiles
constexpr int kFirstSliceTap = 3;         // taps 3-8 activate the next chunk, a sixth each
constexpr int kSlice = kVecs / (9 - kFirstSliceTap);
static_assert(kVecs % (9 - kFirstSliceTap) == 0, "equal slices");
constexpr uint32_t kRawBytes = NPOS * KC * 4, kPatchBytes = NPOS * kUnits * 16;

// Shared memory from a 1024-byte aligned base: the weight ring, the raw patch,
// two activated patches, 2 kStages + 1 barriers, then a and b of the sample.
template <int BN>
struct Smem {
  static constexpr uint32_t kBox = BN * KC * 4;  // one plane's box: BN rows of 64 bytes
  static constexpr uint32_t kStage = 2 * kBox;   // hi, then lo
  static constexpr uint32_t raw = kStages * kStage;
  static constexpr uint32_t patch = raw + (kRawBytes + 127) / 128 * 128;
  static constexpr uint32_t bars = patch + 2 * kPatchBytes;
  static constexpr uint32_t ab = bars + (8 * (2 * kStages + 1) + 15) / 16 * 16;
  static size_t bytes(int c) { return 1024 + ab + sizeof(float) * 2 * c; }
};

struct Maps {  // x as (C, W, H, N), boxes of 16 x PW x PH x 1; the weight planes as (C, 9, Co), boxes of 16 x 1 x BN
  CUtensorMap x, w[2];
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ Maps maps, const float* __restrict__ a, const float* __restrict__ b,
       const float* __restrict__ bias, float* __restrict__ out, int h, int wd, int c, int co, int tiles_x,
       int tiles_y, int co_tiles) {
  using S = Smem<BN>;
  constexpr int kAcc = BN / 2;  // accumulators a thread holds per m64 tile
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + (1024 - smem_u32(smem) % 1024) % 1024;
  const uint32_t sW = smem_u32(base), sRaw = sW + S::raw;
  const uint32_t full = sW + S::bars, empty = full + 8 * kStages, rawbar = empty + 8 * kStages;
  const float* raw = reinterpret_cast<const float*>(base + S::raw);
  float4* patch = reinterpret_cast<float4*>(base + S::patch);
  float* sFa = reinterpret_cast<float*>(base + S::ab);
  float* sFb = sFa + c;

  // output-channel tiles vary fastest, so the blocks that share a patch run together and find it in L2
  int blk = blockIdx.x;
  const int co0 = (blk % co_tiles) * BN;
  blk /= co_tiles;
  const int x0 = (blk % tiles_x) * TW;
  blk /= tiles_x;
  const int y0 = (blk % tiles_y) * TH;
  const int n = blk / tiles_y;
  const int chunks = c / KC, steps = 9 * chunks;  // a step is one tap of one chunk
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool producer = threadIdx.x == 0;  // issues every copy

  auto load_w = [&](int step) {
    const int s = step % kStages;
    mbar_expect_tx(full + 8 * s, S::kStage);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      tma_load(sW + s * S::kStage + p * S::kBox, &maps.w[p], full + 8 * s, (step / 9) * KC, step % 9, co0);
  };
  auto load_raw = [&](int chunk) {
    mbar_expect_tx(rawbar, kRawBytes);
    tma_load(sRaw, &maps.x, rawbar, chunk * KC, x0 - 1, y0 - 1, n);
  };
  // silu(x * a + b) of units [v0, v1) of the raw patch (chunk `chunk`), split into tf32 hi and lo, into its
  // patch. Unit j = 4 s + t of a position holds channels k = 8 s + t and k + 4 of the chunk as (hi, hi, lo, lo):
  // a thread's A fragment of k-step s wants channels t and t + 4 of a pixel. It is stored at unit j ^ 4 at an
  // odd position, so the 8 lanes of a quarter warp, pixels g and g + 1 of one k-step, read 8 bank groups.
  auto activate = [&](int chunk, int v0, int v1) {
    float4* dst = patch + (chunk % 2) * kVecs;
    for (int v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const int pos = v / kUnits, j = v % kUnits;
      const int gy = y0 - 1 + pos / PW, gx = x0 - 1 + pos % PW;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        const int k = 8 * (j / 4) + j % 4;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = chunk * KC + k + 4 * e;
          // two roundings, as the plain version's x * a + b
          const float u = __fadd_rn(__fmul_rn(raw[pos * KC + k + 4 * e], sFa[ch]), sFb[ch]);
          y[e] = u * (1.f / (1.f + expf(-u)));
        }
        const float h0 = tf32_rna(y[0]), h1 = tf32_rna(y[1]);
        o = make_float4(h0, h1, tf32_rna(y[0] - h0), tf32_rna(y[1] - h1));
      }
      dst[pos * kUnits + (j ^ (pos & 1) * 4)] = o;
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
  for (int i = threadIdx.x; i < c; i += kThreads) {
    sFa[i] = a[(size_t)n * c + i];
    sFb[i] = b[(size_t)n * c + i];
  }
  __syncthreads();  // the barriers are set up, a and b in place
  mbar_wait(rawbar, 0);
  activate(0, 0, kVecs);
  __syncthreads();  // the first patch is whole and the raw tile free
  if (producer && chunks > 1) load_raw(1);

  // sum: the wgmma accumulators, restarted every chunk; total: the running sums, one f32 add a chunk
  float sum[kAcc], total[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) sum[j] = total[j] = 0.f;
  // this warp's A rows: pixel row 4 wg + warp of the tile, pixels g and g + 8 of it
  const int row = 4 * wg + warp;

  // A fragments of two taps, [tap % 2][k-step][hi, lo]: this tap's, read by its wgmmas while the next tap's
  // load; a0..a3 = (pixel g, channel t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the k-step
  uint32_t af[2][KC / 8][2][4];
  auto load_a = [&](uint32_t (&f)[KC / 8][2][4], const float4* chunk_patch, int tap) {
    const int p = (row + tap / 3) * PW + tap % 3 + g;  // p + 8 has p's parity
    const int sw = (p & 1) * 4;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const float4 r0 = chunk_patch[p * kUnits + ((4 * ks + t) ^ sw)];
      const float4 r8 = chunk_patch[(p + 8) * kUnits + ((4 * ks + t) ^ sw)];
      f[ks][0][0] = __float_as_uint(r0.x);
      f[ks][0][1] = __float_as_uint(r8.x);
      f[ks][0][2] = __float_as_uint(r0.y);
      f[ks][0][3] = __float_as_uint(r8.y);
      f[ks][1][0] = __float_as_uint(r0.z);
      f[ks][1][1] = __float_as_uint(r8.z);
      f[ks][1][2] = __float_as_uint(r0.w);
      f[ks][1][3] = __float_as_uint(r8.w);
    }
  };
  auto keep = [&](uint32_t (&f)[KC / 8][2][4]) {
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      gnconv_wg::keep_regs(f[ks][0]);
      gnconv_wg::keep_regs(f[ks][1]);
    }
  };

  for (int chunk = 0; chunk < chunks; ++chunk) {
    const float4* a_chunk = patch + (chunk % 2) * kVecs;
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
      // the planes' boxes are BN rows of 64 bytes under the 64-byte swizzle: a k-step is 32 bytes along a row
      const uint64_t w_hi = smem_desc(sW + s * S::kStage, 512, kSwizzle64);
      const uint64_t w_lo = smem_desc(sW + s * S::kStage + S::kBox, 512, kSwizzle64);
      fence_regs(sum);
      wgmma_fence();
      // each k-step as lo.hi + hi.lo + hi.hi, the small terms first; the chunk's first product restarts the sums
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        Wgmma32<BN>::rs(sum, af[tap % 2][ks][1], w_hi + 2 * ks, tap > 0 || ks > 0);
        Wgmma32<BN>::rs(sum, af[tap % 2][ks][0], w_lo + 2 * ks, 1);
        Wgmma32<BN>::rs(sum, af[tap % 2][ks][0], w_hi + 2 * ks, 1);
      }
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
    fence_regs(sum);
    keep(af[0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ((chunk * 9 + 8) % kStages));
#pragma unroll
    for (int j = 0; j < kAcc; ++j) total[j] = __fadd_rn(total[j], sum[j]);
    __syncthreads();  // the next chunk's patch is whole; this one's patch and the raw tile are free
    if (producer && chunk + 2 < chunks) load_raw(chunk + 2);
  }

  // accumulator rows are pixels g and g + 8 of the warp's pixel row; columns 2t, 2t + 1 of each n-tile of 8
  const int gy = y0 + row;
  if (gy >= h) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gx = x0 + g + 8 * hh;
    if (gx >= wd) continue;
    float* op = out + (((size_t)n * h + gy) * wd + gx) * co;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = co0 + nt * 8 + 2 * t;
      if (col >= co) continue;
      *reinterpret_cast<float2*>(op + col) = make_float2(total[4 * nt + 2 * hh] + __ldg(bias + col),
                                                         total[4 * nt + 2 * hh + 1] + __ldg(bias + col + 1));
    }
  }
}

// The channel tile: 128 where Co is a multiple of it, else 64.
int tile_n(int co) { return co % 128 == 0 ? 128 : 64; }

template <int BN>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w_hi, const void* w_lo,
                   const void* bias, void* out, int n, int h, int wd, int c, int co, cudaStream_t stream) {
  using S = Smem<BN>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const size_t bytes = S::bytes(c);
  if (bytes > 232448) return cudaErrorInvalidValue;
  Maps maps;
  const cuuint64_t xdims[4] = {(cuuint64_t)c, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xstrides[3] = {(cuuint64_t)c * 4, (cuuint64_t)wd * c * 4, (cuuint64_t)h * wd * c * 4};
  const cuuint32_t xbox[4] = {KC, PW, PH, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)c, 9, (cuuint64_t)co};
  const cuuint64_t wstrides[2] = {(cuuint64_t)c * 4, (cuuint64_t)c * 9 * 4};
  const cuuint32_t wbox[3] = {KC, 1, BN};
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!tiled_map(&maps.x, x, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE, f32) ||
      !tiled_map(&maps.w[0], w_hi, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B, f32) ||
      !tiled_map(&maps.w[1], w_lo, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B, f32))
    return cudaErrorInvalidValue;
  auto fn = kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH, co_tiles = (co + BN - 1) / BN;
  const long long blocks = (long long)n * tiles_y * tiles_x * co_tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, kThreads, bytes, stream>>>(maps, static_cast<const float*>(a), static_cast<const float*>(b),
                                                   static_cast<const float*>(bias), static_cast<float*>(out), h, wd,
                                                   c, co, tiles_x, tiles_y, co_tiles);
  return cudaGetLastError();
}

template <int BN>
cudaError_t occupancy(int c, int* smem_bytes, int* blocks_per_sm) {
  const size_t bytes = Smem<BN>::bytes(c);
  *smem_bytes = (int)bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel<BN>, kThreads, bytes);
}

}  // namespace gnconv_tf32

}  // namespace

// x: (n, h, wd, c) and out: (n, h, wd, co), contiguous NHWC bf16 (is_bf16
// must be 1: gn_silu_conv3x3_f32 takes f32; the flag stays so that an older
// build, which took f32 here, binds the same way); w: (9 * c, co) bf16; a, b:
// (n, c) f32; bias: (co) f32. c and co are multiples of 32; x and w start on
// 16 bytes. Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int gn_silu_conv3x3(const void* x, const void* a, const void* b, const void* w,
                               const void* bias, void* out, int n, int h, int wd, int c, int co,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16 || c % 32 != 0 || co % 32 != 0 || n < 1 || h < 1 || wd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gnconv_wg::tile_n(co) == 128
                              ? gnconv_wg::launch<128>(x, a, b, w, bias, out, n, h, wd, c, co, s)
                              : gnconv_wg::launch<64>(x, a, b, w, bias, out, n, h, wd, c, co, s));
}

// The f32 form: x and out as above in f32; w_hi, w_lo: the weight's split-tf32
// planes (tf32_planes.cu), each (co, 3, 3, c) f32 (OHWI: channels contiguous);
// a, b, bias as above. Returns a cudaError_t.
extern "C" int gn_silu_conv3x3_f32(const void* x, const void* a, const void* b, const void* w_hi, const void* w_lo,
                                   const void* bias, void* out, int n, int h, int wd, int c, int co, void* stream) {
  using namespace gnconv_tf32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 32 != 0 || co % 32 != 0 || n < 1 || h < 1 || wd < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tile_n(co) == 128 ? launch<128>(x, a, b, w_hi, w_lo, bias, out, n, h, wd, c, co, s)
                                            : launch<64>(x, a, b, w_hi, w_lo, bias, out, n, h, wd, c, co, s));
}

// The bf16 form at channel tile bn (64 or 128) and c input channels: the
// shared memory a block takes and how many of its blocks fit on one SM,
// registers and shared memory together (for reports). Returns a cudaError_t.
extern "C" int gn_silu_conv3x3_occupancy(int bn, int c, int* smem_bytes, int* blocks_per_sm) {
  if (bn == 128) return static_cast<int>(gnconv_wg::occupancy<128>(c, smem_bytes, blocks_per_sm));
  if (bn == 64) return static_cast<int>(gnconv_wg::occupancy<64>(c, smem_bytes, blocks_per_sm));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for the f32 form.
extern "C" int gn_silu_conv3x3_occupancy_f32(int bn, int c, int* smem_bytes, int* blocks_per_sm) {
  using namespace gnconv_tf32;
  if (bn == 128) return static_cast<int>(occupancy<128>(c, smem_bytes, blocks_per_sm));
  if (bn == 64) return static_cast<int>(occupancy<64>(c, smem_bytes, blocks_per_sm));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The channel tile (64 or 128) either launcher takes for co output channels.
extern "C" int gn_silu_conv3x3_tile_n(int co) { return gnconv_wg::tile_n(co); }
