// Swin window attention on a fused NHWC qkv map for Hopper (sm_90a), bound to
// PyTorch through a plain C launcher loaded with ctypes
// (instarevive_tpu_torch/ops/swin_attention.py).
//
// Replaces the Pallas TPU kernel `_kernel` in
// instarevive_tpu/ops/swin_attention.py (reached through
// `swin_window_attention`): for every 8 x 8 window of a (B, H, W, 3C) map
// and every head, softmax(q k^T * scale + bias[h] + mask[window]) v with f32
// scores, softmax and P.V, written to (B, H, W, C) in the input's type. The
// window partition, the head split, the bias and mask, the softmax and the
// head merge all stay in shared memory and registers.
//
// Unlike the TPU kernel, the cyclic shift of a shifted block is inside: a
// block computes its own addresses, so token (y, x) of the rolled map is read
// from ((y + shift) mod H, (x + shift) mod W) and its output is written back
// there. No rolled copy of the map is ever made.
//
// What bounds it on this card: bytes, and below them the launch. One SwinIR
// block at 4 x 64 x 64 x 180 is 0.75 GFLOP against 24 MB moved (about 30
// FLOP/byte, a tenth of the bf16 ridge point), and at 3.35 TB/s those bytes
// take under 0.01 ms, about the cost of a launch. So the design spends
// nothing on the tensor-core rate and everything on touching device memory
// once: a window's q, k and v rows come in once, coalesced along C, straight
// into per-head tiles; scores and P never leave registers; the bias (98 KB
// for 6 heads) and the mask are read from L2 by every block.
//
// Two forms:
// * bf16: grid (windows, head groups). A block stages q, k, v of its heads as
//   64 x 32 tiles (head dim zero-padded to 32 in shared memory only, rows of
//   80 bytes so the 8 rows of an ldmatrix fall on 8 bank groups). A token's
//   row is 6C bytes and a head starts hd * 2 bytes into it, so global
//   accesses are 4-byte words: that alignment holds for every even head dim
//   and every shifted, wrapped window row, where 16 bytes would not. Each
//   warp then takes (head, 16 query rows) tasks: Q.K^T as mma.sync m16n8k16
//   (bf16 x bf16 -> f32), bias and mask added to the f32 fragment, row
//   softmax with shuffles, and P.V with P split into two bf16 terms
//   (hi = bf16(p), lo = bf16(p - hi)), two MMAs per tile. P therefore keeps
//   16 bits of mantissa and v is exact, so the result differs from an f32
//   P.V only in the order of the sums; the TPU kernel keeps P in f32 too.
// * f32: grid (windows, heads), plain FMAs on odd-strided shared tiles, the
//   64 x 64 scores in shared memory; 42 KB of static shared memory a block.
//
// Window 8 and head dims up to 32 (even in bf16) only; the launcher refuses
// anything else.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWin = 8;           // window side
constexpr int kN = kWin * kWin;   // tokens of a window
constexpr int kDP = 32;           // head dim as the tiles hold it

// Pixel index (b * H + y) * W + x of token r of window `win` of the map
// rolled by -shift: the pixel the token comes from and goes back to.
__device__ __forceinline__ int token_pixel(int win, int r, int H, int W, int shift) {
  const int gw = W / kWin, per_image = (H / kWin) * gw;
  const int b = win / per_image, wi = win % per_image;
  int y = (wi / gw) * kWin + r / kWin + shift;
  int x = (wi % gw) * kWin + r % kWin + shift;
  if (y >= H) y -= H;
  if (x >= W) x -= W;
  return (b * H + y) * W + x;
}

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

// (lo, hi) rounded to bf16 as one register, and what the rounding dropped.
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& head, uint32_t& tail) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo - __low2float(h), hi - __high2float(h));
  head = *reinterpret_cast<const uint32_t*>(&h);
  tail = *reinterpret_cast<const uint32_t*>(&t);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, scores and P in registers.

namespace swin_tc {

constexpr int LDS = 40;          // tile row stride in elements: 80 bytes
constexpr int kTile = kN * LDS;  // elements of one (part, head) tile
constexpr int kMaxThreads = 256;

constexpr size_t smem_bytes(int hpb) { return sizeof(bf16) * 3 * hpb * kTile + sizeof(int) * kN; }

__global__ void __launch_bounds__(kMaxThreads, 2)
kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
       bf16* __restrict__ out, int H, int W, int heads, int hd, int hpb, int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sT = reinterpret_cast<bf16*>(smem);  // [q, k, v][head of the group][token][LDS]
  int* sPix = reinterpret_cast<int*>(sT + 3 * hpb * kTile);

  const int win = blockIdx.x, h0 = blockIdx.y * hpb;
  const int C = heads * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;

  if (threadIdx.x < kN) sPix[threadIdx.x] = token_pixel(win, threadIdx.x, H, W, shift);
  // zero the pad lanes [hd, 32) of every tile row: Q.K^T contracts over them
  // and P.V writes columns from them
  const int pad_words = (kDP - hd) / 2;
  if (pad_words > 0) {
    for (int i = threadIdx.x; i < 3 * hpb * kN * pad_words; i += blockDim.x) {
      const int row = i / pad_words, j = i % pad_words;
      *reinterpret_cast<uint32_t*>(sT + row * LDS + hd + 2 * j) = 0u;
    }
  }
  __syncthreads();

  // A warp per token: the 3 * hpb * hd values of the group's heads, as 4-byte
  // words, each to its (part, head) tile.
  const int wpp = hpb * hd / 2;  // words per token and part
  const float inv_hd = 1.f / hd;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(qkv);
  for (int tok = warp; tok < kN; tok += nwarps) {
    const uint32_t* row = src + ((size_t)sPix[tok] * 3 * C + h0 * hd) / 2;
    for (int r = lane; r < 3 * wpp; r += 32) {
      const int part = r >= 2 * wpp ? 2 : (r >= wpp ? 1 : 0);
      const int w = r - part * wpp;
      const int hl = static_cast<int>((2 * w + 0.5f) * inv_hd);  // exact: 2w < 1024
      const int d = 2 * w - hl * hd;
      *reinterpret_cast<uint32_t*>(sT + ((part * hpb + hl) * kN + tok) * LDS + d) = __ldg(row + part * (C / 2) + w);
    }
  }
  __syncthreads();

  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  const int per_image = (H / kWin) * (W / kWin);
  const float* mw = mask == nullptr ? nullptr : mask + (size_t)(win % per_image) * kN * kN;

  for (int task = warp; task < hpb * 4; task += nwarps) {
    const int hl = task / 4, rt = task % 4;  // head of the group, 16-row tile of the window
    const bf16* tq = sT + hl * kTile;
    const bf16* tk = sT + (hpb + hl) * kTile;
    const bf16* tv = sT + (2 * hpb + hl) * kTile;

    // S = Q K^T, 16 x 64
    uint32_t qf[kDP / 16][4];
#pragma unroll
    for (int ks = 0; ks < kDP / 16; ++ks)
      ldsm_x4(qf[ks], tq + (rt * 16 + lane % 16) * LDS + ks * 16 + (lane / 16) * 8);
    float s[kN / 8][4];
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDP / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, tk + (np * 16 + (lane / 16) * 8 + lane % 8) * LDS + ks * 16 + ((lane / 8) % 2) * 8);
        mma(s[2 * np], qf[ks], b[0], b[1]);
        mma(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // scale, bias, mask; this thread holds rows g and g + 8 of the tile
    const float* bh = bias + (size_t)(h0 + hl) * kN * kN;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (rt * 16 + g + 8 * r) * kN + nt * 8 + 2 * t;
        float2 add = __ldg(reinterpret_cast<const float2*>(bh + at));
        if (mw != nullptr) {
          const float2 m = __ldg(reinterpret_cast<const float2*>(mw + at));
          add.x += m.x;
          add.y += m.y;
        }
        s[nt][2 * r] = s[nt][2 * r] * scale + add.x;
        s[nt][2 * r + 1] = s[nt][2 * r + 1] * scale + add.y;
        mx[r] = fmaxf(mx[r], fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }

    // P = exp(S - max) as two bf16 terms in mma A-fragment order: n-tile pairs
    // become 16-key k-steps
    float sum[2] = {0.f, 0.f};
    uint32_t p_hi[kN / 16][4], p_lo[kN / 16][4];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = __expf(s[nt][2 * r] - mx[r]), p1 = __expf(s[nt][2 * r + 1] - mx[r]);
        sum[r] += p0 + p1;
        split_bf16(p0, p1, p_hi[nt / 2][(nt % 2) * 2 + r], p_lo[nt / 2][(nt % 2) * 2 + r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }

    // O = P V, 16 x 32
    float o[kDP / 8][4];
#pragma unroll
    for (int i = 0; i < kDP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
    for (int c = 0; c < kN / 16; ++c) {
#pragma unroll
      for (int dp = 0; dp < kDP / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, tv + (c * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDS + dp * 16 + (lane / 16) * 8);
        mma(o[2 * dp], p_hi[c], b[0], b[1]);
        mma(o[2 * dp + 1], p_hi[c], b[2], b[3]);
        mma(o[2 * dp], p_lo[c], b[0], b[1]);
        mma(o[2 * dp + 1], p_lo[c], b[2], b[3]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / sum[r];
      bf16* orow = out + (size_t)sPix[rt * 16 + g + 8 * r] * C + (h0 + hl) * hd;
#pragma unroll
      for (int dt = 0; dt < kDP / 8; ++dt) {
        const int col = dt * 8 + 2 * t;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
      }
    }
  }
}

cudaError_t launch(const void* qkv, const void* bias, const void* mask, void* out, int windows, int H, int W,
                   int heads, int hd, int hpb, int shift, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(hpb);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(windows, heads / hpb);
  kernel<<<grid, hpb >= 2 ? kMaxThreads : 128, bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<bf16*>(out), H, W, heads, hd, hpb, shift, scale);
  return cudaGetLastError();
}

}  // namespace swin_tc

// ---------------------------------------------------------------------------
// f32: plain FMAs, one block per (window, head), scores in shared memory.

namespace swin_f32 {

constexpr int kThreads = 256;
constexpr int LD = kDP + 1;   // q, k, v rows of 33 words: conflict-free column walks
constexpr int LDSS = kN + 1;  // score rows of 65 words

__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
       float* __restrict__ out, int H, int W, int heads, int hd, int shift, float scale) {
  __shared__ float sQ[kN * LD], sK[kN * LD], sV[kN * LD], sS[kN * LDSS];
  __shared__ int sPix[kN];
  const int win = blockIdx.x, head = blockIdx.y, C = heads * hd;
  const int tid = threadIdx.x;

  if (tid < kN) sPix[tid] = token_pixel(win, tid, H, W, shift);
  __syncthreads();
  for (int tok = tid / 8; tok < kN; tok += kThreads / 8) {  // 8 threads walk a token's head slice
    const float* row = qkv + (size_t)sPix[tok] * 3 * C + head * hd;
    for (int d = tid % 8; d < hd; d += 8) {
      sQ[tok * LD + d] = __ldg(row + d);
      sK[tok * LD + d] = __ldg(row + C + d);
      sV[tok * LD + d] = __ldg(row + 2 * C + d);
    }
  }
  __syncthreads();

  {  // scores: a thread takes rows 4 * i4 .. + 3 and columns j4, j4 + 16, ..
    const int i4 = tid / 16, j4 = tid % 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(4 * i4 + i) * LD + d];
        kv[i] = sK[(j4 + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
    const float* bh = bias + (size_t)head * kN * kN;
    const int per_image = (H / kWin) * (W / kWin);
    const float* mw = mask == nullptr ? nullptr : mask + (size_t)(win % per_image) * kN * kN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = 4 * i4 + i, col = j4 + 16 * j;
        float add = __ldg(bh + row * kN + col);
        if (mw != nullptr) add += __ldg(mw + row * kN + col);
        sS[row * LDSS + col] = acc[i][j] * scale + add;
      }
    }
  }
  __syncthreads();

  {  // softmax: a warp takes 8 rows, a lane two columns of each
    const int warp = tid / 32, lane = tid % 32;
    for (int row = warp * 8; row < warp * 8 + 8; ++row) {
      float a = sS[row * LDSS + lane], b = sS[row * LDSS + lane + 32];
      float m = fmaxf(a, b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      a = expf(a - m);
      b = expf(b - m);
      float sum = a + b;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float inv = 1.f / sum;
      sS[row * LDSS + lane] = a * inv;
      sS[row * LDSS + lane + 32] = b * inv;
    }
  }
  __syncthreads();

  {  // O = P V: 4 threads a row, each the columns dpart, dpart + 4, ..
    const int row = tid / 4, dpart = tid % 4;
    float o[kDP / 4];
#pragma unroll
    for (int i = 0; i < kDP / 4; ++i) o[i] = 0.f;
    for (int j = 0; j < kN; ++j) {
      const float p = sS[row * LDSS + j];
#pragma unroll
      for (int i = 0; i < kDP / 4; ++i)
        if (dpart + 4 * i < hd) o[i] = fmaf(p, sV[j * LD + dpart + 4 * i], o[i]);
    }
    float* orow = out + (size_t)sPix[row] * C + head * hd;
#pragma unroll
    for (int i = 0; i < kDP / 4; ++i)
      if (dpart + 4 * i < hd) orow[dpart + 4 * i] = o[i];
  }
}

cudaError_t launch(const void* qkv, const void* bias, const void* mask, void* out, int windows, int H, int W,
                   int heads, int hd, int shift, float scale, cudaStream_t stream) {
  const dim3 grid(windows, heads);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<float*>(out), H, W, heads, hd, shift, scale);
  return cudaGetLastError();
}

}  // namespace swin_f32

}  // namespace

// qkv: (b, h, w, 3 * heads * hd) contiguous, lanes [q heads.., k heads.., v heads..],
// bf16 when is_bf16, else f32; bias: (heads, 64, 64) f32; mask:
// ((h / 8) * (w / 8), 64, 64) f32 or null; out: (b, h, w, heads * hd) of qkv's
// type. heads_per_block (bf16 only) must divide heads. Returns a cudaError_t;
// 0 means the launch was accepted.
extern "C" int swin_window_attention(const void* qkv, const void* bias, const void* mask, void* out, int b,
                                     int h, int w, int heads, int hd, int window, int shift, float scale,
                                     int heads_per_block, int is_bf16, void* stream) {
  if (window != kWin || h % kWin || w % kWin || b < 1 || h < kWin || w < kWin || heads < 1 || hd < 1 ||
      hd > kDP || shift < 0 || shift >= kWin || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int windows = b * (h / kWin) * (w / kWin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return swin_f32::launch(qkv, bias, mask, out, windows, h, w, heads, hd, shift, scale, s);
  if (hd % 2 || heads_per_block < 1 || heads % heads_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  return swin_tc::launch(qkv, bias, mask, out, windows, h, w, heads, hd, heads_per_block, shift, scale, s);
}
