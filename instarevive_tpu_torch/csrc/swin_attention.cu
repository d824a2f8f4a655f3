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
// What bounds it on this card: bytes, and below them the latency of the
// products. One SwinIR block at 4 x 64 x 64 x 180 is 0.75 GFLOP against 24 MB
// moved (about 30 FLOP/byte, a tenth of the bf16 ridge point), and at 3.35
// TB/s those bytes take 7.4 us; but a (head, 16-row) task is a chain of
// dependent steps (Q.K^T, bias, row max and sum, P.V), so the design spends
// its shared memory on keeping two blocks on every SM, whose copies and
// products overlap:
// * Persistent blocks: the grid is at most what the card holds at once (two
//   blocks of 8 warps an SM; one of 16 warps where the items are no more than
//   the SMs), and a block walks work items with the grid's stride. An item is
//   a window with a group of G heads (the wrapper picks G by the shape).
// * A ring of S slots in shared memory, each the per-head tiles of one item,
//   as many as fit beside the other block (one at 6 bf16 heads of 30). A
//   block fills every slot before its first item and refills a slot with the
//   item S ahead once the slot's item is stored. The copies are cp.async of
//   4-byte words straight from the qkv rows into the tiles (a head starts hd
//   elements into a token's q, k or v part: 4-byte aligned, never 16, so TMA
//   tensor maps cannot describe the rows, and 1-D bulk copies of whole window
//   rows need a second copy in shared memory to reach the tiles), all of an
//   item's issued at once; each thread's completion is counted on the slot's
//   mbarrier (cp.async.mbarrier.arrive), whose phase flips on every fill.
// * Tiles: bf16 q, k, v of each head as 64 x 32 tiles with rows of 80 bytes
//   (ldmatrix's 8 rows on 8 bank groups), [part][head]; f32 q and k as 64 x
//   32 tiles with rows of 144 bytes and v transposed, 32 x 64 with rows of 272
//   bytes. k's and v's rows are held in key_row order, which gives each lane
//   four consecutive keys a 16-key chunk, so that its bias and mask come as
//   one float4 each (with __ldg at the task's start, their latency under
//   Q.K^T); the f32 v^T columns are further in the order PERM8 within each 8,
//   so that one ldmatrix gives P.V's B fragment. Columns and rows past hd
//   stay zero from the block's start.
// * Output: each task writes its rows over its own q rows of the tile; the
//   block then stores the item a token at a time, a warp's lanes on the
//   token's contiguous output words.
//
// Two forms, one skeleton; each warp takes (head, 16 query rows) tasks:
// * bf16 (namespace swin16): Q.K^T as mma.sync m16n8k16 (bf16 x bf16 -> f32),
//   bias and mask added to the f32 fragment, row softmax with shuffles, and
//   P.V with P split into two bf16 terms (hi = bf16(p), lo = bf16(p - hi)),
//   two MMAs per tile. P keeps 16 bits of mantissa and v is exact, so the
//   result differs from an f32 P.V only in the order of the sums.
// * f32 (namespace swin_tf32): the same tasks on mma.sync m16n8k8 .tf32 with
//   split operands: each f32 value x is hi = tf32(x) and lo = tf32(x - hi),
//   and every product is lo.hi + hi.lo + hi.hi (lo.lo, about 2^-22 of it,
//   dropped). P's accumulator columns 2t, 2t + 1 become the A fragment's k =
//   t, t + 4 (hopper::split_fragment). The sums are 64 and at most 32
//   products long, with no per-chunk fold.
//
// Window 8, any head count, head dims up to 32 (even in bf16), any shift in
// [0, 8), H and W multiples of 8; the launcher refuses anything else.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWin = 8;           // window side
constexpr int kN = kWin * kWin;   // tokens of a window
constexpr int kDP = 32;           // largest head dim
constexpr int kThreads = 256;     // 8 warps a block; 16 where the items are no more than the SMs
constexpr int kMaxThreads = 512;  // both held to 128 registers
constexpr int kMaxSlots = 4;      // ring depth
constexpr int kHeader = 128;      // the slots' mbarriers
constexpr int kSmemLimit = 232448;  // a block's shared memory
constexpr int kSmemSm = 233472;     // an SM's, of which each block reserves 1 KB more
constexpr int kLd16 = 40, kLd32 = 36, kLdV = 68;  // tile row strides, elements
constexpr int kRowUnits = 288;  // most 4-byte units of an item's part of a token row: 3 G hd <= 3 x 192 bf16, 3 x 96 f32
constexpr int kMaxJ = kRowUnits / 32;
constexpr int kMaxOut = kRowUnits / 3 / 32;  // the same for its output

struct Params {
  const void* qkv;
  const float* bias;
  const float* mask;
  void* out;
  int H, W, heads, hd, G, groups, shift, items, slots, slot_bytes;
  float scale;
};

__device__ __forceinline__ int wrap(int v, int n) { return v >= n ? v - n : v; }

// Where item `item`'s window lies: image, window row and column.
struct Where {
  int win, h0, b, wy, wx;
  __device__ Where(const Params& p, int item) {
    win = item / p.groups;
    h0 = (item % p.groups) * p.G;
    const int gw = p.W / kWin, per_image = (p.H / kWin) * gw;
    b = win / per_image;
    const int wi = win % per_image;
    wy = wi / gw;
    wx = wi % gw;
  }
  // pixel index (b * H + y) * W + x of token r of the rolled window
  __device__ size_t pixel(const Params& p, int r) const {
    const int y = wrap(wy * kWin + r / kWin + p.shift, p.H), x = wrap(wx * kWin + r % kWin + p.shift, p.W);
    return ((size_t)b * p.H + y) * p.W + x;
  }
};

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
#ifdef SWIN_ABLATE_NO_PRODUCTS  // tools/time_swin_attention.py's ablation: operands read, no product
  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x007fffffu);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
#ifdef SWIN_ABLATE_NO_PRODUCTS
  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x007fffffu);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

// lo.hi + hi.lo + hi.hi of split operands
__device__ __forceinline__ void mma8x3(float (&d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4], uint32_t bhi0,
                                       uint32_t bhi1, uint32_t blo0, uint32_t blo1) {
  mma8(d, alo, bhi0, bhi1);
  mma8(d, ahi, blo0, blo1);
  mma8(d, ahi, bhi0, bhi1);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = hopper::tf32_rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(hopper::tf32_rna(x - h));
}

// (lo, hi) rounded to bf16 as one register, and what the rounding dropped.
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& head, uint32_t& tail) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo - __low2float(h), hi - __high2float(h));
  head = *reinterpret_cast<const uint32_t*>(&h);
  tail = *reinterpret_cast<const uint32_t*>(&t);
}

// The bias plus the mask at this thread's score fragment (rows g and g + 8
// of the 16-row tile rt; in 16-key chunk c the keys 16 c + 4t .. + 3, at
// columns 2t, 2t + 1 of n-tiles 2c and 2c + 1: see key_row), one float4 of
// each a chunk, loaded at a task's start so that their latency runs under
// Q.K^T.
__device__ __forceinline__ void additive(float2 (&add)[kN / 8][2], const float* bh, const float* mw, int rt) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int c = 0; c < kN / 16; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (rt * 16 + g + 8 * r) * kN + c * 16 + 4 * t;
#ifndef SWIN_ABLATE_NO_BIAS
      float4 v = __ldg(reinterpret_cast<const float4*>(bh + at));
#else  // tools/time_swin_attention.py's ablation: no bias or mask read
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      mw = nullptr;
#endif
      if (mw != nullptr) {
        const float4 m = __ldg(reinterpret_cast<const float4*>(mw + at));
        v.x += m.x;
        v.y += m.y;
        v.z += m.z;
        v.w += m.w;
      }
      add[2 * c][r] = make_float2(v.x, v.y);
      add[2 * c + 1][r] = make_float2(v.z, v.w);
    }
  }
}

// s * scale + add on a 16 x 64 score tile, then exp(s - row max) in place;
// returns the row sums.
template <bool kFast>
__device__ __forceinline__ void softmax(float (&s)[kN / 8][4], const float2 (&add)[kN / 8][2], float scale,
                                        float (&sum)[2]) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[nt][2 * r] = s[nt][2 * r] * scale + add[nt][r].x;
      s[nt][2 * r + 1] = s[nt][2 * r + 1] * scale + add[nt][r].y;
      mx[r] = fmaxf(mx[r], fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    sum[r] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = kFast ? __expf(s[nt][e] - mx[e / 2]) : expf(s[nt][e] - mx[e / 2]);
      sum[e / 2] += s[nt][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// Bytes of one item's tiles (a ring slot) for G heads.
template <class T>
__host__ __device__ constexpr int tile_bytes(int G) {
  return sizeof(T) == 2 ? 3 * G * kN * kLd16 * 2 : G * (2 * kN * kLd32 + kDP * kLdV) * 4;
}

// Unit u (a 4-byte word) of an item's part of a token row, the q, k and v
// slices of its G heads one after the other: where it lies in the row past
// the group's first q element (src, in units), and where it goes in the
// tiles (dst, in units, added to the token's place: bit 29 marks k and v,
// whose rows are held in key_row order, bit 30 v of the f32 form, transposed).
template <class T>
__device__ void unit_place(const Params& p, int u, int& src, int& dst) {
  const int per = sizeof(T) == 2 ? 2 : 1, gu = p.G * p.hd / per, hdu = p.hd / per, cu = p.heads * p.hd / per;
  const int part = u / gu, w = u - part * gu, hl = w / hdu, d = (w - hl * hdu) * per;
  src = part * cu + w;
  if (sizeof(T) == 2) dst = (part ? 1 << 29 : 0) | ((part * p.G + hl) * kN * kLd16 + d) / 2;
  else if (part < 2) dst = (part ? 1 << 29 : 0) | ((part * p.G + hl) * kN * kLd32 + d);
  else dst = (1 << 30) | (2 * p.G * kN * kLd32 + hl * kDP * kLdV + d * kLdV);
}

// Where token tok's k and v rows go: keys are held in an order that gives
// lane t of a score fragment the four keys 16 c + 4t .. 16 c + 4t + 3 of each
// 16-key chunk c (at fragment columns 2t, 2t + 1 of n-tile 2c and of n-tile
// 2c + 1), so that it reads their bias and mask as one float4.
__device__ __forceinline__ int key_row(int tok) {
  const int o = tok & 15;
  return (tok & ~15) | ((o & 2) << 2) | ((o >> 2) << 1) | (o & 1);
}

// Fill ring slot `tiles` with item `item`'s q, k and v: warp w takes tokens
// w, w + 8, .., lane l the units l, l + 32, .. of each, whose places it
// holds; every thread then arrives on `bar` once its copies land. Every
// thread calls it.
template <class T>
__device__ void load(const Params& p, int item, uint32_t tiles, uint32_t bar, const int (&src)[kMaxJ],
                     const int (&dst)[kMaxJ]) {
  const Where at(p, item);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int per = sizeof(T) == 2 ? 2 : 1, units = 3 * p.G * p.hd / per, row_units = 3 * p.heads * p.hd / per;
  const uint32_t* rows = static_cast<const uint32_t*>(p.qkv);
  for (int tok = warp; tok < kN; tok += nwarps) {
    const uint32_t* row = rows + at.pixel(p, tok) * row_units + at.h0 * p.hd / per;
    const int kr = key_row(tok);
    // the f32 form's v^T column of this key: within each 8, position 2j -> j, 2j + 1 -> j + 4
    const int vpos = (kr & ~7) | ((kr & 1) * 4 + ((kr >> 1) & 3));
    const int ld = sizeof(T) == 2 ? kLd16 / 2 : kLd32;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      if (lane + 32 * j < units) {
        const int place = dst[j], off = place & ((1 << 29) - 1);
        const int to = (place & (1 << 30)) ? off + vpos : off + ((place & (1 << 29)) ? kr : tok) * ld;
        hopper::cp_async4(tiles + 4 * to, row + src[j]);
      }
    }
  }
  hopper::cp_async_arrive(bar);
}

// Store item `item`'s output, which its tasks wrote over the q tiles, to the
// output rows: warp w takes tokens w, w + 8, .., lane l the 4-byte units l,
// l + 32, .. of the token's G heads (contiguous in the output row) from the
// tile places it holds in `from`.
template <class T>
__device__ __forceinline__ void store(const Params& p, int item, const uint32_t* tiles, const int (&from)[kMaxOut]) {
  const Where at(p, item);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int per = sizeof(T) == 2 ? 2 : 1, units = p.G * p.hd / per, ld = sizeof(T) == 2 ? kLd16 / 2 : kLd32;
  uint32_t* out = static_cast<uint32_t*>(p.out);
  for (int tok = warp; tok < kN; tok += nwarps) {
    uint32_t* row = out + (at.pixel(p, tok) * p.heads * p.hd + at.h0 * p.hd) / per;
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j)
      if (lane + 32 * j < units) row[lane + 32 * j] = tiles[from[j] + tok * ld];
  }
}

// One task, bf16: head hl of the item, 16-row tile rt; the item's tiles `tl`;
// the output goes over the task's own q rows of the tile, which it has read.
__device__ void task16(const Params& p, bf16* tl, int hl, int rt, const float* bh, const float* mw) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int hd = p.hd;
  constexpr int kTile = kN * kLd16;
  const bf16* tq = tl + hl * kTile;
  const bf16* tk = tl + (p.G + hl) * kTile;
  const bf16* tv = tl + (2 * p.G + hl) * kTile;
  const int ksteps = (hd + 15) / 16;
  float2 add[kN / 8][2];
  additive(add, bh, mw, rt);

  // S = Q K^T, 16 x 64
  float s[kN / 8][4];
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kDP / 16; ++ks) {
    if (ks < ksteps) {
      uint32_t a[4];
      ldsm_x4(a, tq + (rt * 16 + lane % 16) * kLd16 + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, tk + (np * 16 + (lane / 16) * 8 + lane % 8) * kLd16 + ks * 16 + ((lane / 8) % 2) * 8);
        mma16(s[2 * np], a, b[0], b[1]);
        mma16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  float sum[2];
  softmax<true>(s, add, p.scale, sum);

  // P as two bf16 terms in A-fragment order: n-tile pairs become 16-key k-steps
  uint32_t p_hi[kN / 16][4], p_lo[kN / 16][4];
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      split_bf16(s[nt][2 * r], s[nt][2 * r + 1], p_hi[nt / 2][(nt % 2) * 2 + r], p_lo[nt / 2][(nt % 2) * 2 + r]);

  // O = P V, 16 x 32
  float o[kDP / 8][4];
#pragma unroll
  for (int i = 0; i < kDP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int dp = 0; dp < kDP / 16; ++dp) {
    if (dp < ksteps) {
#pragma unroll
      for (int c = 0; c < kN / 16; ++c) {
        uint32_t b[4];
        ldsm_x4_trans(b, tv + (c * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd16 + dp * 16 + (lane / 16) * 8);
        mma16(o[2 * dp], p_hi[c], b[0], b[1]);
        mma16(o[2 * dp + 1], p_hi[c], b[2], b[3]);
        mma16(o[2 * dp], p_lo[c], b[0], b[1]);
        mma16(o[2 * dp + 1], p_lo[c], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / sum[r];
    bf16* orow = tl + hl * kTile + (rt * 16 + g + 8 * r) * kLd16;
#pragma unroll
    for (int dt = 0; dt < kDP / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    }
  }
}

// One task, f32 on split-tf32 products.
__device__ void task32(const Params& p, float* tl, int hl, int rt, const float* bh, const float* mw) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, m = lane / 8;
  const int hd = p.hd;
  const float* tq = tl + hl * kN * kLd32;
  const float* tk = tl + (p.G + hl) * kN * kLd32;
  const float* tv = tl + 2 * p.G * kN * kLd32 + hl * kDP * kLdV;
  const int ksteps = (hd + 7) / 8, dpairs = (hd + 15) / 16;
  float2 add[kN / 8][2];
  additive(add, bh, mw, rt);

  float s[kN / 8][4];
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kDP / 8; ++ks) {
    if (ks < ksteps) {
      uint32_t a[4], ahi[4], alo[4];  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      ldsm_x4(a, tq + (rt * 16 + (m % 2) * 8 + lane % 8) * kLd32 + ks * 8 + (m / 2) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ahi[i], alo[i]);
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t b[4], bhi[4], blo[4];  // (key g, k t), (g, t + 4) of n-tiles 2 np and 2 np + 1
        ldsm_x4(b, tk + ((2 * np + m / 2) * 8 + lane % 8) * kLd32 + ks * 8 + (m % 2) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(b[i]), bhi[i], blo[i]);
        mma8x3(s[2 * np], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
        mma8x3(s[2 * np + 1], ahi, alo, bhi[2], bhi[3], blo[2], blo[3]);
      }
    }
  }

  float sum[2];
  softmax<false>(s, add, p.scale, sum);

  // O = P V: chunk c is score n-tile c, whose columns 2t, 2t + 1 are k = t, t + 4
  float o[kDP / 8][4];
#pragma unroll
  for (int i = 0; i < kDP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int c = 0; c < kN / 8; ++c) {
    uint32_t ahi[4], alo[4];
    hopper::split_fragment(s[c], ahi, alo);
#pragma unroll
    for (int dp = 0; dp < kDP / 16; ++dp) {
      if (dp < dpairs) {
        uint32_t b[4], bhi[4], blo[4];  // (column g, k t), (g, t + 4) of column tiles 2 dp and 2 dp + 1
        ldsm_x4(b, tv + ((2 * dp + m / 2) * 8 + lane % 8) * kLdV + c * 8 + (m % 2) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(b[i]), bhi[i], blo[i]);
        mma8x3(o[2 * dp], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
        mma8x3(o[2 * dp + 1], ahi, alo, bhi[2], bhi[3], blo[2], blo[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / sum[r];
    float* orow = tl + hl * kN * kLd32 + (rt * 16 + g + 8 * r) * kLd32;
#pragma unroll
    for (int dt = 0; dt < kDP / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dt * 8 + 2 * t + e;
        if (col < hd) orow[col] = o[dt][2 * r + e] * inv;
      }
    }
  }
}

// The persistent loop: fill the ring; then per item wait for its slot,
// compute every (head, 16-row) task (each writing its output over its own q
// rows), store the item, and refill the slot with the item S ahead.
template <class T>
__device__ __forceinline__ void run(const Params& p, unsigned char* smem) {
  const uint32_t bars = smem_u32(smem);
  unsigned char* slots = smem + kHeader;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int per_image = (p.H / kWin) * (p.W / kWin);
  const int per = sizeof(T) == 2 ? 2 : 1, hdu = p.hd / per;

  int src[kMaxJ], dst[kMaxJ], from[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    src[j] = dst[j] = 0;
    if (lane + 32 * j < 3 * p.G * hdu) unit_place<T>(p, lane + 32 * j, src[j], dst[j]);
  }
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {  // output unit u: head u / hdu of the q tiles, unit u % hdu
    const int u = lane + 32 * j;
    from[j] = (u / hdu) * kN * (sizeof(T) == 2 ? kLd16 / 2 : kLd32) + u % hdu;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.slots; ++s) hopper::mbar_init(bars + 8 * s, blockDim.x);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  for (int k = 0; k < p.slots && blockIdx.x + k * gridDim.x < p.items; ++k)
    load<T>(p, blockIdx.x + k * gridDim.x, smem_u32(slots + k * p.slot_bytes), bars + 8 * k, src, dst);
  // the tiles' pad columns and rows, which no copy writes
  for (int s = 0; s < p.slots; ++s) {
    uint32_t* tw = reinterpret_cast<uint32_t*>(slots + s * p.slot_bytes);
    if (sizeof(T) == 2) {
      const int pad = (kLd16 - p.hd) / 2;  // words a row
      for (int i = threadIdx.x; i < 3 * p.G * kN * pad; i += blockDim.x)
        tw[(i / pad) * (kLd16 / 2) + p.hd / 2 + i % pad] = 0u;
    } else {
      const int pad = kLd32 - p.hd, qk = 2 * p.G * kN;
      for (int i = threadIdx.x; i < qk * pad; i += blockDim.x) tw[(i / pad) * kLd32 + p.hd + i % pad] = 0u;
      for (int i = threadIdx.x; i < p.G * (kDP - p.hd) * kLdV; i += blockDim.x) {
        const int hl = i / ((kDP - p.hd) * kLdV), r = i % ((kDP - p.hd) * kLdV);
        tw[qk * kLd32 + hl * kDP * kLdV + p.hd * kLdV + r] = 0u;
      }
    }
  }
  for (int k = 0;; ++k) {
    const int item = blockIdx.x + k * gridDim.x;
    if (item >= p.items) break;
    const int s = k % p.slots;
    unsigned char* tl = slots + s * p.slot_bytes;
    const Where at(p, item);
    const float* mw = p.mask == nullptr ? nullptr : p.mask + (size_t)(at.win % per_image) * kN * kN;
    hopper::mbar_wait(bars + 8 * s, (k / p.slots) & 1);
    __syncthreads();
#ifndef SWIN_ABLATE_COPIES_ONLY  // tools/time_swin_attention.py's ablation: the copies alone, no task and no store
    for (int task = warp; task < 4 * p.G; task += nwarps) {
      const int hl = task / 4, rt = task % 4;
      const float* bh = p.bias + (size_t)(at.h0 + hl) * kN * kN;
      if constexpr (sizeof(T) == 2)
        task16(p, reinterpret_cast<bf16*>(tl), hl, rt, bh, mw);
      else
        task32(p, reinterpret_cast<float*>(tl), hl, rt, bh, mw);
    }
    __syncthreads();
    store<T>(p, item, reinterpret_cast<const uint32_t*>(tl), from);
#endif
    __syncthreads();
    const int next = item + p.slots * gridDim.x;
    if (next < p.items) load<T>(p, next, smem_u32(tl), bars + 8 * s, src, dst);
  }
}

}  // namespace

namespace swin16 {
__global__ void __launch_bounds__(kMaxThreads, 1) kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  run<bf16>(p, smem);
}
}  // namespace swin16

namespace swin_tf32 {
__global__ void __launch_bounds__(kMaxThreads, 1) kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  run<float>(p, smem);
}
}  // namespace swin_tf32

namespace {

// Block geometry for items of G heads of hd: the ring's slots and the
// dynamic shared memory. Two blocks an SM with two or more slots each where
// they fit, else two blocks of one slot, else one block with the most slots
// (at most kMaxSlots). 0 slots: G x hd is too wide.
void geometry(int G, int hd, bool is_bf16, int& slot_bytes, int& slots, int& smem) {
  const int es = is_bf16 ? 2 : 4;
  slot_bytes = is_bf16 ? tile_bytes<bf16>(G) : tile_bytes<float>(G);
  slots = 0;
  if (3 * G * hd * es / 4 <= kRowUnits) {
    const int two = (kSmemSm / 2 - 1024 - kHeader) / slot_bytes;  // slots that fit two blocks an SM
    const int one = (kSmemLimit - kHeader) / slot_bytes;
    slots = two >= 1 ? std::min(kMaxSlots, two) : std::min(kMaxSlots, one);
  }
  smem = kHeader + slots * slot_bytes;
}

// Blocks an SM holds of the form at this shared memory and block size
// (cached per form, size and threads).
int blocks_per_sm(bool is_bf16, int smem, int threads) {
  static int cached_smem[4] = {-1, -1, -1, -1}, cached_blocks[4] = {0, 0, 0, 0};
  const int f = (is_bf16 ? 0 : 2) + (threads == kThreads ? 0 : 1);
  if (cached_smem[f] != smem) {
    const void* fn = is_bf16 ? reinterpret_cast<const void*>(swin16::kernel) : reinterpret_cast<const void*>(swin_tf32::kernel);
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit) != cudaSuccess) return 0;
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem) != cudaSuccess) return 0;
    cached_blocks[f] = blocks;
    cached_smem[f] = smem;
  }
  return cached_blocks[f];
}

}  // namespace

// qkv: (b, h, w, 3 * heads * hd) contiguous, lanes [q heads.., k heads.., v heads..],
// bf16 when is_bf16, else f32, 4-byte aligned; bias: (heads, 64, 64) f32;
// mask: ((h / 8) * (w / 8), 64, 64) f32 or null, both 16-byte aligned; out: (b, h, w, heads * hd)
// of qkv's type. A work item is a window with heads_per_item heads, which must
// divide heads. Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int swin_window_attention(const void* qkv, const void* bias, const void* mask, void* out, int b,
                                     int h, int w, int heads, int hd, int window, int shift, float scale,
                                     int heads_per_item, int is_bf16, void* stream) {
  if (window != kWin || h % kWin || w % kWin || b < 1 || h < kWin || w < kWin || heads < 1 || hd < 1 ||
      hd > kDP || shift < 0 || shift >= kWin || heads_per_item < 1 || heads % heads_per_item ||
      (is_bf16 && hd % 2) || (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 4 ||
      (reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(mask)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.qkv = qkv;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  p.H = h;
  p.W = w;
  p.heads = heads;
  p.hd = hd;
  p.G = heads_per_item;
  p.groups = heads / heads_per_item;
  p.shift = shift;
  p.scale = scale;
  const long long items = (long long)b * (h / kWin) * (w / kWin) * p.groups;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(items);
  int smem;
  geometry(p.G, hd, is_bf16, p.slot_bytes, p.slots, smem);
  if (p.slots < 1) return static_cast<int>(cudaErrorInvalidValue);
#ifdef SWIN_ABLATE_NO_RING  // tools/time_swin_attention.py's ablation: the same shared memory, one slot used
  p.slots = 1;
#endif
  static int sm_count[64] = {0};  // per device, asked once
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= 64)) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && sm_count[dev] == 0)
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // no more items than SMs: one block an SM, with twice the warps for an item's tasks
  const int threads = items <= sm_count[dev] ? kMaxThreads : kThreads;
  const int per_sm = blocks_per_sm(is_bf16, smem, threads);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(std::min<long long>(items, (long long)per_sm * sm_count[dev]));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    swin16::kernel<<<grid, threads, smem, s>>>(p);
  else
    swin_tf32::kernel<<<grid, threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a block of the form takes with heads_per_item heads of
// hd an item, the ring's slots, and the blocks an SM holds. Returns a
// cudaError_t.
extern "C" int swin_window_attention_occupancy(int heads_per_item, int hd, int is_bf16, int* smem, int* slots,
                                               int* blocks) {
  if (heads_per_item < 1 || hd < 1 || hd > kDP) return static_cast<int>(cudaErrorInvalidValue);
  int slot_bytes;
  geometry(heads_per_item, hd, is_bf16, slot_bytes, *slots, *smem);
  if (*slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = blocks_per_sm(is_bf16, *smem, kThreads);
  return *blocks < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}
