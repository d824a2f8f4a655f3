// Flash-attention backward for Hopper (sm_90a): the dq pass and the dk/dv pass,
// bound to PyTorch through plain C launchers loaded with ctypes
// (instarevive_tpu_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel` in
// instarevive_tpu/ops/attention.py (reached through `_flash_vjp_bwd`). From the
// forward's saved row log-sum-exp L and di = rowsum(dO * O) both passes
// recompute, tile by tile,
//     P  = exp(S * scale - L)            (masked keys: 0, not renormalised)
//     dP = dO V^T
//     dS = P * (dP - di) * scale
// and sum, in f32,
//     dQ = dS K          (dq pass: a block owns queries and walks the keys)
//     dV = P^T dO, dK = dS^T Q
//                        (dk/dv pass: a block owns keys and walks the queries)
// with P and dS rounded to the operands' type before those products. Every
// output element is written once by one block, in a fixed order of sums: no
// atomics, and the same inputs give the same bits.
//
// One body serves both passes. Seen from the block, there are "row" operands
// it owns (Q and dO for dq; K and V for dk/dv) and "column" operands it
// streams through shared memory (K and V; Q and dO). With rows of A, B and
// columns of C, D:  S = A C^T, dP = B D^T, out1 = dS C, out2 = P D (dk/dv
// only: that is dV, and out1 is dK because the tile is S^T). L and di follow
// the queries (rows for dq, columns for dk/dv), the key mask follows the keys.
//
// L and di are one f32 per query row; ragged Nq and Nk are predicated, never
// padded in device memory: rows and columns past the end load as zeros, keys
// past Nk get P = 0, queries past Nq get L = +inf (P = 0) and are not stored.
//
// A query row whose keys are all masked: the forward gives it the mean of V
// over the Nk keys (every score is the same -1e30) and writes L = -1e30. The
// backward sees that flag and takes P = 1/Nk for every key and dS = 0: the
// gradient of that mean, which is what autograd gives through the plain
// version.
//
// Two forms, each templated on the head dim and instantiated at 64 (the UNet
// and ControlNet of the LDM trainer) and 72 (the DiT), the f32 form also at 32
// (the toy DiT of tools/train_validation.py: one 128-byte box a row, output
// products m64 n32 k8); head dim 512 takes no gradient:
// * bf16 (namespace bwd16): wgmma on TMA-fed tiles, the design of the forward's
//   head-dim-64/72 body (flash_attn_fwd.cu, namespace hopper). A warpgroup
//   owns 64 rows. The block's row operands land once by TMA; the column
//   operands stream through a ring of kStages 64-column stages that one warp
//   fills (thread 0 issues the TMA copies, the warp's lanes write the stage's
//   per-column values beside them: the key flag, or L in the log2 domain and
//   di), each stage tracked by a full mbarrier (bytes and values landed) and
//   an empty one (every warp is done with it); no warp is set aside to
//   produce. Tiles are laid out for TMA's widest rows: head dims 0-63 of a row
//   are 128 bytes under the 128-byte swizzle, and at d = 72 head dims 64-79 are
//   a second tile of 32-byte rows under the 32-byte swizzle, 72-79 zero-filled
//   by TMA past the tensor. S = A C^T and dP = B D^T are m64 n64 k16 with both
//   operands in shared memory (a fifth k-step in the tails at d = 72), issued
//   together so the exponentials of P overlap dP's products. P and dS go from
//   the accumulator registers, rounded to bf16, straight into wgmma A
//   fragments (the accumulator layout of S is wgmma's register-A layout), and
//   out1 += dS C, out2 += P D are m64 n64 k16 (plus n16 over the tail at
//   d = 72) with the same streamed tile read as an MN-major B: each column
//   tile serves as the K-major B of a score product and the MN-major B of an
//   output product. The dk/dv pass computes S^T = K Q^T directly, so P^T and
//   dS^T come out already shaped as their product's A operand. The
//   accumulators stay in registers until one store at the end.
// * f32 (namespace bwd_tf32; every f32 trainer): the same body and
//   structure on the tensor cores' TF32 path, f32-accurate by splitting, as
//   the forward's f32 form (flash_attn_fwd.cu, fwd_tf32): each operand comes
//   as hi and lo planes from the prepass (tf32_planes.cu), every product is
//   lo.hi + hi.lo + hi.hi with f32 sums, each tf32 product exact, lo.lo
//   (about 2^-22 of a product) dropped; torch's own TF32 stays off. A tf32 B
//   is K-major only, so the output products' B operands, whose K runs along
//   the streamed columns, come from transposed planes: K^T for dQ = dS K, Q^T
//   and dO^T for dK = dS^T Q and dV = P^T dO, each with the columns in the
//   order 0 2 4 6 1 3 5 7 within each group of 8, which puts a thread's
//   accumulator columns (2t, 2t + 1) at the tf32 A fragment's k = (t, t + 4):
//   P and dS go from the accumulators to the output products with no
//   shuffle. A streamed stage holds 32 columns of C, D (hi, lo) and the
//   transposed planes: 55 KB (dq) or 74 KB (dk/dv) at d = 72. Score products
//   are m64 n32 k8 (ss), output products m64 n64/n72 k8 (rs) into fresh
//   accumulators added into the running sums once a tile: the tensor cores'
//   f32 sums truncate, and chained over 4096 queries straight into the
//   running sums they came to 3.7e-5 of the largest gradient (the f32 bound
//   is 2e-5; tools/time_flash_bwd.py with that copy of the file).
//
// What bounds it on this card: 10 * BH * Nq * Nk * d useful operations against
// a few MB of operands, far above the ridge point, so operations bound it (the
// f32 form: three tf32 products each at half the bf16 rate). The f32 form's
// shared memory (a 64-row warpgroup's four row planes are 74 KB at d = 72)
// allows one block an SM, and each 32-column tile's planes come from L2
// again for every block: with one warpgroup a block, the stage's bytes took
// longer than its products, so where a pass has 128 rows or more a block is
// two warpgroups sharing one stage (dk/dv 0.61 -> 0.37 ms at DiT self, one
// stage's copy waiting for both), and below that one warpgroup with two
// stages (a dk/dv pass over 4 or 77 keys, where two warpgroups were slower). A
// warpgroup runs a tile's steps in turn (S and dP, then P, then dS and the
// output products, whose end it waits for), and only the other warpgroups on
// the SM fill the gaps: two blocks of one at d = 64 (three in the dq pass), one
// of two at d = 72, as registers allow (164-190 a thread, no spill). On an H100
// (tools/time_flash_bwd.py with edited copies of this file) the exponentials
// cost 2-10% of a pass and the output products with their wait a quarter to a
// half of the dq pass; taking that wait into the next tile, behind its score
// products, was 7-20% slower. The dk/dv pass at a short key count fills few
// blocks (Nk = 4: one block per (batch, head), walking every query). A split of
// the query range, a producer warp and ping-pong between warpgroups are left
// for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kDeadRow = -1e29f;  // L below this: every key of the row was masked (L = -1e30)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Key flag: 1 keep, 0 masked, -1 past Nk.
__device__ __forceinline__ float key_flag(const uint8_t* mb, int key, int nk) {
  return key >= nk ? -1.f : (mb == nullptr || mb[key] != 0) ? 1.f : 0.f;
}

// ---------------------------------------------------------------------------
// bf16, head dims 64 and 72: wgmma on TMA-fed tiles, one body templated on the head dim and the pass.

namespace bwd16 {

using namespace hopper;

constexpr int BC = 64;      // columns a streamed tile
constexpr int kStages = 2;  // the column ring: tiles in flight

// Shared memory, from a 1024-byte aligned base: the row tiles A and B, the C
// ring, the D ring (head dims 0-63, 128-byte rows under the 128-byte swizzle);
// at d = 72 the tails (head dims 64-79, 32-byte rows under the 32-byte
// swizzle) in the same order; the ring's per-column values (2 x BC f32 a
// stage); the barriers. A main tile starts on 1024 bytes and a tail tile on
// 256 (their swizzle atoms: 8 rows).
template <int D, bool KV>
struct Tile {
  static_assert(D == 64 || D == 72, "head dims 64 and 72");
  // warpgroups a block, 64 rows each, sharing the column ring: two at d = 72, whose 32-byte tail
  // rows make the copies dearer; one at d = 64 (chosen by time, tools/time_flash_bwd.py)
  static constexpr int kWarpgroups = D == 72 ? 2 : 1;
  static constexpr int kThreads = 128 * kWarpgroups, BR = 64 * kWarpgroups;  // threads, rows a block
  static constexpr bool kTail = D > 64;
  static constexpr uint32_t kRowMain = BR * 128, kRowTail = kTail ? BR * 32 : 0;
  static constexpr uint32_t kColMain = BC * 128, kColTail = kTail ? BC * 32 : 0;
  static constexpr uint32_t kOffB = kRowMain, kOffC = 2 * kRowMain, kOffD = kOffC + kStages * kColMain;
  static constexpr uint32_t kOffAt = kOffD + kStages * kColMain, kOffBt = kOffAt + kRowTail;
  static constexpr uint32_t kOffCt = kOffBt + kRowTail, kOffDt = kOffCt + kStages * kColTail;
  static constexpr uint32_t kOffVals = kOffDt + kStages * kColTail;
  static constexpr uint32_t kOffBars = kOffVals + kStages * 2 * BC * 4;
  static constexpr size_t kSmem = 1024 + kOffBars + 8 * (2 * kStages + 1);  // 1024 bytes of slack to align the base
  static constexpr uint32_t kRowBytes = 2 * (kRowMain + kRowTail), kColBytes = 2 * (kColMain + kColTail);
};

struct Maps {  // the row operands A, B and the column operands C, D: head dims 0-63, and 64-79 at d = 72
  CUtensorMap a, b, c, d, a_tail, b_tail, c_tail, d_tail;
};

// Row r (0, 1) of a 64 x 64 (and, at d = 72, 64 x 16 tail) accumulator as bf16 from orow (the row's column 2 t)
// on; x[4 j + 2 r + e] is column 8 j + 2 t + e. The tail's columns 72-79 are not stored.
template <int D>
__device__ __forceinline__ void store_row(bf16* orow, const float (&x)[32], const float (&tail)[8], int r) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
  if (D > 64) *reinterpret_cast<__nv_bfloat162*>(orow + 64) = __floats2bfloat162_rn(tail[2 * r], tail[2 * r + 1]);
}

// KV = false: the dq pass (out1 = dQ, out2 unused). KV = true: the dk/dv pass
// (out1 = dK, out2 = dV). The accumulator layout of wgmma's m64 fragments:
// this thread holds rows g and g + 8 (r = 0, 1) of its warp's 16, and
// x[4 j + 2 r + e] is column 8 j + 2 t + e of row g + 8 r (t = lane % 4).
template <int D, bool KV>
__global__ void __launch_bounds__(Tile<D, KV>::kThreads)
kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ mask, const float* __restrict__ lse,
       const float* __restrict__ di, bf16* __restrict__ out1, bf16* __restrict__ out2, int heads, int nq, int nk,
       float scale) {
  using T = Tile<D, KV>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  float* vals = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + T::kOffVals);
  const uint32_t sA = base, sB = base + T::kOffB, sC = base + T::kOffC, sD = base + T::kOffD;
  const uint32_t sAt = base + T::kOffAt, sBt = base + T::kOffBt, sCt = base + T::kOffCt, sDt = base + T::kOffDt;
  const uint32_t full = base + T::kOffBars;   // per stage: its tiles and values have landed
  const uint32_t empty = full + 8 * kStages;  // per stage: every warp is done with it
  const uint32_t rowbar = empty + 8 * kStages;

  const int bh = blockIdx.y, r0 = blockIdx.x * T::BR;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row group and column pair
  const int nrow = KV ? nk : nq, ncol = KV ? nq : nk;
  const int n_tiles = (ncol + BC - 1) / BC;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const float* lse_b = lse + (size_t)bh * nq;
  const float* di_b = di + (size_t)bh * nq;
  const float scale_log2 = scale * kLog2e, inv_nk = 1.f / (float)nk;
  const bool producer = threadIdx.x < 32;  // the warp that fills the ring; no warp is set aside for it

  // Called by the whole producer warp: the lanes write a stage's per-column
  // values (the key flag for dq; L in the log2 domain, +inf past Nq, and di for
  // dk/dv), then lane 0 arrives on the stage's full barrier (releasing those
  // writes) with the bytes its TMA copies will bring.
  auto load_cols = [&](int tile) {
    const int s = tile % kStages, c0 = tile * BC;
    float* f = vals + s * 2 * BC;
    for (int j = lane; j < BC; j += 32) {
      const int c = c0 + j;
      if (KV) {
        f[j] = c < nq ? lse_b[c] * kLog2e : CUDART_INF_F;
        f[BC + j] = c < nq ? di_b[c] : 0.f;
      } else {
        f[j] = key_flag(mb, c, nk);
      }
    }
    __syncwarp();
    if (lane == 0) {
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, T::kColBytes);
      tma_load(sC + s * T::kColMain, &maps.c, bar, 0, c0, bh);
      tma_load(sD + s * T::kColMain, &maps.d, bar, 0, c0, bh);
      if (T::kTail) {
        tma_load(sCt + s * T::kColTail, &maps.c_tail, bar, 64, c0, bh);
        tma_load(sDt + s * T::kColTail, &maps.d_tail, bar, 64, c0, bh);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::kThreads / 32);
    }
    mbar_init(rowbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(rowbar, T::kRowBytes);
    tma_load(sA, &maps.a, rowbar, 0, r0, bh);
    tma_load(sB, &maps.b, rowbar, 0, r0, bh);
    if (T::kTail) {
      tma_load(sAt, &maps.a_tail, rowbar, 64, r0, bh);
      tma_load(sBt, &maps.b_tail, rowbar, 64, r0, bh);
    }
  }
  if (producer)
    for (int tile = 0; tile < kStages && tile < n_tiles; ++tile) load_cols(tile);

  // Per-row values of this thread's rows g and g + 8: L (log2 domain) and di (dq), or the key flag (dk/dv).
  const int row0 = r0 + wg * 64 + warp * 16 + g;
  float row_x[2], row_y[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (KV) {
      row_x[r] = key_flag(mb, row, nk);
      row_y[r] = 0.f;
    } else {
      row_x[r] = row < nq ? lse_b[row] * kLog2e : CUDART_INF_F;
      row_y[r] = row < nq ? di_b[row] : 0.f;
    }
  }

  // this warpgroup's 64 rows; a k-step of 16 head dims is 32 bytes along a 128-byte row
  const uint64_t a_desc = smem_desc(sA + wg * 64 * 128, 1024, kSwizzle128);
  const uint64_t b_desc = smem_desc(sB + wg * 64 * 128, 1024, kSwizzle128);
  const uint64_t a_tail = smem_desc(sAt + wg * 64 * 32, 256, kSwizzle32);
  const uint64_t b_tail = smem_desc(sBt + wg * 64 * 32, 256, kSwizzle32);
  float acc1[32], acc1_tail[8], acc2[32], acc2_tail[8];  // head dims 0-63; 64-79 (72-79 stay 0) at d = 72
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc1_tail[i] = acc2_tail[i] = 0.f;
  mbar_wait(rowbar, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % kStages;
    // refill the stage of the previous tile once every warp is done with it
    if (producer && tile > 0 && tile - 1 + kStages < n_tiles) {
      mbar_wait(empty + 8 * ((tile - 1) % kStages), ((tile - 1) / kStages) & 1);
      load_cols(tile - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, (tile / kStages) & 1);
    const float* colf = vals + s * 2 * BC;
    // the stage's C and D tiles: the K-major B of the score products (a k-step is 32 bytes along a row),
    // and the MN-major B of the output products (a k-step of 16 columns is two 8-row swizzle atoms)
    const uint64_t c_desc = smem_desc(sC + s * T::kColMain, 1024, kSwizzle128);
    const uint64_t d_desc = smem_desc(sD + s * T::kColMain, 1024, kSwizzle128);
    const uint64_t c_tail = smem_desc(sCt + s * T::kColTail, 256, kSwizzle32);
    const uint64_t d_tail = smem_desc(sDt + s * T::kColTail, 256, kSwizzle32);

    // S = A C^T and dP = B D^T, 64 x BC a warpgroup: four k-steps in the main tiles, one in the tails
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<64>::ss(sc, a_desc + 2 * ks, c_desc + 2 * ks, ks > 0);
    if (T::kTail) Wgmma<64>::ss(sc, a_tail, c_tail, 1);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<64>::ss(dp, b_desc + 2 * ks, d_desc + 2 * ks, ks > 0);
    if (T::kTail) Wgmma<64>::ss(dp, b_tail, d_tail, 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P in f32 (kept for dS), and for dk/dv rounded to bf16 A fragments (n-tile pairs become 16-column
    // k-steps); dV's product may still read them while dS is formed, so dS has fragments of its own
    uint32_t pf[BC / 16][4], sf[BC / 16][4];
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      const float2 col = *reinterpret_cast<const float2*>(colf + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float cv = (e & 1) ? col.y : col.x;
        const float l2 = KV ? cv : row_x[r];
        const float keep = KV ? row_x[r] : cv;
        float& x = sc[4 * nt + e];
        x = l2 < kDeadRow ? (keep >= 0.f ? inv_nk : 0.f) : (keep > 0.f ? ex2(fmaf(x, scale_log2, -l2)) : 0.f);
      }
      if (KV) {
        pf[nt / 2][(nt % 2) * 2] = pack_bf16(sc[4 * nt], sc[4 * nt + 1]);
        pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(sc[4 * nt + 2], sc[4 * nt + 3]);
      }
    }
    if constexpr (KV) {  // dV += P^T dO
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < BC / 16; ++c) {
        Wgmma<64>::rs(acc2, pf[c], d_desc + c * 128);
        if (T::kTail) Wgmma<16>::rs(acc2_tail, pf[c], d_tail + c * 32);
      }
      wgmma_commit();
      wgmma_wait<1>();  // dP has landed; dV may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dp);

    // dS = P (dP - di) scale, as bf16 A fragments
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      const float2 col = *reinterpret_cast<const float2*>(colf + nt * 8 + 2 * t);
      const float2 col_di = *reinterpret_cast<const float2*>(colf + BC + nt * 8 + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float l2 = KV ? ((e & 1) ? col.y : col.x) : row_x[r];
        const float dii = KV ? ((e & 1) ? col_di.y : col_di.x) : row_y[r];
        ds[e] = l2 < kDeadRow ? 0.f : sc[4 * nt + e] * (dp[4 * nt + e] - dii) * scale;
      }
      sf[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
      sf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K, or dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BC / 16; ++c) {
      Wgmma<64>::rs(acc1, sf[c], c_desc + c * 128);
      if (T::kTail) Wgmma<16>::rs(acc1_tail, sf[c], c_tail + c * 32);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc1);
    if (T::kTail) fence_regs(acc1_tail);
    if constexpr (KV) {
      fence_regs(acc2);
      if (T::kTail) fence_regs(acc2_tail);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nrow) continue;
    const size_t at = ((size_t)bh * nrow + row) * D + 2 * t;
    store_row<D>(out1 + at, acc1, acc1_tail, r);
    if (KV) store_row<D>(out2 + at, acc2, acc2_tail, r);
  }
}

template <int D, bool KV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
                   const void* lse, const void* di, void* out1, void* out2, int bh, int heads, int nq,
                   int nk, float scale, cudaStream_t stream) {
  using T = Tile<D, KV>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const void *a = KV ? k : q, *b = KV ? v : dout, *c = KV ? q : k, *d = KV ? dout : v;
  const int nrow = KV ? nk : nq, ncol = KV ? nq : nk;
  Maps maps = {};
  bool ok = make_map(&maps.a, a, D, nrow, bh, 64, T::BR, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&maps.b, b, D, nrow, bh, 64, T::BR, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&maps.c, c, D, ncol, bh, 64, BC, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&maps.d, d, D, ncol, bh, 64, BC, CU_TENSOR_MAP_SWIZZLE_128B);
  if (T::kTail)
    ok = ok && make_map(&maps.a_tail, a, D, nrow, bh, 16, T::BR, CU_TENSOR_MAP_SWIZZLE_32B) &&
         make_map(&maps.b_tail, b, D, nrow, bh, 16, T::BR, CU_TENSOR_MAP_SWIZZLE_32B) &&
         make_map(&maps.c_tail, c, D, ncol, bh, 16, BC, CU_TENSOR_MAP_SWIZZLE_32B) &&
         make_map(&maps.d_tail, d, D, ncol, bh, 16, BC, CU_TENSOR_MAP_SWIZZLE_32B);
  if (!ok) return cudaErrorInvalidValue;
  auto fn = kernel<D, KV>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nrow + T::BR - 1) / T::BR, bh);
  fn<<<grid, T::kThreads, T::kSmem, stream>>>(maps, static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
                                           static_cast<const float*>(di), static_cast<bf16*>(out1),
                                           static_cast<bf16*>(out2), heads, nq, nk, scale);
  return cudaGetLastError();
}

template <int D, bool KV>
cudaError_t occupancy(int* smem_bytes, int* blocks_per_sm) {
  using T = Tile<D, KV>;
  *smem_bytes = (int)T::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel<D, KV>, T::kThreads, T::kSmem);
}

}  // namespace bwd16

// ---------------------------------------------------------------------------
// f32, head dims 32, 64 and 72: split-tf32 wgmma on TMA-fed tiles, the same body.

namespace bwd_tf32 {

using namespace hopper;

constexpr int BC = 32;      // columns a streamed tile

// Shared memory, from a 1024-byte aligned base: the row planes (A hi, A lo, B hi, B lo: BR rows each), then
// per stage the column planes C hi, C lo, D hi, D lo (BC rows each, the K-major B of the score products),
// C^T hi, C^T lo and, for dk/dv, D^T hi, D^T lo (D rows of BC columns each, from the transposed planes:
// the K-major B of the output products), then the ring's per-column values (2 x BC f32 a stage) and the
// barriers. A row-major plane tile is D / 32 boxes of rows x 32 f32 (128-byte rows, 128-byte swizzle)
// and, at d = 72, a tail box of rows x 8 f32 (32-byte rows, 32-byte swizzle); a transposed one is one box
// of D rows x 32 columns. Every box starts on 1024 bytes.
//
// A block is WG warpgroups of 64 rows: two sharing a single stage where a pass has at least 128 rows (a
// column tile's bytes then serve 128 rows; its copy waits for both warpgroups), one with two stages
// below that (a pass over a few keys: 4 or 77 for the dk/dv pass), as the launcher picks.
template <int D, bool KV, int WG>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 72, "head dims 32, 64 and 72");
  static_assert(WG == 1 || WG == 2, "one or two warpgroups");
  static constexpr int kWarpgroups = WG, kStages = WG == 2 ? 1 : 2;  // the column ring's stages
  static constexpr int kThreads = 128 * kWarpgroups, BR = 64 * kWarpgroups;
  static constexpr uint32_t kRowPlane = BR * D * 4, kColPlane = BC * D * 4;
  static constexpr int kColPlanes = KV ? 8 : 6;
  static constexpr uint32_t kStage = kColPlanes * kColPlane;
  static constexpr uint32_t kOffStages = 4 * kRowPlane, kOffVals = kOffStages + kStages * kStage;
  static constexpr uint32_t kOffBars = kOffVals + kStages * 2 * BC * 4;
  static constexpr size_t kSmem = 1024 + kOffBars + 8 * (2 * kStages + 1);  // 1024 bytes of slack to align the base
  static_assert(kSmem <= 232448, "shared memory over the per-block limit");
};

struct Maps {  // hi ([0]) and lo ([1]): A, B, C, D in 32-wide boxes and 8-wide tails; C^T, D^T in 32-column boxes
  CUtensorMap a[2], b[2], c[2], d[2], a_tail[2], b_tail[2], c_tail[2], d_tail[2], ct[2], dt[2];
};

// A row-major plane tile of `rows` rows from row row0 of head bh.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* main, const CUtensorMap* tail, int rows,
                                          int row0, int bh, uint32_t bar) {
#pragma unroll
  for (int b = 0; b < D / 32; ++b) tma_load(dst + b * rows * 128, main, bar, 32 * b, row0, bh);
  if (D % 32 != 0) tma_load(dst + (D / 32) * rows * 128, tail, bar, 32 * (D / 32), row0, bh);
}

// acc (64 x BC a warpgroup) [+]= X Y^T over the head dims, X rows x0.. x0 + 63 of a row-major plane tile
// of xrows rows (hi at x, lo at x + xplane), Y a BC-row one (hi at y, lo at y + yplane): each k-step of 8
// head dims as lo.hi + hi.lo + hi.hi, the small terms first.
template <int D>
__device__ __forceinline__ void score_product(float (&acc)[BC / 2], uint32_t x, uint32_t xplane, int xrows, int x0,
                                              uint32_t y, uint32_t yplane) {
#pragma unroll
  for (int b = 0; b < D / 32; ++b) {
    const uint64_t xh = smem_desc(x + b * xrows * 128 + x0 * 128, 1024, kSwizzle128);
    const uint64_t xl = smem_desc(x + xplane + b * xrows * 128 + x0 * 128, 1024, kSwizzle128);
    const uint64_t yh = smem_desc(y + b * BC * 128, 1024, kSwizzle128);
    const uint64_t yl = smem_desc(y + yplane + b * BC * 128, 1024, kSwizzle128);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma32<BC>::ss(acc, xl + 2 * ks, yh + 2 * ks, b > 0 || ks > 0);
      Wgmma32<BC>::ss(acc, xh + 2 * ks, yl + 2 * ks, 1);
      Wgmma32<BC>::ss(acc, xh + 2 * ks, yh + 2 * ks, 1);
    }
  }
  if (D % 32 != 0) {
    const uint32_t tx = (D / 32) * xrows * 128 + x0 * 32, ty = (D / 32) * BC * 128;
    const uint64_t xh = smem_desc(x + tx, 256, kSwizzle32), xl = smem_desc(x + xplane + tx, 256, kSwizzle32);
    const uint64_t yh = smem_desc(y + ty, 256, kSwizzle32), yl = smem_desc(y + yplane + ty, 256, kSwizzle32);
    Wgmma32<BC>::ss(acc, xl, yh, 1);
    Wgmma32<BC>::ss(acc, xh, yl, 1);
    Wgmma32<BC>::ss(acc, xh, yh, 1);
  }
}

// acc (64 x D) = F Y over this tile's BC columns, F the split A fragments (k-step j: columns 8 j..), Y
// a transposed plane tile (D rows x BC columns; hi at y, lo at y + plane). acc starts at 0: the caller adds
// it into the running sums, so the tensor cores' truncating sums run over one tile only.
template <int D>
__device__ __forceinline__ void output_product(float (&acc)[D / 2], const uint32_t (&fh)[BC / 8][4],
                                               const uint32_t (&fl)[BC / 8][4], uint32_t y, uint32_t plane) {
#pragma unroll
  for (int j = 0; j < BC / 8; ++j) {
    const uint64_t yh = smem_desc(y, 1024, kSwizzle128) + 2 * j, yl = smem_desc(y + plane, 1024, kSwizzle128) + 2 * j;
    Wgmma32<D>::rs(acc, fl[j], yh, j > 0);
    Wgmma32<D>::rs(acc, fh[j], yl, 1);
    Wgmma32<D>::rs(acc, fh[j], yh, 1);
  }
}

// KV = false: the dq pass (out1 = dQ). KV = true: the dk/dv pass (out1 = dK, out2 = dV). The
// accumulator layout of wgmma's m64 fragments: this thread holds rows g and g + 8 (r = 0, 1) of its
// warp's 16, and x[4 j + 2 r + e] is column 8 j + 2 t + e of row g + 8 r (t = lane % 4).
template <int D, bool KV, int WG>
__global__ void __launch_bounds__(Tile<D, KV, WG>::kThreads, 1)
kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ mask, const float* __restrict__ lse,
       const float* __restrict__ di, float* __restrict__ out1, float* __restrict__ out2, int heads, int nq, int nk,
       float scale) {
  using T = Tile<D, KV, WG>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  float* vals = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + T::kOffVals);
  const uint32_t sA = base, sB = base + 2 * T::kRowPlane;  // hi, then lo one plane on
  const uint32_t full = base + T::kOffBars;   // per stage: its tiles and values have landed
  const uint32_t empty = full + 8 * kStages;  // per stage: every warp is done with it
  const uint32_t rowbar = empty + 8 * kStages;

  const int bh = blockIdx.y, r0 = blockIdx.x * T::BR;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row group and column pair
  const int nrow = KV ? nk : nq, ncol = KV ? nq : nk;
  const int n_tiles = (ncol + BC - 1) / BC;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const float* lse_b = lse + (size_t)bh * nq;
  const float* di_b = di + (size_t)bh * nq;
  const float scale_log2 = scale * kLog2e, inv_nk = 1.f / (float)nk;
  const bool producer = threadIdx.x < 32;  // the warp that fills the ring; no warp is set aside for it
  // a stage's planes: C hi, C lo, D hi, D lo, C^T hi, C^T lo, [D^T hi, D^T lo]
  auto col_plane = [&](int s, int i) { return base + T::kOffStages + s * T::kStage + i * T::kColPlane; };

  // Called by the whole producer warp: the lanes write a stage's per-column values (the key flag for
  // dq; L in the log2 domain, +inf past Nq, and di for dk/dv), then lane 0 arrives on the stage's full
  // barrier (releasing those writes) with the bytes its TMA copies will bring.
  auto load_cols = [&](int tile) {
    const int s = tile % kStages, c0 = tile * BC;
    float* f = vals + s * 2 * BC;
    for (int j = lane; j < BC; j += 32) {
      const int c = c0 + j;
      if (KV) {
        f[j] = c < nq ? lse_b[c] * kLog2e : CUDART_INF_F;
        f[BC + j] = c < nq ? di_b[c] : 0.f;
      } else {
        f[j] = key_flag(mb, c, nk);
      }
    }
    __syncwarp();
    if (lane == 0) {
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, T::kStage);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        load_rows<D>(col_plane(s, p), &maps.c[p], &maps.c_tail[p], BC, c0, bh, bar);
        load_rows<D>(col_plane(s, 2 + p), &maps.d[p], &maps.d_tail[p], BC, c0, bh, bar);
        tma_load(col_plane(s, 4 + p), &maps.ct[p], bar, c0, 0, bh);
        if (KV) tma_load(col_plane(s, 6 + p), &maps.dt[p], bar, c0, 0, bh);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::kThreads / 32);
    }
    mbar_init(rowbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(rowbar, 4 * T::kRowPlane);
    for (int p = 0; p < 2; ++p) {
      load_rows<D>(sA + p * T::kRowPlane, &maps.a[p], &maps.a_tail[p], T::BR, r0, bh, rowbar);
      load_rows<D>(sB + p * T::kRowPlane, &maps.b[p], &maps.b_tail[p], T::BR, r0, bh, rowbar);
    }
  }
  if (producer)
    for (int tile = 0; tile < kStages && tile < n_tiles; ++tile) load_cols(tile);

  // Per-row values of this thread's rows g and g + 8: L (log2 domain) and di (dq), or the key flag (dk/dv).
  const int row0 = r0 + wg * 64 + warp * 16 + g;
  float row_x[2], row_y[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (KV) {
      row_x[r] = key_flag(mb, row, nk);
      row_y[r] = 0.f;
    } else {
      row_x[r] = row < nq ? lse_b[row] * kLog2e : CUDART_INF_F;
      row_y[r] = row < nq ? di_b[row] : 0.f;
    }
  }

  // the running outputs and one tile's contributions to them (out2: dk/dv only)
  constexpr int N2 = KV ? D / 2 : 1;
  float acc1[D / 2], acc2[N2], t1[D / 2], t2[N2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc1[i] = t1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N2; ++i) acc2[i] = t2[i] = 0.f;
  mbar_wait(rowbar, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % kStages;
    // refill the stage of the previous tile once every warp is done with it
    if (producer && tile > 0 && tile - 1 + kStages < n_tiles) {
      mbar_wait(empty + 8 * ((tile - 1) % kStages), ((tile - 1) / kStages) & 1);
      load_cols(tile - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, (tile / kStages) & 1);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
    const float* colf = vals + s * 2 * BC;

    // S = A C^T and dP = B D^T, 64 x BC, issued together
    float sc[BC / 2], dp[BC / 2];
    wgmma_fence();
    score_product<D>(sc, sA, T::kRowPlane, T::BR, wg * 64, col_plane(s, 0), T::kColPlane);
    wgmma_commit();
    score_product<D>(dp, sB, T::kRowPlane, T::BR, wg * 64, col_plane(s, 2), T::kColPlane);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P in f32 (kept for dS); for dk/dv split into A fragments for dV += P^T dO
    uint32_t ph[BC / 8][4], pl[BC / 8][4], sh[BC / 8][4], sl[BC / 8][4];
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      const float2 col = *reinterpret_cast<const float2*>(colf + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float cv = (e & 1) ? col.y : col.x;
        const float l2 = KV ? cv : row_x[r];
        const float keep = KV ? row_x[r] : cv;
        float& x = sc[4 * nt + e];
        x = l2 < kDeadRow ? (keep >= 0.f ? inv_nk : 0.f) : (keep > 0.f ? ex2(fmaf(x, scale_log2, -l2)) : 0.f);
      }
      if (KV) split_fragment(sc + 4 * nt, ph[nt], pl[nt]);
    }
    if constexpr (KV) {  // dV's tile: P^T dO
      fence_regs(t2);
      wgmma_fence();
      output_product<D>(t2, ph, pl, col_plane(s, 6), T::kColPlane);
      wgmma_commit();
      wgmma_wait<1>();  // dP has landed; dV may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dp);

    // dS = P (dP - di) scale, split into A fragments
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      const float2 col = *reinterpret_cast<const float2*>(colf + nt * 8 + 2 * t);
      const float2 col_di = *reinterpret_cast<const float2*>(colf + BC + nt * 8 + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float l2 = KV ? ((e & 1) ? col.y : col.x) : row_x[r];
        const float dii = KV ? ((e & 1) ? col_di.y : col_di.x) : row_y[r];
        ds[e] = l2 < kDeadRow ? 0.f : sc[4 * nt + e] * (dp[4 * nt + e] - dii) * scale;
      }
      split_fragment(ds, sh[nt], sl[nt]);
    }
    // dQ's tile dS K, or dK's tile dS^T Q
    fence_regs(t1);
    wgmma_fence();
    output_product<D>(t1, sh, sl, col_plane(s, 4), T::kColPlane);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(t1);
    if constexpr (KV) fence_regs(t2);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc1[i] += t1[i];
    if constexpr (KV) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc2[i] += t2[i];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nrow) continue;
    const size_t at = ((size_t)bh * nrow + row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(out1 + at + 8 * j) = make_float2(acc1[4 * j + 2 * r], acc1[4 * j + 2 * r + 1]);
      if (KV) *reinterpret_cast<float2*>(out2 + at + 8 * j) = make_float2(acc2[4 * j + 2 * r], acc2[4 * j + 2 * r + 1]);
    }
  }
}

// planes: Q hi, Q lo, K hi, K lo, V hi, V lo, dO hi, dO lo ((bh, n, D) f32), then the transposed planes
// (tf32_planes.cu) K^T hi, K^T lo (the dq pass) or Q^T hi, Q^T lo, dO^T hi, dO^T lo (the dk/dv pass).
template <int D, bool KV, int WG>
cudaError_t run(const void* const* planes, const void* mask, const void* lse, const void* di, void* out1,
                void* out2, int bh, int heads, int nq, int nk, float scale, cudaStream_t stream) {
  using T = Tile<D, KV, WG>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const void* const* q = planes;
  const void* const* k = planes + 2;
  const void* const* v = planes + 4;
  const void* const* dout = planes + 6;
  const void* const* a = KV ? k : q;
  const void* const* b = KV ? v : dout;
  const void* const* c = KV ? q : k;
  const void* const* d = KV ? dout : v;
  const int nrow = KV ? nk : nq, ncol = KV ? nq : nk, ncol_pad = (ncol + 7) / 8 * 8;
  constexpr auto kW128 = CU_TENSOR_MAP_SWIZZLE_128B, kW32 = CU_TENSOR_MAP_SWIZZLE_32B;
  Maps maps = {};
  bool ok = true;
  for (int p = 0; p < 2; ++p) {
    ok = ok && make_map(&maps.a[p], a[p], D, nrow, bh, 32, T::BR, kW128, true) &&
         make_map(&maps.b[p], b[p], D, nrow, bh, 32, T::BR, kW128, true) &&
         make_map(&maps.c[p], c[p], D, ncol, bh, 32, BC, kW128, true) &&
         make_map(&maps.d[p], d[p], D, ncol, bh, 32, BC, kW128, true) &&
         make_map(&maps.ct[p], planes[8 + p], ncol_pad, D, bh, 32, D, kW128, true);
    if (KV) ok = ok && make_map(&maps.dt[p], planes[10 + p], ncol_pad, D, bh, 32, D, kW128, true);
    if (D % 32 != 0)
      ok = ok && make_map(&maps.a_tail[p], a[p], D, nrow, bh, 8, T::BR, kW32, true) &&
           make_map(&maps.b_tail[p], b[p], D, nrow, bh, 8, T::BR, kW32, true) &&
           make_map(&maps.c_tail[p], c[p], D, ncol, bh, 8, BC, kW32, true) &&
           make_map(&maps.d_tail[p], d[p], D, ncol, bh, 8, BC, kW32, true);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto fn = kernel<D, KV, WG>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nrow + T::BR - 1) / T::BR, bh);
  fn<<<grid, T::kThreads, T::kSmem, stream>>>(maps, static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
                                           static_cast<const float*>(di), static_cast<float*>(out1),
                                           static_cast<float*>(out2), heads, nq, nk, scale);
  return cudaGetLastError();
}

// Two warpgroups a block where the pass has 128 rows or more, else one (Tile).
template <int D, bool KV>
cudaError_t launch(const void* const* planes, const void* mask, const void* lse, const void* di, void* out1,
                   void* out2, int bh, int heads, int nq, int nk, float scale, cudaStream_t stream) {
  return (KV ? nk : nq) >= 128 ? run<D, KV, 2>(planes, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, stream)
                               : run<D, KV, 1>(planes, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, stream);
}

template <int D, bool KV, int WG>
cudaError_t occupancy(int* smem_bytes, int* blocks_per_sm) {
  using T = Tile<D, KV, WG>;
  *smem_bytes = (int)T::kSmem;
  auto fn = kernel<D, KV, WG>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, T::kThreads, T::kSmem);
}

template <int D>
cudaError_t occupancy(int kv, int wg, int* smem_bytes, int* blocks_per_sm) {
  if (wg == 2) return kv ? occupancy<D, true, 2>(smem_bytes, blocks_per_sm) : occupancy<D, false, 2>(smem_bytes, blocks_per_sm);
  if (wg == 1) return kv ? occupancy<D, true, 1>(smem_bytes, blocks_per_sm) : occupancy<D, false, 1>(smem_bytes, blocks_per_sm);
  return cudaErrorInvalidValue;
}

}  // namespace bwd_tf32

// The bf16 form at one head dim; cudaErrorInvalidValue for any other.
template <bool KV>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
                     const void* lse, const void* di, void* out1, void* out2, int bh, int heads, int nq, int nk,
                     int d, float scale, cudaStream_t s) {
  if (d == 64) return bwd16::launch<64, KV>(q, k, v, dout, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s);
  if (d == 72) return bwd16::launch<72, KV>(q, k, v, dout, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout, dq: (bh, nq, d); k, v, dk, dv: (bh, nk, d), contiguous bf16 (is_bf16
// must be 1: the f32 form is flash_attn_bwd_f32); lse, di: (bh, nq) f32; mask:
// (bh / heads, nk) bytes, or null for no mask. d = 64 or 72. Each returns a
// cudaError_t; 0 means the launch was accepted.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* mask, const void* lse, const void* di, void* dq, int bh,
                                 int heads, int nq, int nk, int d, float scale, int is_bf16, void* stream) {
  if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<false>(q, k, v, dout, mask, lse, di, dq, nullptr, bh, heads, nq, nk, d, scale,
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* mask, const void* lse, const void* di, void* dk, void* dv,
                                  int bh, int heads, int nq, int nk, int d, float scale, int is_bf16,
                                  void* stream) {
  if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<true>(q, k, v, dout, mask, lse, di, dk, dv, bh, heads, nq, nk, d, scale,
                                         static_cast<cudaStream_t>(stream)));
}

// The f32 form of one pass (kv = 0: dq into out1; kv = 1: dk into out1, dv into
// out2) at head dim d (32, 64 or 72) on the split planes of tf32_planes.cu: planes
// holds Q hi, Q lo, K hi, K lo, V hi, V lo, dO hi, dO lo ((bh, n, d) f32), then
// K^T hi, K^T lo for dq, or Q^T hi, Q^T lo, dO^T hi, dO^T lo for dk/dv ((bh, d,
// n rounded up to a multiple of 8) f32). Returns a cudaError_t.
extern "C" int flash_attn_bwd_f32(const void* const* planes, const void* mask, const void* lse, const void* di,
                                  void* out1, void* out2, int kv, int bh, int heads, int nq, int nk, int d,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return static_cast<int>(kv ? bwd_tf32::launch<32, true>(planes, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s)
                               : bwd_tf32::launch<32, false>(planes, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s));
  if (d == 64)
    return static_cast<int>(kv ? bwd_tf32::launch<64, true>(planes, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s)
                               : bwd_tf32::launch<64, false>(planes, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s));
  if (d == 72)
    return static_cast<int>(kv ? bwd_tf32::launch<72, true>(planes, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s)
                               : bwd_tf32::launch<72, false>(planes, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 form's shared memory a block and blocks an SM for one pass (kv = 0:
// dq, 1: dk/dv) at head dim d (64 or 72); cudaErrorInvalidValue for another.
extern "C" int flash_attn_bwd_occupancy(int d, int kv, int* smem_bytes, int* blocks_per_sm) {
  if (d == 64) return static_cast<int>(kv ? bwd16::occupancy<64, true>(smem_bytes, blocks_per_sm)
                                          : bwd16::occupancy<64, false>(smem_bytes, blocks_per_sm));
  if (d == 72) return static_cast<int>(kv ? bwd16::occupancy<72, true>(smem_bytes, blocks_per_sm)
                                          : bwd16::occupancy<72, false>(smem_bytes, blocks_per_sm));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for the f32 form's block of wg (1 or 2) warpgroups.
extern "C" int flash_attn_bwd_occupancy_f32(int d, int kv, int wg, int* smem_bytes, int* blocks_per_sm) {
  if (d == 32) return static_cast<int>(bwd_tf32::occupancy<32>(kv, wg, smem_bytes, blocks_per_sm));
  if (d == 64) return static_cast<int>(bwd_tf32::occupancy<64>(kv, wg, smem_bytes, blocks_per_sm));
  if (d == 72) return static_cast<int>(bwd_tf32::occupancy<72>(kv, wg, smem_bytes, blocks_per_sm));
  return static_cast<int>(cudaErrorInvalidValue);
}
