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
// and ControlNet of the LDM trainer) and 72 (the DiT); head dim 512 takes no
// gradient:
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
// * f32 (namespace bwd32): tiles of 32 x 32 in shared memory on odd strides,
//   plain FMAs, the accumulators in registers (d / 4 outputs per thread and
//   product).
//
// What bounds it on this card: 10 * BH * Nq * Nk * d useful operations against
// a few MB of operands, far above the ridge point, so operations bound it. A
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
// f32, head dims 64 and 72: shared-memory tiles and FMAs.

namespace bwd32 {

constexpr int kThreads = 128;
constexpr int BR = 32, BC = 32;  // rows a block owns; columns per streamed tile
constexpr int LP = BC + 1;       // odd row stride of the P and dS tiles

// The operand tiles' row stride is D + 1, odd (65, 73): no bank conflicts.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BR * (D + 1) + 2 * BC * (D + 1) + 2 * BR * LP + 2 * BR + 2 * BC);
}

// Rows [row0, row0 + ROWS) of a row-major (n, D) matrix into a (ROWS, D + 1) tile, zero past n.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D, col = e % D;
    dst[r * (D + 1) + col] = row0 + r < n ? src[(size_t)(row0 + r) * D + col] : 0.f;
  }
}

template <int D, bool KV>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ dout, const uint8_t* __restrict__ mask, const float* __restrict__ lse,
       const float* __restrict__ di, float* __restrict__ out1, float* __restrict__ out2, int heads, int nq,
       int nk, float scale) {
  constexpr int LD = D + 1;
  constexpr int kPer = BR * D / kThreads;  // outputs per thread and product
  static_assert(BR * D % kThreads == 0, "the outputs split evenly over the threads");
  extern __shared__ __align__(128) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = sA + BR * LD;
  float* sC = sB + BR * LD;
  float* sD = sC + BC * LD;
  float* sP = sD + BC * LD;
  float* sS = sP + BR * LP;
  float* sRow = sS + BR * LP;  // 2 * BR per-row values
  float* sCol = sRow + 2 * BR; // 2 * BC per-column values

  const int bh = blockIdx.y, r0 = blockIdx.x * BR;
  const int nrow = KV ? nk : nq, ncol = KV ? nq : nk;
  const float* rowA = (KV ? k : q) + (size_t)bh * nrow * D;
  const float* rowB = (KV ? v : dout) + (size_t)bh * nrow * D;
  const float* colC = (KV ? q : k) + (size_t)bh * ncol * D;
  const float* colD = (KV ? dout : v) + (size_t)bh * ncol * D;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const float* lse_b = lse + (size_t)bh * nq;
  const float* di_b = di + (size_t)bh * nq;
  const float inv_nk = 1.f / (float)nk;

  // Values that follow the queries (L, di) or the keys (the flag), for rows or columns.
  auto side_values = [&](float* dst, int n, int first, bool keys) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int idx = first + j;
      if (keys) {
        dst[j] = key_flag(mb, idx, nk);
        dst[n + j] = 0.f;
      } else {
        dst[j] = idx < nq ? lse_b[idx] : CUDART_INF_F;
        dst[n + j] = idx < nq ? di_b[idx] : 0.f;
      }
    }
  };

  load_tile<D, BR>(sA, rowA, r0, nrow);
  load_tile<D, BR>(sB, rowB, r0, nrow);
  side_values(sRow, BR, r0, KV);

  float acc1[kPer], acc2[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) acc1[n] = acc2[n] = 0.f;

  for (int c0 = 0; c0 < ncol; c0 += BC) {
    __syncthreads();  // the previous tile's products are done with sC, sD, sP, sS
    load_tile<D, BC>(sC, colC, c0, ncol);
    load_tile<D, BC>(sD, colD, c0, ncol);
    side_values(sCol, BC, c0, !KV);
    __syncthreads();

    for (int e = threadIdx.x; e < BR * BC; e += kThreads) {
      const int i = e / BC, j = e % BC;
      const float* a = sA + i * LD;
      const float* b = sB + i * LD;
      const float* c = sC + j * LD;
      const float* d = sD + j * LD;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int x = 0; x < D; ++x) {
        s = fmaf(a[x], c[x], s);
        dp = fmaf(b[x], d[x], dp);
      }
      const float l = KV ? sCol[j] : sRow[i];
      const float dii = KV ? sCol[BC + j] : sRow[BR + i];
      const float keep = KV ? sRow[i] : sCol[j];
      const bool dead = l < kDeadRow;
      const float p = dead ? (keep >= 0.f ? inv_nk : 0.f) : (keep > 0.f ? expf(s * scale - l) : 0.f);
      sP[i * LP + j] = p;
      sS[i * LP + j] = dead ? 0.f : p * (dp - dii) * scale;
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int e = threadIdx.x + n * kThreads;
      const int i = e / D, c = e % D;
      float a1 = acc1[n], a2 = acc2[n];
#pragma unroll 8
      for (int j = 0; j < BC; ++j) {
        a1 = fmaf(sS[i * LP + j], sC[j * LD + c], a1);
        if (KV) a2 = fmaf(sP[i * LP + j], sD[j * LD + c], a2);
      }
      acc1[n] = a1;
      acc2[n] = a2;
    }
  }

#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int i = e / D, c = e % D;
    if (r0 + i >= nrow) continue;
    const size_t at = ((size_t)bh * nrow + r0 + i) * D + c;
    out1[at] = acc1[n];
    if (KV) out2[at] = acc2[n];
  }
}

template <int D, bool KV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
                   const void* lse, const void* di, void* out1, void* out2, int bh, int heads, int nq,
                   int nk, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<D>();
  auto fn = kernel<D, KV>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((KV ? nk : nq) + BR - 1) / BR, bh);
  fn<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(out1), static_cast<float*>(out2), heads, nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace bwd32

// Both forms at one head dim; cudaErrorInvalidValue for any other.
template <bool KV>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
                     const void* lse, const void* di, void* out1, void* out2, int bh, int heads, int nq, int nk,
                     int d, float scale, int is_bf16, cudaStream_t s) {
  if (d == 64)
    return is_bf16 ? bwd16::launch<64, KV>(q, k, v, dout, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s)
                   : bwd32::launch<64, KV>(q, k, v, dout, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s);
  if (d == 72)
    return is_bf16 ? bwd16::launch<72, KV>(q, k, v, dout, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s)
                   : bwd32::launch<72, KV>(q, k, v, dout, mask, lse, di, out1, out2, bh, heads, nq, nk, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout, dq: (bh, nq, d); k, v, dk, dv: (bh, nk, d), contiguous and of one type
// (bf16 when is_bf16, else f32); lse, di: (bh, nq) f32; mask: (bh / heads, nk)
// bytes, or null for no mask. d = 64 or 72. Each returns a cudaError_t; 0
// means the launch was accepted.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* mask, const void* lse, const void* di, void* dq, int bh,
                                 int heads, int nq, int nk, int d, float scale, int is_bf16, void* stream) {
  return static_cast<int>(dispatch<false>(q, k, v, dout, mask, lse, di, dq, nullptr, bh, heads, nq, nk, d, scale,
                                          is_bf16, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* mask, const void* lse, const void* di, void* dk, void* dv,
                                  int bh, int heads, int nq, int nk, int d, float scale, int is_bf16,
                                  void* stream) {
  return static_cast<int>(dispatch<true>(q, k, v, dout, mask, lse, di, dk, dv, bh, heads, nq, nk, d, scale,
                                         is_bf16, static_cast<cudaStream_t>(stream)));
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
