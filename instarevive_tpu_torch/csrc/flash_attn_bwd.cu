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
//     dQ = dS K          (dq pass: a block owns 64 queries and walks the keys)
//     dV = P^T dO, dK = dS^T Q
//                        (dk/dv pass: a block owns 64 keys and walks the queries)
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
// * bf16: each of the 4 warps owns 16 rows; S, dP and the accumulators live in
//   registers and all five products run on the tensor cores as mma.sync
//   m16n8k16 (bf16 x bf16 -> f32). P and dS leave the softmax already in the
//   A-fragment layout of the next product; the transposed products need no
//   transposed copy because the dk/dv pass computes S^T directly (K as the
//   row operand). The row operands are re-read from shared memory per k-step
//   rather than held, to keep the two 16 x 80 accumulators of the dk/dv pass
//   and both 16 x 64 tiles within the register file. Column tiles are
//   double-buffered with cp.async. Head dim 72 is zero-padded to 80 in shared
//   memory only; 64 needs no padding.
// * f32: tiles of 32 x 32 in shared memory on odd strides, plain FMAs, the
//   accumulators in registers (d / 4 outputs per thread and product).
//
// What bounds it on this card: 10 * BH * Nq * Nk * d useful operations against
// a few MB of operands, far above the ridge point, so the bf16 form is bound by
// mma.sync throughput and the exp2 of the recomputed softmax, at a fraction of the
// wgmma peak; the dk/dv pass at Nk = 300 fills only 5 x BH blocks. wgmma, TMA
// and a split of the query range for short key counts are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kDeadRow = -1e29f;  // L below this: every key of the row was masked (L = -1e30)

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async_16(bf16* dst, const bf16* src, bool valid) {
  // src-size 0 zero-fills the 16 destination bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Key flag: 1 keep, 0 masked, -1 past Nk.
__device__ __forceinline__ float key_flag(const uint8_t* mb, int key, int nk) {
  return key >= nk ? -1.f : (mb == nullptr || mb[key] != 0) ? 1.f : 0.f;
}

// ---------------------------------------------------------------------------
// bf16, head dims 64 and 72, tensor cores: one body templated on the head dim.

namespace bwd16 {

constexpr int kThreads = 128;
constexpr int BR = 64, BC = 64;  // rows a block owns (16 per warp); columns per streamed tile
constexpr int kNT = BC / 8;      // n-tiles of the 16 x 64 score tile

// Per head dim D: DP, its MMA padding, and LDS, the shared row stride in
// halves; an odd number of 16-byte chunks a row (144 B for 64, 176 B for 72)
// puts the 8 rows of an ldmatrix on 8 bank groups.
template <int D> struct Dims;
template <> struct Dims<64> { static constexpr int DP = 64, LDS = 72; };
template <> struct Dims<72> { static constexpr int DP = 80, LDS = 88; };

template <int D>
constexpr size_t smem_bytes() { return sizeof(bf16) * (2 * BR + 4 * BC) * Dims<D>::LDS + sizeof(float) * 4 * BC; }

// Rows [row0, row0 + ROWS) x columns [0, DP) of a row-major (n, D) bf16 matrix
// into a (ROWS, LDS) shared tile by cp.async, zero-filled past n and past D.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n) {
  constexpr int LDS = Dims<D>::LDS;
  constexpr int kChunks = Dims<D>::DP / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = row0 + r < n && col < D;
    cp_async_16(dst + r * LDS + col, valid ? src + (size_t)(row0 + r) * D + col : src, valid);
  }
}

// acc (16 x 64 per warp) = rows (this warp's 16 of a shared tile) x cols^T.
template <int D>
__device__ __forceinline__ void rows_times_cols_t(float (&acc)[kNT][4], const bf16* rows, const bf16* cols,
                                                  int warp, int lane) {
  constexpr int LDS = Dims<D>::LDS, kKS = Dims<D>::DP / 16;  // k-steps over the head dim
#pragma unroll
  for (int i = 0; i < kNT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, rows + (warp * 16 + lane % 16) * LDS + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, cols + (np * 16 + (lane / 16) * 8 + lane % 8) * LDS + ks * 16 + ((lane / 8) % 2) * 8);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DP per warp) += frag (16 x 64, A fragments) x cols (64 x DP shared tile).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[Dims<D>::DP / 8][4], const uint32_t (&frag)[BC / 16][4],
                                           const bf16* cols, int lane) {
  constexpr int LDS = Dims<D>::LDS, kDT = Dims<D>::DP / 8;
#pragma unroll
  for (int c = 0; c < BC / 16; ++c) {
#pragma unroll
    for (int dp = 0; dp < kDT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, cols + (c * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDS + dp * 16 + (lane / 16) * 8);
      mma(acc[2 * dp], frag[c], b[0], b[1]);
      mma(acc[2 * dp + 1], frag[c], b[2], b[3]);
    }
  }
}

// A 16 x 64 f32 tile in mma accumulator layout, rounded to bf16 A fragments.
__device__ __forceinline__ void to_fragments(uint32_t (&frag)[BC / 16][4], const float (&x)[kNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    frag[nt / 2][(nt % 2) * 2] = pack_bf16(x[nt][0], x[nt][1]);
    frag[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
  }
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[Dims<D>::DP / 8][4], int row0, int n,
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// KV = false: the dq pass (out1 = dQ, out2 unused). KV = true: the dk/dv pass
// (out1 = dK, out2 = dV). ptxas -v (sm_90a, CUDA 12.8), registers per thread:
// d = 72, 159 (dq) and 216 (dk/dv), no spills; d = 64, 128 (dq, with 24 bytes
// of spill stores and 8 of loads: ptxas stops at 128 there) and 165 (dk/dv, no
// spills). chip_smoke.py's build line prints them.
template <int D, bool KV>
__global__ void __launch_bounds__(kThreads)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const bf16* __restrict__ dout, const uint8_t* __restrict__ mask, const float* __restrict__ lse,
       const float* __restrict__ di, bf16* __restrict__ out1, bf16* __restrict__ out2, int heads, int nq,
       int nk, float scale) {
  constexpr int LDS = Dims<D>::LDS, kDT = Dims<D>::DP / 8;  // n-tiles of a 16 x DP accumulator
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + BR * LDS;
  bf16* sC = sB + BR * LDS;      // two stages
  bf16* sD = sC + 2 * BC * LDS;  // two stages
  float* sCol = reinterpret_cast<float*>(sD + 2 * BC * LDS);  // two stages of 2 * BC per-column values

  const int bh = blockIdx.y, r0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  const int nrow = KV ? nk : nq, ncol = KV ? nq : nk;
  const bf16* rowA = (KV ? k : q) + (size_t)bh * nrow * D;
  const bf16* rowB = (KV ? v : dout) + (size_t)bh * nrow * D;
  const bf16* colC = (KV ? q : k) + (size_t)bh * ncol * D;
  const bf16* colD = (KV ? dout : v) + (size_t)bh * ncol * D;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const float* lse_b = lse + (size_t)bh * nq;
  const float* di_b = di + (size_t)bh * nq;
  const float scale_log2 = scale * kLog2e;
  const float inv_nk = 1.f / (float)nk;
  const int n_tiles = (ncol + BC - 1) / BC;

  // Per-column values of a tile: the key flag (dq), or L in the log2 domain and di (dk/dv).
  auto load_cols = [&](int tile, int stage) {
    const int c0 = tile * BC;
    load_rows<D, BC>(sC + stage * BC * LDS, colC, c0, ncol);
    load_rows<D, BC>(sD + stage * BC * LDS, colD, c0, ncol);
    float* f = sCol + stage * 2 * BC;
    for (int j = threadIdx.x; j < BC; j += kThreads) {
      const int c = c0 + j;
      if (KV) {
        f[j] = c < nq ? lse_b[c] * kLog2e : CUDART_INF_F;
        f[BC + j] = c < nq ? di_b[c] : 0.f;
      } else {
        f[j] = key_flag(mb, c, nk);
      }
    }
  };

  load_rows<D, BR>(sA, rowA, r0, nrow);
  load_rows<D, BR>(sB, rowB, r0, nrow);
  load_cols(0, 0);
  cp_async_commit();

  // Per-row values of this thread's rows g and g + 8: L and di (dq), or the key flag (dk/dv).
  float row_x[2], row_y[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (KV) {
      row_x[r] = key_flag(mb, row, nk);
      row_y[r] = 0.f;
    } else {
      row_x[r] = row < nq ? lse_b[row] * kLog2e : CUDART_INF_F;
      row_y[r] = row < nq ? di_b[row] : 0.f;
    }
  }

  float acc1[kDT][4], acc2[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) {
    acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.f;
    acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) load_cols(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // this tile (and the row operands) have landed
    __syncthreads();
    const bf16* tc = sC + stage * BC * LDS;
    const bf16* td = sD + stage * BC * LDS;
    const float* colf = sCol + stage * 2 * BC;

    // P from the recomputed scores
    float s[kNT][4];
    rows_times_cols_t<D>(s, sA, tc, warp, lane);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = nt * 8 + 2 * t + (e & 1);
        const float l2 = KV ? colf[j] : row_x[r];
        const float keep = KV ? row_x[r] : colf[j];
        s[nt][e] = l2 < kDeadRow ? (keep >= 0.f ? inv_nk : 0.f)
                                 : (keep > 0.f ? exp2f(s[nt][e] * scale_log2 - l2) : 0.f);
      }
    }
    uint32_t frag[BC / 16][4];
    if (KV) {  // dV += P^T dO
      to_fragments(frag, s);
      accumulate<D>(acc2, frag, td, lane);
    }

    // dS = P (dP - di) scale
    float dp[kNT][4];
    rows_times_cols_t<D>(dp, sB, td, warp, lane);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = nt * 8 + 2 * t + (e & 1);
        const float l2 = KV ? colf[j] : row_x[r];
        const float dii = KV ? colf[BC + j] : row_y[r];
        s[nt][e] = l2 < kDeadRow ? 0.f : s[nt][e] * (dp[nt][e] - dii) * scale;
      }
    }
    to_fragments(frag, s);
    accumulate<D>(acc1, frag, tc, lane);  // dQ += dS K, or dK += dS^T Q
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  store_rows<D>(out1 + (size_t)bh * nrow * D, acc1, r0 + warp * 16, nrow, g, t);
  if (KV) store_rows<D>(out2 + (size_t)bh * nrow * D, acc2, r0 + warp * 16, nrow, g, t);
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
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const uint8_t*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(out1), static_cast<bf16*>(out2), heads, nq, nk, scale);
  return cudaGetLastError();
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
