// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C launcher loaded with ctypes (instarevive_tpu_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// instarevive_tpu/ops/attention.py (reached through `_flash_fwd_impl` and
// `flash_attention`): online-softmax attention with f32 scores and
// accumulators, an optional (B, Nk) boolean key mask whose masked scores are
// -1e30, and ragged Nq / Nk. With a non-null `lse` the head-dim-72 forms also
// write the row log-sum-exp m + log(max(l, 1e-30)) (the kernel's `emit_lse`
// output), one f32 per query row, which the backward (flash_attn_bwd.cu) reads;
// a row whose keys are all masked gets exactly -1e30. Inference passes null and
// pays one branch per row.
//
// Work split: one block per (batch*head, q-tile), looping over key tiles with
// an online softmax (running max, running sum, f32 accumulator), so no
// N x N score matrix ever reaches device memory. Ragged edges are
// bounds-checked, never padded in device memory: rows past Nq are zero and
// never stored, keys past Nk get a score of -inf (weight exactly 0) and zero
// V rows. The key mask is read per key tile from the (B, Nk) array and shared
// by all heads of a batch row.
//
// Three forms:
// * bf16, head dim 72 (the DiT: 56 of the 58 launches of one restoration
//   call) runs FlashAttention-2 style. Each of the 4 warps owns 16 query rows
//   and keeps S, P and the output accumulator in registers; both products
//   run on the tensor cores as mma.sync m16n8k16 (bf16 x bf16 -> f32), with
//   P rounded to bf16 before P.V as the TPU kernel does. Head dim 72 is
//   zero-padded to 80 in shared memory (the MMA depth is 16).
// * bf16, head dim 512 (the VAE mid block): one warp cannot hold a 512-wide
//   accumulator, so the 8 warps of a block split both products. For S each
//   warp takes a 64-wide slice of the head dim for all 32 query rows (its Q
//   slice in registers) and the 8 partial score tiles meet in shared memory,
//   where the softmax sums them; for P.V each warp owns 64 output columns of
//   all 32 rows in registers.
// * f32, both head dims, keeps the scores and the accumulator in shared
//   memory and runs plain FMAs on odd-strided tiles (no bank conflicts).
// The bf16 forms double-buffer K and V tiles in shared memory with cp.async,
// so the next tile loads while this one computes. Other head dims are refused.
//
// What bounds it on this card: at the DiT shapes the work is far above the
// H100's bf16 ridge point (~295 FLOP/byte), so the head-dim-72 form is bound
// by mma.sync throughput and the exp/max work of the softmax, at a fraction
// of the wgmma peak. The head-dim-512 form re-reads every K/V tile from L2
// once per 32 query rows, so L2 bandwidth bounds it; its 210 KB of shared
// memory allow one block per SM. The f32 form is bound by shared-memory
// traffic and the barriers between its phases. wgmma, TMA and warp
// specialisation are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskedScore = -1e30f;  // as the plain version: masked keys keep a finite score

// ---------------------------------------------------------------------------
// PTX helpers of the bf16 forms.

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
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Rows [row0, row0 + ROWS) x columns [0, DP) of a row-major (n, D) bf16
// matrix into a (ROWS, LDS) shared tile by cp.async, zero-filled past n and
// past column D.
template <int THREADS, int ROWS, int D, int DP, int LDS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int n) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = row0 + r < n && col < D;
    cp_async_16(dst + r * LDS + col, valid ? src + (size_t)(row0 + r) * D + col : src, valid);
  }
}

// Key flags of one tile: 1 keep, 0 masked, -1 past Nk.
template <int THREADS, int BK>
__device__ __forceinline__ void load_keep(float* dst, const uint8_t* mb, int kv0, int nk) {
  for (int j = threadIdx.x; j < BK; j += THREADS) {
    const int key = kv0 + j;
    dst[j] = key >= nk ? -1.f : (mb == nullptr || mb[key] != 0) ? 1.f : 0.f;
  }
}

// A tile's score in the log2 domain, from its key flag.
__device__ __forceinline__ float masked_score(float s, float keep, float scale_log2) {
  return keep > 0.f ? s * scale_log2 : (keep == 0.f ? kMaskedScore : -CUDART_INF_F);
}

// ---------------------------------------------------------------------------
// bf16, head dim 72: register-resident tiles (FlashAttention-2 layout).

namespace fa2 {

constexpr int kThreads = 128;
constexpr int BQ = 64, BK = 64;  // 16 query rows per warp; keys per tile
constexpr int D = 72, DP = 80;   // head dim and its MMA padding
constexpr int LDS = 88;          // shared row stride: 176 B puts the 8 rows of an ldmatrix on 8 bank groups
constexpr int kNT = BK / 8;      // score n-tiles of 8 keys
constexpr int kDT = DP / 8;      // output n-tiles of 8 dims
constexpr int kKS = DP / 16;     // k-steps of Q.K^T
constexpr size_t kSmem = sizeof(bf16) * (BQ + 4 * BK) * LDS + sizeof(float) * 2 * BK;

__global__ void __launch_bounds__(kThreads)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const uint8_t* __restrict__ mask, bf16* __restrict__ out, float* __restrict__ lse, int heads,
       int nq, int nk, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDS;      // two stages
  bf16* sV = sK + 2 * BK * LDS;  // two stages
  float* sKeep = reinterpret_cast<float*>(sV + 2 * BK * LDS);  // two stages

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  const bf16* kb = k + (size_t)bh * nk * D;
  const bf16* vb = v + (size_t)bh * nk * D;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const int n_tiles = (nk + BK - 1) / BK;

  auto load_kv = [&](int tile, int stage) {
    const int kv0 = tile * BK;
    load_rows<kThreads, BK, D, DP, LDS>(sK + stage * BK * LDS, kb, kv0, nk);
    load_rows<kThreads, BK, D, DP, LDS>(sV + stage * BK * LDS, vb, kv0, nk);
    load_keep<kThreads, BK>(sKeep + stage * BK, mb, kv0, nk);
  };

  load_rows<kThreads, BQ, D, DP, LDS>(sQ, q + (size_t)bh * nq * D, q0, nq);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[kKS][4];
  float o[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {kMaskedScore, kMaskedScore}, l_run[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // this tile (and Q) have landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        ldsm_x4(qf[ks], sQ + (warp * 16 + lane % 16) * LDS + ks * 16 + (lane / 16) * 8);
    }
    const bf16* tk = sK + stage * BK * LDS;
    const bf16* tv = sV + stage * BK * LDS;
    const float* keep = sKeep + stage * BK;

    // S = Q K^T, 16 x 64 per warp
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, tk + (np * 16 + (lane / 16) * 8 + lane % 8) * LDS + ks * 16 + ((lane / 8) % 2) * 8);
        mma(s[2 * np], qf[ks], b[0], b[1]);
        mma(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // online softmax in the log2 domain; this thread holds rows g and g + 8
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = masked_score(s[nt][e], keep[nt * 8 + 2 * t + (e & 1)], scale_log2);
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    uint32_t pf[BK / 16][4];  // P as mma A fragments: n-tile pairs become 16-key k-steps
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_run[0]), p1 = exp2f(s[nt][1] - m_run[0]);
      const float p2 = exp2f(s[nt][2] - m_run[1]), p3 = exp2f(s[nt][3] - m_run[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pf[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, tv + (c * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDS + dp * 16 + (lane / 16) * 8);
        mma(o[2 * dp], pf[c], b[0], b[1]);
        mma(o[2 * dp + 1], pf[c], b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  bf16* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    // the running max is in the log2 domain; a row with no real key keeps the mask's score
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * nq + row] = m_run[r] <= kMaskedScore
                                       ? kMaskedScore
                                       : (m_run[r] + log2f(fmaxf(l_run[r], 1e-30f))) * 0.6931471805599453f;
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                   int bh, int heads, int nq, int nk, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse), heads, nq, nk,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace fa2

// ---------------------------------------------------------------------------
// bf16, head dim 512: both products split over the 8 warps of a block.

namespace wide {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int BQ = 32, BK = 32, D = 512;
constexpr int kSlice = D / kWarps;  // head dims (for S) or output columns (for P.V) per warp
constexpr int LDS = D + 8;          // 1040-byte rows put the 8 rows of an ldmatrix on 8 bank groups
constexpr int LDSP = BK + 8;        // partial-score rows of 40 words: conflict-free float2 stores
constexpr int LDP = BK + 8;         // P rows of 80 bytes, for ldmatrix as above
constexpr int kNT = BK / 8;         // score n-tiles of 8 keys
constexpr int kKS = kSlice / 16;    // k-steps of one warp's part of Q.K^T
constexpr int kDT = kSlice / 8;     // output n-tiles of 8 columns per warp
constexpr size_t kSmem = sizeof(bf16) * (BQ + 4 * BK) * LDS + sizeof(float) * kWarps * BQ * LDSP +
                         sizeof(bf16) * BQ * LDP + sizeof(float) * (2 * BQ + 2 * BK);
static_assert(kThreads == BQ * 8 && BK == 4 * 8, "the softmax gives each query row 8 threads of 4 keys");

__global__ void __launch_bounds__(kThreads, 1)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const uint8_t* __restrict__ mask, bf16* __restrict__ out, int heads, int nq, int nk,
       float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDS;      // two stages
  bf16* sV = sK + 2 * BK * LDS;  // two stages
  float* sSp = reinterpret_cast<float*>(sV + 2 * BK * LDS);  // each warp's partial S
  bf16* sP = reinterpret_cast<bf16*>(sSp + kWarps * BQ * LDSP);
  float* sAlpha = reinterpret_cast<float*>(sP + BQ * LDP);  // per-row rescale of this tile
  float* sL = sAlpha + BQ;                                   // final row sums
  float* sKeep = sL + BQ;                                    // two stages

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  const int slice = warp * kSlice;
  const int srow = threadIdx.x / 8, spart = threadIdx.x % 8;  // softmax: row, 4-key part
  const bf16* kb = k + (size_t)bh * nk * D;
  const bf16* vb = v + (size_t)bh * nk * D;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const int n_tiles = (nk + BK - 1) / BK;

  auto load_kv = [&](int tile, int stage) {
    const int kv0 = tile * BK;
    load_rows<kThreads, BK, D, D, LDS>(sK + stage * BK * LDS, kb, kv0, nk);
    load_rows<kThreads, BK, D, D, LDS>(sV + stage * BK * LDS, vb, kv0, nk);
    load_keep<kThreads, BK>(sKeep + stage * BK, mb, kv0, nk);
  };

  load_rows<kThreads, BQ, D, D, LDS>(sQ, q + (size_t)bh * nq * D, q0, nq);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[2][kKS][4];  // this warp's head-dim slice of Q: rows 0-15 and 16-31
  float o[2][kDT][4];      // this warp's output columns: rows 0-15 and 16-31
#pragma unroll
  for (int rg = 0; rg < 2; ++rg)
#pragma unroll
    for (int i = 0; i < kDT; ++i) o[rg][i][0] = o[rg][i][1] = o[rg][i][2] = o[rg][i][3] = 0.f;
  float m_run = kMaskedScore, l_run = 0.f;  // row srow, the same in its 8 threads

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed, and the previous tile's readers are done
    if (tile + 1 < n_tiles) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    if (tile == 0) {
#pragma unroll
      for (int rg = 0; rg < 2; ++rg)
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks)
          ldsm_x4(qf[rg][ks], sQ + (rg * 16 + lane % 16) * LDS + slice + ks * 16 + (lane / 16) * 8);
    }
    const bf16* tk = sK + stage * BK * LDS;
    const bf16* tv = sV + stage * BK * LDS;
    const float* keep = sKeep + stage * BK;

    // partial S over this warp's head-dim slice, 32 rows x 32 keys
    float s[2][kNT][4];
#pragma unroll
    for (int rg = 0; rg < 2; ++rg)
#pragma unroll
      for (int i = 0; i < kNT; ++i) s[rg][i][0] = s[rg][i][1] = s[rg][i][2] = s[rg][i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, tk + (np * 16 + (lane / 16) * 8 + lane % 8) * LDS + slice + ks * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int rg = 0; rg < 2; ++rg) {
          mma(s[rg][2 * np], qf[rg][ks], b[0], b[1]);
          mma(s[rg][2 * np + 1], qf[rg][ks], b[2], b[3]);
        }
      }
    }
    float* sp = sSp + warp * BQ * LDSP;
#pragma unroll
    for (int rg = 0; rg < 2; ++rg)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(sp + (rg * 16 + g + 8 * h) * LDSP + nt * 8 + 2 * t) =
              make_float2(s[rg][nt][2 * h], s[rg][nt][2 * h + 1]);
    __syncthreads();

    // online softmax in the log2 domain: the 8 partial sums, then row max and sum over 8 lanes
    {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 part = *reinterpret_cast<const float4*>(sSp + (w * BQ + srow) * LDSP + spart * 4);
        x[0] += part.x;
        x[1] += part.y;
        x[2] += part.z;
        x[3] += part.w;
      }
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[c] = masked_score(x[c], keep[spart * 4 + c], scale_log2);
        mx = fmaxf(mx, x[c]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      m_run = m_new;
      float p[4], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = exp2f(x[c] - m_new);
        sum += p[c];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run = l_run * alpha + sum;
      *reinterpret_cast<uint2*>(sP + srow * LDP + spart * 4) = make_uint2(pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]));
      if (spart == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // O = alpha O + P V over this warp's output columns
#pragma unroll
    for (int rg = 0; rg < 2; ++rg) {
      const float a0 = sAlpha[rg * 16 + g], a1 = sAlpha[rg * 16 + g + 8];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[rg][dt][0] *= a0;
        o[rg][dt][1] *= a0;
        o[rg][dt][2] *= a1;
        o[rg][dt][3] *= a1;
      }
    }
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t pf[2][4];
#pragma unroll
      for (int rg = 0; rg < 2; ++rg)
        ldsm_x4(pf[rg], sP + (rg * 16 + lane % 16) * LDP + c * 16 + (lane / 16) * 8);
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, tv + (c * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDS + slice + dp * 16 + (lane / 16) * 8);
#pragma unroll
        for (int rg = 0; rg < 2; ++rg) {
          mma(o[rg][2 * dp], pf[rg], b[0], b[1]);
          mma(o[rg][2 * dp + 1], pf[rg], b[2], b[3]);
        }
      }
    }
  }
  if (spart == 0) sL[srow] = l_run;
  __syncthreads();

  bf16* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int rg = 0; rg < 2; ++rg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rg * 16 + g + 8 * h;
      if (q0 + row >= nq) continue;
      const float inv = 1.f / fmaxf(sL[row], 1e-30f);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(q0 + row) * D + slice + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(o[rg][dt][2 * h] * inv, o[rg][dt][2 * h + 1] * inv);
    }
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, int bh,
                   int heads, int nq, int nk, float scale, cudaStream_t stream) {
  static_assert(kSmem <= 232448, "shared memory over the per-block limit");
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), heads, nq, nk,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace wide

// ---------------------------------------------------------------------------
// f32, head dims 72 and 512: scores and accumulator in shared memory, FMAs.

namespace fp32 {

constexpr int kThreads = 128;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory layout of one block. BQ query rows, BK keys per tile, DP the
// padded head dim, LD the (odd) row stride of the Q and K tiles.
template <int BQ, int BK, int DP, int LD>
struct Layout {
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(float) * BQ * LD);
  static constexpr size_t v = k + align128(sizeof(float) * BK * LD);
  static constexpr size_t s = v + align128(sizeof(float) * BK * DP);
  static constexpr size_t o = s + align128(sizeof(float) * BQ * BK);
  static constexpr size_t m = o + align128(sizeof(float) * BQ * DP);
  static constexpr size_t l = m + align128(sizeof(float) * BQ);
  static constexpr size_t keep = l + align128(sizeof(float) * BQ);
  static constexpr size_t bytes = keep + align128(sizeof(float) * BK);
};

// Copies rows [row0, row0 + ROWS) of a row-major (n, d) matrix into a
// (ROWS, LD) shared tile, zero-filling rows >= n and columns in [d, DP).
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n, int d) {
  for (int e = threadIdx.x; e < ROWS * DP; e += kThreads) {
    const int r = e / DP, col = e % DP;
    dst[r * LD + col] = (row0 + r < n && col < d) ? src[(size_t)(row0 + r) * d + col] : 0.f;
  }
}

// S = Q K^T for one key tile (unscaled).
template <int BQ, int BK, int DP, int LD>
__device__ __forceinline__ void tile_scores(const float* sQ, const float* sK, float* sS) {
  for (int e = threadIdx.x; e < BQ * BK; e += kThreads) {
    const int i = e / BK, j = e % BK;
    const float* qr = sQ + i * LD;
    const float* kr = sK + j * LD;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) acc = fmaf(qr[c], kr[c], acc);
    sS[e] = acc;
  }
}

// Online-softmax step for one key tile: scale and mask the scores, update the
// running max and sum, write P in place in sS and rescale the output
// accumulator rows by exp(m_old - m_new).
template <int BQ, int BK, int DP>
__device__ __forceinline__ void tile_softmax(float* sS, float* sO, float* sM, float* sL,
                                             const float* sKeep, float scale, int kv0, int nk) {
  constexpr int kTpr = kThreads / BQ;  // threads per row, a power of two within one warp
  constexpr int kCols = BK / kTpr;
  const int row = threadIdx.x / kTpr, part = threadIdx.x % kTpr;
  float* s = sS + row * BK + part * kCols;
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = part * kCols + c;
    float x = -CUDART_INF_F;  // keys past Nk take no weight at all
    if (kv0 + j < nk) x = sKeep[j] != 0.f ? s[c] * scale : kMaskedScore;
    s[c] = x;
    mx = fmaxf(mx, x);
  }
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float m_old = sM[row];
  const float m_new = fmaxf(m_old, mx);
  const float alpha = expf(m_old - m_new);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float p = expf(s[c] - m_new);
    sum += p;
    s[c] = p;
  }
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  float* o = sO + row * DP;
  for (int c = part; c < DP; c += kTpr) o[c] *= alpha;
  __syncwarp();
  if (part == 0) {
    sM[row] = m_new;
    sL[row] = sL[row] * alpha + sum;
  }
}

// O += P V for one key tile.
template <int BQ, int BK, int DP>
__device__ __forceinline__ void tile_pv(const float* sS, const float* sV, float* sO) {
  for (int e = threadIdx.x; e < BQ * DP; e += kThreads) {
    const int i = e / DP, c = e % DP;
    const float* p = sS + i * BK;
    float acc = sO[e];
#pragma unroll 8
    for (int j = 0; j < BK; ++j) acc = fmaf(p[j], sV[j * DP + c], acc);
    sO[e] = acc;
  }
}

template <int BQ, int BK, int DP, int LD>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const uint8_t* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int heads,
       int nq, int nk, int d, float scale) {
  using L = Layout<BQ, BK, DP, LD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);
  float* sKeep = reinterpret_cast<float*>(smem + L::keep);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t)bh * nq * d;
  const float* kb = k + (size_t)bh * nk * d;
  const float* vb = v + (size_t)bh * nk * d;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;

  load_tile<BQ, DP, LD>(sQ, qb, q0, nq, d);
  for (int e = threadIdx.x; e < BQ * DP; e += kThreads) sO[e] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    sM[r] = kMaskedScore;
    sL[r] = 0.f;
  }

  for (int kv0 = 0; kv0 < nk; kv0 += BK) {
    __syncthreads();  // the previous tile's P.V is done with sK, sV, sS
    load_tile<BK, DP, LD>(sK, kb, kv0, nk, d);
    load_tile<BK, DP, DP>(sV, vb, kv0, nk, d);
    for (int j = threadIdx.x; j < BK; j += kThreads)
      sKeep[j] = (mb == nullptr || (kv0 + j < nk && mb[kv0 + j] != 0)) ? 1.f : 0.f;
    __syncthreads();
    tile_scores<BQ, BK, DP, LD>(sQ, sK, sS);
    __syncthreads();
    tile_softmax<BQ, BK, DP>(sS, sO, sM, sL, sKeep, scale, kv0, nk);
    __syncthreads();
    tile_pv<BQ, BK, DP>(sS, sV, sO);
  }
  __syncthreads();

  float* ob = out + (size_t)bh * nq * d;
  for (int e = threadIdx.x; e < BQ * DP; e += kThreads) {
    const int i = e / DP, c = e % DP;
    if (q0 + i < nq && c < d) ob[(size_t)(q0 + i) * d + c] = sO[e] / fmaxf(sL[i], 1e-30f);
  }
  if (lse != nullptr) {  // a row with no real key: -1e30 + log(Nk) is -1e30 in f32
    for (int r = threadIdx.x; r < BQ; r += kThreads)
      if (q0 + r < nq) lse[(size_t)bh * nq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

template <int BQ, int BK, int DP, int LD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                   int bh, int heads, int nq, int nk, int d, float scale, cudaStream_t stream) {
  using L = Layout<BQ, BK, DP, LD>;
  static_assert(L::bytes <= 232448, "shared memory over the per-block limit");
  static_assert(kThreads % BQ == 0 && BK % (kThreads / BQ) == 0, "softmax row split");
  auto fn = kernel<BQ, BK, DP, LD>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  fn<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), static_cast<float*>(lse), heads, nq, nk, d,
      scale);
  return cudaGetLastError();
}

}  // namespace fp32

}  // namespace

// q: (bh, nq, d), k and v: (bh, nk, d), out: (bh, nq, d), all contiguous and of
// one type (bf16 when is_bf16, else f32); mask: (bh / heads, nk) bytes, or
// null for no mask; lse: (bh, nq) f32 to receive the row log-sum-exp, or null
// (head dim 72 only). Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask,
                              void* out, void* lse, int bh, int heads, int nq, int nk, int d,
                              float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 72) {
    return is_bf16 ? fa2::launch(q, k, v, mask, out, lse, bh, heads, nq, nk, scale, s)
                   : fp32::launch<64, 64, 80, 81>(q, k, v, mask, out, lse, bh, heads, nq, nk, d, scale, s);
  }
  if (d == 512 && lse == nullptr) {
    return is_bf16 ? wide::launch(q, k, v, mask, out, bh, heads, nq, nk, scale, s)
                   : fp32::launch<16, 16, 512, 513>(q, k, v, mask, out, nullptr, bh, heads, nq, nk, d, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
