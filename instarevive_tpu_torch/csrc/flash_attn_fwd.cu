// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C launcher loaded with ctypes (instarevive_tpu_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// instarevive_tpu/ops/attention.py (reached through `_flash_fwd_impl` and
// `flash_attention`): online-softmax attention with f32 scores and
// accumulators, an optional (B, Nk) boolean key mask whose masked scores are
// -1e30, and ragged Nq / Nk. With a non-null `lse` the head-dim-64 and -72 forms also
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
// * bf16, head dims 64 and 72 (the UNet and ControlNet of the LDM trainer at
//   64; the DiT at 72: 56 of the 58 launches of one restoration call) runs on
//   Hopper's tensor-core path, one body templated on the head dim. A block is
//   one (d = 64) or two (d = 72) warpgroups of 64 query rows that share a ring
//   of three 64-key K/V stages. One thread of the block brings every tile in
//   by TMA (Q once, then K and V tile by tile), each stage tracked by a full
//   mbarrier (the bytes landed) and an empty one (every warp is done with
//   it); no warp is set aside to produce. Both products are wgmma: S = Q.K^T
//   (m64 n64 k16) with Q and K read from shared memory, and O += P.V (m64 n64
//   k16, plus n16 at d = 72) with P taken from registers, since the accumulator layout of S is wgmma's
//   register-A fragment layout, and V read as an MN-major operand. S, P and
//   the output accumulator stay in registers; P is rounded to bf16 before P.V
//   as the TPU kernel does. Tiles are laid out for TMA's widest rows: head
//   dims 0-63 of a row are 128 bytes under the 128-byte swizzle, and at d = 72
//   head dims 64-79 are a second tile of 32-byte rows under the 32-byte
//   swizzle, 72-79 zero-filled by TMA past the tensor (a fifth Q.K^T k-step
//   and an n16 P.V, whose last 8 columns are not stored). Exponentials are
//   ex2.approx.ftz (flushing results below 2^-126 to 0, which moves no
//   output by a bf16 step), and an unmasked tile's scale rides in one FFMA.
// * bf16, head dim 512 (the VAE mid block): one warp cannot hold a 512-wide
//   accumulator, so the 8 warps of a block split both products. For S each
//   warp takes a 64-wide slice of the head dim for all 32 query rows (its Q
//   slice in registers) and the 8 partial score tiles meet in shared memory,
//   where the softmax sums them; for P.V each warp owns 64 output columns of
//   all 32 rows in registers. It double-buffers K and V tiles with cp.async,
//   so the next tile loads while this one computes.
// * f32, every head dim, keeps the scores and the accumulator in shared
//   memory and runs plain FMAs on odd-strided tiles (no bank conflicts).
// Other head dims are refused.
//
// What bounds it on this card: at the DiT and UNet shapes the work is far
// above the H100's bf16 ridge point (~295 FLOP/byte), so operations bound the
// head-dim-64/72 form. Within a warpgroup the two products and the softmax
// run one after another: per 64-key tile a warpgroup's 4,096 exponentials
// take the SM's exp units about as long as its two products take the tensor
// cores, and only the other warpgroups on the SM (two blocks of two at d = 72,
// as registers allow; three of one at d = 64, as shared memory allows) fill
// the gaps. A first layout with 16-byte TMA rows (wgmma's no-swizzle core
// matrices) was bound by the copies instead, at the rate of the mma.sync form
// it replaced. A producer warp, ping-pong between two warpgroups and
// overlapping one tile's softmax with the next tile's Q.K^T are the next
// steps. On the host the launcher encodes the tensor maps (about 1 us a call
// for all of them) and keeps the last 256 by address and shape, so a call on
// tensors seen before costs what the mma.sync form's launcher did, within a
// microsecond (tools/time_flash_fwd.py). The head-dim-512 form re-reads
// every K/V tile from L2 once per 32 query rows, so L2 bandwidth bounds it;
// its 210 KB of shared memory allow one block per SM. The f32 form is bound by shared-memory traffic and the
// barriers between its phases.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

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
// bf16, head dims 64 and 72: wgmma on TMA-fed tiles.

namespace hopper {

constexpr int BK = 64;                      // keys a tile
constexpr int kStages = 3;                  // the K/V ring: tiles in flight

// Shared tiles. Head dims 0-63 of a row are one 128-byte row of a tile under
// the 128-byte swizzle, the widest rows TMA and wgmma share; at d = 72 head
// dims 64-79 are a second tile of 32-byte rows under the 32-byte swizzle,
// where TMA zero-fills 72-79 (past the tensor), so the last Q.K^T k-step adds
// nothing for them and their P.V columns come out 0 and are not stored. The
// same bytes serve Q and K as K-major operands and V as an MN-major one.
// A main tile starts on 1024 bytes and a tail tile on 256 (their swizzle
// atoms: 8 rows).
template <int D>
struct Tile {
  static_assert(D == 64 || D == 72, "head dims 64 and 72");
  // warpgroups a block, 64 query rows each, sharing the K/V ring: two at d = 72, whose
  // 32-byte tail rows make the copies dearer; one at d = 64 (chosen by time, time_flash_fwd.py)
  static constexpr int kWarpgroups = D == 64 ? 1 : 2;
  static constexpr int kThreads = 128 * kWarpgroups, BQ = 64 * kWarpgroups;  // threads, query rows a block
  static constexpr bool kTail = D > 64;  // head dims 64-79 in their own tiles
  static constexpr uint32_t kQMain = BQ * 128, kQTail = kTail ? BQ * 32 : 0;
  static constexpr uint32_t kKVMain = BK * 128, kKVTail = kTail ? BK * 32 : 0;
  // the main tiles (Q, the K ring, the V ring), the tail tiles in the same order, 2 kStages + 1 barriers
  static constexpr uint32_t kTails = kQMain + 2 * kStages * kKVMain;
  static constexpr uint32_t kBars = kTails + kQTail + 2 * kStages * kKVTail;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (2 * kStages + 1);  // 1024 bytes of slack to align the base
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of `map` (head dims [col, col + box width) of rows [row, row + box
// rows) of head `head`) into shared memory at dst; its bytes complete on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(head), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, swizzle (1: 128 bytes, 3: 32 bytes). K-major under a swizzle: the
// stride offset is between 8-row groups and the leading one unused (1). MN-major:
// the stride offset is between groups of 8 along K; the leading one (between
// swizzle-wide groups along M or N) is unused when the tile is one group wide.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(sbo >> 4) << 32 | swizzle << 62;
}
constexpr uint64_t kSwizzle128 = 1, kSwizzle32 = 3;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Keeps the compiler from moving reads or writes of wgmma's registers across the asm around them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define WGMMA_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_ACC16(i) WGMMA_ACC4(i), WGMMA_ACC4(i + 4), WGMMA_ACC4(i + 8), WGMMA_ACC4(i + 12)

template <int N> struct Wgmma;

template <> struct Wgmma<16> {
  // D (64 x 16, f32) += A (64 x 16, registers) . B (16 x 16, shared, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
                 : WGMMA_ACC4(0), WGMMA_ACC4(4)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  // D (64 x 64, f32) = [D +] A (64 x 16, shared, K-major) . B (64 x 16, shared, K-major)^T
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : WGMMA_ACC16(0), WGMMA_ACC16(16)
                 : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : WGMMA_ACC16(0), WGMMA_ACC16(16)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef WGMMA_ACC16
#undef WGMMA_ACC4

template <int D>
struct Maps {  // the tensor maps of Q, K and V: head dims 0-63, and 64-79 at d = 72
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
kernel(const __grid_constant__ Maps<D> maps, const uint8_t* __restrict__ mask, bf16* __restrict__ out,
       float* __restrict__ lse, int heads, int nq, int nk, float scale_log2) {
  using T = Tile<D>;
  constexpr int kNT = BK / 8;  // score n-tiles of 8 keys
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sK = sQ + T::kQMain, sV = sK + kStages * T::kKVMain;
  const uint32_t sQt = sQ + T::kTails, sKt = sQt + T::kQTail, sVt = sKt + kStages * T::kKVTail;
  const uint32_t full = sQ + T::kBars;       // per stage: its K and V tiles have landed
  const uint32_t empty = full + 8 * kStages;  // per stage: every warp is done with it
  const uint32_t qbar = empty + 8 * kStages;

  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row group and column pair
  const int n_tiles = (nk + BK - 1) / BK;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const bool producer = threadIdx.x == 0;  // issues every copy; no warp is set aside for it

  auto load_kv = [&](int tile) {
    const int s = tile % kStages;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, 2 * (T::kKVMain + T::kKVTail));
    tma_load(sK + s * T::kKVMain, &maps.k, bar, 0, tile * BK, bh);
    tma_load(sV + s * T::kKVMain, &maps.v, bar, 0, tile * BK, bh);
    if (T::kTail) {
      tma_load(sKt + s * T::kKVTail, &maps.k_tail, bar, 64, tile * BK, bh);
      tma_load(sVt + s * T::kKVTail, &maps.v_tail, bar, 64, tile * BK, bh);
    }
  };
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::kThreads / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    mbar_expect_tx(qbar, T::kQMain + T::kQTail);
    tma_load(sQ, &maps.q, qbar, 0, q0, bh);
    if (T::kTail) tma_load(sQt, &maps.q_tail, qbar, 64, q0, bh);
    for (int tile = 0; tile < kStages && tile < n_tiles; ++tile) load_kv(tile);
  }

  // this warpgroup's 64 query rows; a k-step of 16 head dims is 32 bytes along a 128-byte row
  const uint64_t q_desc = smem_desc(sQ + wg * 64 * 128, 1024, kSwizzle128);
  const uint64_t q_tail = smem_desc(sQt + wg * 64 * 32, 256, kSwizzle32);
  float o[32], o_tail[8];  // head dims 0-63; 64-79 (of which 72-79 are 0) at d = 72
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o_tail[i] = 0.f;
  float m_run[2] = {kMaskedScore, kMaskedScore}, l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % kStages;
    // refill the stage of the previous tile once every warp is done with it
    if (producer && tile > 0 && tile - 1 + kStages < n_tiles) {
      mbar_wait(empty + 8 * ((tile - 1) % kStages), ((tile - 1) / kStages) & 1);
      load_kv(tile - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, (tile / kStages) & 1);

    // S = Q K^T, 64 x BK a warpgroup: four k-steps in the main tiles, one in the tails
    float sc[BK / 2];
    const uint64_t k_desc = smem_desc(sK + s * T::kKVMain, 1024, kSwizzle128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<BK>::ss(sc, q_desc + 2 * ks, k_desc + 2 * ks, ks > 0);
    if (T::kTail) Wgmma<BK>::ss(sc, q_tail, smem_desc(sKt + s * T::kKVTail, 256, kSwizzle32), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax in the log2 domain; this thread holds rows g and g + 8 of its warp's 16:
    // sc[4 nt + e] is key nt * 8 + 2 t + (e & 1) of row g + 8 (e >> 1). A tile of real,
    // unmasked keys is scaled inside the exponent (one FFMA a score, the max taken on the
    // raw scores); any other tile is scaled first and its absent and masked keys set.
    const int kv0 = tile * BK;
    float mul = scale_log2;
    if (mb != nullptr || kv0 + BK > nk || scale_log2 <= 0.f) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
        sc[i] = key >= nk ? -CUDART_INF_F : (mb != nullptr && mb[key] == 0) ? kMaskedScore : sc[i] * scale_log2;
      }
      mul = 1.f;
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * mul);
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    uint32_t pf[BK / 16][4];  // P as wgmma A fragments: n-tile pairs become 16-key k-steps
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float p0 = ex2(fmaf(sc[4 * nt], mul, -m_run[0])), p1 = ex2(fmaf(sc[4 * nt + 1], mul, -m_run[0]));
      const float p2 = ex2(fmaf(sc[4 * nt + 2], mul, -m_run[1])), p3 = ex2(fmaf(sc[4 * nt + 3], mul, -m_run[1]));
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
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    if (T::kTail) {
#pragma unroll
      for (int i = 0; i < 8; ++i) o_tail[i] *= alpha[(i >> 1) & 1];
    }

    // O += P V: P from registers, the V tiles (keys x head dims) as MN-major operands;
    // a k-step of 16 keys is two 8-row swizzle atoms
    const uint64_t v_desc = smem_desc(sV + s * T::kKVMain, 1024, kSwizzle128);
    const uint64_t v_tail = smem_desc(sVt + s * T::kKVTail, 256, kSwizzle32);
    fence_regs(o);
    if (T::kTail) fence_regs(o_tail);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      Wgmma<64>::rs(o, pf[c], v_desc + c * 128);
      if (T::kTail) Wgmma<16>::rs(o_tail, pf[c], v_tail + c * 32);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (T::kTail) fence_regs(o_tail);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  bf16* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    bf16* orow = ob + (size_t)row * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) = __floats2bfloat162_rn(o[4 * dt + 2 * r] * inv,
                                                                                o[4 * dt + 2 * r + 1] * inv);
    if (T::kTail)
      *reinterpret_cast<__nv_bfloat162*>(orow + 64) = __floats2bfloat162_rn(o_tail[2 * r] * inv,
                                                                            o_tail[2 * r + 1] * inv);
    // the running max is in the log2 domain; a row with no real key keeps the mask's score
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * nq + row] = m_run[r] <= kMaskedScore
                                       ? kMaskedScore
                                       : (m_run[r] + log2f(fmaxf(l_run[r], 1e-30f))) * 0.6931471805599453f;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, found through the runtime:
// the library links no libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A (bh, n, d) bf16 tensor seen as 3-D (d, n, bh), read in boxes of `width`
// head dims x `rows` rows of one head under the given swizzle (the box's rows
// are its width, 128 or 32 bytes). Rows past n and head dims past d are
// zero-filled, so a ragged tail never reads the next head.
//
// A map holds only the address, the shape and the box, never the data, so the
// maps made last are kept in a table of kMapSlots slots indexed by a hash of
// those, and a call on tensors at the same addresses and shapes encodes none.
constexpr int kMapSlots = 256;

struct MapSlot {
  const void* ptr;
  int d, n, bh, width, rows, swizzle;
  CUtensorMap map;
};

bool make_map(CUtensorMap* map, const void* ptr, int d, int n, int bh, int width, int rows, CUtensorMapSwizzle swizzle) {
  static MapSlot slots[kMapSlots];
  static std::mutex lock;
  const int key[6] = {d, n, bh, width, rows, (int)swizzle};
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) >> 4;
  for (const int x : key) h = (h ^ (uint32_t)x) * 0x100000001b3ull;
  MapSlot& slot = slots[(h ^ (h >> 29)) % kMapSlots];
  std::lock_guard<std::mutex> guard(lock);
  if (slot.ptr != ptr || memcmp(&slot.d, key, sizeof(key)) != 0) {
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
    const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    slot.ptr = nullptr;
    if (encode_tiled()(&slot.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                       unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
    slot.ptr = ptr;
    memcpy(&slot.d, key, sizeof(key));
  }
  *map = slot.map;
  return true;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                   int bh, int heads, int nq, int nk, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  Maps<D> maps = {};
  bool ok = make_map(&maps.q, q, D, nq, bh, 64, T::BQ, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&maps.k, k, D, nk, bh, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&maps.v, v, D, nk, bh, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (T::kTail)
    ok = ok && make_map(&maps.q_tail, q, D, nq, bh, 16, T::BQ, CU_TENSOR_MAP_SWIZZLE_32B) &&
         make_map(&maps.k_tail, k, D, nk, bh, 16, BK, CU_TENSOR_MAP_SWIZZLE_32B) &&
         make_map(&maps.v_tail, v, D, nk, bh, 16, BK, CU_TENSOR_MAP_SWIZZLE_32B);
  if (!ok) return cudaErrorInvalidValue;
  auto fn = kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + T::BQ - 1) / T::BQ, bh);
  fn<<<grid, T::kThreads, T::kSmem, stream>>>(maps, static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
                                           static_cast<float*>(lse), heads, nq, nk, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = (int)Tile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile<D>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel<D>, Tile<D>::kThreads, Tile<D>::kSmem);
}

}  // namespace hopper

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
// (head dims 64 and 72 only). Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask,
                              void* out, void* lse, int bh, int heads, int nq, int nk, int d,
                              float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    return is_bf16 ? hopper::launch<64>(q, k, v, mask, out, lse, bh, heads, nq, nk, scale, s)
                   : fp32::launch<64, 64, 64, 65>(q, k, v, mask, out, lse, bh, heads, nq, nk, d, scale, s);
  }
  if (d == 72) {
    return is_bf16 ? hopper::launch<72>(q, k, v, mask, out, lse, bh, heads, nq, nk, scale, s)
                   : fp32::launch<64, 64, 80, 81>(q, k, v, mask, out, lse, bh, heads, nq, nk, d, scale, s);
  }
  if (d == 512 && lse == nullptr) {
    return is_bf16 ? wide::launch(q, k, v, mask, out, bh, heads, nq, nk, scale, s)
                   : fp32::launch<16, 16, 512, 513>(q, k, v, mask, out, nullptr, bh, heads, nq, nk, d, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 head-dim-64/72 form at head dim d: the shared memory a block takes
// and how many of its blocks fit on one SM, registers and shared memory
// together (for reports). Returns a cudaError_t.
extern "C" int flash_attn_fwd_occupancy(int d, int* smem_bytes, int* blocks_per_sm) {
  if (d == 64) return hopper::occupancy<64>(smem_bytes, blocks_per_sm);
  if (d == 72) return hopper::occupancy<72>(smem_bytes, blocks_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
