// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C launcher loaded with ctypes (instarevive_tpu_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// instarevive_tpu/ops/attention.py (reached through `_flash_fwd_impl` and
// `flash_attention`): online-softmax attention with f32 scores and
// accumulators, an optional (B, Nk) boolean key mask whose masked scores are
// -1e30, and ragged Nq / Nk. With a non-null `lse` every form but the bf16
// one at head dim 512 also writes the row log-sum-exp m + log(max(l, 1e-30))
// (the kernel's `emit_lse` output), one f32 per query row, which the backward
// (flash_attn_bwd.cu) reads;
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
// Four forms:
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
// * bf16, head dim 512 (the VAE mid block, 2 of the 58 launches of one
//   restoration call, 5 of the tiled call's 61) on the same path. A 64 x 512
//   f32 output accumulator is half of an SM's registers, so a block is one
//   wgmma M of 64 query rows whose 512 output columns are split between two
//   warpgroups (128 accumulator registers a thread). Q is resident in shared
//   memory as 8 boxes of 64 head dims x 64 rows under the 128-byte swizzle;
//   K and V arrive by TMA in 32-key tiles of 8 such boxes through a ring of
//   two stages, issued by one thread under full and empty mbarriers as
//   above. Each warpgroup computes S = Q.K^T over its half of the head dim
//   (16 k-steps of m64 n32 k16, both operands in shared memory); the two
//   partial 64 x 32 tiles meet once a tile in shared memory, and each adds
//   the other's, so both hold the same S and run the same online softmax.
//   O += P.V is m64 n256 k16 with P from registers and the warpgroup's four
//   V boxes read as one MN-major operand.
// * f32, head dims 32, 64 and 72 (namespace fwd_tf32; every f32 trainer's DiT,
//   UNet and ControlNet, and at 32 the toy DiT of tools/train_validation.py,
//   hidden 128 over 4 heads): the bf16 form's design on the tensor cores' TF32
//   path, with f32 accuracy kept by splitting. The launcher is handed each
//   operand as two planes made by the prepass (tf32_planes.cu), hi =
//   tf32(x) and lo = tf32(x - hi), and every product is hi.hi + hi.lo +
//   lo.hi (the small terms first), f32-accumulated, each tf32 product exact:
//   what is lost is lo.lo, about 2^-22 of a product, and the sums' order.
//   Torch's own TF32 stays off; these products are f32-accurate by
//   construction. A block is two warpgroups of 64 query rows sharing a ring
//   of two 64-key stages; Q's planes are resident, each stage holds K's two
//   planes and V's two transposed planes (a tf32 operand of wgmma is read
//   from shared memory K-major only, so V, the B of P.V whose K is the key,
//   comes transposed, (bh, d, nk rounded up to 8)). Head dims run in 32-f32
//   boxes of 128-byte rows under the 128-byte swizzle (one box at d = 32,
//   whose P.V is m64 n32 k8), at d = 72 plus an 8-f32 tail box of 32-byte
//   rows under the 32-byte swizzle; a k-step of
//   tf32 is 8 values, 32 bytes, as a bf16 k-step, so the descriptors step as
//   the bf16 form's. S = Q.K^T is three m64 n64 k8 ss products a k-step; the
//   online softmax stays f32 in registers; P is split in registers into
//   tf32 A fragments, which want columns (t, t + 4) of each 8-key group where
//   the accumulator holds (2t, 2t + 1): the prepass writes the transposed
//   planes with keys in the order 0 2 4 6 1 3 5 7 within each group of 8, so
//   the fragments need no shuffle. O's tile P.V (m64 n64/n72 k8, rs) runs
//   into a fresh accumulator that one FFMA folds into the running output with
//   the softmax's rescale: the tensor cores' f32 sums truncate, and chained
//   over thousands of keys that bias alone would pass the f32 bounds (the
//   backward measured it: 3.7e-5 against 2e-5 at 4096 queries).
// * f32, head dim 512 (namespace d512_tf32; the VAE mid block of every f32
//   run): the bf16 head-dim-512 form's block (64 query rows, the head dim
//   split between two warpgroups whose partial scores meet in shared memory,
//   256 output columns a warpgroup) on split-tf32 products. The planes are
//   four times the bf16 bytes, so Q stays resident as raw f32 (128 KB in 16
//   boxes of 32 f32; its hi and lo planes would take 256 KB), and each Q.K^T
//   k-step reads the thread's four A values from it, splits them in
//   registers and takes them from there (rs); their order is K's natural
//   one. K's natural planes and V's transposed planes (the prepass's, as at
//   64 and 72) arrive in chunks of 64 head dims of a 32-key tile, 16 KB with
//   both planes, each warpgroup through two slots of its own that one of its
//   threads refills as soon as its four warps are done with one. P.V runs
//   one chunk of 64 output columns at a time into a fresh accumulator folded
//   into the running output by one FFMA, as at 64 and 72. With a non-null
//   `lse` it writes the row log-sum-exp as the forms at 32, 64 and 72 do
//   (the first warpgroup: both hold the same running max and sum), which the
//   head-dim-512 backward reads.
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
// microsecond (tools/time_flash_fwd.py). At head dim 512 the block's 64
// query rows set the ratio of work to K/V bytes: each 32-key tile (64 KB)
// feeds 4 MFLOP, and every block streams all of K and V through L2. On an
// H100 (700 W, tools/time_flash_fwd.py with edited copies of this file) a
// copy without its two products took 0.36 ms where the body took 0.48 at
// (4,1,4096,4096,512); each SM drew the same
// ~45 GB/s from L2 with 81 busy SMs as with 132 (so not the aggregate L2
// rate), and 16-key tiles in three or four stages were 1.7x slower: what a
// tile costs whatever its size bounds it. Each tile's S re-reads the
// warpgroup's 32 KB of Q from shared memory, and a tile's S, exchange,
// softmax and P.V run one after another with no other block on the SM to
// fill the gaps. A stage's K tile is refilled as soon as both warpgroups are
// past the exchange, half a tile before its V tile (8% faster). Tried and
// not kept: S whole in each warpgroup with no exchange (9% slower); a
// cluster of two blocks on adjacent query tiles sharing each K/V tile by TMA
// multicast (twice as slow with the copying thread waiting on the other
// block, and as slow without the multicast: the wait, not the copies,
// costs). 225 KB of shared memory allow one block per SM; at batch 1 a
// 5184-token tile gives 81 blocks for 132 SMs. The f32 form at head dims 64
// and 72 does three times the bf16 form's products at half the bf16 rate
// (495 TFLOP/s TF32), so operations bound it at 6x the bf16 bound; 221 KB of
// shared memory at d = 72 (197 KB at 64) allow one block of two warpgroups
// an SM, whose 64-key stage (74 KB) arrives from L2 in about the time the two
// warpgroups take for its products. The f32 form at head dim 512 does three
// tf32 products a product too, and each of its blocks streams all of K's and
// V^T's planes through L2 (33.5 MB at 4096 keys). On an H100 (700 W,
// tools/time_flash_fwd.py with edited copies of this file) it took 1.08-1.10
// ms at (2,1,4096,4096,512), its bound 0.42; a copy without its products took
// 0.55 (about 61 GB/s an SM from L2), one without the split of Q 0.87-0.89,
// so copies and products run nearly one after the other: one chunk in flight
// a warpgroup while it works on the other. Chunks of 32 head dims in four
// slots a warpgroup were 10-14% slower, with or without two P.V accumulators
// in turn (both spill); each chunk's Q.K^T products into a fresh
// accumulator took the error at 4096 keys from 4.0e-7 to 2.6e-7 and spilled.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskedScore = -1e30f;  // as the plain version: masked keys keep a finite score

// Two f32 values rounded to bf16 in one register: a wgmma A-fragment word.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// The accumulator layout of wgmma's m64 fragments: this thread holds rows g and g + 8 (r = 0, 1) of
// its warp's 16, and x[4 j + 2 r + e] is column 8 j + 2 t + e of row g + 8 r (t = lane % 4).

// One key tile of the online softmax in the log2 domain over the scores sc of keys kv0.. of this
// thread's two rows, turned in place into the tile's unnormalised weights P. A tile of real, unmasked
// keys is scaled inside the exponent (one FFMA a score, the max taken on the raw scores); any other
// tile is scaled first and its absent keys (past nk: weight exactly 0) and masked keys (kMaskedScore)
// set. Updates the running max and sum, and gives each row's rescale of the accumulator (alpha).
template <int BK>
__device__ __forceinline__ void softmax_probs(float (&sc)[BK / 2], int kv0, int nk, const uint8_t* mb,
                                              float scale_log2, int t, float (&m_run)[2], float (&l_run)[2],
                                              float (&alpha)[2]) {
  float mul = scale_log2;
  if (mb != nullptr || kv0 + BK > nk || scale_log2 <= 0.f) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
      sc[i] = key >= nk ? -CUDART_INF_F : (mb != nullptr && mb[key] == 0) ? kMaskedScore : sc[i] * scale_log2;
    }
    mul = 1.f;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * mul);
    alpha[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    sc[4 * nt] = ex2(fmaf(sc[4 * nt], mul, -m_run[0]));
    sc[4 * nt + 1] = ex2(fmaf(sc[4 * nt + 1], mul, -m_run[0]));
    sc[4 * nt + 2] = ex2(fmaf(sc[4 * nt + 2], mul, -m_run[1]));
    sc[4 * nt + 3] = ex2(fmaf(sc[4 * nt + 3], mul, -m_run[1]));
    sum[0] += sc[4 * nt] + sc[4 * nt + 1];
    sum[1] += sc[4 * nt + 2] + sc[4 * nt + 3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + sum[r];
  }
}

// softmax_probs, then P rounded to bf16 as wgmma A fragments (pf: n-tile pairs become 16-key k-steps).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], int kv0, int nk, const uint8_t* mb,
                                             float scale_log2, int t, float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], uint32_t (&pf)[BK / 16][4]) {
  softmax_probs<BK>(sc, kv0, nk, mb, scale_log2, t, m_run, l_run, alpha);
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    pf[nt / 2][(nt % 2) * 2] = pack_bf16(sc[4 * nt], sc[4 * nt + 1]);
    pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(sc[4 * nt + 2], sc[4 * nt + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// Row r of the accumulator times inv, as bf16 from orow (the row's column 2 t) on.
template <int N>
__device__ __forceinline__ void store_row(bf16* orow, const float (&o)[N], int r, float inv) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                                                             o[4 * j + 2 * r + 1] * inv);
}

template <int D>
struct Maps {  // the tensor maps of Q, K and V: head dims 0-63, and 64-79 at d = 72
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads)
kernel(const __grid_constant__ Maps<D> maps, const uint8_t* __restrict__ mask, bf16* __restrict__ out,
       float* __restrict__ lse, int heads, int nq, int nk, float scale_log2) {
  using T = Tile<D>;
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
    mbar_init_fence();
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
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax in the log2 domain, P as wgmma A fragments
    float alpha[2];
    uint32_t pf[BK / 16][4];
    softmax_tile<BK>(sc, tile * BK, nk, mb, scale_log2, t, m_run, l_run, alpha, pf);
    rescale(o, alpha);
    if (T::kTail) rescale(o_tail, alpha);

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
    wgmma_wait<0>();
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
    store_row(orow, o, r, inv);
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
// bf16, head dim 512: wgmma on TMA-fed tiles, the head dim split over two warpgroups.

namespace d512 {

using namespace hopper;

constexpr int D = 512, BQ = 64, BK = 32;    // head dims, query rows a block, keys a tile
constexpr int kStages = 2;                  // the K/V ring: tiles in flight
constexpr int kWarpgroups = 2, kThreads = 128 * kWarpgroups;
constexpr int kChunks = D / 64;             // 64-wide head-dim chunks, one 128-byte swizzled row each
constexpr int kMine = kChunks / kWarpgroups;  // a warpgroup's chunks: its half of Q.K^T, its output columns
// Shared memory, from a 1024-byte aligned base: Q (64 KB, resident), the K ring, the V ring (32 KB a
// stage each), the partial scores (8 KB a warpgroup, double-buffered by tile parity), the barriers.
// A chunk of a tile is its rows x 128 bytes, so chunks start on 1024 bytes (the swizzle atom).
constexpr uint32_t kQChunk = BQ * 128, kKVChunk = BK * 128;
constexpr uint32_t kQ = kChunks * kQChunk, kKV = kChunks * kKVChunk;
constexpr uint32_t kPart = 128 * (BK / 2) * 4;  // 16 f32 scores a thread
constexpr uint32_t kOffK = kQ, kOffV = kOffK + kStages * kKV, kOffParts = kOffV + kStages * kKV;
constexpr uint32_t kOffBars = kOffParts + 2 * kWarpgroups * kPart;
constexpr size_t kSmem = 1024 + kOffBars + 8 * (2 * kStages + 1);  // 1024 bytes of slack to align the base
static_assert(kSmem <= 232448, "shared memory over the per-block limit");

struct Maps {  // Q in boxes of 64 head dims x 64 rows, K and V in boxes of 64 head dims x 32 rows
  CUtensorMap q, k, v;
};

__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ mask, bf16* __restrict__ out, int heads,
       int nq, int nk, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sK = sQ + kOffK, sV = sQ + kOffV;
  const uint32_t full = sQ + kOffBars;        // per stage: its K and V tiles have landed
  const uint32_t empty = full + 8 * kStages;  // per stage: every warp is done with its V tile
  const uint32_t qbar = empty + 8 * kStages;
  float* parts = reinterpret_cast<float*>(smem + (sQ - smem_u32(smem)) + kOffParts);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row group and column pair
  const int n_tiles = (nk + BK - 1) / BK;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const bool producer = threadIdx.x == 0;  // issues every copy; no warp is set aside for it

  // a stage's K and V tiles complete on one barrier, whose expected bytes come with the K copies
  auto load_k = [&](int tile) {
    const int s = tile % kStages;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, 2 * kKV);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) tma_load(sK + s * kKV + c * kKVChunk, &maps.k, bar, 64 * c, tile * BK, bh);
  };
  auto load_v = [&](int tile) {
    const int s = tile % kStages;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) tma_load(sV + s * kKV + c * kKVChunk, &maps.v, full + 8 * s, 64 * c, tile * BK, bh);
  };
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (producer) {
    mbar_expect_tx(qbar, kQ);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) tma_load(sQ + c * kQChunk, &maps.q, qbar, 64 * c, q0, bh);
    for (int tile = 0; tile < kStages && tile < n_tiles; ++tile) {
      load_k(tile);
      load_v(tile);
    }
  }

  float o[128];  // 64 rows x this warpgroup's 256 output columns
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_run[2] = {kMaskedScore, kMaskedScore}, l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % kStages;
    // refill the V tile of the previous tile's stage once every warp is done with it (its K tile went
    // in after the previous tile's exchange)
    if (producer && tile > 0 && tile - 1 + kStages < n_tiles) {
      mbar_wait(empty + 8 * ((tile - 1) % kStages), ((tile - 1) / kStages) & 1);
      load_v(tile - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, (tile / kStages) & 1);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spin

    // this warpgroup's half of S = Q K^T, 64 x BK: four k-steps of 16 head dims in each of its chunks
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kMine; ++c) {
      const int chunk = wg * kMine + c;
      const uint64_t q_desc = smem_desc(sQ + chunk * kQChunk, 1024, kSwizzle128);
      const uint64_t k_desc = smem_desc(sK + s * kKV + chunk * kKVChunk, 1024, kSwizzle128);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) Wgmma<BK>::ss(sc, q_desc + 2 * ks, k_desc + 2 * ks, c > 0 || ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the two halves meet in shared memory: thread tid of either warpgroup holds the same rows and
    // keys, so each adds the other's 16 values (a + b == b + a: both get the same bits)
    float4* mine = reinterpret_cast<float4*>(parts + ((tile & 1) * kWarpgroups + wg) * (kPart / 4));
    const float4* theirs = reinterpret_cast<const float4*>(parts + ((tile & 1) * kWarpgroups + (wg ^ 1)) * (kPart / 4));
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) mine[i * 128 + tid] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
    __syncthreads();  // a part is rewritten two tiles on, after the next barrier: its reader is past it
    // both warpgroups are done with this K tile: refill it now, half a tile before its V tile
    if (producer && tile + kStages < n_tiles) load_k(tile + kStages);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float4 x = theirs[i * 128 + tid];
      sc[4 * i] += x.x;
      sc[4 * i + 1] += x.y;
      sc[4 * i + 2] += x.z;
      sc[4 * i + 3] += x.w;
    }

    // online softmax in the log2 domain, as the head-dim-64/72 form (both warpgroups compute the same)
    float alpha[2];
    uint32_t pf[BK / 16][4];
    softmax_tile<BK>(sc, tile * BK, nk, mb, scale_log2, t, m_run, l_run, alpha, pf);
    rescale(o, alpha);

    // O += P V over this warpgroup's 256 columns: P from registers, its four V chunks as one MN-major
    // operand (64-wide groups a chunk apart); a k-step of 16 keys is two 8-row swizzle atoms
    const uint64_t v_desc = smem_desc(sV + s * kKV + wg * kMine * kKVChunk, 1024, kSwizzle128, kKVChunk);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) Wgmma<256>::rs(o, pf[c], v_desc + c * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  bf16* ob = out + (size_t)bh * nq * D + wg * (D / kWarpgroups);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    bf16* orow = ob + (size_t)row * D + 2 * t;
    store_row(orow, o, r, inv);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, int bh, int heads,
                   int nq, int nk, float scale, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  Maps maps = {};
  if (!(make_map(&maps.q, q, D, nq, bh, 64, BQ, CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_map(&maps.k, k, D, nk, bh, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_map(&maps.v, v, D, nk, bh, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(maps, static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), heads,
                                            nq, nk, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t occupancy(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = (int)kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, kSmem);
}

}  // namespace d512

// ---------------------------------------------------------------------------
// f32, head dims 32, 64 and 72: split-tf32 wgmma on TMA-fed tiles.

namespace fwd_tf32 {

using namespace hopper;

constexpr int BK = 64;       // keys a tile
constexpr int kStages = 2;   // the K/V ring: tiles in flight

// Shared tiles, from a 1024-byte aligned base: Q's hi and lo planes (BQ rows, resident), then per stage
// K's hi and lo planes (BK rows) and V's transposed hi and lo planes (D rows of BK keys), then the
// barriers. A row-major plane tile (Q, K) is kBoxes boxes of rows x 32 f32 (128-byte rows under the
// 128-byte swizzle) and, at d = 72, a tail box of rows x 8 f32 (head dims 64-71: 32-byte rows under the
// 32-byte swizzle); a transposed V tile is BK / 32 boxes of D rows x 32 keys. Every box starts on 1024
// bytes (the 128-byte swizzle's atom is 8 rows; the 32-byte one's 256 bytes).
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 72, "head dims 32, 64 and 72");
  static constexpr int kWarpgroups = 2, kThreads = 128 * kWarpgroups, BQ = 64 * kWarpgroups;
  static constexpr int kBoxes = D / 32;       // 128-byte-row boxes of a row
  static constexpr bool kTail = D % 32 != 0;  // head dims 64-71 in a box of their own
  static constexpr uint32_t kQPlane = BQ * D * 4, kKPlane = BK * D * 4, kVPlane = D * BK * 4;
  static constexpr uint32_t kStage = 2 * kKPlane + 2 * kVPlane;
  static constexpr uint32_t kOffStages = 2 * kQPlane, kBars = kOffStages + kStages * kStage;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (2 * kStages + 1);  // 1024 bytes of slack to align the base
  static_assert(kSmem <= 232448, "shared memory over the per-block limit");
};

struct Maps {  // the hi ([0]) and lo ([1]) planes: Q and K in 32-wide boxes and 8-wide tails, V^T in 32-key boxes
  CUtensorMap q[2], k[2], q_tail[2], k_tail[2], vt[2];
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ mask, float* __restrict__ out,
       float* __restrict__ lse, int heads, int nq, int nk, float scale_log2) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full = sQ + T::kBars;        // per stage: its K and V tiles have landed
  const uint32_t empty = full + 8 * kStages;  // per stage: every warp is done with it
  const uint32_t qbar = empty + 8 * kStages;

  const int bh = blockIdx.y, q0 = blockIdx.x * T::BQ;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row group and column pair
  const int n_tiles = (nk + BK - 1) / BK;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const bool producer = threadIdx.x == 0;  // issues every copy; no warp is set aside for it

  // a row-major plane tile of `rows` rows, from row row0 of this head
  auto load_rows = [&](uint32_t dst, const CUtensorMap* main, const CUtensorMap* tail, int rows, int row0,
                       uint32_t bar) {
#pragma unroll
    for (int b = 0; b < T::kBoxes; ++b) tma_load(dst + b * rows * 128, main, bar, 32 * b, row0, bh);
    if (T::kTail) tma_load(dst + T::kBoxes * rows * 128, tail, bar, 32 * T::kBoxes, row0, bh);
  };
  auto load_kv = [&](int tile) {
    const int s = tile % kStages;
    const uint32_t bar = full + 8 * s, base = sQ + T::kOffStages + s * T::kStage;
    mbar_expect_tx(bar, T::kStage);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      load_rows(base + p * T::kKPlane, &maps.k[p], &maps.k_tail[p], BK, tile * BK, bar);
#pragma unroll
      for (int kb = 0; kb < BK / 32; ++kb)
        tma_load(base + 2 * T::kKPlane + p * T::kVPlane + kb * D * 128, &maps.vt[p], bar, tile * BK + 32 * kb, 0, bh);
    }
  };
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::kThreads / 32);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (producer) {
    mbar_expect_tx(qbar, 2 * T::kQPlane);
    for (int p = 0; p < 2; ++p) load_rows(sQ + p * T::kQPlane, &maps.q[p], &maps.q_tail[p], T::BQ, q0, qbar);
    for (int tile = 0; tile < kStages && tile < n_tiles; ++tile) load_kv(tile);
  }

  float o[D / 2], ot[D / 2];  // the running output; one tile's P.V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = ot[i] = 0.f;
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
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
    const uint32_t k_hi = sQ + T::kOffStages + s * T::kStage, k_lo = k_hi + T::kKPlane;
    const uint32_t v_hi = k_hi + 2 * T::kKPlane, v_lo = v_hi + T::kVPlane;

    // S = Q K^T, 64 x BK a warpgroup: each k-step of 8 head dims (32 bytes along a row) as
    // lo.hi + hi.lo + hi.hi, the small terms first
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < T::kBoxes; ++b) {
      const uint64_t qh = smem_desc(sQ + b * T::BQ * 128 + wg * 64 * 128, 1024, kSwizzle128);
      const uint64_t ql = smem_desc(sQ + T::kQPlane + b * T::BQ * 128 + wg * 64 * 128, 1024, kSwizzle128);
      const uint64_t kh = smem_desc(k_hi + b * BK * 128, 1024, kSwizzle128);
      const uint64_t kl = smem_desc(k_lo + b * BK * 128, 1024, kSwizzle128);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wgmma32<BK>::ss(sc, ql + 2 * ks, kh + 2 * ks, b > 0 || ks > 0);
        Wgmma32<BK>::ss(sc, qh + 2 * ks, kl + 2 * ks, 1);
        Wgmma32<BK>::ss(sc, qh + 2 * ks, kh + 2 * ks, 1);
      }
    }
    if (T::kTail) {
      const uint32_t tq = T::kBoxes * T::BQ * 128 + wg * 64 * 32, tk = T::kBoxes * BK * 128;
      const uint64_t qh = smem_desc(sQ + tq, 256, kSwizzle32), ql = smem_desc(sQ + T::kQPlane + tq, 256, kSwizzle32);
      const uint64_t kh = smem_desc(k_hi + tk, 256, kSwizzle32), kl = smem_desc(k_lo + tk, 256, kSwizzle32);
      Wgmma32<BK>::ss(sc, ql, kh, 1);
      Wgmma32<BK>::ss(sc, qh, kl, 1);
      Wgmma32<BK>::ss(sc, qh, kh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax in the log2 domain; P in f32, split into hi and lo A fragments
    float alpha[2];
    softmax_probs<BK>(sc, tile * BK, nk, mb, scale_log2, t, m_run, l_run, alpha);
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) split_fragment(sc + 4 * j, ph[j], pl[j]);

    // this tile's P V into a fresh accumulator (the tensor cores' sums then run over one tile only), V^T
    // planes as K-major B operands: a k-step of 8 keys is 32 bytes along a 128-byte row of 32 keys
    fence_regs(ot);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t at = (j / 4) * D * 128;
      const uint64_t vh = smem_desc(v_hi + at, 1024, kSwizzle128) + 2 * (j % 4);
      const uint64_t vl = smem_desc(v_lo + at, 1024, kSwizzle128) + 2 * (j % 4);
      Wgmma32<D>::rs(ot, pl[j], vh, j > 0);
      Wgmma32<D>::rs(ot, ph[j], vl, 1);
      Wgmma32<D>::rs(ot, ph[j], vh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ot);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
  }

  float* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    float* orow = ob + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    // the running max is in the log2 domain; a row with no real key keeps the mask's score
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * nq + row] = m_run[r] <= kMaskedScore
                                       ? kMaskedScore
                                       : (m_run[r] + log2f(fmaxf(l_run[r], 1e-30f))) * 0.6931471805599453f;
  }
}

// planes: Q hi, Q lo, K hi, K lo ((bh, n, D) f32), V^T hi, V^T lo ((bh, D, nk rounded up to 8) f32, keys in
// the order of tf32_planes.cu).
template <int D>
cudaError_t launch(const void* const* planes, const void* mask, void* out, void* lse, int bh, int heads, int nq,
                   int nk, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const int nk_pad = (nk + 7) / 8 * 8;
  Maps maps = {};
  bool ok = true;
  for (int p = 0; p < 2; ++p) {
    ok = ok && make_map(&maps.q[p], planes[p], D, nq, bh, 32, T::BQ, CU_TENSOR_MAP_SWIZZLE_128B, true) &&
         make_map(&maps.k[p], planes[2 + p], D, nk, bh, 32, BK, CU_TENSOR_MAP_SWIZZLE_128B, true) &&
         make_map(&maps.vt[p], planes[4 + p], nk_pad, D, bh, 32, D, CU_TENSOR_MAP_SWIZZLE_128B, true);
    if (T::kTail)
      ok = ok && make_map(&maps.q_tail[p], planes[p], D, nq, bh, 8, T::BQ, CU_TENSOR_MAP_SWIZZLE_32B, true) &&
           make_map(&maps.k_tail[p], planes[2 + p], D, nk, bh, 8, BK, CU_TENSOR_MAP_SWIZZLE_32B, true);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto fn = kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + T::BQ - 1) / T::BQ, bh);
  fn<<<grid, T::kThreads, T::kSmem, stream>>>(maps, static_cast<const uint8_t*>(mask), static_cast<float*>(out),
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

}  // namespace fwd_tf32

// ---------------------------------------------------------------------------
// f32, head dim 512: split-tf32 wgmma, Q resident as raw f32, K's and V^T's planes streamed in chunks.

namespace d512_tf32 {

using namespace hopper;

constexpr int D = 512, BQ = 64, BK = 32;      // head dims, query rows a block, keys a tile
constexpr int kWarpgroups = 2, kThreads = 128 * kWarpgroups;
constexpr int kHalf = D / kWarpgroups;        // a warpgroup's head dims: its half of Q.K^T, its output columns
constexpr int kChunkDims = 64;                // head dims a chunk
constexpr int kChunks = kHalf / kChunkDims;   // a warpgroup's K chunks a tile, and as many V^T chunks
constexpr int kSteps = kChunkDims / 8;        // tf32 k-steps of Q.K^T in a K chunk
// Shared memory, from a 1024-byte aligned base: Q as raw f32 (16 boxes of 64 rows x 32 f32, resident), a
// ring of four 16 KB chunk slots (2 wg and 2 wg + 1 are warpgroup wg's), the partial scores (8 KB a
// warpgroup, double-buffered by tile parity), the barriers. A K chunk is 32 keys x 64 head dims of both
// planes, two boxes of 32 head dims each; a V^T chunk is 64 head dims x 32 keys of both planes, one box
// each. Every box is rows of 128 bytes under the 128-byte swizzle and starts on 1024 bytes.
constexpr uint32_t kQBox = BQ * 128, kQ = (D / 32) * kQBox;
constexpr uint32_t kKBox = BK * 128, kVtBox = kChunkDims * 128;
constexpr uint32_t kSlot = 4 * kKBox;
static_assert(kSlot == 2 * kVtBox, "K and V^T chunks share the slots");
constexpr int kSlots = 2 * kWarpgroups;
constexpr uint32_t kPart = 128 * (BK / 2) * 4;  // 16 f32 scores a thread
constexpr uint32_t kOffRing = kQ, kOffParts = kOffRing + kSlots * kSlot;
constexpr uint32_t kOffBars = kOffParts + 2 * kWarpgroups * kPart;
constexpr size_t kSmem = 1024 + kOffBars + 8 * (2 * kSlots + 1);  // 1024 bytes of slack to align the base
static_assert(kSmem <= 232448, "shared memory over the per-block limit");

struct Maps {  // Q raw in boxes of 32 head dims x 64 rows; K's hi ([0]) and lo ([1]) planes in boxes of 32 x 32;
  CUtensorMap q, k[2], vt[2];  // V^T's planes in boxes of 32 keys x 64 head dims
};

__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ mask, float* __restrict__ out,
       float* __restrict__ lse, int heads, int nq, int nk, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* const base = smem + (sQ - smem_u32(smem));
  const uint32_t ring = sQ + kOffRing;
  const uint32_t full = sQ + kOffBars;      // per slot: its chunk has landed
  const uint32_t empty = full + 8 * kSlots;  // per slot: every warp of its warpgroup is done with it
  const uint32_t qbar = empty + 8 * kSlots;
  float* parts = reinterpret_cast<float*>(base + kOffParts);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row group and column pair
  const int n_tiles = (nk + BK - 1) / BK, n_chunks = n_tiles * 2 * kChunks;  // this warpgroup's chunks
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * nk;
  const bool producer = tid == 0;  // issues this warpgroup's copies; no warp is set aside for it

  // This warpgroup's chunk i: of tile i / 8, its K chunk i % 8 (below kChunks) or V^T chunk i % 8 - kChunks,
  // the head dims kHalf wg + 64 (i % 4) on; it goes to slot 2 wg + i % 2, whose (i / 2)-th use it is.
  auto slot = [&](int i) { return ring + (2 * wg + (i & 1)) * kSlot; };
  auto load_chunk = [&](int i) {
    const int tile = i / (2 * kChunks), j = i % (2 * kChunks), d0 = kHalf * wg + kChunkDims * (j % kChunks);
    const uint32_t dst = slot(i), bar = full + 8 * (2 * wg + (i & 1));
    mbar_expect_tx(bar, kSlot);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (j < kChunks) {
        tma_load(dst + 2 * p * kKBox, &maps.k[p], bar, d0, tile * BK, bh);
        tma_load(dst + (2 * p + 1) * kKBox, &maps.k[p], bar, d0 + 32, tile * BK, bh);
      } else {
        tma_load(dst + p * kVtBox, &maps.vt[p], bar, tile * BK, d0, bh);
      }
    }
  };
  auto wait_chunk = [&](int i) {
    __syncwarp();
    mbar_wait(full + 8 * (2 * wg + (i & 1)), (i >> 1) & 1);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
  };
  // every warp of this warpgroup is done with chunk i: its slot takes chunk i + 2
  auto release = [&](int i) {
    const uint32_t bar = empty + 8 * (2 * wg + (i & 1));
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
    if (producer && i + 2 < n_chunks) {
      mbar_wait(bar, (i >> 1) & 1);
      load_chunk(i + 2);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, kQ);
#pragma unroll
    for (int b = 0; b < D / 32; ++b) tma_load(sQ + b * kQBox, &maps.q, qbar, 32 * b, q0, bh);
  }
  if (producer) {
    load_chunk(0);
    load_chunk(1);
  }

  float o[kHalf / 2], ot[kChunkDims / 2];  // 64 rows x this warpgroup's 256 output columns; one chunk's P.V
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kChunkDims / 2; ++i) ot[i] = 0.f;
  float m_run[2] = {kMaskedScore, kMaskedScore}, l_run[2] = {0.f, 0.f};
  // this thread's Q row g of its warp's 16 in every box (row g + 8 is 8 rows on, under the same swizzle)
  const float* q_row = reinterpret_cast<const float*>(base) + (warp * 16 + g) * 32;
  mbar_wait(qbar, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * 2 * kChunks;  // this tile's first chunk

    // this warpgroup's half of S = Q K^T, 64 x BK: each k-step of 8 head dims as lo.hi + hi.lo + hi.hi, the
    // small terms first; Q's A fragment (rows g, g + 8; head dims t, t + 4 of the step, K's natural order) is
    // read from the raw boxes and split in registers, two fragments in flight
    float sc[BK / 2];
    uint32_t qa[2][2][4];  // [fragment][hi, lo]
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = c0 + c;
      wait_chunk(i);
      const uint32_t k_hi = slot(i), k_lo = k_hi + 2 * kKBox;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int step = c * kSteps + ks, f = step & 1, dim = kHalf * wg + 8 * step;
        // the 128-byte swizzle: 16-byte unit u of row r lies at unit u ^ (r % 8), and r % 8 = g
        const float* box = q_row + (dim / 32) * (kQBox / 4);
        const int u = (dim % 32) / 4, at = ((u ^ g) << 2) + t, at4 = (((u + 1) ^ g) << 2) + t;
        const float v[4] = {box[at], box[8 * 32 + at], box[at4], box[8 * 32 + at4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = tf32_rna(v[e]);
          qa[f][0][e] = __float_as_uint(h);
          qa[f][1][e] = __float_as_uint(tf32_rna(v[e] - h));
        }
        const uint64_t kh = smem_desc(k_hi + (ks / 4) * kKBox, 1024, kSwizzle128) + 2 * (ks % 4);
        const uint64_t kl = smem_desc(k_lo + (ks / 4) * kKBox, 1024, kSwizzle128) + 2 * (ks % 4);
        wgmma_fence();
        Wgmma32<BK>::rs(sc, qa[f][1], kh, step > 0);
        Wgmma32<BK>::rs(sc, qa[f][0], kl, 1);
        Wgmma32<BK>::rs(sc, qa[f][0], kh, 1);
        wgmma_commit();
        wgmma_wait<1>();  // the step before is done: its fragment may be rewritten
        if (ks == 0 && c > 0) release(i - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);
    release(c0 + kChunks - 1);

    // the two halves meet in shared memory: thread tid of either warpgroup holds the same rows and
    // keys, so each adds the other's 16 values (a + b == b + a: both get the same bits)
    float4* mine = reinterpret_cast<float4*>(parts + ((tile & 1) * kWarpgroups + wg) * (kPart / 4));
    const float4* theirs = reinterpret_cast<const float4*>(parts + ((tile & 1) * kWarpgroups + (wg ^ 1)) * (kPart / 4));
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) mine[i * 128 + tid] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
    __syncthreads();  // a part is rewritten two tiles on, after the next barrier: its reader is past it
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float4 x = theirs[i * 128 + tid];
      sc[4 * i] += x.x;
      sc[4 * i + 1] += x.y;
      sc[4 * i + 2] += x.z;
      sc[4 * i + 3] += x.w;
    }

    // online softmax in the log2 domain (both warpgroups compute the same); P in f32, split into hi and lo
    // A fragments in the order of the transposed planes' keys
    float alpha[2];
    softmax_probs<BK>(sc, tile * BK, nk, mb, scale_log2, t, m_run, l_run, alpha);
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) split_fragment(sc + 4 * j, ph[j], pl[j]);

    // O += P V over this warpgroup's 256 columns, a V^T chunk of 64 at a time: the chunk's products into a
    // fresh accumulator (the tensor cores' sums run over one tile only), folded into the running output with
    // the softmax's rescale by one FFMA
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = c0 + kChunks + c;
      wait_chunk(i);
      const uint32_t v_hi = slot(i), v_lo = v_hi + kVtBox;
      fence_regs(ot);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const uint64_t vh = smem_desc(v_hi, 1024, kSwizzle128) + 2 * j;
        const uint64_t vl = smem_desc(v_lo, 1024, kSwizzle128) + 2 * j;
        Wgmma32<kChunkDims>::rs(ot, pl[j], vh, j > 0);
        Wgmma32<kChunkDims>::rs(ot, ph[j], vl, 1);
        Wgmma32<kChunkDims>::rs(ot, ph[j], vh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ot);
      release(i);
#pragma unroll
      for (int e = 0; e < kChunkDims / 2; ++e)
        o[c * (kChunkDims / 2) + e] = fmaf(o[c * (kChunkDims / 2) + e], alpha[(e >> 1) & 1], ot[e]);
    }
  }

  float* ob = out + (size_t)bh * nq * D + kHalf * wg;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    float* orow = ob + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    // both warpgroups hold the same running max and sum; the first writes the row's log-sum-exp, as fwd_tf32
    if (lse != nullptr && wg == 0 && t == 0)
      lse[(size_t)bh * nq + row] = m_run[r] <= kMaskedScore
                                       ? kMaskedScore
                                       : (m_run[r] + log2f(fmaxf(l_run[r], 1e-30f))) * 0.6931471805599453f;
  }
}

// planes: Q raw ((bh, nq, D) f32), K hi, K lo ((bh, nk, D) f32), V^T hi, V^T lo ((bh, D, nk rounded up to 8)
// f32, keys in the order of tf32_planes.cu).
cudaError_t launch(const void* const* planes, const void* mask, void* out, void* lse, int bh, int heads, int nq,
                   int nk, float scale, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const int nk_pad = (nk + 7) / 8 * 8;
  Maps maps = {};
  bool ok = make_map(&maps.q, planes[0], D, nq, bh, 32, BQ, CU_TENSOR_MAP_SWIZZLE_128B, true);
  for (int p = 0; p < 2; ++p)
    ok = ok && make_map(&maps.k[p], planes[1 + p], D, nk, bh, 32, BK, CU_TENSOR_MAP_SWIZZLE_128B, true) &&
         make_map(&maps.vt[p], planes[3 + p], nk_pad, D, bh, 32, kChunkDims, CU_TENSOR_MAP_SWIZZLE_128B, true);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(maps, static_cast<const uint8_t*>(mask), static_cast<float*>(out),
                                            static_cast<float*>(lse), heads, nq, nk, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t occupancy(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = (int)kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, kSmem);
}

}  // namespace d512_tf32

}  // namespace

// q: (bh, nq, d), k and v: (bh, nk, d), out: (bh, nq, d), all contiguous bf16
// (is_bf16 must be 1: flash_attn_fwd_f32 takes f32; the flag stays so that an
// older build, which took f32 here, binds the same way); mask: (bh / heads, nk)
// bytes, or null for no mask; lse: (bh, nq) f32 to receive the row
// log-sum-exp, or null (head dims 64 and 72 only). Returns a cudaError_t; 0
// means the launch was accepted.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* mask,
                              void* out, void* lse, int bh, int heads, int nq, int nk, int d,
                              float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64) return hopper::launch<64>(q, k, v, mask, out, lse, bh, heads, nq, nk, scale, s);
  if (d == 72) return hopper::launch<72>(q, k, v, mask, out, lse, bh, heads, nq, nk, scale, s);
  if (d == 512 && lse == nullptr) return d512::launch(q, k, v, mask, out, bh, heads, nq, nk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 forms on split planes (tf32_planes.cu). At head dims 32, 64 and 72
// planes holds the pointers Q hi, Q lo, K hi, K lo ((bh, n, d) f32) and V^T
// hi, V^T lo ((bh, d, nk rounded up to a multiple of 8) f32); at head dim 512
// Q raw ((bh, nq, d) f32), K hi, K lo, V^T hi, V^T lo. mask, out (f32), lse
// (at every head dim) and the rest as flash_attn_fwd. Returns a cudaError_t.
extern "C" int flash_attn_fwd_f32(const void* const* planes, const void* mask, void* out, void* lse, int bh,
                                  int heads, int nq, int nk, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) return fwd_tf32::launch<32>(planes, mask, out, lse, bh, heads, nq, nk, scale, s);
  if (d == 64) return fwd_tf32::launch<64>(planes, mask, out, lse, bh, heads, nq, nk, scale, s);
  if (d == 72) return fwd_tf32::launch<72>(planes, mask, out, lse, bh, heads, nq, nk, scale, s);
  if (d == 512) return d512_tf32::launch(planes, mask, out, lse, bh, heads, nq, nk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 form at head dim d: the shared memory a block takes and how many
// of its blocks fit on one SM, registers and shared memory together (for
// reports). Returns a cudaError_t.
extern "C" int flash_attn_fwd_occupancy(int d, int* smem_bytes, int* blocks_per_sm) {
  if (d == 64) return hopper::occupancy<64>(smem_bytes, blocks_per_sm);
  if (d == 72) return hopper::occupancy<72>(smem_bytes, blocks_per_sm);
  if (d == 512) return d512::occupancy(smem_bytes, blocks_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for the f32 form at head dim 32, 64, 72 or 512.
extern "C" int flash_attn_fwd_occupancy_f32(int d, int* smem_bytes, int* blocks_per_sm) {
  if (d == 32) return fwd_tf32::occupancy<32>(smem_bytes, blocks_per_sm);
  if (d == 64) return fwd_tf32::occupancy<64>(smem_bytes, blocks_per_sm);
  if (d == 72) return fwd_tf32::occupancy<72>(smem_bytes, blocks_per_sm);
  if (d == 512) return d512_tf32::occupancy(smem_bytes, blocks_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
