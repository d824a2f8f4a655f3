// Per-sample depthwise 2-D correlation over a reflect-padded NHWC f32 image
// for Hopper (sm_90a), bound to PyTorch through a plain C launcher loaded with
// ctypes (instarevive_tpu_torch/ops/filters.py):
//
//   out[b, y, x, c] = sum_{i, j} k[b, i, j] * img[b, refl(y + i - kh/2), refl(x + j - kw/2), c]
//
// with torch's "reflect" (no edge repeat: -i -> i, H-1+i -> H-1-i), the same
// (kh, kw) taps for every channel of a sample, f32 throughout.
//
// Replaces the Pallas TPU kernel `_filter2d_plane_kernel` of
// instarevive_tpu/ops/filters.py (reached through `_filter2d_pallas`). That
// version pads a copy of the image, transposes it to one plane per channel
// and refuses shapes that do not tile by 8 rows and 128-aligned columns. None
// of that is carried over: the image is read as it lies in memory.
//
// What bounds it on this card: 2 * kh * kw operations per output float (882
// at 21 taps, 3362 at 41) against 8 bytes moved, so f32 FMAs, not memory. The
// design keeps the FMA pipes fed:
//
// * A row of a band is flat: E channels of each pixel side by side, so a
//   horizontal tap is E floats further on. For C <= 3 the band is the whole
//   row (E = C, W * C floats as in memory); a wider image is cut into bands
//   of E = 4, 2 or 1 channels (the largest that divides C and the pointers'
//   alignment allows), each band a tile
//   coordinate, so every C takes one launch.
// * A thread accumulates R rows (4, 2 or 1) x 12 flat outputs. For each of
//   its R + kh - 1 input rows and each chunk of 4 tap columns it loads the
//   row segment it needs (3 + E float4, 16-byte aligned) and, per output row,
//   one float4 of taps (a broadcast: every lane reads the same taps), then
//   runs R * 4 * 12 FMAs: 192 FMAs for 10 shared-memory loads at R = 4.
//   Rows whose tap row range is partial (the first and last R - 1) take a
//   guarded copy of the loop; a tap row's last kw % 4 taps a chunk of their
//   own, so no FMA multiplies a padding tap.
// * A block is two groups of 4 warps over the same outputs: group g takes
//   the input rows r = g mod 2; once the tile is filtered both groups' sums
//   meet in the freed patch as a row-major tile, which the whole block
//   stores in 16-byte pieces (each thread's own 12 outputs, 48 bytes apart
//   from its neighbours', would cost a partial sector a lane). At the main shape
//   (2, 512, 512, 3) x 21^2 a 48-output register tile leaves only 8 warps an
//   SM if each thread owns its outputs alone; the split gives 16.
// * Lanes: 8 across a tile's 96 flats, 12 floats apart, 4 down. A 16-byte
//   load is served 8 lanes at a time, and 8 lanes 12 words apart cover the
//   32 banks once: no bank conflict whatever C is.
// * A block filters one tile, 16 R rows x 96 flats of one (sample, band),
//   from its patch with the halo: (16 R + kh - 1) rows of 96 + (kw - 1) E
//   flats, and the sample's taps, padded to rows of a multiple of 4, at two
//   blocks an SM. A block copies, then filters: neither a second stage nor
//   persistent blocks walking tiles made it faster (tools/time_degrade.py). Copies are
//   cp.async: in the flat form 16 or 8 bytes over the interior, as the
//   halo's start is aligned in memory (16 at 41 taps and C = 3, 8 at 21:
//   where the row pitch is a multiple of 16 bytes), one float at the
//   reflected border columns and wherever the pitch is not; in a band one
//   pixel's E channels at a time. Row and column reflections are worked out
//   per copy from the tile's origin; no division per element.
// * The launcher picks E and R from the shape, the pointers' alignment and
//   the SM count (make_plan), so that a small image still reaches the SMs;
//   filter2d_plan reports the pick.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroup = 128;             // threads of a group: each covers the whole tile
constexpr int kThreads = 2 * kGroup;    // two groups split a tile's input rows
constexpr int kTX = 8;                  // threads across a tile's flats
constexpr int kTY = kGroup / kTX;       // thread rows of a tile
constexpr int kQ = 12;                  // flat outputs a thread owns in each of its rows
constexpr int kSpan = kTX * kQ;         // flats a tile spans
constexpr int kMaxTaps = 41;
constexpr int kMaxSmem = 232448;        // bytes a block may use on sm_90

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// Floats of a tap row, of a patch row (a 16-byte window may reach 3 floats past the halo) and of a block's taps and patch.
__host__ __device__ constexpr int tap_pitch(int kw) { return round4(kw); }
__host__ __device__ constexpr int patch_pitch(int e, int kw) { return round4(kSpan + (kw - 1) * e) + 4; }
__host__ __device__ constexpr int patch_rows(int rows, int kh) { return kTY * rows + kh - 1; }
__host__ __device__ constexpr int stage_floats(int e, int rows, int kh, int kw) {
  return kh * tap_pitch(kw) + patch_rows(rows, kh) * patch_pitch(e, kw);
}

static_assert(4 * stage_floats(4, 4, kMaxTaps, kMaxTaps) <= kMaxSmem, "the largest tile fits a block");

struct Params {
  const float* img;
  const float* taps;
  float* out;
  int H, W, C, kh, kw, tap_stride;
  int bands, xtiles, ytiles;
  int kwp, pwp, prows;   // tap pitch, patch pitch, patch rows
  int vec;               // flat form: the row pitch, the image and the output are 16-byte aligned
};

// The origin of tile t: sample, first channel of its band, first row, and
// first output flat (flat form) or pixel (band form); g0 is the row flat
// (flat form) or pixel (band form) of patch column 0.
struct Tile {
  int b, c0, y0, f0, g0;
};

// torch "reflect" for an index at most n - 1 outside [0, n); clamped beyond
// that, where only the unused rows and columns of a ragged tile fall.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// f(row, col) for every cell of a rows x cols grid, kThreads cells apart in
// row-major order, starting at cell tid: two divisions a call, none a cell.
template <typename F>
__device__ __forceinline__ void walk(int rows, int cols, int tid, F&& f) {
  if (cols <= 0) return;
  int r = tid / cols, c = tid - r * cols;
  const int dr = kThreads / cols, dc = kThreads - dr * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// E = C <= 3 takes the flat form; E = 4 (and E = 1, 2 below C) the band form.
template <int E>
__device__ __forceinline__ bool flat_form(const Params& p) {
  if constexpr (E == 3) return true;
  if constexpr (E == 4) return false;
  return p.C == E;
}

template <int E, int R>
__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  const int xt = t % p.xtiles;
  t /= p.xtiles;
  const int yt = t % p.ytiles;
  t /= p.ytiles;
  Tile T;
  T.c0 = (t % p.bands) * E;
  T.b = t / p.bands;
  T.y0 = yt * kTY * R;
  if (flat_form<E>(p)) {
    T.f0 = xt * kSpan;
    T.g0 = T.f0 - (p.kw / 2) * E;
  } else {
    T.f0 = xt * (kSpan / E);
    T.g0 = T.f0 - p.kw / 2;
  }
  return T;
}

// Offset of the (reflected) image row under patch row r.
__device__ __forceinline__ int row_offset(const Params& p, const Tile& T, int r) {
  return (T.b * p.H + reflect(T.y0 + r - p.kh / 2, p.H)) * p.W * p.C;
}

// Copies tile t's taps and patch into `stage` (cp.async, not waited for).
template <int E, int R>
__device__ void stage_tile(const Params& p, int t, float* stage, int tid) {
  const Tile T = tile_at<E, R>(p, t);
  float* ks = stage;
  float* patch = stage + p.kh * p.kwp;
  const float* kb = p.taps + static_cast<size_t>(T.b) * p.tap_stride;
  const int j = tid & 63;  // kwp <= 44: thread j of each quarter-block copies column j of every fourth tap row
  if (j < p.kwp)
    for (int i = tid >> 6; i < p.kh; i += kThreads / 64) {
      if (j < p.kw)
        cp_async<4>(ks + i * p.kwp + j, kb + i * p.kw + j);
      else
        ks[i * p.kwp + j] = 0.f;
    }
  if (flat_form<E>(p)) {
    if constexpr (E <= 3) {
      // Columns [kL, kR) lie inside the row; with vec, the halo's start is as aligned in memory as in the stage
      // and they go in chunks of cw floats, one float each otherwise.
      const int wc = p.W * E;
      const int cw = !p.vec ? 1 : (T.g0 & 3) == 0 ? 4 : (T.g0 & 1) == 0 ? 2 : 1;
      const int kL = min(max(-T.g0, 0), p.pwp), kR = max(min(wc - T.g0, p.pwp), kL);
      const int inner = kR - kL;
      const auto interior = [&](auto width) {
        constexpr int w = decltype(width)::value;
        walk(p.prows, inner / w, tid, [&](int r, int m) {
          const int k = kL + w * m;
          cp_async<4 * w>(patch + r * p.pwp + k, p.img + row_offset(p, T, r) + T.g0 + k);
        });
      };
      if (cw == 4)
        interior(std::integral_constant<int, 4>());
      else if (cw == 2)
        interior(std::integral_constant<int, 2>());
      else
        interior(std::integral_constant<int, 1>());
      walk(p.prows, p.pwp - inner, tid, [&](int r, int u) {
        const int k = u < kL ? u : u + inner;
        int g = T.g0 + k;
        if (g < 0 || g >= wc) {  // a border column: the same channel of the reflected pixel
          const int x = g >= 0 ? g / E : -((E - 1 - g) / E);
          g = reflect(x, p.W) * E + (g - x * E);
        }
        cp_async<4>(patch + r * p.pwp + k, p.img + row_offset(p, T, r) + g);
      });
    }
  } else {
    if constexpr (E != 3) {
      walk(p.prows, p.pwp / E, tid, [&](int r, int u) {
        cp_async<4 * E>(patch + r * p.pwp + u * E, p.img + row_offset(p, T, r) + reflect(T.g0 + u, p.W) * p.C + T.c0);
      });
    }
  }
}

// NT taps (columns j0 .. j0 + NT - 1 of each tap row) of one input row:
// `win` is the thread's row segment at column j0, `krow` tap row r at column
// j0; output row o takes tap row r - o, for o in [lo, hi] unless FULL.
template <int E, int NT, int R, bool FULL>
__device__ __forceinline__ void tap_chunk(float (&acc)[R][kQ], const float* __restrict__ win,
                                          const float* __restrict__ krow, int kwp, int lo, int hi) {
  constexpr int NV = (kQ + (NT - 1) * E + 3) / 4;
  float v[4 * NV];
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const float4 x = reinterpret_cast<const float4*>(win)[n];
    v[4 * n] = x.x;
    v[4 * n + 1] = x.y;
    v[4 * n + 2] = x.z;
    v[4 * n + 3] = x.w;
  }
#pragma unroll
  for (int o = 0; o < R; ++o) {
    if (FULL || (o >= lo && o <= hi)) {
      const float4 t4 = *reinterpret_cast<const float4*>(krow - o * kwp);
      const float t[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int jj = 0; jj < NT; ++jj)
#pragma unroll
        for (int q = 0; q < kQ; ++q) acc[o][q] = fmaf(t[jj], v[q + jj * E], acc[o][q]);
    }
  }
}

template <int E, int R, bool FULL>
__device__ __forceinline__ void tap_row(float (&acc)[R][kQ], const float* prow, const float* krow, int kw, int kwp,
                                        int lo, int hi) {
  int j0 = 0;
#pragma unroll 1
  for (; j0 + 4 <= kw; j0 += 4) tap_chunk<E, 4, R, FULL>(acc, prow + j0 * E, krow + j0, kwp, lo, hi);
  switch (kw - j0) {
    case 1: tap_chunk<E, 1, R, FULL>(acc, prow + j0 * E, krow + j0, kwp, lo, hi); break;
    case 2: tap_chunk<E, 2, R, FULL>(acc, prow + j0 * E, krow + j0, kwp, lo, hi); break;
    case 3: tap_chunk<E, 3, R, FULL>(acc, prow + j0 * E, krow + j0, kwp, lo, hi); break;
    default: break;
  }
}

template <int E, int R>
__device__ __forceinline__ void filter_tile(const Params& p, const float* stage, int tx, int ty, int g,
                                            float (&acc)[R][kQ]) {
#pragma unroll
  for (int o = 0; o < R; ++o)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[o][q] = 0.f;
  const float* patch = stage + p.kh * p.kwp + ty * R * p.pwp + tx * kQ;
  const int rows = R + p.kh - 1;
#pragma unroll 1
  for (int r = g; r < rows; r += 2) {
    const float* prow = patch + r * p.pwp;
    const float* krow = stage + r * p.kwp;  // tap row r; output row o takes krow - o * kwp
    if (r >= R - 1 && r < p.kh)
      tap_row<E, R, true>(acc, prow, krow, p.kw, p.kwp, 0, R - 1);
    else
      tap_row<E, R, false>(acc, prow, krow, p.kw, p.kwp, max(0, r - p.kh + 1), min(R - 1, r));
  }
}

// The tile's outputs: both groups' sums meet in `buf` (the patch just
// filtered, row-major, kSpan floats a row), then every thread of the block
// stores whole rows: 16-byte stores where the row is aligned (a pixel's E
// channels in a band), so each warp writes whole lines. Every thread of the
// block calls it after the tile's FMAs.
template <int E, int R>
__device__ __forceinline__ void store_tile(const Params& p, const Tile& T, float (&acc)[R][kQ], float* buf, int tid,
                                           int tx, int ty, int g) {
  float* mine = buf + ty * R * kSpan + tx * kQ;
  __syncthreads();  // both groups are done reading the patch
  if (g == 1)
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int q = 0; q < kQ; q += 4)
        *reinterpret_cast<float4*>(mine + o * kSpan + q) =
            make_float4(acc[o][q], acc[o][q + 1], acc[o][q + 2], acc[o][q + 3]);
  __syncthreads();
  if (g == 0)
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int q = 0; q < kQ; q += 4) {
        float4* x = reinterpret_cast<float4*>(mine + o * kSpan + q);
        const float4 v = *x;
        *x = make_float4(v.x + acc[o][q], v.y + acc[o][q + 1], v.z + acc[o][q + 2], v.w + acc[o][q + 3]);
      }
  __syncthreads();
  if (flat_form<E>(p)) {
    const int wc = p.W * E;
    for (int i = tid; i < kTY * R * (kSpan / 4); i += kThreads) {
      const int r = i / (kSpan / 4), f = T.f0 + 4 * (i - r * (kSpan / 4)), y = T.y0 + r;
      if (y >= p.H) break;
      float* orow = p.out + (T.b * p.H + y) * wc;
      const float4 v = reinterpret_cast<const float4*>(buf)[i];
      if (p.vec && f + 4 <= wc) {
        *reinterpret_cast<float4*>(orow + f) = v;
      } else {
        const float w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (f + k < wc) orow[f + k] = w4[k];
      }
    }
  } else {
    if constexpr (E != 3) {
      using Vec = std::conditional_t<E == 4, float4, std::conditional_t<E == 2, float2, float>>;
      for (int i = tid; i < kTY * R * (kSpan / E); i += kThreads) {
        const int r = i / (kSpan / E), x = T.f0 + (i - r * (kSpan / E)), y = T.y0 + r;
        if (y >= p.H) break;
        if (x < p.W)
          *reinterpret_cast<Vec*>(p.out + ((T.b * p.H + y) * p.W + x) * p.C + T.c0) = reinterpret_cast<const Vec*>(buf)[i];
      }
    }
  }
}

// -DFILTER2D_ABLATE_COPIES_ONLY: the copies and their wait, no FMA and no
// store; -DFILTER2D_ABLATE_NO_COPIES: no copy, the FMAs and the store on
// whatever shared memory holds. Timing builds only (tools/time_degrade.py --ablations).
template <int E, int R>
__global__ void __launch_bounds__(kThreads, 2) filter2d_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, g = tid / kGroup, t_in = tid % kGroup, tx = t_in % kTX, ty = t_in / kTX;
#ifndef FILTER2D_ABLATE_NO_COPIES
  stage_tile<E, R>(p, blockIdx.x, stage, tid);
  cp_async_commit();
  cp_async_wait<0>();
#endif
  __syncthreads();
#ifndef FILTER2D_ABLATE_COPIES_ONLY
  float acc[R][kQ];
  filter_tile<E, R>(p, stage, tx, ty, g, acc);
  store_tile<E, R>(p, tile_at<E, R>(p, blockIdx.x), acc, stage, tid, tx, ty, g);
#endif
}

using KernelFn = void (*)(const Params);

KernelFn pick_kernel(int e, int rows) {
  switch (e * 8 + rows) {
    case 1 * 8 + 1: return filter2d_kernel<1, 1>;
    case 1 * 8 + 2: return filter2d_kernel<1, 2>;
    case 1 * 8 + 4: return filter2d_kernel<1, 4>;
    case 2 * 8 + 1: return filter2d_kernel<2, 1>;
    case 2 * 8 + 2: return filter2d_kernel<2, 2>;
    case 2 * 8 + 4: return filter2d_kernel<2, 4>;
    case 3 * 8 + 1: return filter2d_kernel<3, 1>;
    case 3 * 8 + 2: return filter2d_kernel<3, 2>;
    case 3 * 8 + 4: return filter2d_kernel<3, 4>;
    case 4 * 8 + 1: return filter2d_kernel<4, 1>;
    case 4 * 8 + 2: return filter2d_kernel<4, 2>;
    case 4 * 8 + 4: return filter2d_kernel<4, 4>;
    default: return nullptr;
  }
}

struct Plan {
  int e, rows, tiles, smem;  // band width, output rows a thread, blocks (one a tile), bytes a block
};

// The tiles of the walk over (sample, band, row band, flat or pixel span).
long long tile_count(int b, int h, int w, int c, int e, int rows) {
  const long long xtiles = c <= 3 ? (w * c + kSpan - 1) / kSpan : (w + kSpan / e - 1) / (kSpan / e);
  return (long long)b * (c <= 3 ? 1 : c / e) * ((h + kTY * rows - 1) / (kTY * rows)) * xtiles;
}

// The launch for one shape. E: all channels up to 3 (the flat form), else
// the largest of 4, 2, 1 that divides C and whose 4E-byte copies the
// pointers' alignment allows. R: the largest of 4, 2, 1 whose tiles reach
// three quarters of the SMs, else 1 (the most tiles): 48 accumulators at 4
// rows keep the most FMAs a shared-memory load, and a small image takes
// thin tiles that reach more SMs.
Plan make_plan(int b, int h, int w, int c, int kh, int kw, int align, int sms) {
  Plan p;
  p.e = c;
  if (c > 3) p.e = c % 4 == 0 && align % 16 == 0 ? 4 : c % 2 == 0 && align % 8 == 0 ? 2 : 1;
  p.rows = 1;
  const int choices[2] = {4, 2};
  for (int rows : choices)
    if (4 * tile_count(b, h, w, c, p.e, rows) >= 3LL * sms) {
      p.rows = rows;
      break;
    }
  const long long tiles = tile_count(b, h, w, c, p.e, p.rows);
  p.tiles = tiles < (1LL << 31) ? static_cast<int>(tiles) : -1;
  p.smem = 4 * stage_floats(p.e, p.rows, kh, kw);
  return p;
}

// The largest power of two up to 16 that divides both addresses.
int alignment(const void* a, const void* b) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) | 16;
  return static_cast<int>(x & (~x + 1));
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

bool shape_ok(int b, int h, int w, int c, int kh, int kw) {
  return b >= 1 && h >= 1 && w >= 1 && c >= 1 && kh >= 1 && kw >= 1 && kh % 2 == 1 && kw % 2 == 1 &&
         kh <= kMaxTaps && kw <= kMaxTaps && kh / 2 < h && kw / 2 < w && (long long)b * h * w * c < (1LL << 31);
}

}  // namespace

// The launch filter2d_f32 makes on the current device for this shape, with
// img and out `align`-byte aligned: plan[0..5] = band width, output rows a
// thread, blocks (one a tile), bytes of shared memory a block, blocks an SM
// holds, the device's SMs.
extern "C" int filter2d_plan(int b, int h, int w, int c, int kh, int kw, int align, int* plan) {
  int sms = 0;
  if (!shape_ok(b, h, w, c, kh, kw) || align < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(b, h, w, c, kh, kw, align, sms);
  if (p.tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = pick_kernel(p.e, p.rows);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[4], fn, kThreads, p.smem);
  plan[0] = p.e;
  plan[1] = p.rows;
  plan[2] = p.tiles;
  plan[3] = p.smem;
  plan[5] = sms;
  return static_cast<int>(err);
}

// img, out: (b, h, w, c) f32 contiguous; taps: (b, kh, kw) f32 when
// per_sample, else (kh, kw). One launch filters every channel, as make_plan picks.
extern "C" int filter2d_f32(const void* img, const void* taps, void* out, int b, int h, int w, int c, int kh, int kw,
                            int per_sample, void* stream) {
  int sms = 0;
  if (!shape_ok(b, h, w, c, kh, kw)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int align = alignment(img, out);
  const Plan plan = make_plan(b, h, w, c, kh, kw, align, sms);
  if (plan.tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int e = plan.e, rows = plan.rows;
  Params p;
  p.img = static_cast<const float*>(img);
  p.taps = static_cast<const float*>(taps);
  p.out = static_cast<float*>(out);
  p.H = h;
  p.W = w;
  p.C = c;
  p.kh = kh;
  p.kw = kw;
  p.tap_stride = per_sample ? kh * kw : 0;
  const bool flat = c <= 3;
  p.bands = flat ? 1 : c / e;
  p.vec = flat && (w * c) % 4 == 0 && align == 16;
  p.xtiles = flat ? (w * c + kSpan - 1) / kSpan : (w + kSpan / e - 1) / (kSpan / e);
  p.ytiles = (h + kTY * rows - 1) / (kTY * rows);
  p.kwp = tap_pitch(kw);
  p.pwp = patch_pitch(e, kw);
  p.prows = patch_rows(rows, kh);
  const KernelFn fn = pick_kernel(e, rows);
  if (plan.smem > 48 * 1024) {  // the most a block may take, never less: a later launch may need more
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<plan.tiles, kThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
