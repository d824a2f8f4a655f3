// Hopper (sm_90a) building blocks shared by the port's kernels:
// flash_attn_fwd.cu (K1 at head dims 64, 72 and 512), flash_attn_bwd.cu (K2),
// gn_conv.cu (K3), swin_attention.cu (K4) and tf32_planes.cu (the split
// prepass of the f32 forms).
//
// * mbarriers: init, arrive (with an expected byte count for TMA), wait on a
//   phase's parity;
// * cp.async of 4 bytes, with an mbarrier arrival when the thread's copies
//   land;
// * TMA: cp.async.bulk.tensor loads of one box of a tiled tensor map into
//   shared memory, completing on an mbarrier (3-D and 4-D);
// * wgmma: shared-memory descriptors, the fences and commit/wait around
//   wgmma.mma_async, and the bf16 x bf16 -> f32 forms the kernels use
//   (Wgmma<N>::ss with both operands in shared memory, Wgmma<N>::rs with A in
//   registers and B an MN-major shared tile), the tf32 x tf32 -> f32 forms of
//   the f32 kernels (Wgmma32<N>::ss, Wgmma32<N>::rs; a tf32 B is K-major
//   only), and ex2 (2^x);
// * tf32_rna: an f32 value rounded to tf32 (its low 13 bits zero), the split
//   of an f32 operand into hi + lo planes;
// * on the host: cuTensorMapEncodeTiled, a libcuda entry point found through
//   the runtime (the libraries link no libcuda), and a cache of the maps
//   last made, keyed by address, element type, shape, box and swizzle, and
//   make_map, the map of one head-major (bh, n, d) attention operand.
//
// Every library that includes this header hashes it into its build path
// (ops/cuda_build.py), so an edit here rebuilds all three.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

namespace hopper {

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
// After the mbarriers are initialised, before any thread or TMA uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// 4 bytes from global src to shared dst.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
// One arrival on bar once this thread's cp.async copies so far have landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// One box of `map` at the given coordinates (innermost first) into shared
// memory at dst; its bytes complete on bar. Coordinates may be negative or
// past the tensor: those elements are zero-filled.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// x rounded to tf32, to nearest with ties away from zero, as f32 bits whose
// low 13 bits are zero (cleared again in case the conversion leaves them).
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y & 0xffffe000u);
}

// Columns 8 j + 2 t and 8 j + 2 t + 1 of rows g and g + 8 of a wgmma
// accumulator (x = &acc[4 j]) as the tf32 A fragment of one k-step, split
// into hi and lo planes: k = t takes column 2 t and k = t + 4 column 2 t + 1,
// the order of the transposed planes along K (tf32_planes.cu), so the product
// pairs each value with its own B row.
__device__ __forceinline__ void split_fragment(const float* x, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {x[0], x[2], x[1], x[3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float h = tf32_rna(v[e]);
    hi[e] = __float_as_uint(h);
    lo[e] = __float_as_uint(tf32_rna(v[e] - h));
  }
}

// 2^x on the SM's exponential unit (ex2.approx.ftz: results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, swizzle (1: 128 bytes, 2: 64 bytes, 3: 32 bytes). K-major under a swizzle: the
// stride offset is between 8-row groups and the leading one unused; a k-step
// is 32 bytes along a row whatever the type (16 bf16 or 8 tf32 values), so a
// step's descriptor is the previous one plus 2 (the address is in 16 bytes). MN-major:
// the stride offset is between groups of 8 along K; the leading one is between
// swizzle-wide groups along M or N (64 bf16 under the 128-byte swizzle), and
// unused when the tile is one group wide.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo, uint64_t swizzle, uint32_t lbo = 16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32 |
         swizzle << 62;
}
constexpr uint64_t kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Waits until at most N committed groups of this warpgroup's wgmmas are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers across the asm around them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

template <> struct Wgmma<32> {
  // D (64 x 32, f32) = [D +] A (64 x 16, shared, K-major) . B (32 x 16, shared, K-major)^T
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "%16, %17, p, 1, 1, 0, 0;\n}\n"
                 : WGMMA_ACC16(0)
                 : "l"(a), "l"(b), "r"(accumulate));
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

template <> struct Wgmma<128> {
  // D (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major: two 64-wide groups LBO apart)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
                 "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : WGMMA_ACC16(0), WGMMA_ACC16(16), WGMMA_ACC16(32), WGMMA_ACC16(48)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<256> {
  // D (64 x 256, f32) += A (64 x 16, registers) . B (16 x 256, shared, MN-major: four 64-wide groups LBO apart)
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
                 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
                 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
                 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
                 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
                 "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
                 : WGMMA_ACC16(0), WGMMA_ACC16(16), WGMMA_ACC16(32), WGMMA_ACC16(48), WGMMA_ACC16(64),
                   WGMMA_ACC16(80), WGMMA_ACC16(96), WGMMA_ACC16(112)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// tf32 x tf32 -> f32, for the f32 kernels. A .tf32 operand in
// shared memory is K-major only (no transpose bit), so a B whose K is the
// tile's row index comes from a transposed plane. The register A fragment of
// a warp is a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
// (row, k) of its 16 rows, g = lane / 4, t = lane % 4.
template <int N> struct Wgmma32;

template <> struct Wgmma32<32> {
  // D (64 x 32, f32) = [D +] A (64 x 8, shared, K-major) . B (32 x 8, shared, K-major)^T
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
                 "}, %16, %17, p, 1, 1;\n}\n"
                 : WGMMA_ACC16(0)
                 : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 32, f32) = [D +] A (64 x 8, registers) . B (32 x 8, shared, K-major)^T
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
                 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : WGMMA_ACC16(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma32<64> {
  // D (64 x 64, f32) = [D +] A (64 x 8, shared, K-major) . B (64 x 8, shared, K-major)^T
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
                 "}, %32, %33, p, 1, 1;\n}\n"
                 : WGMMA_ACC16(0), WGMMA_ACC16(16)
                 : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 64, f32) = [D +] A (64 x 8, registers) . B (64 x 8, shared, K-major)^T
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
                 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : WGMMA_ACC16(0), WGMMA_ACC16(16)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma32<72> {
  // D (64 x 72, f32) = [D +] A (64 x 8, registers) . B (72 x 8, shared, K-major)^T
  static __device__ __forceinline__ void rs(float (&d)[36], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35"
                 "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
                 : WGMMA_ACC16(0), WGMMA_ACC16(16), WGMMA_ACC4(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma32<128> {
  // D (64 x 128, f32) = [D +] A (64 x 8, registers) . B (128 x 8, shared, K-major)^T
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : WGMMA_ACC16(0), WGMMA_ACC16(16), WGMMA_ACC16(32), WGMMA_ACC16(48)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

#undef WGMMA_ACC16
#undef WGMMA_ACC4

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime; null where the driver lacks it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` (at most 5) dimensions, innermost first, of elements
// of `dtype` (bf16 unless given): dims, the byte strides of dimensions 1..
// (rank - 1 of them), the box and the swizzle; elements outside the tensor
// read as zero. A map holds only the
// address, the shape and the box, never the data, so the maps made last are
// kept in a table of kMapSlots slots indexed by a hash of those, and a call on
// tensors at the same addresses and shapes encodes none. Returns false when
// the driver refuses the map.
constexpr int kMapSlots = 256;

struct MapKey {
  const void* ptr;
  int rank, swizzle, dtype, unused;  // an f32 and a bf16 map of one address differ
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5];
};

inline bool tiled_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                      CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  struct Slot {
    MapKey key;
    CUtensorMap map;
  };
  static Slot slots[kMapSlots];
  static std::mutex lock;
  MapKey key;
  memset(&key, 0, sizeof(key));  // the padding too: keys are compared and hashed as raw memory
  key.ptr = ptr;
  key.rank = rank;
  key.swizzle = (int)swizzle;
  key.dtype = (int)dtype;
  memcpy(key.dims, dims, rank * sizeof(cuuint64_t));
  memcpy(key.strides, strides, (rank - 1) * sizeof(cuuint64_t));
  memcpy(key.box, box, rank * sizeof(cuuint32_t));
  static_assert(sizeof(MapKey) % 8 == 0, "the key is hashed as 8-byte words");
  uint64_t h = 0xcbf29ce484222325ull;
  for (size_t i = 0; i < sizeof(key); i += 8) {
    uint64_t word;
    memcpy(&word, reinterpret_cast<const unsigned char*>(&key) + i, 8);
    h = (h ^ word) * 0x100000001b3ull;
  }
  h = (h ^ (h >> 33)) * 0xff51afd7ed558ccdull;  // mix the high bits down before taking the low ones
  Slot& slot = slots[(h ^ (h >> 33)) % kMapSlots];
  std::lock_guard<std::mutex> guard(lock);
  if (memcmp(&slot.key, &key, sizeof(key)) != 0) {
    const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
    slot.key.ptr = nullptr;
    if (encode_tiled()(&slot.map, dtype, rank, const_cast<void*>(ptr), dims, strides, box,
                       unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
    slot.key = key;
  }
  *map = slot.map;
  return true;
}

// A (bh, n, d) bf16 (or, with f32 set, f32) tensor seen as 3-D (d, n, bh),
// read in boxes of `width` elements x `rows` rows of one head under the given
// swizzle (the box's rows are its width in bytes, 128 or 32). Rows past n and
// elements past d are zero-filled, so a ragged tail never reads the next head.
// Cached by hopper::tiled_map: a call on tensors at the same addresses, types
// and shapes encodes none.
inline bool make_map(CUtensorMap* map, const void* ptr, int d, int n, int bh, int width, int rows,
                     CUtensorMapSwizzle swizzle, bool f32 = false) {
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * esize, (cuuint64_t)n * d * esize};
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)rows, 1};
  return tiled_map(map, ptr, 3, dims, strides, box, swizzle,
                   f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

}  // namespace hopper

}  // namespace
