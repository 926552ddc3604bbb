// Hopper (sm_90a) building blocks for the flash-attention backward:
// asynchronous 16- and 4-byte copies into shared memory (cp.async, with
// zero-fill past a ragged edge), shared-memory matrix descriptors for
// wgmma, and the warpgroup products it uses, f32 accumulators: bf16
// m64nNk16 and tf32 m64nNk8 with A in registers (the "RS" form), and bf16
// m64n64k16 and tf32 m64n32k8 with A in shared memory too ("SS", laid out
// as B is).
//
// Shared-memory operand layout. wgmma reads B (N rows, K deep) from shared
// memory with K contiguous ("K-major"), with no swizzle, as 8 x 16-byte
// "core matrices": core matrix (i, j) holds rows 8i..8i+7 and bytes
// 16j..16j+15 of K, 128 contiguous bytes, row by row. A tile of R rows and
// C elements stores core matrix (i, j) at i * (C * sizeof(T) * 8) + j * 128
// bytes (``tile_offset``), so the 16-byte chunks of K of one 8-row group
// sit side by side (leading byte offset 128) and 8-row groups follow each
// other (stride byte offset C * sizeof(T) * 8). A product over 32 bytes of
// K (16 bf16 or 8 tf32 values) starts two core matrices further on.
//
// Register fragments (per warp w of the warpgroup, lane = 4 g + t):
//   accumulator of m64nN: d[4j + 0, 1] = (row 16w + g, cols 8j + 2t, +1),
//                         d[4j + 2, 3] = (row 16w + g + 8, same cols);
//   A of bf16 m64k16: a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same),
//                     a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, same),
//                     rows relative to 16w, the lower column in the low half;
//   A of tf32 m64k8:  a0 = (row g, col t), a1 = (row g+8, col t),
//                     a2 = (row g, col t+4), a3 = (row g+8, col t+4).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zoo {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, c) in a K-major core-matrix tile whose rows
// hold ``row_bytes`` bytes
__device__ __forceinline__ uint32_t tile_offset(int r, int cbyte,
                                                int row_bytes) {
  return (r >> 3) * (row_bytes * 8) + (cbyte >> 4) * 128 + (r & 7) * 16 +
         (cbyte & 15);
}

// no-swizzle shared-memory matrix descriptor: start address, leading byte
// offset (between core matrices adjacent along K) and stride byte offset
// (between 8-row groups), all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// descriptor of an operand tile (A or B) for one product: ``k32`` is the
// index of the 32-byte slice of K it reads
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile_saddr, int k32,
                                              int row_bytes) {
  return make_desc(tile_saddr + k32 * 256, 128, row_bytes * 8);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// make generic-proxy writes to shared memory (st.shared, cp.async) visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across a
// wgmma fence/commit/wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 16 bytes global -> shared; zero-filled when ``valid`` is false (the
// source is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round to tf32 (10 mantissa bits), to nearest, ties away from zero, as
// cvt.rna.tf32.f32 does: half a tf32 step added to the magnitude bits, the
// low 13 bits cleared. Two integer operations, where sm_90 expands the
// cvt into a longer sequence.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo + O(2^-22 |x|), hi and lo both tf32 ("3xTF32")
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

#define ZOO_ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d(64 x 64) += A(64 x 8, registers) . B(8 x 64, shared), tf32
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : ZOO_ACC8(0), ZOO_ACC8(8), ZOO_ACC8(16), ZOO_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d(64 x 32) += A(64 x 8, registers) . B(8 x 32, shared), tf32
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : ZOO_ACC8(0), ZOO_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d(64 x 64) += A(64 x 16, registers) . B(16 x 64, shared), bf16
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : ZOO_ACC8(0), ZOO_ACC8(8), ZOO_ACC8(16), ZOO_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d(64 x 32) += A(64 x 8, shared) . B(8 x 32, shared), tf32, both K-major
__device__ __forceinline__ void wgmma_tf32_n32_ss(float (&d)[16],
                                                  uint64_t adesc,
                                                  uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : ZOO_ACC8(0), ZOO_ACC8(8)
      : "l"(adesc), "l"(bdesc), "r"(1));
}

// d(64 x 64) += A(64 x 16, shared) . B(16 x 64, shared), bf16, both
// K-major
__device__ __forceinline__ void wgmma_bf16_n64_ss(float (&d)[32],
                                                  uint64_t adesc,
                                                  uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ZOO_ACC8(0), ZOO_ACC8(8), ZOO_ACC8(16), ZOO_ACC8(24)
      : "l"(adesc), "l"(bdesc), "r"(1));
}

#undef ZOO_ACC8

}  // namespace zoo
