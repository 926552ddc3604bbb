// Tile pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): one warpgroup a block owning 64 rows, tiles brought into
// shared memory by 16-byte cp.async in wgmma's K-major core-matrix layout
// (wgmma.cuh), float32 operands split into TF32 hi/lo halves ("3xTF32"),
// register fragments read out of those tiles, and the products over one
// reduction step.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace zoo {
namespace flash {

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU (relative error ~2^-22; 0 below 2^-126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int BM = 64;        // owned rows per block: one warpgroup's m64
constexpr int THREADS = 128;  // one warpgroup

// rows [r0, r0 + R) of a (B, L, H, d) operand into a core-matrix tile, by
// cp.async; rows past L are zero-filled
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src,
                                          long long sl, int r0, int L,
                                          int tid) {
  constexpr int CPR = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int ROW = D * (int)sizeof(T);
  constexpr int RPI = THREADS / CPR;             // rows a pass covers
  static_assert(THREADS % CPR == 0 && R % RPI == 0, "whole passes");
  const int c = tid % CPR, rt = tid / CPR;
  const long long step = RPI * sl;
  const T* s = src + (long long)(r0 + rt) * sl + c * (16 / (int)sizeof(T));
#pragma unroll
  for (int n = 0; n < R / RPI; ++n, s += step) {
    const bool ok = r0 + rt + n * RPI < L;
    zoo::cp_async16(dst + zoo::tile_offset(rt + n * RPI, 16 * c, ROW),
                    ok ? s : src, ok);
  }
}

// the same rows by slot: 16-byte slot i of the tile's storage (its order
// of core matrices) is copied by thread i mod THREADS, so the stores are
// free of bank conflicts and split_tile afterwards touches exactly the
// slots this thread copied (no barrier between the two)
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile_by_slot(unsigned char* dst,
                                                  const T* src, long long sl,
                                                  int r0, int L, int tid) {
  constexpr int CPR = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int SLOTS = R * CPR;
  static_assert(SLOTS % THREADS == 0, "whole passes");
#pragma unroll
  for (int i = tid; i < SLOTS; i += THREADS) {
    const int r = (i / (CPR * 8)) * 8 + (i & 7);   // tile_offset inverted
    const int c = (i >> 3) % CPR;
    const bool ok = r0 + r < L;
    zoo::cp_async16(dst + 16 * i,
                    ok ? src + (long long)(r0 + r) * sl +
                             c * (16 / (int)sizeof(T))
                       : src,
                    ok);
  }
}

// float32 B tile: x -> tf32 hi in place, tf32 lo into ``lo``
template <int BYTES>
__device__ __forceinline__ void split_tile(unsigned char* tile,
                                           unsigned char* lo, int tid) {
  float4* x = reinterpret_cast<float4*>(tile);
  uint4* l = reinterpret_cast<uint4*>(lo);
  static_assert(BYTES % (16 * THREADS) == 0, "whole passes");
#pragma unroll
  for (int i = tid; i < BYTES / 16; i += THREADS) {
    const float4 v = x[i];
    uint4 h, w;
    zoo::split_tf32(v.x, h.x, w.x);
    zoo::split_tf32(v.y, h.y, w.y);
    zoo::split_tf32(v.z, h.z, w.z);
    zoo::split_tf32(v.w, h.w, w.w);
    reinterpret_cast<uint4*>(tile)[i] = h;
    l[i] = w;
  }
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* tile,
                                          uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(tile + off);
}
__device__ __forceinline__ uint32_t lds16(const unsigned char* tile,
                                          uint32_t off) {
  return *reinterpret_cast<const uint16_t*>(tile + off);
}

// float32 A fragment, split into hi/lo, of step ``ks`` of a product over
// the contiguous axis (d) of a resident tile (rows = the block's rows)
template <int D>
__device__ __forceinline__ void frag_rows(const unsigned char* tile, int ks,
                                          int r0, int t, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  constexpr int ROW = 4 * D;
  const int c = ks * 8 + t;
  const uint32_t o[4] = {zoo::tile_offset(r0, 4 * c, ROW),
                         zoo::tile_offset(r0 + 8, 4 * c, ROW),
                         zoo::tile_offset(r0, 4 * c + 16, ROW),
                         zoo::tile_offset(r0 + 8, 4 * c + 16, ROW)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    zoo::split_tf32(__uint_as_float(lds32(tile, o[i])), hi[i], lo[i]);
}

// A fragment of step ``ks`` of a product over the rows of a streamed tile
// X (rows x d): A = X^T, rows of A = d columns ``c0`` and ``c0 + 8``. In
// float32 hi comes from the (split) tile and lo from its lo half.
template <typename T, int D>
__device__ __forceinline__ void frag_cols(const unsigned char* tile,
                                          const unsigned char* tile_lo,
                                          int ks, int c0, int t,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  constexpr int ROW = D * (int)sizeof(T);
  if constexpr (std::is_same<T, float>::value) {
    const int r = ks * 8 + t;
    const uint32_t o[4] = {zoo::tile_offset(r, 4 * c0, ROW),
                           zoo::tile_offset(r, 4 * (c0 + 8), ROW),
                           zoo::tile_offset(r + 4, 4 * c0, ROW),
                           zoo::tile_offset(r + 4, 4 * (c0 + 8), ROW)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = lds32(tile, o[i]);
      lo[i] = lds32(tile_lo, o[i]);
    }
  } else {
    const int r = ks * 16 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + (i >> 1) * 8;
      const int cc = 2 * (c0 + (i & 1) * 8);
      hi[i] = lds16(tile, zoo::tile_offset(rr, cc, ROW)) |
              (lds16(tile, zoo::tile_offset(rr + 1, cc, ROW)) << 16);
    }
  }
}

// float32 A fragment of step ``ks`` over the rows of a streamed tile that
// is not split (as frag_cols): each value split into hi/lo as it is read
template <int D>
__device__ __forceinline__ void frag_cols_split(const unsigned char* tile,
                                                int ks, int c0, int t,
                                                uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  constexpr int ROW = 4 * D;
  const int r = ks * 8 + t;
  const uint32_t o[4] = {zoo::tile_offset(r, 4 * c0, ROW),
                         zoo::tile_offset(r, 4 * (c0 + 8), ROW),
                         zoo::tile_offset(r + 4, 4 * c0, ROW),
                         zoo::tile_offset(r + 4, 4 * (c0 + 8), ROW)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    zoo::split_tf32(__uint_as_float(lds32(tile, o[i])), hi[i], lo[i]);
}

// d += A . B over one reduction step: one wgmma in bf16, three in float32
// (lo.hi, hi.lo, hi.hi: the small terms first)
template <typename T, int N>
__device__ __forceinline__ void mma(float (&d)[N / 2],
                                    const uint32_t (&ahi)[4],
                                    const uint32_t (&alo)[4], uint64_t bhi,
                                    uint64_t blo) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 64) {
      zoo::wgmma_tf32_n64(d, alo, bhi);
      zoo::wgmma_tf32_n64(d, ahi, blo);
      zoo::wgmma_tf32_n64(d, ahi, bhi);
    } else {
      zoo::wgmma_tf32_n32(d, alo, bhi);
      zoo::wgmma_tf32_n32(d, ahi, blo);
      zoo::wgmma_tf32_n32(d, ahi, bhi);
    }
  } else {
    static_assert(N == 64, "bf16 products are m64n64k16");
    zoo::wgmma_bf16_n64(d, ahi, bhi);
  }
}

// round(x0), round(x1) at columns (c, c + 1) of row r of a P tile (hi and,
// in float32, lo halves)
template <typename T, int PROW>
__device__ __forceinline__ void store_pair(unsigned char* hi,
                                           unsigned char* lo, int r, int c,
                                           float x0, float x1) {
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t off = zoo::tile_offset(r, 4 * c, PROW);
    uint2 h, l;
    zoo::split_tf32(x0, h.x, l.x);
    zoo::split_tf32(x1, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + off) = h;
    *reinterpret_cast<uint2*>(lo + off) = l;
  } else {
    *reinterpret_cast<uint32_t*>(hi + zoo::tile_offset(r, 2 * c, PROW)) =
        zoo::pack_bf16(x0, x1);
  }
}

}  // namespace flash
}  // namespace zoo
