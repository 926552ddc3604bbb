// Helpers shared by the port's CUDA kernels: loads and stores between the
// working dtype (float32 or bfloat16) and float, the rounding that mirrors a
// cast to the working dtype, and warp-shuffle reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zoo {

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store_f(T* p, float x);
template <>
__device__ __forceinline__ void store_f<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store_f<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T and back (identity for float): where the TPU kernels
// cast an f32 intermediate to the operand dtype before a product
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// reductions across the 16 lanes that share a row (lanes differ in bits 0-3)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// sum across the whole warp
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ops/attention.py DEFAULT_MASK_VALUE: -0.7 * float32 max
constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;

}  // namespace zoo
