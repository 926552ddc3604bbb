// Fused dropout + residual add + layer norm for Hopper (sm_90a), CUDA C++:
// forward and backward.
//
// Replace the TPU kernels ``analytics_zoo_tpu/ops/fused_dropout_ln.py::
// _dln_fwd_kernel`` and ``_dln_bwd_kernel``. Over (N, D) rows, with raw
// 32-bit random words ``bits`` and keep = 1 - p:
//
//   dln_fwd: mask = bits < thresh            (thresh = keep * 2^32, as uint32)
//            z    = (mask ? x * (1/keep) : 0) + resid         (f32)
//            mean = sum(z) / D, var = max(sum(z^2) / D - mean^2, 0)
//            inv  = rsqrt(var + eps)
//            y    = (z - mean) * inv * gamma + beta            (in x's dtype)
//            saves z (in x's dtype), mean and inv (f32) for the backward
//   dln_bwd: xhat = (z - mean) * inv, g = dy * gamma
//            dz   = inv * (g - mean(g) - xhat * mean(g * xhat))
//            dx   = mask ? dz * (1/keep) : 0,  dres = dz        (in dy's dtype)
//            per-block partials of dgamma = sum(dy * xhat) and
//            dbeta = sum(dy), summed over blocks outside, in torch
//
// What bounds them on this card: bytes. Each element is read and written a
// handful of times for some ten operations: at BERT-base training
// (N = 32 * 512, D = 768, float32) each kernel moves about 5 x 50.3 MB, some
// 75 us at 3.35 TB/s.
//
// What the design does about it: one pass over the data. One warp owns one
// row, its D values held in registers (D / 32 a lane, columns lane + 32 j
// so each load of the warp is one contiguous run), and the row statistics
// and the backward's two row means are warp-shuffle f32 reductions, so no
// row is read twice and no intermediate reaches device memory. In the
// backward each warp sums its rows' dgamma/dbeta terms in registers and the
// block's warps combine them through shared memory into one partial per
// block: no atomics, so the result is deterministic.
//
// Built by ``analytics_zoo_tpu_torch/ops/_kernels.py`` and called through
// ctypes (plain C interface below).

#include "common.cuh"

namespace {

using zoo::load_f;
using zoo::store_f;
using zoo::warp_sum;

constexpr int WARPS = 8;             // rows in flight per block
constexpr int THREADS = 32 * WARPS;
constexpr int BWD_ROWS_PER_WARP = 4; // backward: rows per warp per block
constexpr int MAX_CPL = 32;          // columns per lane: D <= 1024

struct FwdParams {
  const void* x;
  const void* resid;
  const unsigned int* bits;
  const float* gamma;
  const float* beta;
  void* y;
  void* z;
  float* mean;
  float* inv;
  int N, D;
  unsigned int thresh;
  float inv_keep;
  float eps;
};

struct BwdParams {
  const void* dy;
  const void* z;
  const unsigned int* bits;
  const float* gamma;
  const float* mean;
  const float* inv;
  void* dx;
  void* dres;
  float* dgamma_part;   // (num blocks, D)
  float* dbeta_part;    // (num blocks, D)
  int N, D;
  unsigned int thresh;
  float inv_keep;
};

template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS)
dln_fwd_kernel(const FwdParams p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= p.N) return;
  const long long base = (long long)row * p.D;
  const T* x = static_cast<const T*>(p.x) + base;
  const T* r = static_cast<const T*>(p.resid) + base;
  const unsigned int* bits = p.bits + base;

  float z[CPL];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    float v = 0.f;
    if (c < p.D) {
      const float xv = load_f<T>(x + c);
      v = (bits[c] < p.thresh ? xv * p.inv_keep : 0.f) + load_f<T>(r + c);
    }
    z[j] = v;
    s1 += v;
    s2 += v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / p.D;
  const float var = fmaxf(s2 / p.D - mean * mean, 0.f);
  const float inv = rsqrtf(var + p.eps);

  T* y = static_cast<T*>(p.y) + base;
  T* zo = static_cast<T*>(p.z) + base;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c < p.D) {
      store_f<T>(y + c, (z[j] - mean) * inv * p.gamma[c] + p.beta[c]);
      store_f<T>(zo + c, z[j]);
    }
  }
  if (lane == 0) {
    p.mean[row] = mean;
    p.inv[row] = inv;
  }
}

template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS)
dln_bwd_kernel(const BwdParams p) {
  __shared__ float red[WARPS * 32 * MAX_CPL];   // one D-vector per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float g[CPL], acc_g[CPL], acc_b[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    g[j] = c < p.D ? p.gamma[c] : 0.f;
    acc_g[j] = acc_b[j] = 0.f;
  }

  for (int rr = 0; rr < BWD_ROWS_PER_WARP; ++rr) {
    const int row = (blockIdx.x * BWD_ROWS_PER_WARP + rr) * WARPS + warp;
    if (row >= p.N) break;
    const long long base = (long long)row * p.D;
    const T* dy = static_cast<const T*>(p.dy) + base;
    const T* z = static_cast<const T*>(p.z) + base;
    const float mean = p.mean[row];
    const float inv = p.inv[row];

    float dyv[CPL], xhat[CPL];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      float d = 0.f, xh = 0.f;
      if (c < p.D) {
        d = load_f<T>(dy + c);
        xh = (load_f<T>(z + c) - mean) * inv;
      }
      dyv[j] = d;
      xhat[j] = xh;
      const float dg = d * g[j];
      m1 += dg;
      m2 += dg * xh;
    }
    m1 = warp_sum(m1) / p.D;
    m2 = warp_sum(m2) / p.D;

    const unsigned int* bits = p.bits + base;
    T* dx = static_cast<T*>(p.dx) + base;
    T* dres = static_cast<T*>(p.dres) + base;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < p.D) {
        const float dz = inv * (dyv[j] * g[j] - m1 - xhat[j] * m2);
        store_f<T>(dx + c, bits[c] < p.thresh ? dz * p.inv_keep : 0.f);
        store_f<T>(dres + c, dz);
        acc_g[j] += dyv[j] * xhat[j];
        acc_b[j] += dyv[j];
      }
    }
  }

  // combine the warps' partials: dgamma, then dbeta through the same buffer
  const int stride = 32 * CPL;
#pragma unroll
  for (int j = 0; j < CPL; ++j) red[warp * stride + lane + 32 * j] = acc_g[j];
  __syncthreads();
  for (int c = threadIdx.x; c < p.D; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * stride + c];
    p.dgamma_part[(long long)blockIdx.x * p.D + c] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CPL; ++j) red[warp * stride + lane + 32 * j] = acc_b[j];
  __syncthreads();
  for (int c = threadIdx.x; c < p.D; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * stride + c];
    p.dbeta_part[(long long)blockIdx.x * p.D + c] = s;
  }
}

template <typename T, int CPL>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  const int blocks = (p.N + WARPS - 1) / WARPS;
  dln_fwd_kernel<T, CPL><<<blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int CPL>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const int rows_per_block = WARPS * BWD_ROWS_PER_WARP;
  const int blocks = (p.N + rows_per_block - 1) / rows_per_block;
  dln_bwd_kernel<T, CPL><<<blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// columns per lane, rounded up to a multiple of 4: D in (0, 1024]
#define ZOO_DLN_DISPATCH(LAUNCH, T, P, S)                 \
  switch ((P.D + 127) / 128) {                            \
    case 1: return (int)LAUNCH<T, 4>(P, S);               \
    case 2: return (int)LAUNCH<T, 8>(P, S);               \
    case 3: return (int)LAUNCH<T, 12>(P, S);              \
    case 4: return (int)LAUNCH<T, 16>(P, S);              \
    case 5: return (int)LAUNCH<T, 20>(P, S);              \
    case 6: return (int)LAUNCH<T, 24>(P, S);              \
    case 7: return (int)LAUNCH<T, 28>(P, S);              \
    case 8: return (int)LAUNCH<T, 32>(P, S);              \
    default: return (int)cudaErrorInvalidValue;           \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, resid, y, z). Rows are contiguous
// (row stride D). Returns the cudaError_t of the launch (0 on success).
extern "C" int zoo_dln_fwd(
    const void* x, const void* resid, const unsigned int* bits,
    const float* gamma, const float* beta, void* y, void* z, float* mean,
    float* inv, int N, int D, int dtype, unsigned int thresh, float inv_keep,
    float eps, void* stream) {
  if (N <= 0 || D <= 0 || D > 32 * MAX_CPL) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.x = x; p.resid = resid; p.bits = bits; p.gamma = gamma; p.beta = beta;
  p.y = y; p.z = z; p.mean = mean; p.inv = inv;
  p.N = N; p.D = D; p.thresh = thresh; p.inv_keep = inv_keep; p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) { ZOO_DLN_DISPATCH(launch_fwd, float, p, s) }
  if (dtype == 1) { ZOO_DLN_DISPATCH(launch_fwd, __nv_bfloat16, p, s) }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (dy, z, dx, dres). The partials hold
// zoo_dln_bwd_blocks(N) rows of D.
extern "C" int zoo_dln_bwd(
    const void* dy, const void* z, const unsigned int* bits,
    const float* gamma, const float* mean, const float* inv, void* dx,
    void* dres, float* dgamma_part, float* dbeta_part, int N, int D,
    int dtype, unsigned int thresh, float inv_keep, void* stream) {
  if (N <= 0 || D <= 0 || D > 32 * MAX_CPL) return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.dy = dy; p.z = z; p.bits = bits; p.gamma = gamma; p.mean = mean;
  p.inv = inv; p.dx = dx; p.dres = dres; p.dgamma_part = dgamma_part;
  p.dbeta_part = dbeta_part;
  p.N = N; p.D = D; p.thresh = thresh; p.inv_keep = inv_keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) { ZOO_DLN_DISPATCH(launch_bwd, float, p, s) }
  if (dtype == 1) { ZOO_DLN_DISPATCH(launch_bwd, __nv_bfloat16, p, s) }
  return (int)cudaErrorInvalidValue;
}

extern "C" int zoo_dln_bwd_blocks(int N) {
  const int rows_per_block = WARPS * BWD_ROWS_PER_WARP;
  return (N + rows_per_block - 1) / rows_per_block;
}
