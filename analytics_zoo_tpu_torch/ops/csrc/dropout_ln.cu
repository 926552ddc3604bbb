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
//            dgamma = sum(dy * xhat), dbeta = sum(dy) over the rows
//
// What bounds them on this card: bytes. Each element is read and written a
// handful of times for some ten operations: at BERT-base training
// (N = 32 * 512, D = 768, float32) each kernel moves about 5 x 50.3 MB, some
// 75 us at 3.35 TB/s.
//
// Forward: one pass over the data. One warp owns one row, its D values held
// in registers (D / 32 a lane, columns lane + 32 j so each load of the warp
// is one contiguous run), and the row statistics are warp-shuffle f32
// reductions, so no row is read twice and no intermediate reaches device
// memory.
//
// Backward: one warp a row too, and what keeps enough bytes in flight:
// - 16-byte accesses: a lane owns contiguous chunks of 4 float32 or 8 bf16
//   values (chunk lane + 32 j), loaded and stored as 16 bytes, and the
//   chunk's 32-bit words as 16-byte loads too. Where D is not a multiple of
//   the chunk, the rows start off 16-byte boundaries, and the same kernel
//   runs with one value a chunk.
// - Few registers: a lane holds only its dy and xhat values. gamma is
//   staged once into shared memory, and the dgamma/dbeta sums live there
//   too, one slice per warp in which each lane updates only its own
//   columns: no bank conflicts, no atomics. So three blocks of 8 warps
//   share an SM at D = 768.
// - A persistent grid: as many blocks as fit the card at once, each warp
//   walking rows with a grid stride, so there is no tail wave.
// - dgamma/dbeta: each block sums its warps' slices into one partial row,
//   and a second small kernel (dln_bwd_sum) sums the partial rows in block
//   order. Fixed orders throughout, so the result is deterministic.
//
// Built by ``analytics_zoo_tpu_torch/ops/_kernels.py`` and called through
// ctypes (plain C interface below).

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using zoo::load_f;
using zoo::store_f;
using zoo::warp_sum;

constexpr int WARPS = 8;             // rows in flight per block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CPL = 32;          // columns per lane: D <= 1024
constexpr int BWD_MAX_BLOCKS_PER_SM = 4;

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
  float* dgamma_part;   // (gridDim.x, D)
  float* dbeta_part;    // (gridDim.x, D)
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

// VEC consecutive values at p, as floats: 16 bytes when VEC > 1
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = load_f<T>(p);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC == 4, "16 bytes of float32");
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    static_assert(VEC == 8, "16 bytes of bf16");
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    store_f<T>(p, x[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// VEC 32-bit words at p (16-byte loads when VEC > 1)
template <int VEC>
__device__ __forceinline__ void load_words(const unsigned int* p,
                                           unsigned int (&b)[VEC]) {
  if constexpr (VEC == 1) {
    b[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      b[i] = v.x; b[i + 1] = v.y; b[i + 2] = v.z; b[i + 3] = v.w;
    }
  }
}

// VEC floats of shared memory at p, 16 bytes at a time when VEC > 1
template <int VEC>
__device__ __forceinline__ void lds_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
    }
  }
}

// p[i] += x[i] in shared memory, 16 bytes at a time when VEC > 1
template <int VEC>
__device__ __forceinline__ void add_smem(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    *p += x[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      float4 v = *reinterpret_cast<float4*>(p + i);
      v.x += x[i]; v.y += x[i + 1]; v.z += x[i + 2]; v.w += x[i + 3];
      *reinterpret_cast<float4*>(p + i) = v;
    }
  }
}

// floats of a row of gamma or of one warp's dgamma/dbeta slice: D rounded
// up to 4, so that every slice starts on a 16-byte boundary
__host__ __device__ __forceinline__ int padded(int d) { return (d + 3) & ~3; }

__host__ __device__ __forceinline__ size_t bwd_smem(int d) {
  return sizeof(float) * (size_t)padded(d) * (1 + 2 * WARPS);
}

// A lane owns NCH chunks of VEC values (chunk lane + 32 j). Three blocks
// an SM (<= 85 registers a thread) while a lane holds at most 24 values.
template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(THREADS, VEC * NCH <= 24 ? 3 : 2)
dln_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dp = padded(p.D);
  float* gs = sm;                           // gamma
  float* acc_g = sm + dp * (1 + 2 * warp);  // this warp's dgamma slice
  float* acc_b = acc_g + dp;                // and its dbeta slice
  for (int c = threadIdx.x; c < p.D; c += THREADS) gs[c] = p.gamma[c];
  for (int c = threadIdx.x; c < 2 * WARPS * dp; c += THREADS)
    sm[dp + c] = 0.f;
  __syncthreads();

  const int stride = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + warp; row < p.N; row += stride) {
    const long long base = (long long)row * p.D;
    const T* dy = static_cast<const T*>(p.dy) + base;
    const T* z = static_cast<const T*>(p.z) + base;
    const float mean = p.mean[row];
    const float inv = p.inv[row];

    float dyv[NCH][VEC], xhat[NCH][VEC];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = (lane + 32 * j) * VEC;   // D % VEC == 0: whole chunks
      if (c < p.D) {
        float g[VEC];
        load_vec<T, VEC>(dy + c, dyv[j]);
        load_vec<T, VEC>(z + c, xhat[j]);
        lds_vec<VEC>(gs + c, g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          xhat[j][e] = (xhat[j][e] - mean) * inv;
          const float dg = dyv[j][e] * g[e];
          m1 += dg;
          m2 += dg * xhat[j][e];
        }
      }
    }
    m1 = warp_sum(m1) / p.D;
    m2 = warp_sum(m2) / p.D;

    const unsigned int* bits = p.bits + base;
    T* dx = static_cast<T*>(p.dx) + base;
    T* dres = static_cast<T*>(p.dres) + base;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = (lane + 32 * j) * VEC;
      if (c < p.D) {
        float g[VEC], dz[VEC], dxv[VEC], tg[VEC];
        unsigned int wb[VEC];
        lds_vec<VEC>(gs + c, g);
        load_words<VEC>(bits + c, wb);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          dz[e] = inv * (dyv[j][e] * g[e] - m1 - xhat[j][e] * m2);
          dxv[e] = wb[e] < p.thresh ? dz[e] * p.inv_keep : 0.f;
          tg[e] = dyv[j][e] * xhat[j][e];
        }
        store_vec<T, VEC>(dx + c, dxv);
        store_vec<T, VEC>(dres + c, dz);
        add_smem<VEC>(acc_g + c, tg);
        add_smem<VEC>(acc_b + c, dyv[j]);
      }
    }
  }

  // the block's partial: its warps' slices summed in warp order
  __syncthreads();
  for (int c = threadIdx.x; c < p.D; c += THREADS) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sg += sm[dp * (1 + 2 * w) + c];
      sb += sm[dp * (2 + 2 * w) + c];
    }
    p.dgamma_part[(long long)blockIdx.x * p.D + c] = sg;
    p.dbeta_part[(long long)blockIdx.x * p.D + c] = sb;
  }
}

// dgamma and dbeta: the column sums of the (nblk, D) partials, each column
// by one block in a fixed order (rows w, w + 8, ... by warp w, then the
// warps in order); blockIdx.y picks dgamma (0) or dbeta (1)
__global__ void __launch_bounds__(THREADS)
dln_bwd_sum_kernel(const float* dgamma_part, const float* dbeta_part,
                   float* dgamma, float* dbeta, int nblk, int D) {
  __shared__ float red[WARPS][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* part = blockIdx.y ? dbeta_part : dgamma_part;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int r = warp; r < nblk; r += WARPS) s += part[(long long)r * D + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tot += red[w][lane];
    (blockIdx.y ? dbeta : dgamma)[c] = tot;
  }
}

template <typename T, int CPL>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  const int blocks = (p.N + WARPS - 1) / WARPS;
  dln_fwd_kernel<T, CPL><<<blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// rows of the partials a launch may write: the blocks that fit the card
// at once (at most BWD_MAX_BLOCKS_PER_SM an SM), no more than one per 8
// rows
int bwd_blocks_cap(int N) {
  const int rows = (N + WARPS - 1) / WARPS;
  const int cap = sm_count() * BWD_MAX_BLOCKS_PER_SM;
  return cap < rows ? cap : rows;
}

template <typename T, int VEC, int NCH>
cudaError_t launch_bwd(const BwdParams& p, float* dgamma, float* dbeta,
                       int part_rows, cudaStream_t stream) {
  auto kernel = dln_bwd_kernel<T, VEC, NCH>;
  const size_t smem = bwd_smem(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  if (per_sm > BWD_MAX_BLOCKS_PER_SM) per_sm = BWD_MAX_BLOCKS_PER_SM;
  int nblk = sm_count() * per_sm;
  if (nblk > part_rows) nblk = part_rows;
  if (nblk < 1) return cudaErrorInvalidValue;
  kernel<<<nblk, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.D + 31) / 32, 2);
  dln_bwd_sum_kernel<<<grid, THREADS, 0, stream>>>(
      p.dgamma_part, p.dbeta_part, dgamma, dbeta, nblk, p.D);
  return cudaGetLastError();
}

// 16-byte chunks (4 float32 or 8 bf16 values) where D is a multiple of the
// chunk and every row operand starts on a 16-byte boundary; one value a
// chunk otherwise. Chunks a lane: rounded up to a few sizes.
template <typename T>
cudaError_t dispatch_bwd(const BwdParams& p, float* dgamma, float* dbeta,
                         int part_rows, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  bool aligned = p.D % VEC == 0;
  const void* rows[] = {p.dy, p.z, p.bits, p.dx, p.dres};
  for (const void* ptr : rows)
    aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (aligned) {
    const int nch = (p.D / VEC + 31) / 32;   // 1..8 (f32), 1..4 (bf16)
    if constexpr (VEC == 4) {
      switch ((nch + 1) / 2) {
        case 1: return launch_bwd<T, 4, 2>(p, dgamma, dbeta, part_rows, s);
        case 2: return launch_bwd<T, 4, 4>(p, dgamma, dbeta, part_rows, s);
        case 3: return launch_bwd<T, 4, 6>(p, dgamma, dbeta, part_rows, s);
        case 4: return launch_bwd<T, 4, 8>(p, dgamma, dbeta, part_rows, s);
      }
    } else {
      switch (nch) {
        case 1: return launch_bwd<T, 8, 1>(p, dgamma, dbeta, part_rows, s);
        case 2: return launch_bwd<T, 8, 2>(p, dgamma, dbeta, part_rows, s);
        case 3: return launch_bwd<T, 8, 3>(p, dgamma, dbeta, part_rows, s);
        case 4: return launch_bwd<T, 8, 4>(p, dgamma, dbeta, part_rows, s);
      }
    }
    return cudaErrorInvalidValue;
  }
  switch ((p.D + 255) / 256) {   // columns a lane, rounded up to 8
    case 1: return launch_bwd<T, 1, 8>(p, dgamma, dbeta, part_rows, s);
    case 2: return launch_bwd<T, 1, 16>(p, dgamma, dbeta, part_rows, s);
    case 3: return launch_bwd<T, 1, 24>(p, dgamma, dbeta, part_rows, s);
    case 4: return launch_bwd<T, 1, 32>(p, dgamma, dbeta, part_rows, s);
  }
  return cudaErrorInvalidValue;
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

// dtype: 0 = float32, 1 = bfloat16 (dy, z, dx, dres). Rows are contiguous
// (row stride D). The partials hold ``part_rows`` rows of D, at least one
// and at most zoo_dln_bwd_blocks(N); dgamma and dbeta are (D,). Two
// launches, the rows and then the partial sum; returns the first
// cudaError_t (0 on success).
extern "C" int zoo_dln_bwd(
    const void* dy, const void* z, const unsigned int* bits,
    const float* gamma, const float* mean, const float* inv, void* dx,
    void* dres, float* dgamma_part, float* dbeta_part, float* dgamma,
    float* dbeta, int part_rows, int N, int D, int dtype,
    unsigned int thresh, float inv_keep, void* stream) {
  if (N <= 0 || D <= 0 || D > 32 * MAX_CPL || part_rows <= 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.dy = dy; p.z = z; p.bits = bits; p.gamma = gamma; p.mean = mean;
  p.inv = inv; p.dx = dx; p.dres = dres; p.dgamma_part = dgamma_part;
  p.dbeta_part = dbeta_part;
  p.N = N; p.D = D; p.thresh = thresh; p.inv_keep = inv_keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_bwd<float>(p, dgamma, dbeta, part_rows, s);
  if (dtype == 1)
    return (int)dispatch_bwd<__nv_bfloat16>(p, dgamma, dbeta, part_rows, s);
  return (int)cudaErrorInvalidValue;
}

// rows of partials to allocate for zoo_dln_bwd on the current device
// (0 if the device cannot be queried)
extern "C" int zoo_dln_bwd_blocks(int N) { return bwd_blocks_cap(N); }
