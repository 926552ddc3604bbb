// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel ``analytics_zoo_tpu/ops/attention.py::
// _flash_fwd_kernel`` (reached through ``_flash_forward_blhd`` and
// ``_flash_forward``). It computes the same function:
//
//   s   = q . k^T * sm_scale + key_bias[b, key]
//   s   = MASK_VALUE where causal and key > row + (Lk - Lq)   (bottom-right)
//   o   = softmax(s) . v   (online softmax over key tiles, f32 statistics)
//   lse = m + log(max(l, 1e-30))
//
// with p rounded to v's dtype before p . v, as the TPU kernel does.
//
// What bounds it on this card: the two products are 4*B*H*Lq*Lk*d
// operations against q/k/v/o bytes of 4*B*L*H*d*sizeof(T). At BERT-base
// (L=512, d=64) that is 128 operations a byte in f32 and 256 in bf16 —
// compute-bound in f32 on the CUDA cores (67 TFLOP/s), and near the
// memory line in bf16 if the tensor cores carried the products.
//
// What the design does about it: the L x L score matrix never reaches
// device memory. One thread block owns one (batch*head, 64-row query
// tile); a loop inside the block walks the key tiles (it replaces the TPU
// kernel's sequential grid axis), staging each 64-row K and V tile in
// shared memory once and reusing it for all 64 query rows. Each thread
// keeps a 4x4 patch of the score tile and a 4 x d/16 patch of the output
// accumulator in f32 registers, so every shared-memory read feeds four
// FMAs. Row statistics (m, l) are reduced with warp shuffles across the 16
// lanes that share a row. Key tiles wholly above the causal diagonal are
// skipped; ragged Lq/Lk edges are masked explicitly. The products run on
// the CUDA cores in f32 for both dtypes — a simple, exact first design;
// tensor cores (wgmma), TMA and warp specialisation are later work.
//
// Built by ``analytics_zoo_tpu_torch/ops/_kernels.py`` with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -Xcompiler -fPIC -c
// (one process per source, then one ``nvcc -shared`` link) and called
// through ctypes (plain C interface below).

#include "common.cuh"

namespace {

using zoo::load_f;
using zoo::MASK_VALUE;
using zoo::round_to;
using zoo::row_max16;
using zoo::row_sum16;
using zoo::store_f;

constexpr int BLOCK_M = 64;     // query rows per block
constexpr int BLOCK_N = 64;     // keys per tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr int RPT = 4;          // rows per thread    (BLOCK_M / 16)
constexpr int CPT = 4;          // score cols per thread (BLOCK_N / 16)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kbias;   // (B, Lk) f32, key stride 1
  void* o;
  float* lse;           // (B*H, Lq) f32, contiguous
  int B, H, Lq, Lk;
  int causal;
  float sm_scale;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  long long kb_sb;
};

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles with a padded row stride (D + 1) and the P tile (BLOCK_N + 1)
  return sizeof(float) *
         (size_t)((BLOCK_M + 2 * BLOCK_N) * (D + 1) + BLOCK_M * (BLOCK_N + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int DP = D + 1;         // padded stride: conflict-free column reads
  constexpr int NP = BLOCK_N + 1;
  constexpr int DC = D / 16;        // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BLOCK_M][DP]
  float* Ks = Qs + BLOCK_M * DP;    // [BLOCK_N][DP]
  float* Vs = Ks + BLOCK_N * DP;    // [BLOCK_N][DP]
  float* Ps = Vs + BLOCK_N * DP;    // [BLOCK_M][NP]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BLOCK_M;
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // column group: score cols tx + 16 j
  const int ty = tid >> 4;          // row group: rows ty * RPT + i
  const int q_offset = p.Lk - p.Lq; // bottom-right causal alignment

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* kb = p.kbias + b * p.kb_sb;

  for (int idx = tid; idx < BLOCK_M * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = q0 + r;
    Qs[r * DP + c] = row < p.Lq ? load_f<T>(qg + row * p.q_sl + c) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (p.Lk + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {
    // the last key any row of this tile may see; later tiles are all masked
    const int last_key = q_offset + q0 + BLOCK_M - 1;
    n_tiles = min(n_tiles, last_key / BLOCK_N + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();  // the previous tile's K, V and P reads are done
    for (int idx = tid; idx < BLOCK_N * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const int key = k0 + r;
      const bool ok = key < p.Lk;
      Ks[r * DP + c] = ok ? load_f<T>(kg + key * p.k_sl + c) : 0.f;
      Vs[r * DP + c] = ok ? load_f<T>(vg + key * p.v_sl + c) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * DP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool valid = key < p.Lk;
      const float bias = valid ? kb[key] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty * RPT + i;
        float x = s[i][j] * p.sm_scale + bias;
        if (p.causal && key > row + q_offset) x = MASK_VALUE;
        // ragged key edge: contributes exactly 0 (every tile holds a valid key)
        s[i][j] = valid ? x : -INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < CPT; ++j) mx = fmaxf(mx, s[i][j]);
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pv = expf(s[i][j] - m_new);
        rs += pv;
        Ps[(ty * RPT + i) * NP + tx + 16 * j] = round_to<T>(pv);
      }
      rs = row_sum16(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float pv[RPT], vv[DC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * NP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[n * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row < p.Lq) {
      const float l_safe = fmaxf(l[i], 1e-30f);
      T* og = static_cast<T*>(p.o) + b * p.o_sb + row * p.o_sl + h * p.o_sh;
#pragma unroll
      for (int c = 0; c < DC; ++c) store_f<T>(og + tx + 16 * c, acc[i][c] / l_safe);
      if (tx == 0) p.lse[(long long)bh * p.Lq + row] = m[i] + logf(l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Lq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1. Returns the cudaError_t of the launch (0 on success).
extern "C" int zoo_flash_fwd(
    const void* q, const void* k, const void* v, const float* kbias, void* o,
    float* lse, int B, int H, int Lq, int Lk, int D, int dtype, int causal,
    float sm_scale, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, long long kb_sb, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.kbias = kbias; p.o = o; p.lse = lse;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.causal = causal; p.sm_scale = sm_scale;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.kb_sb = kb_sb;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
