// Flash-attention backward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Replace the TPU kernels ``analytics_zoo_tpu/ops/attention.py::
// _flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` (reached through
// ``_flash_backward_blhd`` and ``_flash_backward``). With the forward's
// saved lse and delta = rowsum(dO * O) (computed outside, in torch, as the
// JAX wrapper does), each rebuilds the score tile from q, k and the key
// bias under the same bottom-right causal mask and computes
//
//   p  = exp(s - lse)            s = q . k^T * sm_scale + key_bias[b, key]
//   dp = dO . v^T
//   ds = p * (dp - delta)
//   flash_bwd_dq : dq = sum_k round(ds) . k * sm_scale
//   flash_bwd_dkv: dv = sum_q round(p)^T . dO
//                  dk = sum_q round(ds)^T . q * sm_scale
//                  db = sum_q ds            (per head; summed over heads
//                                            outside, in torch)
//
// where round() is the cast to the operand dtype the TPU kernels make
// before those products (identity in float32).
//
// What bounds them on this card: dq does three L x L products
// (6*B*H*Lq*Lk*d operations), dkv four (8*B*H*Lq*Lk*d), against q, k, v,
// dO reads and one or two L x d writes. At BERT-base (L=512, d=64) that is
// well over 100 operations a byte in float32, so the CUDA cores' 67 TFLOP/s
// bound them, as it bounds the forward.
//
// What the design does about it: no L x L tensor reaches device memory.
// Blocks run in no order, so each owns its accumulator outright and loops
// over the other operand's tiles inside the block (the TPU kernels'
// sequential grid axis): flash_bwd_dq owns a 64-row q tile with Q and dO
// resident in shared memory and walks the key tiles; flash_bwd_dkv owns a
// 64-key tile with K and V resident and walks the query tiles, so dk, dv
// and db are summed in registers with no atomics and the result is
// deterministic, as on the TPU. Each thread of the 16 x 16 grid keeps a
// 4 x 4 patch of the score tiles and a 4 x d/16 patch of its accumulators
// in f32 registers; p and ds go through shared memory once per tile for
// the second products. Tiles wholly masked by the causal diagonal are
// skipped; ragged Lq/Lk edges are masked explicitly. Products run on the
// CUDA cores in f32 for both dtypes, a simple, exact first design;
// tensor cores (wgmma) and TMA are later work.
//
// Built by ``analytics_zoo_tpu_torch/ops/_kernels.py`` and called through
// ctypes (plain C interface below).

#include "common.cuh"

namespace {

using zoo::load_f;
using zoo::MASK_VALUE;
using zoo::round_to;
using zoo::row_sum16;
using zoo::store_f;

constexpr int BLOCK_M = 64;     // query rows per tile
constexpr int BLOCK_N = 64;     // keys per tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr int RPT = 4;          // tile rows per thread (64 / 16)
constexpr int CPT = 4;          // tile cols per thread (64 / 16)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* kbias;   // (B, Lk) f32, key stride 1
  const float* lse;     // (B*H, Lq) f32, contiguous
  const float* delta;   // (B, Lq, H) f32, contiguous
  void* dq;
  void* dk;
  void* dv;
  float* dbias;         // (B*H, Lk) f32, contiguous
  int B, H, Lq, Lk;
  int causal;
  float sm_scale;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long do_sb, do_sl, do_sh;
  long long dq_sb, dq_sl, dq_sh;
  long long dk_sb, dk_sl, dk_sh;
  long long dv_sb, dv_sl, dv_sh;
  long long kb_sb;
};

// rows [r0, r0 + 64) of a (B, L, H, d) operand into a padded f32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long sl,
                                          int r0, int L, int tid) {
  constexpr int DP = D + 1;
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * DP + c] = row < L ? load_f<T>(src + row * sl + c) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles (row stride D + 1) and the dS tile (stride 65)
  return sizeof(float) *
         (size_t)((2 * BLOCK_M + 2 * BLOCK_N) * (D + 1) + BLOCK_M * (BLOCK_N + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles, the P and dS tiles (keys x queries, stride 65) and
  // the q tile's lse and delta
  return sizeof(float) *
         (size_t)((2 * BLOCK_M + 2 * BLOCK_N) * (D + 1) +
                  2 * BLOCK_N * (BLOCK_M + 1) + 2 * BLOCK_M);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const Params p) {
  constexpr int DP = D + 1;
  constexpr int NP = BLOCK_N + 1;
  constexpr int DC = D / 16;        // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BLOCK_M][DP]
  float* dOs = Qs + BLOCK_M * DP;   // [BLOCK_M][DP]
  float* Ks = dOs + BLOCK_M * DP;   // [BLOCK_N][DP]
  float* Vs = Ks + BLOCK_N * DP;    // [BLOCK_N][DP]
  float* dSs = Vs + BLOCK_N * DP;   // [BLOCK_M][NP]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.y * BLOCK_M;
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // key group: keys tx + 16 j; dq cols tx + 16 c
  const int ty = tid >> 4;          // row group: rows ty * RPT + i
  const int q_offset = p.Lk - p.Lq; // bottom-right causal alignment

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kb = p.kbias + b * p.kb_sb;

  load_tile<T, D>(Qs, qg, p.q_sl, q0, p.Lq, tid);
  load_tile<T, D>(dOs, dog, p.do_sl, q0, p.Lq, tid);

  float lse_r[RPT], delta_r[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    const bool ok = row < p.Lq;
    lse_r[i] = ok ? p.lse[(long long)bh * p.Lq + row] : 0.f;
    delta_r[i] = ok ? p.delta[((long long)b * p.Lq + row) * p.H + h] : 0.f;
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
    __syncthreads();  // the previous tile's K and dS reads are done
    load_tile<T, D>(Ks, kg, p.k_sl, k0, p.Lk, tid);
    load_tile<T, D>(Vs, vg, p.v_sl, k0, p.Lk, tid);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;

#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty * RPT + i) * DP + c];
        ov[i] = dOs[(ty * RPT + i) * DP + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + c];
        vv[j] = Vs[(tx + 16 * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool kvalid = key < p.Lk;
      const float bias = kvalid ? kb[key] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty * RPT + i;
        float x = s[i][j] * p.sm_scale + bias;
        if (p.causal && key > row + q_offset) x = MASK_VALUE;
        const float pv = (kvalid && row < p.Lq) ? expf(x - lse_r[i]) : 0.f;
        const float ds = pv * (dp[i][j] - delta_r[i]);
        dSs[(ty * RPT + i) * NP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float dsv[RPT], kv[DC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dSs[(ty * RPT + i) * NP + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[n * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row < p.Lq) {
      T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + row * p.dq_sl + h * p.dq_sh;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        store_f<T>(dqg + tx + 16 * c, acc[i][c] * p.sm_scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int DP = D + 1;
  constexpr int MP = BLOCK_M + 1;
  constexpr int DC = D / 16;        // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BLOCK_N][DP]
  float* Vs = Ks + BLOCK_N * DP;    // [BLOCK_N][DP]
  float* Qs = Vs + BLOCK_N * DP;    // [BLOCK_M][DP]
  float* dOs = Qs + BLOCK_M * DP;   // [BLOCK_M][DP]
  float* Ps = dOs + BLOCK_M * DP;   // [BLOCK_N][MP]  round(p), keys x queries
  float* dSs = Ps + BLOCK_N * MP;   // [BLOCK_N][MP]  round(ds)
  float* lse_s = dSs + BLOCK_N * MP;  // [BLOCK_M]
  float* delta_s = lse_s + BLOCK_M;   // [BLOCK_M]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * BLOCK_N;
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // query group: queries tx + 16 j; cols tx + 16 c
  const int ty = tid >> 4;          // key group: keys ty * RPT + i
  const int q_offset = p.Lk - p.Lq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kb = p.kbias + b * p.kb_sb;

  load_tile<T, D>(Ks, kg, p.k_sl, k0, p.Lk, tid);
  load_tile<T, D>(Vs, vg, p.v_sl, k0, p.Lk, tid);

  float bias_r[RPT], db[RPT], dk[RPT][DC], dv[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty * RPT + i;
    bias_r[i] = key < p.Lk ? kb[key] : 0.f;
    db[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  const int n_q_tiles = (p.Lq + BLOCK_M - 1) / BLOCK_M;
  int t0 = 0;
  if (p.causal) {
    // query tiles whose last row sees no key of this tile are all masked
    const int first_row = k0 - q_offset;
    t0 = first_row > 0 ? first_row / BLOCK_M : 0;
  }

  for (int t = t0; t < n_q_tiles; ++t) {
    const int q0 = t * BLOCK_M;
    __syncthreads();  // the previous tile's Q, dO, P and dS reads are done
    load_tile<T, D>(Qs, qg, p.q_sl, q0, p.Lq, tid);
    load_tile<T, D>(dOs, dog, p.do_sl, q0, p.Lq, tid);
    for (int r = tid; r < BLOCK_M; r += THREADS) {
      const int row = q0 + r;
      const bool ok = row < p.Lq;
      lse_s[r] = ok ? p.lse[(long long)bh * p.Lq + row] : 0.f;
      delta_s[r] = ok ? p.delta[((long long)b * p.Lq + row) * p.H + h] : 0.f;
    }
    __syncthreads();

    // score and dp tiles, transposed: s[i][j] is (key ty*4+i, query tx+16j)
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;

#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = Ks[(ty * RPT + i) * DP + c];
        vv[i] = Vs[(ty * RPT + i) * DP + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qv[j] = Qs[(tx + 16 * j) * DP + c];
        ov[j] = dOs[(tx + 16 * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int key = k0 + ty * RPT + i;
      const bool kvalid = key < p.Lk;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = tx + 16 * j;
        const int row = q0 + r;
        float x = s[i][j] * p.sm_scale + bias_r[i];
        if (p.causal && key > row + q_offset) x = MASK_VALUE;
        const float pv = (kvalid && row < p.Lq) ? expf(x - lse_s[r]) : 0.f;
        const float ds = pv * (dp[i][j] - delta_s[r]);
        db[i] += ds;
        Ps[(ty * RPT + i) * MP + r] = round_to<T>(pv);
        dSs[(ty * RPT + i) * MP + r] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BLOCK_M; ++n) {
      float pv[RPT], dsv[RPT], ov[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = Ps[(ty * RPT + i) * MP + n];
        dsv[i] = dSs[(ty * RPT + i) * MP + n];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        ov[c] = dOs[n * DP + tx + 16 * c];
        qv[c] = Qs[n * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float col_sum = row_sum16(db[i]);   // over the 16 query groups
    const int key = k0 + ty * RPT + i;
    if (key < p.Lk) {
      T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + key * p.dk_sl + h * p.dk_sh;
      T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + key * p.dv_sl + h * p.dv_sh;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        store_f<T>(dkg + tx + 16 * c, dk[i][c] * p.sm_scale);
        store_f<T>(dvg + tx + 16 * c, dv[i][c]);
      }
      if (tx == 0) p.dbias[(long long)bh * p.Lk + key] = col_sum;
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Lq + BLOCK_M - 1) / BLOCK_M);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Lk + BLOCK_N - 1) / BLOCK_N);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(
    const void* q, const void* k, const void* v, const void* dout,
    const float* kbias, const float* lse, const float* delta, void* dq,
    void* dk, void* dv, float* dbias, int B, int H, int Lq, int Lk,
    int causal, float sm_scale, const long long* st) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.kbias = kbias; p.lse = lse;
  p.delta = delta; p.dq = dq; p.dk = dk; p.dv = dv; p.dbias = dbias;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.causal = causal; p.sm_scale = sm_scale;
  p.q_sb = st[0]; p.q_sl = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_sl = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_sl = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_sl = st[10]; p.do_sh = st[11];
  p.dq_sb = st[12]; p.dq_sl = st[13]; p.dq_sh = st[14];
  p.dk_sb = st[15]; p.dk_sl = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_sl = st[19]; p.dv_sh = st[20];
  p.kb_sb = st[21];
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ``strides`` holds 22 element strides:
// (batch, length, head) of q, k, v, dO, dq, dk, dv in that order, then the
// key bias's batch stride; every head-dim stride must be 1. Each returns
// the cudaError_t of its launch (0 on success). zoo_flash_bwd_dq writes dq
// only; zoo_flash_bwd_dkv writes dk, dv and dbias.
extern "C" int zoo_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* kbias, const float* lse, const float* delta, void* dq,
    int B, int H, int Lq, int Lk, int D, int dtype, int causal,
    float sm_scale, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, kbias, lse, delta, dq, nullptr,
                               nullptr, nullptr, B, H, Lq, Lk, causal,
                               sm_scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch_dq<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_dq<float, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_dq<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch_dq<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int zoo_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* kbias, const float* lse, const float* delta, void* dk,
    void* dv, float* dbias, int B, int H, int Lq, int Lk, int D, int dtype,
    int causal, float sm_scale, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, kbias, lse, delta, nullptr, dk,
                               dv, dbias, B, H, Lq, Lk, causal, sm_scale,
                               strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch_dkv<float, 64>(p, s);
  if (dtype == 0 && D == 128) return (int)launch_dkv<float, 128>(p, s);
  if (dtype == 1 && D == 64) return (int)launch_dkv<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return (int)launch_dkv<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
